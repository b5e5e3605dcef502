"""Core contracts of the port: the pipeline config (its own copy of the JAX
package's, ``config.py``) and the float32 rule for work on the card.

Data contract, as in the JAX package: images are (B, 1, H, W) float32 in
[0, 255]; keypoints (B, K, 2) float32 (y, x) with (-1, -1) padding; the
matching output is (B, K+1, K+1) with a dustbin last row and column.
"""

from __future__ import annotations

import contextlib

import torch

from .config import AKAZEConfig, CameraConfig, DoGConfig, FASTConfig, MatcherConfig

__all__ = ["AKAZEConfig", "CameraConfig", "DoGConfig", "FASTConfig", "MatcherConfig",
           "full_fp32"]


@contextlib.contextmanager
def full_fp32():
    """Run the block with TF32 off for matrix products and convolutions.

    On the card PyTorch may run float32 products and (by default) cuDNN
    convolutions in TF32, which keeps ~3 decimal digits; the cost matrix and
    every stencil must be full float32. The previous settings are restored.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

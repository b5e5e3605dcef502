"""What the harness takes from the program: its registry, its ``models.jit``
entry points, its serving loop and the VO CLI's halves, built from a
configuration file's settings. Nothing here computes a result itself."""

from __future__ import annotations

import numpy as np


def overrides(cfg: dict) -> dict:
    """The configuration's settings as the registry's flat overrides
    (``akaze_<field>`` for the nested AKAZE settings)."""
    out = {k: v for k, v in cfg["settings"].items() if k != "akaze"}
    out.update({f"akaze_{k}": v for k, v in cfg["settings"].get("akaze", {}).items()})
    return out


def matcher_config(cfg: dict):
    """The registry's config of the configuration's pipeline with its settings."""
    from onnx_image_processing_tpu_torch import models

    return models.get(cfg["pipeline"]).defaults.with_(**overrides(cfg))


def takes_k_inv(cfg: dict) -> bool:
    from onnx_image_processing_tpu_torch import models

    return models.get(cfg["pipeline"].removesuffix("_extraction")).takes_k_inv


def k_inv(cfg: dict) -> np.ndarray:
    """The camera's K^-1 as the VO CLI builds it (``CameraIntrinsics.k_inv``)."""
    from onnx_image_processing_tpu_torch.vo import CameraIntrinsics

    c = cfg["camera"]
    return CameraIntrinsics(c["fx"], c["fy"], c["cx"], c["cy"], cfg["width"],
                            cfg["height"]).k_inv()


class Traced:
    """A jitted entry with a ``jit_call`` span around each call; it answers
    ``device`` as the entry does (the serving loop and the CLI read it)."""

    def __init__(self, fn, spans):
        self.fn, self.spans, self.device = fn, spans, fn.device

    def __call__(self, *args):
        t = self.spans.now()
        out = self.fn(*args)
        self.spans.add("jit_call", t)
        return out

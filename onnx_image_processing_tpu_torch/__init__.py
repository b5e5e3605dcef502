"""onnx_image_processing_tpu_torch -- the PyTorch/CUDA port of
``onnx_image_processing_tpu``, for one NVIDIA Hopper card.

Two two-image matcher families run as PyTorch code: the flagship
(Shi-Tomasi + orientation + sparse BAD + Sinkhorn, with mutual-NN
extraction; also with ``fused_detect=True``) and the AKAZE matcher. Around
them are five hand-written CUDA kernels in ``csrc/`` (select frontend,
sparse sampler, Sinkhorn sweeps, detect frontend, AKAZE ladder). Each
kernel has a plain PyTorch version beside it: a CUDA tensor goes to the
kernel, a CPU tensor to the plain version. The JAX
package stays the reference the port is tested against; this package
imports no JAX.

    from onnx_image_processing_tpu_torch import models
    fn = models.build("shi_tomasi_angle_sparse_bad_sinkhorn_extraction",
                      max_keypoints=512, max_matches=256, device="cuda")
    mkpts1, mkpts2, scores, valid = fn(img1, img2)  # (1, 1, H, W) f32 on cuda
"""

__version__ = "0.1.0"

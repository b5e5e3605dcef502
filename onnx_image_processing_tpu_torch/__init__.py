"""onnx_image_processing_tpu_torch -- the PyTorch/CUDA port of
``onnx_image_processing_tpu``, for one NVIDIA Hopper card.

The flagship two-image matcher (Shi-Tomasi + orientation + sparse BAD +
Sinkhorn, with mutual-NN extraction) runs as PyTorch code around three
hand-written CUDA kernels in ``csrc/`` (select frontend, sparse sampler,
Sinkhorn sweeps). Each kernel has a plain PyTorch version beside it: a CUDA
tensor goes to the kernel, a CPU tensor to the plain version. The JAX
package stays the reference the port is tested against; this package
imports no JAX.

    from onnx_image_processing_tpu_torch import models
    fn = models.build("shi_tomasi_angle_sparse_bad_sinkhorn_extraction",
                      max_keypoints=512, max_matches=256, device="cuda")
    mkpts1, mkpts2, scores, valid = fn(img1, img2)  # (1, 1, H, W) f32 on cuda
"""

__version__ = "0.1.0"

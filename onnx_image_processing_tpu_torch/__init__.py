"""onnx_image_processing_tpu_torch -- the PyTorch/CUDA port of
``onnx_image_processing_tpu``, for one NVIDIA Hopper card.

The matchers run as PyTorch code: the flagship (Shi-Tomasi + orientation +
sparse BAD + Sinkhorn; also with ``fused_detect=True``), its with-filters
variant, the unoriented, dense-descriptor and AKAZE matchers, and the
flagship and AKAZE essential-matrix pipelines (``geometry/``), each with
mutual-NN extraction and a streaming split (``models.build_streaming``) for
sequential frames; beside them the single-image heads (score, angle, dense
BAD maps, keypoints with descriptors). ``cli/`` holds the feature
detection, image matching and VO apps. Around them are hand-written CUDA
kernels in ``csrc/`` (select frontend, sparse sampler and its stage
ablation, Sinkhorn sweeps, detect frontend, AKAZE ladder). Each kernel has
a plain PyTorch version beside it: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version. The JAX package stays the reference the port
is tested against; this package imports nothing of it, nor JAX.

    from onnx_image_processing_tpu_torch import models
    fn = models.build("shi_tomasi_angle_sparse_bad_sinkhorn_extraction",
                      max_keypoints=512, max_matches=256, device="cuda")
    mkpts1, mkpts2, scores, valid = fn(img1, img2)  # (1, 1, H, W) f32 on cuda
"""

__version__ = "0.1.0"

"""Measurement scripts for the port on a GPU, run from the repo root as
``python -m onnx_image_processing_tpu_torch.tools.<name>``."""

"""Command-line apps of the port:

    python -m onnx_image_processing_tpu_torch.cli.visual_odometry -i frames/ --device cuda
"""

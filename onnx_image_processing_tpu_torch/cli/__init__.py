"""Command-line apps of the port (``--device cuda`` by default, or ``cpu``):

    python -m onnx_image_processing_tpu_torch.cli.feature_detection -i img.png
    python -m onnx_image_processing_tpu_torch.cli.image_matching -i1 a.png -i2 b.png
    python -m onnx_image_processing_tpu_torch.cli.image_matching_extraction -i1 a.png -i2 b.png
    python -m onnx_image_processing_tpu_torch.cli.visual_odometry -i frames/
"""

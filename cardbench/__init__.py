"""The benchmark of ``onnx_image_processing_tpu_torch`` on one H100.

``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line last. Every
configuration, traffic mix, metric and limit is a file of its own under this
folder, found by the name ``BENCHMARK.json`` gives it (``README.md``).
"""

"""Round trips of the port's artifacts against the live modules, on the CPU.

Every registry name exported at a static shape (64x80, 32 keypoints, 16
matches), saved, loaded and called on new inputs: the live module's outputs,
bit for bit. Every streaming name's extract / match pair, reloaded and
composed: the two-image pipeline's outputs (integers and masks equal,
floats within ``cli.export``'s 1e-5 absolute / 2e-6 relative; on the CPU
they are equal).
"""

import pytest
import torch

from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli import export as export_cli

H, W = 64, 80


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _overrides(name):
    kw = dict(max_keypoints=32)
    if name.endswith("_extraction"):
        kw["max_matches"] = 16
    return kw


def test_every_name_is_covered():
    assert len(models.names()) == 24
    assert len(models.streaming_names()) == 7


@pytest.mark.parametrize("name", models.names())
def test_static_roundtrip_bit_exact(name, tmp_path):
    kw = _overrides(name)
    path = models.save_exported(models.export_model(name, H, W, device="cpu", **kw),
                                models.artifact_path(str(tmp_path), name, "cpu"))
    export_cli._verify_roundtrip(path, name, H, W, kw, "cpu")


@pytest.mark.parametrize("name", models.streaming_names())
def test_streaming_pair_matches_two_image(name, tmp_path):
    kw = _overrides(name)
    ex, ma = models.export_streaming(name, H, W, device="cpu", **kw)
    path_ex = models.save_exported(ex, models.artifact_path(str(tmp_path), name + ".extract",
                                                            "cpu"))
    path_ma = models.save_exported(ma, models.artifact_path(str(tmp_path), name + ".match",
                                                            "cpu"))
    export_cli._verify_streaming_roundtrip(path_ex, path_ma, name, H, W, kw, "cpu")

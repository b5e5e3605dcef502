"""Shape-polymorphic artifacts of the port on the CPU: every name in
``models.POLYMORPHIC_EXPORTS`` exported with ``torch.export.Dim`` sizes,
saved, loaded, and equal to the live module bit for bit at two shapes
(``cli.export``'s verification shapes: the batch too for the dense heads).

The port's ranges, where they differ from the JAX package's symbolic
scopes: a size that JAX lets start at 1 starts at 2 here (``torch.export``
specializes sizes 0 and 1), except the batch, which both serve from 1.
"""

import pytest
import torch
from torch.export import Dim

from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli import export as export_cli
from onnx_image_processing_tpu_torch.models.serialize import polymorphic_example


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(models.POLYMORPHIC_EXPORTS))
def test_polymorphic_artifact_serves_two_shapes(name, tmp_path):
    kw = dict(max_keypoints=32)
    path = models.save_exported(models.export_model_polymorphic(name, device="cpu", **kw),
                                models.artifact_path(str(tmp_path), name, "cpu",
                                                     polymorphic=True))
    export_cli._verify_poly_roundtrip(path, name, kw, "cpu")


@pytest.mark.parametrize("name,ranges", [
    ("sinkhorn", {"b": 1, "n": 2, "m": 2, "d": 2}),
    ("voxel_downsampling", {"n": 2}),
    ("shi_tomasi", {"b": 1, "h": 32, "w": 32}),
    ("shi_tomasi_angle_sparse_bad_sinkhorn", {"h": 64, "w": 64}),
])
def test_stated_lower_bounds(name, ranges):
    """The lower bounds each entry states (the port's, where JAX's n >= 1
    becomes n >= 2)."""
    _, dims = polymorphic_example(name, device="cpu")
    found = {d.__name__: d.min for spec in dims.values() for d in spec.values()
             if isinstance(d, Dim)}
    assert found == ranges


def test_block_grid_constraint_is_checked(tmp_path):
    """A matcher's symbolic artifact keeps the block-grid constraint: an
    image with fewer NMS blocks than keypoints is refused (the eager module
    serves it with the flat top-k)."""
    name = "shi_tomasi_angle_sparse_bad_sinkhorn"
    loaded = models.load_exported(models.save_exported(
        models.export_model_polymorphic(name, device="cpu", max_keypoints=256),
        str(tmp_path / "m.pt2")))
    small = torch.rand(1, 1, 64, 72) * 255
    with pytest.raises(Exception, match=">= 256"):
        loaded(small, small)
    k1, _, _ = models.build(name, device="cpu", max_keypoints=256)(small, small)
    assert k1.shape == (1, 256, 2)

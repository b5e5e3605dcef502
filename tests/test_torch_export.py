"""The port's export layer on the CPU, held against the JAX package's.

``models.export_model`` / ``load_exported`` of the port (``torch.export``,
``.pt2``) against the JAX package's (``jax.export``, ``.jaxexport``) on the
same numpy inputs (64x80, 32 keypoints, 16 matches), under the parity tests'
tolerances: keypoint sets within 2 swaps and P within 5e-3 on the common
keypoints (``test_torch_flagship.py``), integer and mask outputs equal,
score maps within 1e-5 of the map's largest value (``test_torch_heads.py``), Sinkhorn within 1e-6 +
1e-5 relative (``test_torch_sinkhorn.py``), voxel centroids within 2e-4 (the JAX export's
8,192 points: the residual prefix sum's rounding grows with N, as
``test_torch_aux_ops.py`` states), E within 1e-3 unit norm up to sign
(``test_torch_essential.py``). Then the CLI (``cli/export.py``) through
``main()``, the coverage of ``POLYMORPHIC_EXPORTS``, ``compile_model`` and
the artifact's dependence on the port's ops.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_image_processing_tpu import models as jax_models
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli import export as export_cli
from test_torch_essential import k_inv_of, parallax_pair
from test_torch_geometry import _unit_diff

H, W = 64, 80
KW = dict(max_keypoints=32, max_matches=16)
P_ATOL = 5e-3
SCORE_RTOL = 1e-5   # of the score map's largest value
SINKHORN_BAND = dict(rtol=1e-5, atol=1e-6)
VOXEL_ATOL = 2e-4
E_ATOL = 1e-3
MAX_SWAPS = 2
FLAGSHIP = "shi_tomasi_angle_sparse_bad_sinkhorn"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _overrides(name):
    spec = models.get(name)
    if name == "sinkhorn":
        return dict(max_keypoints=32, num_pairs=64)
    kw = dict(KW) if spec.n_images == 2 or spec.selects_keypoints else {}
    if not name.endswith("_extraction"):
        kw.pop("max_matches", None)
    return kw


def _inputs(name):
    """The same numpy inputs for both packages."""
    if name == "sinkhorn":
        rng = np.random.default_rng(2)
        return [rng.normal(0, 0.5, (1, 32, 64)).astype(np.float32) for _ in range(2)]
    if name == "voxel_downsampling":
        pts = np.random.default_rng(4).uniform(0, 2, (models.VOXEL_EXPORT_POINTS, 3))
        return [pts.astype(np.float32), np.float32(0.05)]
    img1, img2 = parallax_pair(H, W)
    spec = models.get(name)
    args = [img1, img2][:max(spec.n_images, 1)]
    return args + ([k_inv_of(H, W)] if spec.takes_k_inv else [])


def _common(a, b):
    """Indices of the keypoints (rows of (K, 2)) both sets hold, plus the
    dustbin, and the symmetric set difference."""
    ia = {tuple(v): i for i, v in enumerate(a.tolist())}
    ib = {tuple(v): i for i, v in enumerate(b.tolist())}
    shared = sorted(set(ia) & set(ib))
    return ([ia[v] for v in shared] + [len(a)], [ib[v] for v in shared] + [len(b)],
            len(set(ia) ^ set(ib)))


def _compare_matcher(ours, ref):
    (k1, k2, p), (jk1, jk2, jp) = ours[:3], ref[:3]
    ia1, ib1, s1 = _common(k1[0], jk1[0])
    ia2, ib2, s2 = _common(k2[0], jk2[0])
    assert max(s1, s2) <= MAX_SWAPS, (s1, s2)
    np.testing.assert_allclose(p[0][np.ix_(ia1, ia2)], jp[0][np.ix_(ib1, ib2)],
                               atol=P_ATOL, rtol=0)


PARITY = [
    "shi_tomasi",
    FLAGSHIP,
    FLAGSHIP + "_extraction",
    "akaze_sparse_bad_sinkhorn",
    "sinkhorn",
    "voxel_downsampling",
    FLAGSHIP + "_essential_matrix",
]


@pytest.mark.parametrize("name", PARITY)
def test_cpu_artifact_matches_jax_artifact(name, tmp_path):
    kw = _overrides(name)
    arrays = _inputs(name)
    j_path = jax_models.save_exported(
        jax_models.export_model(name, H, W, platform="cpu", **kw),
        jax_models.artifact_path(str(tmp_path), name, "cpu"))
    ref = jax_models.load_exported(j_path)(*map(jnp.asarray, arrays))
    ref = [np.asarray(o) for o in (ref if isinstance(ref, (tuple, list)) else (ref,))]
    path = models.save_exported(models.export_model(name, H, W, device="cpu", **kw),
                                models.artifact_path(str(tmp_path), name, "cpu"))
    assert path.endswith(f"{name}.cpu.pt2")
    out = models.load_exported(path)(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    ours = [o.numpy() for o in (out if isinstance(out, (tuple, list)) else (out,))]
    assert [o.shape for o in ours] == [r.shape for r in ref]
    if name == "shi_tomasi":
        assert np.abs(ours[0] - ref[0]).max() <= SCORE_RTOL * np.abs(ref[0]).max()
    elif name == "sinkhorn":
        np.testing.assert_allclose(ours[0], ref[0], **SINKHORN_BAND)
    elif name == "voxel_downsampling":
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_allclose(ours[0], ref[0], atol=VOXEL_ATOL, rtol=0)
    elif name.endswith("_extraction"):
        for got, want in zip(ours[:2] + ours[3:], ref[:2] + ref[3:]):   # coordinates, valid
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(ours[2], ref[2], atol=P_ATOL, rtol=0)
        assert ours[3].sum() >= KW["max_matches"] // 2
    else:
        _compare_matcher(ours, ref)
        if name.endswith("_essential_matrix"):
            np.testing.assert_array_equal(ours[0], ref[0])
            np.testing.assert_array_equal(ours[1], ref[1])
            assert _unit_diff(ours[3], ref[3]) < E_ATOL


@pytest.mark.parametrize("flags,names,suffixes", [
    ([], ["shi_tomasi", FLAGSHIP + "_extraction"], [".cpu.pt2"]),
    (["--dynamic"], ["sinkhorn", "shi_tomasi_angle_sparse_bad"], [".poly.cpu.pt2"]),
    (["--streaming"], [FLAGSHIP + "_extraction"], [".extract.cpu.pt2", ".match.cpu.pt2"]),
])
def test_cli_exports_and_verifies(flags, names, suffixes, tmp_path, capsys):
    """``cli/export.py`` through ``main()``: each artifact written and its
    round trip verified (static bit for bit, dynamic at two shapes, the
    streaming pair against the two-image pipeline)."""
    argv = ["--device", "cpu", "-o", str(tmp_path), "--height", str(H), "--width", str(W),
            "--max-keypoints", "32", "--models", *names, *flags]
    assert export_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == len(names) and "verified" in out
    for name in names:
        for suffix in suffixes:
            assert (tmp_path / f"{name}{suffix}").stat().st_size > 0


def test_cli_trace_check_and_failures(capsys):
    """Without -o: a trace check that reports nodes and kernel op nodes;
    a failing pipeline is listed and the exit code is 1."""
    argv = ["--device", "cpu", "--height", str(H), "--width", str(W), "--max-keypoints", "32",
            "--models", FLAGSHIP, "no_such_pipeline"]
    assert export_cli.main(argv) == 1
    out = capsys.readouterr().out
    assert f"[OK]   {FLAGSHIP}: traced" in out and "3 kernel op nodes" in out
    assert "[FAIL] no_such_pipeline" in out and "1 pipeline(s) failed" in out
    assert export_cli.main(["--device", "cpu", "--dynamic"]) == 2
    assert export_cli.main(["--device", "cpu", "--dynamic", "--streaming", "-o", "x"]) == 2


def test_polymorphic_exports_cover_jax():
    """Every JAX shape-polymorphic export has a port counterpart, less the
    names ROADMAP.md lists as not yet symbolic (none at present)."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    pending = {n for n in jax_models.POLYMORPHIC_EXPORTS
               if f"`{n}` is not yet symbolic" in roadmap}
    assert set(jax_models.POLYMORPHIC_EXPORTS) - pending <= set(models.POLYMORPHIC_EXPORTS)
    assert set(models.POLYMORPHIC_EXPORTS) <= set(models.names())
    with pytest.raises(ValueError, match="no shape-polymorphic export"):
        models.export_model_polymorphic("no_such_pipeline", device="cpu")


def test_compile_model_and_artifact_names(tmp_path):
    fn = models.compile_model("shi_tomasi", H, W, device="cpu")
    img = torch.from_numpy(parallax_pair(H, W)[0])
    assert torch.equal(fn(img), models.build("shi_tomasi", device="cpu")(img))
    assert models.artifact_path("d", "x", "cuda", polymorphic=True) == "d/x.poly.cuda.pt2"
    assert models.artifact_path("d", "x", torch.device("cpu")) == "d/x.cpu.pt2"
    paths = models.export_to_dir(str(tmp_path), ["shi_tomasi", "sinkhorn"], H, W,
                                 device="cpu", max_keypoints=16, num_pairs=32)
    assert [Path(p).name for p in paths] == ["shi_tomasi.cpu.pt2", "sinkhorn.cpu.pt2"]


def test_artifact_needs_the_port_to_load(tmp_path):
    """A .pt2 whose graph holds the port's ops loads in a process that
    imports the port (``load_exported`` imports the kernel modules), and
    not in one that only has torch."""
    path = models.save_exported(models.export_model("sinkhorn", H, W, device="cpu",
                                                    max_keypoints=8, num_pairs=16),
                                str(tmp_path / "sinkhorn.cpu.pt2"))
    code = ("import sys, torch; ep = torch.export.load(sys.argv[1]); "
            "ep.module()(torch.zeros(1, 8, 16), torch.zeros(1, 8, 16))")
    bare = subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert bare.returncode != 0
    code = ("import sys, torch; from onnx_image_processing_tpu_torch import models; "
            "p = models.load_exported(sys.argv[1])(torch.zeros(1, 8, 16), torch.zeros(1, 8, 16)); "
            "assert p.shape == (1, 9, 9)")
    subprocess.run([sys.executable, "-c", code, path], check=True, timeout=300, cwd=ROOT)

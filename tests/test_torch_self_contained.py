"""The port stands alone: no module of it (nor ``chip_smoke.py``) imports
JAX or the JAX package, its own copies of the JAX package's host code and
data agree with the originals, and importing it needs neither OpenCV nor
PIL (the card's machine has neither).
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import onnx_image_processing_tpu.core.config as jconfig
import onnx_image_processing_tpu.utils as jutils
import onnx_image_processing_tpu_torch.core.config as tconfig
import onnx_image_processing_tpu_torch.utils as tutils

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "onnx_image_processing_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "onnx_image_processing_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    """Every absolute module name an ``import`` or ``from`` names in the file,
    at any depth of the syntax tree (function bodies included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        for line, name in _imported_modules(path):
            top = name.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{line} imports {name}")
    assert len(_sources()) > 30
    assert not bad, "\n".join(bad)


def test_the_scan_sees_a_forbidden_import(tmp_path):
    """The scan reads nested and dotted imports, and keeps ``_torch``."""
    f = tmp_path / "m.py"
    f.write_text("import onnx_image_processing_tpu_torch.ops\n"
                 "def f():\n    from onnx_image_processing_tpu.vo import pose\n"
                 "    import jax.numpy as jnp\n")
    tops = [name.split(".")[0] for _, name in _imported_modules(f)]
    assert tops == ["onnx_image_processing_tpu_torch", "onnx_image_processing_tpu", "jax"]
    assert [t for t in tops if t in FORBIDDEN] == ["onnx_image_processing_tpu", "jax"]


@pytest.mark.parametrize("cls", ["MatcherConfig", "AKAZEConfig", "FASTConfig", "DoGConfig",
                                 "CameraConfig"])
def test_config_copy_has_the_same_fields_and_defaults(cls):
    ours, theirs = getattr(tconfig, cls), getattr(jconfig, cls)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_config_copy_folds_flat_overrides_as_the_original():
    kw = dict(max_keypoints=64, akaze_threshold=0.01, fast_threshold=30.0, dog_num_scales=4)
    ours = tconfig.MatcherConfig().with_(**kw)
    theirs = jconfig.MatcherConfig().with_(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(tconfig.MatcherConfig.from_kwargs(**kw, unknown=1, nms_radius=None)) \
        == dataclasses.asdict(jconfig.MatcherConfig.from_kwargs(**kw, unknown=1, nms_radius=None))
    with pytest.raises(ValueError):
        tconfig.MatcherConfig(topk_mode="fast")


@pytest.mark.parametrize("pairs", [256, 512])
def test_bad_tables_are_byte_copies(pairs):
    name = f"data/bad_params_{pairs}.npz"
    ours = (PORT / name).read_bytes()
    assert ours == (ROOT / "onnx_image_processing_tpu" / name).read_bytes()
    assert len(ours) > 1000


def test_host_postprocess_copy_agrees():
    rng = np.random.default_rng(3)
    scores = rng.random((1, 1, 60, 80)).astype(np.float32)
    kw = dict(threshold=0.2, max_keypoints=50, nms_radius=2, subpixel=True)
    np.testing.assert_array_equal(tutils.select_keypoints(scores, **kw),
                                  jutils.select_keypoints(scores, **kw))
    p = rng.random((1, 21, 21)).astype(np.float32)
    k1 = rng.integers(0, 60, (1, 20, 2)).astype(np.float32)
    k2 = rng.integers(0, 60, (1, 20, 2)).astype(np.float32)
    for a, b in zip(tutils.extract_matches(p, k1, k2, threshold=0.05, max_matches=8),
                    jutils.extract_matches(p, k1, k2, threshold=0.05, max_matches=8)):
        np.testing.assert_array_equal(a, b)


def test_import_needs_neither_cv2_nor_pil_nor_jax():
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                   for p in PORT.rglob("*.py")})
    code = ("import sys; sys.modules['cv2'] = None; sys.modules['PIL'] = None; "
            f"import importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)

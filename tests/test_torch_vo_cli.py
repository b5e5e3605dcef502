"""The port's VO CLI (``onnx_image_processing_tpu_torch.cli.visual_odometry``)
with ``--device cpu`` on the synthetic pans of ``tests/test_cli.py``
(image directories, 120x160; the host pose step uses OpenCV).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli import visual_odometry as vo
from onnx_image_processing_tpu_torch.vo import Trajectory

ESSENTIAL = "shi_tomasi_angle_sparse_bad_sinkhorn_essential_matrix"
COMMON = ["--height", "120", "--width", "160", "--fx", "120", "--skip-frames", "0",
          "--min-matches", "8", "--max-matches", "64", "--quiet", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pan(tmp_path, n, step, seed, extra_wave=False):
    """``n`` frames of a horizontal pan over a textured board, as PNGs."""
    rng = np.random.default_rng(seed)
    h, w = (240, 600) if extra_wave else (200, 400)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    big = 127 + 90 * np.sin(xx / 12) * np.cos(yy / 10)
    if extra_wave:
        big = big + 30 * np.sin(xx / 37 + yy / 23)
    big = np.clip(big + rng.normal(0, 4, (h, w)), 0, 255).astype(np.uint8)
    y0 = 60 if extra_wave else 40
    frames = os.path.join(tmp_path, "frames")
    os.makedirs(frames)
    for i in range(n):
        Image.fromarray(big[y0:y0 + 120, i * step:i * step + 160]).save(
            os.path.join(frames, f"f{i:03d}.png"))
    return frames


def test_default_streaming_model_recovers_pan_direction(tmp_path, monkeypatch):
    """The default model (flagship, streaming) on a pure horizontal pan:
    at least 3 poses, x the dominant axis of most steps, one sign among
    them; one host copy per processed frame."""
    frames = _pan(tmp_path, 8, 14, seed=6, extra_wave=True)
    copies = []
    to_host = vo.to_host
    monkeypatch.setattr(vo, "to_host", lambda outs: copies.append(1) or to_host(outs))
    traj_path = os.path.join(tmp_path, "traj.npz")
    assert vo.main(["-i", frames, "--min-inlier-ratio", "0.3", "-o", traj_path] + COMMON) == 0
    assert len(copies) == 7
    t = Trajectory.load_from_file(traj_path)
    assert len(t) >= 3
    steps = np.diff(t.get_positions_array(), axis=0)
    x_dom = ((np.abs(steps[:, 0]) > np.abs(steps[:, 1]))
             & (np.abs(steps[:, 0]) > np.abs(steps[:, 2])))
    assert x_dom.mean() >= 0.5
    signs = np.sign(steps[x_dom, 0])
    assert np.all(signs == signs[0])


def test_essential_model_writes_trajectory_and_plot(tmp_path):
    frames = _pan(tmp_path, 4, 12, seed=4)
    traj = os.path.join(tmp_path, "traj.npz")
    plot = os.path.join(tmp_path, "traj.png")
    assert vo.main(["-i", frames, "--model", ESSENTIAL, "-o", traj, "--plot", plot]
                   + COMMON) == 0
    assert os.path.exists(traj) and os.path.getsize(plot) > 0


@pytest.mark.parametrize("name,extra", [("shi_tomasi_angle_sparse_bad_sinkhorn", {}),
                                        (ESSENTIAL, dict(essential_ransac_hypotheses=16,
                                                         essential_irls_iters=1))])
def test_no_streaming_gives_the_same_matches(tmp_path, name, extra):
    """On the first frame pair the two-image matcher (``--no-streaming``)
    and the streaming split give the same matches, bit for bit."""
    from onnx_image_processing_tpu_torch.cli.common import load_image_from_array
    import cv2

    frames = _pan(tmp_path, 2, 10, seed=2)
    imgs = [torch.from_numpy(load_image_from_array(cv2.imread(os.path.join(frames, f)), 120, 160))
            for f in sorted(os.listdir(frames))]
    cfg = models.get(name).defaults.with_(max_matches=64, **extra)
    extract, match = vo.build_vo_matcher(name, cfg, True, "cpu")
    none, two = vo.build_vo_matcher(name + "_extraction", cfg, False, "cpu")
    assert extract is not None and none is None
    k = (torch.from_numpy(np.linalg.inv(np.array([[120.0, 0, 80], [0, 120.0, 60], [0, 0, 1]]))
                          .astype(np.float32)),) if models.get(name).takes_k_inv else ()
    streamed = vo.to_host(match(extract(imgs[0]), extract(imgs[1]), *k))
    direct = vo.to_host(two(imgs[0], imgs[1], *k))
    assert streamed[3].sum() >= 8
    for a, b in zip(streamed, direct):
        np.testing.assert_array_equal(a, b)


def test_no_streaming_flag_gives_the_same_trajectory(tmp_path):
    frames = _pan(tmp_path, 5, 10, seed=2)
    paths = [os.path.join(tmp_path, f"t{i}.npz") for i in range(2)]
    assert vo.main(["-i", frames, "-o", paths[0]] + COMMON) == 0
    assert vo.main(["-i", frames, "-o", paths[1], "--no-streaming"] + COMMON) == 0
    a, b = (Trajectory.load_from_file(p).get_positions_array() for p in paths)
    assert len(a) >= 2
    np.testing.assert_array_equal(a, b)


def test_to_host_restores_shapes_and_types():
    outs = (torch.arange(6, dtype=torch.float32).reshape(1, 3, 2),
            torch.tensor([[True, False, True]]), torch.eye(3) * 0.5)
    host = vo.to_host(outs)
    for got, t in zip(host, outs):
        assert got.shape == tuple(t.shape)
        np.testing.assert_array_equal(got, t.numpy())
    assert host[1].dtype == bool


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        vo.select_device("cuda")
    frames = _pan(tmp_path, 2, 10, seed=2)
    with pytest.raises(RuntimeError, match="is_available"):
        vo.main(["-i", frames, "--device", "cuda", "--quiet"])
    assert vo.select_device("cpu") == torch.device("cpu")


def test_import_needs_neither_cv2_nor_pil():
    code = ("import sys; sys.modules['cv2'] = None; sys.modules['PIL'] = None; "
            "import onnx_image_processing_tpu_torch.cli.visual_odometry as vo; "
            "assert vo.parse_args(['-i', 'x']).device == 'cuda'; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])

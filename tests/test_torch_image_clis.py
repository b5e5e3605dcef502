"""The port's three image CLIs with ``--device cpu`` against the JAX CLIs
(``--platform cpu``) on the same PNGs: the printed keypoint and match counts
are equal, and each port CLI writes its picture. Scene: a non-periodic
texture (blurred noise, 192x256) and its 7-px roll in x.
"""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from onnx_image_processing_tpu.cli import feature_detection as j_fd
from onnx_image_processing_tpu.cli import image_matching as j_im
from onnx_image_processing_tpu.cli import image_matching_extraction as j_ime
from onnx_image_processing_tpu_torch.cli import feature_detection as fd
from onnx_image_processing_tpu_torch.cli import image_matching as im
from onnx_image_processing_tpu_torch.cli import image_matching_extraction as ime

H, W = 192, 256
SIZE = ["--height", str(H), "--width", str(W)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_cache_in_tmp(tmp_path_factory, monkeypatch):
    """The JAX CLIs point JAX's compile cache at $JAX_COMPILATION_CACHE_DIR."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))


def _blur(a, r):
    k = 2 * r + 1
    for ax in (0, 1):
        pad = [(r + 1, r) if i == ax else (0, 0) for i in range(2)]
        c = np.cumsum(np.pad(a, pad, mode="edge"), axis=ax)
        n = c.shape[ax]
        a = (np.take(c, range(k, n), axis=ax) - np.take(c, range(0, n - k), axis=ax)) / k
    return a


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    rng = np.random.default_rng(11)
    tex = _blur(_blur(rng.uniform(0, 1, (H, W)), 2), 2)
    tex = (255 * (tex - tex.min()) / (tex.max() - tex.min())).astype(np.uint8)
    d = tmp_path_factory.mktemp("clis")
    paths = (os.path.join(d, "a.png"), os.path.join(d, "b.png"))
    Image.fromarray(tex).save(paths[0])
    Image.fromarray(np.roll(tex, 7, axis=1)).save(paths[1])
    return paths


def _counts(text):
    return [int(n) for n in re.findall(r"(?:Detected|Keypoints:|/|Matches:) (\d+)", text)]


def _run_both(capsys, port_main, jax_main, args, out_path):
    assert jax_main(args + ["--platform", "cpu", "-o", out_path + ".jax.png"]) == 0
    want = capsys.readouterr().out
    assert port_main(args + ["--device", "cpu", "-o", out_path]) == 0
    got = capsys.readouterr().out
    assert os.path.getsize(out_path) > 0
    return _counts(got), _counts(want)


@pytest.mark.parametrize("model", ["shi_tomasi", "shi_tomasi_angle"])
def test_feature_detection_counts_match_jax(model, pngs, tmp_path, capsys):
    got, want = _run_both(capsys, fd.main, j_fd.main,
                          ["-i", pngs[0], "-m", model, "-k", "300"] + SIZE,
                          str(tmp_path / "k.png"))
    assert got == want and len(got) == 1 and got[0] > 50


def test_image_matching_counts_match_jax(pngs, tmp_path, capsys):
    got, want = _run_both(capsys, im.main, j_im.main,
                          ["-i1", pngs[0], "-i2", pngs[1], "-k", "128", "--no-benchmark"]
                          + SIZE, str(tmp_path / "m.png"))
    assert got == want and len(got) == 3 and got[2] > 20


def test_image_matching_extraction_counts_match_jax(pngs, tmp_path, capsys):
    got, want = _run_both(capsys, ime.main, j_ime.main,
                          ["-i1", pngs[0], "-i2", pngs[1], "--max-matches", "64",
                           "--no-benchmark"] + SIZE, str(tmp_path / "me.png"))
    assert got == want and len(got) == 1 and got[0] > 20


def test_device_functions_recover_the_shift(pngs):
    """What the card's smoke drives: the device halves, arrays in and out."""
    from onnx_image_processing_tpu_torch import models
    from onnx_image_processing_tpu_torch.cli.common import load_image

    a1, a2 = (load_image(p, H, W)[0] for p in pngs)
    mk1, mk2, scores = ime.match(models.build(
        "shi_tomasi_bad_sinkhorn_extraction", max_matches=64, device="cpu"), a1, a2)
    assert len(mk1) > 20 and scores.shape == (len(mk1),)
    assert np.median(mk2[:, 1] - mk1[:, 1]) == 7 and np.median(mk2[:, 0] - mk1[:, 0]) == 0
    k1, k2, p = im.match(models.build("shi_tomasi_angle_sparse_bad_sinkhorn",
                                      max_keypoints=64, device="cpu"), a1, a2)
    assert k1.shape == (1, 64, 2) and p.shape == (1, 65, 65)
    scores = fd.detect(models.build("shi_tomasi", device="cpu"), a1)
    assert scores.shape == (1, 1, H, W)


def test_benchmark_flag_prints_a_time(pngs, tmp_path, capsys):
    assert fd.main(["-i", pngs[0], "--benchmark", "--device", "cpu", "-o",
                    str(tmp_path / "k.png")] + SIZE) == 0
    assert re.search(r"Elapsed: [0-9.]+ ms/frame .* on cpu", capsys.readouterr().out)


@pytest.mark.parametrize("model,flags", [("fast", ["--fast-threshold", "30", "--fast-use-nms"]),
                                         ("dog_with_score", ["--dog-num-scales", "4"])])
def test_fast_and_dog_feature_detection_counts_match_jax(model, flags, pngs, tmp_path, capsys):
    got, want = _run_both(capsys, fd.main, j_fd.main,
                          ["-i", pngs[0], "-m", model, "-k", "300", "-t", "0.5"] + flags + SIZE,
                          str(tmp_path / "k.png"))
    assert got == want and len(got) == 1 and got[0] > 20


def test_fast_and_dog_flags_run_and_missing_card_fails_plainly(pngs, tmp_path, monkeypatch,
                                                              capsys):
    for args in (["-m", "fast", "--fast-threshold", "30"], ["-m", "dog_with_score"]):
        out = str(tmp_path / f"{args[1]}.png")
        assert fd.main(["-i", pngs[0], "--device", "cpu", "-o", out] + args + SIZE) == 0
        assert os.path.getsize(out) > 0
        assert re.search(rf"Detected \d+ keypoints \(model={args[1]},", capsys.readouterr().out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        im.main(["-i1", pngs[0], "-i2", pngs[1]])

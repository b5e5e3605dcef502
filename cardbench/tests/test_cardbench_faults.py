"""The comparison that decides ``correct`` comes out false when the timed
path is broken underneath a run, once for each fault a cell can have, and
the control (the reference in TF32) comes out not correct too."""

import time

import numpy as np
import pytest
import torch

from cardbench import control
from cardbench.run import run_cell


def _run(cell, wrap=None):
    return run_cell(cell, 2 ** 33 + 5, 1.0, False, "cpu", time.time(), wrap=wrap)


class _Entry:
    """A callable in the place of a jitted entry: ``fn`` wrapped by ``edit``."""

    def __init__(self, fn, edit):
        self.fn, self.edit, self.device = fn, edit, fn.device

    def __call__(self, *args):
        return self.edit(self.fn, *args)


def _shift_one_match(out):
    """One answer altered where it is produced: the first matched keypoint
    of the second image moved by one pixel."""
    mk1, mk2, *rest = out
    mk2 = mk2.clone()
    mk2[0, 0, 1] += 1.0
    return (mk1, mk2, *rest)


def test_a_sound_run_is_correct(cells):
    for name in cells:
        assert _run(cells[name])["correct"], name


@pytest.mark.parametrize("name", ["flagship.serve", "flagship.single", "akaze_essential.pairs"])
def test_an_altered_answer_is_caught(cells, name):
    def wrap(traffic):
        traffic.fn = _Entry(traffic.fn, lambda fn, *a: _shift_one_match(fn(*a)))

    assert not _run(cells[name], wrap)["correct"]


def test_half_of_the_batch_left_out_is_caught(cells):
    def half(fn, img1, img2):
        h = img1.shape[0] // 2
        out = fn(img1[:h], img2[:h])
        return tuple(torch.cat([t, t]) for t in out)

    def wrap(traffic):
        traffic.fn = _Entry(traffic.fn, half)

    assert not _run(cells["flagship.serve"], wrap)["correct"]


def test_an_altered_frame_is_caught(cells):
    def wrap(traffic):
        traffic.match = _Entry(traffic.match, lambda fn, *a: _shift_one_match(fn(*a)))

    assert not _run(cells["akaze_vo.stream"], wrap)["correct"]


def test_a_step_that_keeps_its_state_is_caught(cells):
    """The feature cache's state left unchanged: every frame's extract
    returns the first frame's features."""
    def wrap(traffic):
        kept = {}

        def stale(fn, image):
            if "feats" not in kept:
                kept["feats"] = fn(image)
            return kept["feats"]

        traffic.extract = _Entry(traffic.extract, stale)

    assert not _run(cells["akaze_vo.stream"], wrap)["correct"]


def test_a_wrong_pose_is_caught(cells):
    """The pose step's answer altered where it is produced: a fixed pose with
    every match an inlier, whatever the frame."""
    def wrap(traffic):
        def fixed(e, mk1, mk2, intrinsics):
            return np.eye(3), np.array([[0.0], [0.0], [1.0]]), np.ones(len(mk1), dtype=bool)

        traffic.recover_pose = fixed

    assert not _run(cells["akaze_vo.stream"], wrap)["correct"]


@pytest.mark.parametrize("name", ["flagship.serve", "akaze_vo.stream", "flagship.single",
                                  "akaze_essential.pairs"])
def test_the_control_is_not_correct(cells, name):
    out = control.control(cells[name], 2 ** 35 + 3, 1.0, "cpu")
    assert out["program_correct"], out
    assert not out["control_correct"], out
    assert np.isfinite(out["control"]["p_gap"])

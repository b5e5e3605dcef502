"""The port's own trace (``core/trace.py``): when it records, how spans
nest, the spans and counts at each layer boundary (``core/jit.py``, the
CLIs' device functions, serving, the pose step), and the benchmark's
readers of them (``cardbench/program_spans.py``, ``cardbench/metrics/``).

The CUDA case is marked ``cuda`` and skips without a card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch import nn

from cardbench import bench, program_spans
from cardbench.run import Log, Run, run_cell
from cardbench.tests.conftest import small
from onnx_image_processing_tpu_torch import models
from onnx_image_processing_tpu_torch.cli.image_matching_extraction import match
from onnx_image_processing_tpu_torch.cli.visual_odometry import to_host
from onnx_image_processing_tpu_torch.core import trace
from onnx_image_processing_tpu_torch.parallel import stream_map_chunked
from onnx_image_processing_tpu_torch.vo import CameraIntrinsics, recover_pose


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The CPU runs below answer requests inside a fixed window; torch's
    # threads fight the other test workers' for the cores.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh():
    trace.clear()
    yield
    trace.clear()


def _names(recs=None):
    return [r.name for r in (trace.records() if recs is None else recs)]


def _nest():
    with trace.span("a", k=1):
        with trace.span("b"):
            trace.count("c", 3)
        trace.count("d")
    with trace.span("e"):
        pass


def _check_nested(recs):
    a, b, c, d, e = recs
    assert _names(recs) == ["a", "b", "c", "d", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, 0, 1, 0, None)
    assert a.call == b.call == c.call == d.call != e.call
    assert a.attrs == {"k": 1} and b.attrs is None
    assert (c.n, d.n) == (3, 1) and c.start == c.end
    assert a.start <= b.start <= c.start <= b.end <= d.start <= a.end <= e.start <= e.end


def test_nothing_is_recorded_while_recording_is_off():
    assert not torch._C._autograd._profiler_enabled()
    _nest()
    assert trace.records() == []


def test_spans_nest_under_recording():
    with trace.recording():
        _nest()
    _check_nested(trace.records())
    _nest()
    assert len(trace.records()) == 5


def test_start_and_stop():
    trace.start()
    try:
        _nest()
    finally:
        trace.stop()
    _nest()
    _check_nested(trace.records())


def test_spans_nest_under_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _nest()
    _nest()
    _check_nested(trace.records())


def test_a_kept_span_is_recorded_while_off():
    with trace.kept("jit.capture", pipeline="p"):
        with trace.span("inner"):
            pass
    (r,) = trace.records()
    assert (r.name, r.parent, r.attrs) == ("jit.capture", None, {"pipeline": "p"})
    assert r.end >= r.start


def test_past_the_limit_records_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 3)
    with trace.recording():
        with trace.span("a"):
            for _ in range(4):
                trace.count("x")
    assert _names() == ["a", "x", "x"]
    assert trace.dropped() == 2


def test_a_clear_inside_a_span_leaves_later_records_without_a_parent():
    with trace.recording():
        with trace.span("a"):
            trace.clear()
            trace.count("x")
    (x,) = trace.records()
    assert x.parent is None


class _Pairwise(nn.Module):
    """A stand-in for an extraction pipeline: (mk1, mk2, scores, valid)."""

    pipeline_name = "pairwise"
    device = "cpu"

    def forward(self, a, b):
        k = 5
        mk = torch.stack([a.flatten()[:k], b.flatten()[:k]], -1)[None]
        scores = (a.flatten()[:k] + b.flatten()[:k])[None]
        return mk, mk + 1, scores, scores > scores.mean()


def _images(h=8, w=8):
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 255, (1, 1, h, w)).astype(np.float32) for _ in range(2)]


def test_a_jitted_call_on_the_cpu_is_one_span():
    fn = models.jit(_Pairwise())
    a, b = (torch.from_numpy(x) for x in _images())
    with trace.recording():
        fn(a, b)
    (r,) = trace.records()
    assert (r.name, r.attrs) == ("jit.call", {"pipeline": "pairwise"})


def test_match_records_its_copies_and_four_syncs():
    fn = models.jit(_Pairwise())
    with trace.recording():
        mk1, mk2, scores = match(fn, *_images())
    recs = trace.records()
    assert _names(recs) == ["io.upload", "jit.call", "io.fetch"] + ["io.sync"] * 4
    fetch = _names(recs).index("io.fetch")
    assert all(r.parent == fetch for r in recs if r.name == "io.sync")
    assert len({r.call for r in recs}) == 3
    assert len(mk1) == len(mk2) == len(scores)


def test_to_host_records_one_sync():
    out = [torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool), torch.eye(3)]
    with trace.recording():
        host = to_host(out)
    assert _names() == ["io.fetch", "io.sync"]
    assert trace.records()[1].parent == 0
    assert host[1].dtype == bool


class _Batched:
    device = "cpu"

    def __call__(self, a, b):
        return a.sum((1, 2, 3)), b * 2


def test_stream_map_chunked_spans_once_per_chunk():
    pairs = [tuple(_images()) for _ in range(5)]
    with trace.recording():
        out = list(stream_map_chunked(_Batched(), pairs, chunk=2, depth=2))
    assert len(out) == 5
    names = _names()
    for name in ("serve.upload", "serve.fetch", "serve.wait"):
        assert names.count(name) == 3, names
    assert names[:2] == ["serve.upload", "serve.fetch"]


def _two_view(n, seed=0):
    """Points 3-10 m in front of a camera that moves 0.4 m sideways, seen as
    (y, x) pixels in both views, and E = [t]x R."""
    rng = np.random.default_rng(seed)
    cam = CameraIntrinsics(200.0, 200.0, 80.0, 60.0, 160, 120)
    pts = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 10, n)]
    t = np.array([0.4, 0.0, 0.05])

    def project(x):
        uv = x @ cam.K.T
        return (uv[:, :2] / uv[:, 2:])[:, ::-1].astype(np.float32)

    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    return tx / np.linalg.norm(tx), project(pts), project(pts + t), cam


def test_recover_pose_records_the_chirality_only_when_it_reaches_the_candidates():
    e, kp1, kp2, cam = _two_view(40)
    with trace.recording():
        recover_pose(e, kp1[:4], kp2[:4], cam)
    assert trace.records() == []
    with trace.recording():
        r, t, inliers = recover_pose(e, kp1, kp2, cam)
    assert _names() == ["pose.chirality"]
    assert r is not None and inliers.sum() >= 5


@pytest.mark.cuda
def test_a_capture_is_kept_while_off_and_a_replay_has_three_children():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    class Twice(nn.Module):
        def forward(self, x):
            return x * 2, x + 1

    fn = models.jit(Twice())
    x = torch.arange(6.0, device="cuda")
    fn(x)
    (cap,) = trace.records()
    assert cap.name == "jit.capture" and cap.attrs["pipeline"] == "Twice"
    assert cap.attrs["signature"] == ("tuple", (((6,), torch.float32, x.device),))
    trace.clear()
    with trace.recording():
        out = fn(x)
    assert _names() == ["jit.call", "jit.copy_in", "jit.replay", "jit.clone"]
    assert [r.parent for r in trace.records()] == [None, 0, 0, 0]
    assert torch.equal(out[0], x * 2)


# The benchmark's readers on a synthetic traced run: two pairs (or frames)
# answered inside a 10 ms window, the program's records planted, two device
# operations per request. Times in ms.
MS = 1_000_000
PER_REQUEST = [
    ("io.upload", 1.0, 1.3), ("jit.call", 1.3, 2.3), ("jit.copy_in", 1.3, 1.5),
    ("jit.replay", 1.5, 2.0), ("jit.clone", 2.0, 2.3), ("io.fetch", 2.3, 3.9),
    ("io.sync", 2.4, 2.4), ("io.sync", 2.6, 2.6), ("serve.upload", 3.0, 3.1),
    ("serve.fetch", 3.1, 3.15), ("serve.wait", 3.2, 3.5), ("pose.chirality", 3.5, 3.8)]
PLANTED = [(n, s + shift, e + shift) for shift in (0, 4) for n, s, e in PER_REQUEST]
PLANTED.append(("jit.replay", 12.0, 12.5))   # after the window
EVENTS = [("copy", 1.0, 1.4), ("kernel", 1.8, 3.5), ("copy", 5.0, 5.4), ("kernel", 5.8, 7.5)]
HARNESS = [("jit_call", 1.3, 2.3), ("jit_call", 5.3, 6.3)]

READINGS = {   # metric, unit: value by hand
    ("jit_replay_ms.pairs", "pairs"): 0.5,              # 2 x 0.5 ms over 2 pairs
    ("jit_copy_ms.pairs", "pairs"): 0.5,                # 2 x (0.2 + 0.3)
    ("host_io_ms.pairs", "pairs"): 1.9,                 # 2 x (0.3 + 1.6)
    ("host_syncs.pairs", "pairs"): 2.0,                 # 4 counts
    ("idle_in_jit_ms.pairs", "pairs"): 0.4,             # gaps 1.4-1.8, 5.4-5.8 in jit.replay
    ("serve_wait_ms.served", "pairs"): 0.3,
    ("serve_host_ms.served", "pairs"): 0.15,            # 2 x (0.1 + 0.05)
    ("jit_replay_ms.vo", "frames"): 0.5,
    ("pose_chirality_ms.vo", "frames"): 0.3,
}


class _DeviceTrace:
    def __init__(self, events, window):
        self.events, self.window = events, window


def _ns(items):
    return [(n, int(s * MS), int(e * MS)) for n, s, e in items]


def _run(unit, traced=True):
    cell = bench.cell(bench.load(), "flagship.single")
    spans = None
    if traced:
        from cardbench.trace import Spans

        spans = Spans()
        spans.items = _ns(HARNESS)
    log = Log(spans)
    for handed, done in ((1.0, 4.0), (5.0, 8.0)):
        rid = log.hand(0)
        log.handed[rid] = int(handed * MS)
        log.done[rid] = int(done * MS)
    dev = _DeviceTrace(_ns(EVENTS), (0, 10 * MS)) if traced else None
    return Run(cell, log, 0, 10 * MS, 1.0, unit, 1, dev)


def _plant(monkeypatch, items):
    recs = [trace.Record(n, s, e, None, 1) for n, s, e in _ns(items)]
    monkeypatch.setattr(program_spans, "records", lambda: recs)


@pytest.mark.parametrize("metric,unit", sorted(READINGS))
def test_readers_give_the_hand_computed_value(monkeypatch, metric, unit):
    _plant(monkeypatch, PLANTED)
    assert bench.reader(metric)(_run(unit)) == pytest.approx(READINGS[metric, unit])
    other = "frames" if unit == "pairs" else "pairs"
    assert bench.reader(metric)(_run(other)) is None


@pytest.mark.parametrize("metric,unit", sorted(READINGS))
@pytest.mark.parametrize("records", ["no module", "none", "outside the window"])
def test_readers_give_none_without_records(monkeypatch, metric, unit, records):
    if records == "no module":
        monkeypatch.setattr(program_spans, "records", lambda: None)
    else:
        _plant(monkeypatch, [] if records == "none" else [(n, s + 20, e + 20)
                                                          for n, s, e in PLANTED])
    assert bench.reader(metric)(_run(unit)) is None


def test_a_reader_without_a_device_trace_windows_to_the_whole_run(monkeypatch):
    _plant(monkeypatch, PLANTED)
    run = _run("pairs", traced=False)
    assert bench.reader("jit_replay_ms.pairs")(run) == pytest.approx(0.5)
    assert bench.reader("idle_in_jit_ms.pairs")(run) is None


def test_idle_split_puts_each_gap_under_both_traces(monkeypatch):
    _plant(monkeypatch, PLANTED)
    split = program_spans.idle_split(_run("pairs"))
    assert split["jit_call"] == {"jit.replay": pytest.approx(0.8e-3)}
    # Gaps 0-1, 3.5-5.0 and 7.5-10 ms, outside both traces' spans.
    assert split["harness"] == {"outside program spans": pytest.approx(5.0e-3)}


@pytest.mark.parametrize("name,readings", [
    ("flagship.single", ("host_io_ms.pairs", "host_syncs.pairs")),
    ("akaze_essential.pairs", ("host_io_ms.pairs", "host_syncs.pairs")),
    ("flagship.serve", ("serve_wait_ms.served", "serve_host_ms.served")),
])
def test_a_cpu_run_under_the_profiler_reads_the_program_spans(name, readings):
    from torch.profiler import ProfilerActivity, profile

    cell = small(bench.cell(bench.load(), name))
    if "chunk" in cell.traffic:
        # Two pairs a chunk, so that a loaded CPU answers some inside the window.
        cell = dataclasses.replace(cell, traffic={**cell.traffic, "chunk": 2})
    with profile(activities=[ProfilerActivity.CPU]):
        res = run_cell(cell, 2 ** 40 + 5, 5.0, True, "cpu", time.time())
    assert res["correct"] is True, res["checks"]
    got = {m: res["metrics"].get(m, {}).get("value") for m in readings}
    assert all(v is not None and v > 0 for v in got.values()), (
        got, res["attempted"], len(trace.records()), trace.dropped())
    if "host_syncs.pairs" in got:
        # The request in flight when the window closes is counted but not answered.
        syncs = 4 if name == "flagship.single" else 1
        n = res["attempted"]
        assert syncs <= got["host_syncs.pairs"] <= syncs * n / (n - 1)

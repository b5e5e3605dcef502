"""One camera streaming frames through the VO CLI's per-frame step, closed
loop. ``cli.visual_odometry.run_visual_odometry`` reads its frames through
OpenCV, so the harness runs the loop's body itself on frames already at
model size: upload the frame, extract its features, match them against the
cached reference features with ``k_inv`` (``build_vo_matcher``'s jitted
halves, streaming), bring the matches and E back in one copy (``to_host``),
then the loop's gating: too few matches, no motion (the reference frame
ages and is replaced at ``max_reference_age``), or ``vo.recover_pose`` and
the inlier tests; an accepted pose extends the trajectory and makes the
frame the new reference. Frames come from ``scene_walks``: each walk
forward and back, the walks in turn; a walk starts as the loop starts on a
recording, its first frame the reference (not a request).

Spans (traced runs): ``upload``, ``extract``, ``match``, ``to_host``,
``pose`` (``vo.recover_pose``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from cardbench import inputs, program, reference


class VOStream:
    unit = "frames"
    pairs_per_call = 1

    def __init__(self, cell, seed: int, device: str):
        from onnx_image_processing_tpu_torch.cli.visual_odometry import build_vo_matcher
        from onnx_image_processing_tpu_torch.vo import CameraIntrinsics, recover_pose

        cfg, mix = cell.config, cell.traffic
        self.cfg, self.device, self.gates = cfg, device, cfg["vo"]
        walks = inputs.scene_walks(seed, mix["walks"], mix["frames"], cfg["height"],
                                   cfg["width"], cfg["camera"], mix["scene"], device)
        self.frames = [f for walk in walks for f in walk]
        self.n_walks, self.n_frames = mix["walks"], mix["frames"]
        self.first_walk = seed % self.n_walks
        self.extract, self.match = build_vo_matcher(cfg["pipeline"], program.matcher_config(cfg),
                                                    streaming=cfg["vo"]["streaming"],
                                                    device=device)
        if self.extract is None:
            raise ValueError(f"{cfg['pipeline']} has no streaming split")
        c = cfg["camera"]
        self.intrinsics = CameraIntrinsics(c["fx"], c["fy"], c["cx"], c["cy"], cfg["width"],
                                           cfg["height"])
        self.k_inv = torch.as_tensor(self.intrinsics.k_inv(), device=device)
        self.recover_pose = recover_pose
        self.order = self._order()
        self.ref, self.ref_feats, self.age = None, None, 0

    def _order(self):
        """(flat frame index, starts a walk) without end: each walk forward
        and back, the walks in turn from the seeded first."""
        k = self.first_walk
        while True:
            for j, i in enumerate(inputs.sweep(self.n_frames)):
                yield k * self.n_frames + i, j == 0
            k = (k + 1) % self.n_walks

    def _restart(self, first: int) -> None:
        """A walk starts as the loop starts on a recording: its first frame's
        features become the reference."""
        self.ref, self.ref_feats, self.age = first, self.extract(self._upload(first)), 0

    def _upload(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.frames[i]).to(self.device)

    def _step(self, cur: int, spans) -> dict:
        """One frame of the loop against the current reference frame."""
        from onnx_image_processing_tpu_torch.cli.visual_odometry import to_host

        g = self.gates
        t = spans.now() if spans else 0
        image = self._upload(cur)
        if spans:
            spans.add("upload", t)
            t = spans.now()
        feats = self.extract(image)
        if spans:
            spans.add("extract", t)
            t = spans.now()
        out = self.match(self.ref_feats, feats, self.k_inv)[:5]
        if spans:
            spans.add("match", t)
            t = spans.now()
        mk1a, mk2a, scores, valid, e = to_host(out)
        if spans:
            spans.add("to_host", t)
        keep = valid[0]
        mk1, mk2 = mk1a[0][keep], mk2a[0][keep]
        ans = {"mk1": mk1, "mk2": mk2, "scores": scores[0][keep], "e": e, "r": None, "t": None,
               "accepted": False}
        if len(mk1) < g["min_matches"]:
            return ans
        if float(np.sqrt(np.mean(np.sum((mk2 - mk1) ** 2, axis=1)))) < g["min_motion_pixels"]:
            self.age += 1
            if self.age >= g["max_reference_age"]:
                self.ref, self.ref_feats, self.age = cur, feats, 0
            return ans
        t = spans.now() if spans else 0
        r, tv, inliers = self.recover_pose(e, mk1, mk2, self.intrinsics)
        if spans:
            spans.add("pose", t)
        n_in = int(inliers.sum())
        ans["r"], ans["t"] = r, tv
        if r is None or n_in < g["min_matches"] or n_in / len(mk1) < g["min_inlier_ratio"]:
            self.age += 1
            if self.age >= g["max_reference_age"]:
                self.ref, self.ref_feats, self.age = cur, feats, 0
            return ans
        self.trajectory.add_relative_pose(r, tv)
        ans["accepted"] = True
        self.ref, self.ref_feats, self.age = cur, feats, 0
        return ans

    def warm(self) -> None:
        """The captures of both halves: a walk's start and three frames of the
        loop; then the order starts again."""
        from onnx_image_processing_tpu_torch.vo import Trajectory

        self.trajectory = Trajectory()
        with torch.inference_mode():
            for _ in range(4):
                cur, starts = next(self.order)
                if starts:
                    self._restart(cur)
                else:
                    self._step(cur, None)
        self.order = self._order()
        self.trajectory = Trajectory()

    def serve(self, until: int, log) -> None:
        spans = log.spans
        with torch.inference_mode():
            while time.perf_counter_ns() < until:
                cur, starts = next(self.order)
                if starts:
                    self._restart(cur)
                    continue
                rid = log.hand((self.ref, cur))
                log.answer(rid, self._step(cur, spans))
                log.tick()

    def close(self) -> None:
        del self.extract, self.match, self.ref_feats

    def reference(self, keys, precision: str):
        return reference.vo_answers(self.cfg, self.frames, keys, self.device, precision)


def build(cell, seed: int, device: str) -> VOStream:
    return VOStream(cell, seed, device)

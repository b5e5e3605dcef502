"""One pair at a time, closed loop: each request is one synchronous call of
the jitted two-image pipeline on a (1, 1, H, W) pair, its answer on the host
before the next is handed. A pipeline without ``k_inv`` runs through the
extraction CLI's device function (``cli.image_matching_extraction.match``
on ``models.jit(models.build(...))``); an essential pipeline through the VO
CLI's two-image matcher (``build_vo_matcher`` without streaming), uploaded
from the host and brought back in the CLI's one copy (``to_host``).

Pairs: ``texture_pairs`` (a pool of distinct textures rolled in x) or
``vo_pairs`` (frames of ``scene_walks`` ``gap`` steps apart), cycled.

Spans (traced runs): ``jit_call`` around each call of the jitted entry."""

from __future__ import annotations

import time

import torch

from cardbench import inputs, program, reference


class SinglePair:
    unit = "pairs"
    pairs_per_call = 1

    def __init__(self, cell, seed: int, device: str):
        from onnx_image_processing_tpu_torch import models
        from onnx_image_processing_tpu_torch.cli.visual_odometry import build_vo_matcher

        cfg, mix = cell.config, cell.traffic
        self.cfg, self.device = cfg, device
        h, w = cfg["height"], cfg["width"]
        if mix["inputs"] == "texture_pairs":
            self.pool = inputs.texture_pairs(seed, mix["pool"], h, w, mix["shift_min"],
                                             mix["shift_max"], device)
        elif mix["inputs"] == "vo_pairs":
            self.pool = [(walk[i], walk[j])
                         for walk in inputs.scene_walks(seed, mix["walks"], mix["frames"], h, w,
                                                        cfg["camera"], mix["scene"], device)
                         for i, j in inputs.frame_pairs(mix["frames"], mix["gap"])]
        else:
            raise ValueError(f"unknown inputs {mix['inputs']!r}")
        self.essential = program.takes_k_inv(cfg)
        if self.essential:
            _, self.fn = build_vo_matcher(cfg["pipeline"], program.matcher_config(cfg),
                                          streaming=False, device=device)
            self.k_inv = torch.as_tensor(program.k_inv(cfg), device=device)
        else:
            self.fn = models.jit(models.build(cfg["pipeline"], device=device,
                                              **program.overrides(cfg)))

    def _ask(self, fn, key: int) -> dict:
        a, b = self.pool[key]
        if not self.essential:
            from onnx_image_processing_tpu_torch.cli.image_matching_extraction import match

            mk1, mk2, scores = match(fn, a, b)
            return {"mk1": mk1, "mk2": mk2, "scores": scores}
        from onnx_image_processing_tpu_torch.cli.visual_odometry import to_host

        with torch.inference_mode():
            out = fn(torch.from_numpy(a).to(self.device), torch.from_numpy(b).to(self.device),
                     self.k_inv)
            mk1, mk2, scores, valid, e = to_host(out[:5])
        v = valid[0]
        return {"mk1": mk1[0][v], "mk2": mk2[0][v], "scores": scores[0][v], "e": e}

    def warm(self) -> None:
        for key in range(3):
            self._ask(self.fn, key % len(self.pool))

    def serve(self, until: int, log) -> None:
        fn = program.Traced(self.fn, log.spans) if log.spans else self.fn
        i = 0
        while time.perf_counter_ns() < until:
            key = i % len(self.pool)
            rid = log.hand(key)
            log.answer(rid, self._ask(fn, key))
            log.tick()
            i += 1

    def close(self) -> None:
        del self.fn

    def reference(self, keys, precision: str):
        return reference.pair_answers(self.cfg, {k: self.pool[k] for k in keys}, self.device,
                                      precision, essential=self.essential)


def build(cell, seed: int, device: str) -> SinglePair:
    return SinglePair(cell, seed, device)

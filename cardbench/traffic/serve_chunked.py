"""Served pairs: ``parallel.stream_map_chunked`` over
``models.jit(models.build_batched(...))``, ``chunk`` pairs per call and
``depth`` calls in flight, closed loop: a seeded pool of distinct texture
pairs, cycled, handed to the serving loop as fast as it takes them.

Spans (traced runs): ``serve_next`` around each step of the serving
iterator, ``jit_call`` around each call of the jitted entry,
``pair_gen`` around each pair the generator makes."""

from __future__ import annotations

import time

from cardbench import inputs, program, reference


class ServeChunked:
    unit = "pairs"

    def __init__(self, cell, seed: int, device: str):
        from onnx_image_processing_tpu_torch import models

        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.device = cfg, mix, device
        self.chunk, self.depth = int(mix["chunk"]), int(mix["depth"])
        self.pairs_per_call = self.chunk
        self.pool = inputs.texture_pairs(seed, mix["pool"], cfg["height"], cfg["width"],
                                         mix["shift_min"], mix["shift_max"], device)
        self.fn = models.jit(models.build_batched(cfg["pipeline"], device=device,
                                                  **program.overrides(cfg)))

    def _stream(self, log, until: int, count: int | None = None):
        """Pairs of the pool in turn, each handed as it is made, until
        ``until`` (or ``count`` pairs); yields the results with their ids."""
        from onnx_image_processing_tpu_torch import parallel

        spans = log.spans if log is not None else None
        rids = []

        def pairs():
            i = 0
            while (count is None or i < count) and time.perf_counter_ns() < until:
                t = spans.now() if spans else 0
                key = i % len(self.pool)
                pair = self.pool[key]
                if log is not None:
                    rids.append(log.hand(key))
                if spans:
                    spans.add("pair_gen", t)
                i += 1
                yield pair

        fn = program.Traced(self.fn, spans) if spans else self.fn
        it = parallel.stream_map_chunked(fn, pairs(), self.chunk, self.depth)
        k = 0
        while True:
            t = spans.now() if spans else 0
            try:
                res = next(it)
            except StopIteration:
                return
            if spans:
                spans.add("serve_next", t)
            yield (rids[k] if log is not None else None), res
            k += 1

    def warm(self) -> None:
        """Three chunks through the serving loop: the capture of the chunk's
        graph and the pinned buffers' first use."""
        for _ in self._stream(None, time.perf_counter_ns() + 10 ** 12, 3 * self.chunk):
            pass

    def serve(self, until: int, log) -> None:
        """Pairs until ``until``; the serving loop then answers every pair it
        took (the last chunk padded) before it stops."""
        for rid, (mk1, mk2, scores, valid) in self._stream(log, until):
            log.answer(rid, {"mk1": mk1[valid], "mk2": mk2[valid], "scores": scores[valid]})
            log.tick()

    def close(self) -> None:
        del self.fn

    def reference(self, keys, precision: str):
        return reference.pair_answers(self.cfg, {k: self.pool[k] for k in keys}, self.device,
                                      precision)


def build(cell, seed: int, device: str) -> ServeChunked:
    return ServeChunked(cell, seed, device)

"""The comparison that decides ``correct``: each answer the program gave
against the reference's answer to the same request, reduced to a few
numbers, each held to its limit (``limits/<cell>.json``).

Numbers (each the worst over every distinct answer compared):

- ``missing``: requests handed to the program whose answer never came.
- ``p_gap``: the least change of the reference's assignment matrix P that
  would give the program's matches and scores. A match both give counts
  the difference of its probability; a match only the program gives, the
  amount by which P rejects it (below the match threshold, not the row's or
  the column's maximum, or below the ``max_matches`` cut); a match only the
  reference gives, the amount by which it clears the program's cut. A
  keypoint the reference did not select reads 1. So keypoints, P, the
  mutual-NN extraction and validity all show here, and a top-k set that
  splits on a near-tie reads the size of that tie, not a whole match.
- ``e_shift``: the distance between the two essential matrices (unit norm,
  up to sign) times (lambda2 - lambda1) / lambda_max of the reference's
  8-point normal matrix: the relative change of that matrix that turns its
  least eigenvector that far (Davis-Kahan). Where the 8-point system is
  near-degenerate (flat P, no motion) any of many E fit it, and the
  eigengap says so.
- ``pose_gap_deg``: the program's (R, t) against the reference's pose step
  run on the program's own matches and E: the larger of the rotation
  between the two R and the angle between the two t, in degrees (180 where
  only one finds a pose). E and the matches are held above; this holds the
  host stage alone, exactly.
- ``verdict_flips``: frames whose acceptance differs, on the same inputs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["NUMBERS", "numbers", "judge", "answer_numbers", "distinct"]

NUMBERS = ("missing", "p_gap", "e_shift", "pose_gap_deg", "verdict_flips")


def _unit(e) -> np.ndarray:
    e = np.asarray(e, np.float64)
    return e / max(np.linalg.norm(e), 1e-30)


def _angle_deg(a, b) -> float:
    """The angle between two vectors (atan2 of |a x b| and a.b: 0 for equal ones)."""
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)), np.dot(a, b))))


def _rotation_deg(r1, r2) -> float:
    """The angle of the rotation between two rotation matrices, from their
    chordal distance ||R1 - R2|| = 2 sqrt(2) sin(angle / 2)."""
    d = np.linalg.norm(np.asarray(r1, np.float64) - np.asarray(r2, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0))))))


def _index(kpts: np.ndarray, valid: np.ndarray) -> dict:
    return {tuple(k): i for i, (k, v) in enumerate(zip(kpts.tolist(), valid.tolist())) if v}


def _cut(scores, s: dict) -> float:
    """The lowest probability a match may have and be left out: the list's
    last where it is full, else the threshold."""
    scores = np.asarray(scores)
    return float(scores.min()) if len(scores) >= s["max_matches"] else s["match_threshold"]


def p_gap(ans: dict, want) -> float:
    s = want.settings
    i1, i2 = _index(want.k1, want.v1), _index(want.k2, want.v2)
    prog = []
    for a, b in zip(ans["mk1"].tolist(), ans["mk2"].tolist()):
        i, j = i1.get(tuple(a)), i2.get(tuple(b))
        if i is None or j is None:
            return 1.0
        prog.append((i, j))
    ref = [(i1[tuple(a)], i2[tuple(b)])
           for a, b in zip(want.answer["mk1"].tolist(), want.answer["mk2"].tolist())]
    pairs = prog + ref
    if not pairs:
        return 0.0
    n, m = want.k1.shape[0], want.k2.shape[0]
    core = want.p[:n, :m]
    ii = torch.tensor([i for i, _ in pairs], device=core.device)
    jj = torch.tensor([j for _, j in pairs], device=core.device)
    at = core[ii, jj].cpu().numpy().astype(np.float64)
    row_max = core.amax(dim=1)[ii].cpu().numpy().astype(np.float64)
    col_max = core.amax(dim=0)[jj].cpu().numpy().astype(np.float64)
    ref_set, prog_set = set(ref), set(prog)
    cut_r = _cut(want.answer["scores"], s)
    gap = 0.0
    for k, (pair, score) in enumerate(zip(prog, np.asarray(ans["scores"], np.float64))):
        g = abs(score - at[k])
        if pair not in ref_set:
            g = max(g, s["match_threshold"] - at[k], row_max[k] - at[k], col_max[k] - at[k],
                    cut_r - at[k])
        gap = max(gap, g)
    cut_p = _cut(ans["scores"], s)
    for k, pair in enumerate(ref, start=len(prog)):
        if pair not in prog_set:
            gap = max(gap, at[k] - cut_p)
    return float(gap)


def answer_numbers(ans: dict, want) -> dict:
    """The numbers of one answer against the reference's ``Want``."""
    out = {"p_gap": p_gap(ans, want)}
    if "e" in want.answer:
        a, b = _unit(ans["e"]), _unit(want.answer["e"])
        out["e_shift"] = float(min(np.linalg.norm(a - b), np.linalg.norm(a + b))
                               * want.e_gap_scale)
    if "accepted" in want.answer:
        r, t, ok = want.pose_of(ans)
        if (r is None) != (ans["r"] is None):
            out["pose_gap_deg"] = 180.0
        elif r is None:
            out["pose_gap_deg"] = 0.0
        else:
            out["pose_gap_deg"] = max(_rotation_deg(ans["r"], r), _angle_deg(ans["t"], t))
        out["verdict_flips"] = float(bool(ok) != bool(ans["accepted"]))
    return out


def _digest(ans: dict) -> bytes:
    h = hashlib.sha1()
    for k in sorted(ans):
        v = ans[k]
        h.update(k.encode())
        h.update(b"none" if v is None else np.ascontiguousarray(v).tobytes())
    return h.digest()


def distinct(answered) -> dict:
    """``{key: [answer, ...]}`` of (key, answer) pairs, each distinct
    answer to a key once."""
    out: dict = {}
    seen = set()
    for key, ans in answered:
        d = (key, _digest(ans))
        if d not in seen:
            seen.add(d)
            out.setdefault(key, []).append(ans)
    return out


def numbers(by_key: dict, wants, missing: int = 0) -> dict:
    """The cell's numbers: ``by_key`` ``{key: [answer, ...]}`` against the
    reference's ``(key, Want)`` pairs. ``verdict_flips`` counts keys; the
    rest are worst cases."""
    out = {"missing": float(missing)}
    flipped = 0
    for key, want in wants:
        flip = False
        for ans in by_key[key]:
            for name, v in answer_numbers(ans, want).items():
                if name == "verdict_flips":
                    flip = flip or bool(v)
                else:
                    out[name] = max(out.get(name, 0.0), v)
        if "accepted" in want.answer:
            flipped += flip
            out["verdict_flips"] = float(flipped)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, ``{name: {"value", "limit"}}``). A
    number the cell's limits name but the run could not give fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, checks

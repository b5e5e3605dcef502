"""Trace / export CLI of the port: the export-registry analogue (port of
``onnx_image_processing_tpu/cli/export.py``).

Without ``--output-dir`` it traces every registered pipeline at the
deployment shape with ``torch.export`` and reports, per pipeline, the
seconds, the graph's node count and how many of its nodes are the port's
kernel ops (``oip::*``). With ``--output-dir`` it writes each pipeline as
a ``.pt2`` artifact (``models.save_exported``) and verifies a load-and-call
round trip against the live module: bit for bit at the static shape, at two
shapes for ``--dynamic`` artifacts, and for ``--streaming`` the reloaded
extract / match pair composed against the two-image pipeline.

    python -m onnx_image_processing_tpu_torch.cli.export --device cpu -o artifacts
    python -m onnx_image_processing_tpu_torch.cli.export --device cuda --dynamic -o artifacts
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import models
from ..models.registry import arg_specs, essential_grid_side, k_inv_for, resolve_config
from .common import add_device_arg, select_device

# Streaming pair vs the two-image pipeline: floats within these (P's dustbin
# corner holds the unmatched mass, ~K, so it is held relatively), integers
# and masks equal.
STREAM_ATOL, STREAM_RTOL = 1e-5, 2e-6


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Trace-check / serialize all registry pipelines")
    p.add_argument("--models", nargs="*", default=None,
                   help="pipeline names (default: all)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max-keypoints", type=int, default=None)
    p.add_argument("--output-dir", "-o", default=None,
                   help="write <name>.<device>.pt2 artifacts here")
    p.add_argument("--dynamic", action="store_true",
                   help="shape-polymorphic artifacts (reference --dynamic-axes parity); "
                        "the default model set is models.POLYMORPHIC_EXPORTS")
    p.add_argument("--streaming", action="store_true",
                   help="export the streaming split instead: two artifacts per matcher "
                        "(<name>.extract / <name>.match); the default model set is "
                        "models.streaming_names()")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the artifact load-and-call round trip")
    add_device_arg(p)
    return p.parse_args(argv)


def _tensors(arrays, device) -> tuple:
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device) for a in arrays)


def _poly_test_args(name, overrides, scale, device):
    """Inputs for verifying a polymorphic artifact at one shape (scale 1 or
    3), inside the ranges of ``models.POLYMORPHIC_EXPORTS``."""
    spec = models.get(name)
    resolved = resolve_config(spec, **overrides)
    rng = np.random.default_rng(scale)
    if name == "sinkhorn":
        n, m = 64 * scale, 48 * scale
        return _tensors([rng.normal(size=(scale, n, 128)), rng.normal(size=(scale, m, 128))],
                        device)
    if name == "essential_matrix_estimator":
        g = essential_grid_side(resolved) ** 2
        n, m = min(60 * scale, g), min(80 * scale, g)
        return _tensors([rng.uniform(0, 1, (n + 1, m + 1)), k_inv_for(480, 640)], device)
    if name == "voxel_downsampling":
        return _tensors([rng.uniform(0, 2, (1000 * scale, 3)), np.float32(0.05)], device)
    if spec.n_images == 2 or spec.selects_keypoints:
        # Enough NMS blocks for the registry's K = 1024 at block 6.
        h, w = 144 + 48 * scale, 208 + 48 * scale
        images = [rng.uniform(0, 255, (1, 1, h, w)) for _ in range(spec.n_images or 1)]
        return _tensors(images + ([k_inv_for(h, w)] if spec.takes_k_inv else []), device)
    # Dense heads: the batch and the resolution vary.
    return _tensors([rng.uniform(0, 255, (scale, 1, 16 * scale + 32, 24 * scale + 40))], device)


def _leaves(out) -> tuple:
    return out if isinstance(out, (tuple, list)) else (out,)


def _assert_equal(got, want, what: str) -> None:
    got, want = _leaves(got), _leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs, expected {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from the live module")


def _verify_roundtrip(path, name, height, width, overrides, device):
    """Reload the artifact: the live module's outputs, bit for bit."""
    spec = models.get(name)
    args = arg_specs(spec, resolve_config(spec, **overrides), height, width,
                     device=device, seed=1)
    live = models.build(name, device=device, **overrides)(*args)
    _assert_equal(models.load_exported(path)(*args), live, name)


def _verify_poly_roundtrip(path, name, overrides, device):
    """Reload a polymorphic artifact: the live module's outputs, bit for bit,
    at two shapes."""
    live = models.build(name, device=device, **overrides)
    loaded = models.load_exported(path)
    for scale in (1, 3):
        args = _poly_test_args(name, overrides, scale, device)
        _assert_equal(loaded(*args), live(*args), f"{name} at {[tuple(a.shape) for a in args]}")


def _verify_streaming_roundtrip(path_ex, path_ma, name, height, width, overrides, device):
    """Reload the streaming pair: composed, the two-image pipeline's outputs
    (integers and masks equal, floats within STREAM_ATOL / STREAM_RTOL)."""
    spec = models.get(name.removesuffix("_extraction"))
    rng = np.random.default_rng(0)
    img1, img2 = _tensors([rng.uniform(0, 255, (1, 1, height, width)) for _ in range(2)],
                          device)
    extra = _tensors([k_inv_for(height, width)], device) if spec.takes_k_inv else ()
    extract, match = models.load_exported(path_ex), models.load_exported(path_ma)
    got = _leaves(match(extract(img1), extract(img2), *extra))
    want = _leaves(models.build(name, device=device, **overrides)(img1, img2, *extra))
    if len(got) != len(want):
        raise AssertionError(f"{name}: streaming gives {len(got)} outputs, expected {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        same = (torch.allclose(a, b, rtol=STREAM_RTOL, atol=STREAM_ATOL)
                if a.is_floating_point() else torch.equal(a, b))
        if a.dtype != b.dtype or a.shape != b.shape or not same:
            raise AssertionError(f"{name}: streaming output {i} differs from the two-image "
                                 "pipeline")


def op_nodes(exported) -> int:
    """Nodes of an exported graph that call the port's kernel ops."""
    return sum(1 for n in exported.graph.nodes
               if n.op == "call_function" and str(n.target).startswith("oip."))


def _export_one(args, name, overrides, device) -> str:
    """Export (and verify) one pipeline as the flags ask; returns the line to print."""
    verify = not args.no_verify
    out = args.output_dir
    t0 = time.perf_counter()
    if args.dynamic:
        exported = models.export_model_polymorphic(name, device=device, **overrides)
        path = models.save_exported(exported, models.artifact_path(out, name, device,
                                                                   polymorphic=True))
        if verify:
            _verify_poly_roundtrip(path, name, overrides, device)
        return (f"dynamic export in {time.perf_counter() - t0:.1f}s -> "
                f"{os.path.basename(path)} ({os.path.getsize(path) / 1e6:.2f} MB"
                f"{', verified @2 shapes' if verify else ''})")
    if args.streaming:
        ex, ma = models.export_streaming(name, args.height, args.width, device=device,
                                         **overrides)
        path_ex = models.save_exported(ex, models.artifact_path(out, name + ".extract", device))
        path_ma = models.save_exported(ma, models.artifact_path(out, name + ".match", device))
        if verify:
            _verify_streaming_roundtrip(path_ex, path_ma, name, args.height, args.width,
                                        overrides, device)
        return (f"streaming export in {time.perf_counter() - t0:.1f}s -> "
                f"{os.path.basename(path_ex)} + {os.path.basename(path_ma)}"
                f"{', verified' if verify else ''}")
    exported = models.export_model(name, args.height, args.width, device=device, **overrides)
    if not out:
        return (f"traced in {time.perf_counter() - t0:.1f}s, {len(exported.graph.nodes)} "
                f"nodes, {op_nodes(exported)} kernel op nodes")
    path = models.save_exported(exported, models.artifact_path(out, name, device))
    if verify:
        _verify_roundtrip(path, name, args.height, args.width, overrides, device)
    return (f"exported in {time.perf_counter() - t0:.1f}s -> {os.path.basename(path)} "
            f"({os.path.getsize(path) / 1e6:.2f} MB{', verified' if verify else ''})")


def main(argv=None) -> int:
    args = parse_args(argv)
    device = select_device(args.device)
    if args.dynamic and args.streaming:
        print("error: --dynamic and --streaming are mutually exclusive")
        return 2
    if (args.dynamic or args.streaming) and not args.output_dir:
        # Without -o the static path is a trace check; the other two must
        # write their artifacts to verify them.
        print(f"error: --{'dynamic' if args.dynamic else 'streaming'} requires --output-dir "
              "(artifacts must be written somewhere to be verified)")
        return 2
    if args.dynamic:
        names = args.models or sorted(models.POLYMORPHIC_EXPORTS)
    elif args.streaming:
        names = args.models or models.streaming_names()
    else:
        names = args.models or models.names()
    overrides = {} if args.max_keypoints is None else {"max_keypoints": args.max_keypoints}
    failures = []
    for name in names:
        try:
            print(f"[OK]   {name}: {_export_one(args, name, overrides, device)}", flush=True)
        except Exception as err:  # report every failure, keep going
            failures.append(name)
            print(f"[FAIL] {name}: {type(err).__name__}: {err}", flush=True)
    if failures:
        print(f"\n{len(failures)} pipeline(s) failed: {failures}")
        return 1
    print(f"\nAll {len(names)} pipelines {'exported' if args.output_dir else 'traced'}.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

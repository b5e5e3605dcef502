"""Clock cycles of each phase of the detect kernel, and of detect_select's
last-CTA selection, on the card.

    python -m onnx_image_processing_tpu_torch.tools.detect_phases   # repo root

Builds a copy of ``csrc/detect_frontend.cu`` and ``csrc/select_topk.cuh``
with a ``clock64()`` stamp before each phase (thread 0 of each CTA writes
them to a device array) into ``build/kernels/phases/``, launches it at the
fused flagship pair's settings (``chip_smoke.py``'s 2x480x640 pair, block 5,
NMS 5, patch 15, K 512, margin 16, the tiles of ``detect_plan``) and prints
one JSON line per variant (with and without the moments, the detect kernel
alone and ``detect_select``): the mean and the max over the CTAs of each
phase's cycles, and for ``detect_select`` each image's last CTA's selection
split into staging, radix select, compaction, sort and decode. Cycles are
the SM's clock between two stamps of one CTA; two CTAs share an SM, so a
phase's cycles include the other CTA's work issued meanwhile. The kernels
the port runs carry no stamps: only the copy does. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ..kernels import _build, detect_frontend

MAX_CTAS = 8192
SLOTS = 16   # stamps per CTA
PHASES = ("load", "box columns, moment columns", "box rows, moment rows", "NMS columns",
          "NMS rows, stores", "block maxima, ticket")
SELECT = ("stage", "radix select", "compact", "sort", "decode")


def _insert(text: str, marker: str, code: str, after: bool = False) -> str:
    if text.count(marker) != 1:
        raise RuntimeError(f"phase marker not found once in the source: {marker!r}")
    return text.replace(marker, marker + code if after else code + marker)


def stamped_sources(out_dir) -> str:
    """Write the stamped copies into ``out_dir``; returns the .cu path."""
    stamp = ("if (threadIdx.x == 0) oip_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * "
             "gridDim.x + blockIdx.x) * %d + {i}] = clock64();" % SLOTS)
    header = (_build.CSRC / "select_topk.cuh").read_text()
    header = _insert(header, "namespace oip_topk {\n",
                     f"\n__device__ long long oip_stamps[{MAX_CTAS * SLOTS}];\n", after=True)
    header = _insert(header, "cta_exclusive_scan<THREADS>(pos, warp_sums, &npos);",
                     "\n  " + stamp.format(i=8), after=True)
    header = _insert(header, "  // Compact the survivors", "  __syncthreads();\n  "
                     + stamp.format(i=9) + "\n")
    header = _insert(header, "  bitonic_desc(keys, p2);\n", "  " + stamp.format(i=10) + "\n")
    header = _insert(header, "  bitonic_desc(keys, p2);\n", "  " + stamp.format(i=11) + "\n",
                     after=True)
    src = (_build.CSRC / "detect_frontend.cu").read_text()
    src = _insert(src, '#include "select_topk.cuh"', "").replace(
        '#include "select_topk.cuh"', '#include "select_topk_stamped.cuh"')
    for i, marker in enumerate(("  // 1. The clamped image", "  // 2. Column passes",
                                "  // 3. Row passes", "  // 4. The NMS window",
                                "  // 5. Row maxima")):
        src = _insert(src, marker, "  " + stamp.format(i=i) + "\n")
    src = _insert(src, "  if constexpr (SELECT) {\n    __syncthreads();",
                  "  __syncthreads();\n  " + stamp.format(i=5) + "\n")
    src = _insert(src, "select_tail(masked, s, rn, w, th, tw, b, smem);",
                  "\n    __syncthreads();\n    " + stamp.format(i=6), after=True)
    src = _insert(src, "if (!last_of_image(s.counters, b, gridDim.x * gridDim.y)) return;",
                  "\n  " + stamp.format(i=7), after=True)
    src += ('\nextern "C" int oip_stamps_read(long long* host, int n) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, oip_topk::oip_stamps, sizeof(long long) * n);\n}\n'
            'extern "C" int oip_stamps_clear() {\n'
            f'  static long long zeros[{MAX_CTAS * SLOTS}];\n'
            '  return (int)cudaMemcpyToSymbol(oip_topk::oip_stamps, zeros, sizeof(zeros));\n}\n')
    (out_dir / "select_topk_stamped.cuh").write_text(header)
    path = out_dir / "detect_stamped.cu"
    path.write_text(src)
    return str(path)


def build() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libdetect_stamped.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                           stamped_sources(out_dir)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped copy:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def run() -> list[dict]:
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("detect_phases: needs a CUDA device")
    lib = build()
    dev = torch.device("cuda")
    image = torch.cat([torch.from_numpy(a) for a in chip_smoke.bench_pair()]).to(dev)
    b, _, h, w = image.shape
    rb, rn, half, k, margin = 2, 5, 7, chip_smoke.MAX_KEYPOINTS, 16
    plan = detect_frontend.device_plan(b, h, w, rb, rn, half, dev)
    ctas = b * plan.ny * plan.nx
    taps = detect_frontend._taps(2.5, 2 * half + 1)
    maps = [torch.empty_like(image) for _ in range(3)]
    hb, wb = -(-h // (rn + 1)), -(-w // (rn + 1))
    scratch = [torch.empty((b, hb, wb), device=dev),
               torch.empty((b, hb, wb), dtype=torch.int32, device=dev),
               torch.zeros(64, dtype=torch.int32, device=dev)]
    out = [torch.empty((b, k, 2), device=dev), torch.empty((b, k), device=dev)]
    detect = lib.oip_detect_frontend
    detect.argtypes = detect_frontend._ARGTYPES
    select = lib.oip_detect_select
    select.argtypes = detect_frontend._SELECT_ARGTYPES
    ptr = _build.ptr
    lines = []
    for with_select in (False, True):
        for with_angle in (True, False):
            def launch():
                common = (ptr(image), taps.ctypes.data_as(ctypes.c_void_p), *map(ptr, maps))
                shape = (b, h, w, rb, rn, half, int(with_angle), plan.th, plan.tw)
                if with_select:
                    err = select(*common, *map(ptr, scratch), None, *map(ptr, out), *shape,
                                 margin, 0.0, k, 0, _build.stream(image))
                else:
                    err = detect(*common, *shape, _build.stream(image))
                if err:
                    raise RuntimeError(f"stamped launch: CUDA error {err}")
            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            if lib.oip_stamps_clear():
                raise RuntimeError("clearing the stamps failed")
            launch()
            torch.cuda.synchronize()
            st = np.zeros(ctas * SLOTS, dtype=np.int64)
            if lib.oip_stamps_read(st.ctypes.data_as(ctypes.c_void_p), ctas * SLOTS):
                raise RuntimeError("reading the stamps failed")
            st = st.reshape(ctas, SLOTS).astype(np.float64)
            n_phases = 6 if with_select else 5
            cycles = np.diff(st[:, :n_phases + 1], axis=1)
            line = {"case": ("detect_select" if with_select else "detect_frontend")
                    + (" with moments" if with_angle else " score only"),
                    "tile": [plan.th, plan.tw], "ctas": ctas,
                    "phase_cycles_mean": dict(zip(PHASES, cycles.mean(0).round(1).tolist())),
                    "phase_cycles_max": dict(zip(PHASES, cycles.max(0).tolist())),
                    "cta_cycles_mean": float((st[:, n_phases] - st[:, 0]).mean())}
            if with_select:
                last = st[st[:, 7] > 0]
                split = np.stack([last[:, 8] - last[:, 7], last[:, 9] - last[:, 8],
                                  last[:, 10] - last[:, 9], last[:, 11] - last[:, 10],
                                  last[:, 6] - last[:, 11]], axis=1)
                line["last_cta_select_cycles"] = [dict(zip(SELECT, row)) for row in
                                                  split.tolist()]
            lines.append(line)
    return lines


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for line in run():
        print(json.dumps({**line, "card": card}), flush=True)


if __name__ == "__main__":
    main()

"""Build the CUDA kernels with nvcc into one shared library and load it.

The sources in ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers (no ``torch.utils.cpp_extension``) and are
called through ``ctypes`` with tensor pointers and PyTorch's current stream.
Each source compiles in its own nvcc process, all started together, and one
last nvcc links the objects.
The build runs at first use, never at import, into ``build/kernels/`` beside
the package (listed in ``.gitignore``); the library's name carries a digest
of the flags, the sources and every header in ``csrc/``, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("runtime.cu", "select_frontend.cu", "sparse_sampler.cu",
           "sinkhorn.cu", "detect_frontend.cu", "akaze_ladder.cu", "essential_solve.cu")
# sm_90a: Hopper's full instruction set. No --use_fast_math: the Sinkhorn
# tolerance needs the full-precision expf/logf. -Xptxas -v reports each
# kernel's registers, shared memory and spills into the build log.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when an existing library was loaded
    log: str         # nvcc's output ("" when nothing was compiled)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_result: BuildResult | None = None
_constants: dict[tuple, torch.Tensor] = {}
_entries: dict[str, tuple] = {}
_tickets: dict[str, torch.Tensor] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    """Digest of the flags, the sources and every header they may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cuh", ".h"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile the kernels if no library for these sources exists yet."""
    global _result
    with _lock:
        if _result is not None:
            return _result
        out = BUILD_DIR / f"liboip_kernels_{_digest()}.so"
        if out.exists():
            _result = BuildResult(out, 0.0, "")
            return _result
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # Objects and library go to a private directory, and the library is
        # renamed into place: concurrent builders (test workers) never load
        # a half-written one.
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, name + ".o") for name in SOURCES]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for name, obj in zip(SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            log = "".join(f"== {name}\n{text}" for name, text in zip(SOURCES, logs))
            failed = [name for name, p in zip(SOURCES, procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            lib = os.path.join(tmp, "lib.so")
            proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", lib, *objs],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
            os.replace(lib, out)
        _result = BuildResult(out, time.perf_counter() - t0, log)
        return _result


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        major, minor = torch.cuda.get_device_capability()
        if (major, minor) != (9, 0):
            raise RuntimeError(
                f"kernels are built for sm_90a (Hopper); this device is "
                f"sm_{major}{minor}")
        path = build().path
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(path))
                lib.oip_error_string.argtypes = [ctypes.c_int]
                lib.oip_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib


def entry(name: str, argtypes: list) -> "ctypes._CFuncPtr":
    """A C entry point of the library, typed: every entry returns an int
    error code (``cudaGetLastError()`` after its launches). Typed once and
    kept, so a launch does not pay for setting its types again."""
    cached = _entries.get(name)
    if cached is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        cached = _entries[name] = (fn, tuple(argtypes))
    if cached[1] != tuple(argtypes):
        raise TypeError(f"{name} was typed {cached[1]}, now asked as {tuple(argtypes)}")
    return cached[0]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().oip_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def constant(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small float32 array (stencil taps) on ``device``, copied there once
    and kept, so a launch does not wait on a host-to-device copy."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    key = (values.tobytes(), str(device))
    t = _constants.get(key)
    if t is None:
        t = torch.from_numpy(values.copy()).to(device)
        _constants[key] = t
    return t


def ticket_counters(device: torch.device, b: int, caller: str) -> torch.Tensor:
    """The per-image ticket counters of the kernels that select in their
    last CTA (``select_frontend.nms_select_blocks`` and
    ``detect_frontend.detect_select``): one set per device, shared by both,
    at least ``b`` of them. Each launch leaves its counters at 0, so they
    are zeroed once, when made, outside any CUDA-graph capture; calls on one
    device must not run at once on two streams."""
    key = str(device)
    t = _tickets.get(key)
    if t is None or t.numel() < b:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{caller} makes its counters outside a CUDA-graph capture: "
                               f"call it once at batch {b} before capturing")
        t = _tickets[key] = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
    return t

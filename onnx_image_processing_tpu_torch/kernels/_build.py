"""Build the CUDA kernels with nvcc into one shared library and load it.

The sources in ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers (no ``torch.utils.cpp_extension``) and are
called through ``ctypes`` with tensor pointers and PyTorch's current stream.
The build runs at first use, never at import, into ``build/kernels/`` beside
the package (listed in ``.gitignore``); the library's name carries a digest
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.
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
           "sinkhorn.cu", "detect_frontend.cu", "akaze_ladder.cu")
# sm_90a: Hopper's full instruction set. No --use_fast_math: the Sinkhorn
# tolerance needs the full-precision expf/logf. -Xptxas -v reports each
# kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when an existing library was loaded
    log: str         # nvcc's output ("" when nothing was compiled)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_result: BuildResult | None = None
_constants: dict[tuple, torch.Tensor] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
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
        # Compile to a private name and rename: concurrent builders (test
        # workers) never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / name) for name in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
        _result = BuildResult(out, seconds, log)
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
    error code (``cudaGetLastError()`` after its launches)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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

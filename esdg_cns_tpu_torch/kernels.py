"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/esdg_cns_tpu_torch/libesdg_kernels.so \
         esdg_cns_tpu_torch/csrc/*.cu

The build runs at first use, into ``build/esdg_cns_tpu_torch/`` at the
repository root, and again whenever a source is newer than the library.
``--use_fast_math`` is deliberately absent: the entropy identities need
IEEE log, exp, pow, division and sqrt.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "esdg_cns_tpu_torch"
LIB_PATH = BUILD_DIR / "libesdg_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when the library was up to date
    log: str            # nvcc's output (ptxas register/spill report)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> BuildInfo:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every source."""
    newest = max(p.stat().st_mtime for p in _sources())
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        log = LOG_PATH.read_text() if LOG_PATH.exists() else ""
        return BuildInfo(LIB_PATH, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libesdg_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log[-8000:]}")
    LOG_PATH.write_text(log)
    os.replace(tmp, LIB_PATH)   # atomic: a concurrent build never sees half a file
    return BuildInfo(LIB_PATH, seconds, log)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    lib = ctypes.CDLL(str(build().path))
    lib.esdg_hex_volume.argtypes = [_I, _I, _I] + [_P] * 10 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_volume.restype = _I
    lib.esdg_hex_surface.argtypes = [_I, _I, _I, _I] + [_P] * 9 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_surface.restype = _I
    lib.esdg_tri_modal_volume.argtypes = [_I] + [_P] * 9 + [
        ctypes.c_longlong, _I, _I, _I, ctypes.c_double, _P]
    lib.esdg_tri_modal_volume.restype = _I
    lib.esdg_cns_surface_viscous.argtypes = [_I] + [_P] * 4 + [
        ctypes.c_longlong, _I, _I, _I] + [ctypes.c_double] * 5 + [
        _I] * 4 + [_P]
    lib.esdg_cns_surface_viscous.restype = _I
    return lib


def pointer_array(tensors):
    """A host array of device pointers (void*[]) for a kernel's C entry;
    None stands for an argument the kernel does not read."""
    return (_P * len(tensors))(*[None if t is None else t.data_ptr()
                                 for t in tensors])

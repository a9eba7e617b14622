"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled by ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o build/esdg_cns_tpu_torch/<src>.o \
         esdg_cns_tpu_torch/csrc/<src>.cu           # for each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/esdg_cns_tpu_torch/libesdg_kernels.so build/esdg_cns_tpu_torch/*.o

The build runs at first use, into ``build/esdg_cns_tpu_torch/`` at the
repository root, and again whenever a source is newer than the library.
``--use_fast_math`` is deliberately absent: the entropy identities need
IEEE log, exp, pow, division and sqrt.  Nothing here runs at import.
``python -m esdg_cns_tpu_torch.kernels`` times the build with one nvcc at
a time against all started together.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "esdg_cns_tpu_torch"
LIB_PATH = BUILD_DIR / "libesdg_kernels.so"
LOG_PATH = BUILD_DIR / "build.log"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when the library was up to date
    log: str            # nvcc's output (ptxas register/spill report),
                        # each source under "== <name> (<seconds> s)"

    def source_seconds(self):
        """{source name: its nvcc seconds}, from the log's headers."""
        return {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^== (\S+\.cu) \(([0-9.]+) s\)$", self.log, re.M)}


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


def _compile(lib: Path, jobs: int) -> BuildInfo:
    """Compile csrc/*.cu, at most `jobs` nvcc processes at once, and link
    the objects into `lib`; raises when nvcc fails."""
    nvcc = _nvcc()
    sources = sorted(CSRC_DIR.glob("*.cu"))
    # per-process names: a concurrent build never sees half a file
    objs = [lib.parent / f"{src.stem}.{os.getpid()}.o" for src in sources]
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so")

    def compile_one(src_obj):
        src, obj = src_obj
        t = time.perf_counter()
        res = subprocess.run([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return res, time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        timed = list(pool.map(compile_one, zip(sources, objs)))
    results = [res for res, _ in timed]
    log = "\n".join(f"== {src.name} ({sec:.1f} s)\n{res.stdout}"
                    for src, (res, sec) in zip(sources, timed))
    failed = [src.name for src, res in zip(sources, results)
              if res.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        log += f"\n== link\n{res.stdout}{res.stderr}"
        if res.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{log[-8000:]}")
    os.replace(tmp, lib)   # atomic
    return BuildInfo(lib, seconds, log)


def build() -> BuildInfo:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every
    source: one nvcc per source, all started together, then one link."""
    newest = max(p.stat().st_mtime for p in _sources())
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= newest:
        log = LOG_PATH.read_text() if LOG_PATH.exists() else ""
        return BuildInfo(LIB_PATH, 0.0, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info = _compile(LIB_PATH, len(list(CSRC_DIR.glob("*.cu"))))
    LOG_PATH.write_text(info.log)
    return info


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    lib = ctypes.CDLL(str(build().path))
    lib.esdg_hex_volume.argtypes = [_I] * 4 + [_P] * 11 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_volume.restype = _I
    lib.esdg_hex_surface.argtypes = [_I] * 6 + [_P, _P] + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_surface.restype = _I
    lib.esdg_hex_surface_shape.argtypes = [_I] * 5 + [_P]
    lib.esdg_hex_surface_shape.restype = _I
    lib.esdg_hex_project.argtypes = [_I, _I] + [_P] * 5 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_project.restype = _I
    lib.esdg_hex_project_shape.argtypes = [_I, _I, _P]
    lib.esdg_hex_project_shape.restype = _I
    lib.esdg_hex_fd_dir.argtypes = [_I] * 5 + [_P] * 6 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_fd_dir.restype = _I
    lib.esdg_hex_fd_dir_shape.argtypes = [_I] * 4 + [_P]
    lib.esdg_hex_fd_dir_shape.restype = _I
    lib.esdg_hex_volume_shape.argtypes = [_I] * 5 + [_P]
    lib.esdg_hex_volume_shape.restype = _I
    lib.esdg_modal_volume.argtypes = [_I, _I, _I] + [_P] * 7 + [
        ctypes.c_longlong] + [_I] * 5 + [ctypes.c_double, _P]
    lib.esdg_modal_volume.restype = _I
    lib.esdg_modal_volume_shape.argtypes = [_I] * 8 + [_P]
    lib.esdg_modal_volume_shape.restype = _I
    lib.esdg_hex_lines.argtypes = [_I] * 3 + [_P] * 6 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_hex_lines.restype = _I
    lib.esdg_dense_fd.argtypes = [_I] * 3 + [_P] * 5 + [
        ctypes.c_longlong, _I, _I, ctypes.c_double, _P]
    lib.esdg_dense_fd.restype = _I
    lib.esdg_cns_surface_viscous.argtypes = [_I, _I, _I] + [_P] * 7 + [
        ctypes.c_longlong, _I, _I, _I] + [ctypes.c_double] * 5 + [
        _I] * 4 + [_P]
    lib.esdg_cns_surface_viscous.restype = _I
    lib.esdg_cns_surface_viscous_shape.argtypes = [_I] * 7 + [_P, _P]
    lib.esdg_cns_surface_viscous_shape.restype = _I
    lib.esdg_cns_viscous.argtypes = [_I, _I, _I, _I] + [_P] * 5 + [
        ctypes.c_longlong, _I, _I, _I] + [ctypes.c_double] * 4 + [_P]
    lib.esdg_cns_viscous.restype = _I
    lib.esdg_cns_viscous_shape.argtypes = [_I] * 6 + [_P, _P]
    lib.esdg_cns_viscous_shape.restype = _I
    lib.esdg_cns_surface.argtypes = [_I, _I] + [_P] * 4 + [
        ctypes.c_longlong, _I, ctypes.c_double, ctypes.c_double] + [
        _I] * 3 + [_P]
    lib.esdg_cns_surface.restype = _I
    lib.esdg_becker_bisect.argtypes = [_I, _P, _P, ctypes.c_longlong] + [
        ctypes.c_double] * 7 + [_I, _P]
    lib.esdg_becker_bisect.restype = _I
    lib.esdg_lsrk45_update.argtypes = [_I, _I] + [_P] * 4 + [
        ctypes.c_longlong] + [ctypes.c_double] * 3 + [_P]
    lib.esdg_lsrk45_update.restype = _I
    lib.esdg_cns_tail.argtypes = [_I, _I, _P, ctypes.c_longlong, _P]
    lib.esdg_cns_tail.restype = _I
    lib.esdg_cns_tail_shape.argtypes = [_I, _I, _P]
    lib.esdg_cns_tail_shape.restype = _I
    lib.esdg_probe_peak.argtypes = [_P, _P, ctypes.c_longlong, _I, _P]
    lib.esdg_probe_peak.restype = _I
    lib.esdg_probe_chain.argtypes = [_I, _P, _P, ctypes.c_longlong, _I, _P]
    lib.esdg_probe_chain.restype = _I
    lib.esdg_fd_section.argtypes = [_I, _I, _I] + [_P] * 6 + [
        ctypes.c_longlong, ctypes.c_double, _P]
    lib.esdg_fd_section.restype = _I
    return lib


def pointer_array(tensors):
    """A host array of device pointers (void*[]) for a kernel's C entry;
    None stands for an argument the kernel does not read."""
    return (_P * len(tensors))(*[None if t is None else t.data_ptr()
                                 for t in tensors])


if __name__ == "__main__":
    # python -m esdg_cns_tpu_torch.kernels: times fresh builds of csrc/ with
    # one nvcc at a time (serial) and with all started together (the form
    # build() uses), alternating, into a scratch folder under build/.
    import json

    out = BUILD_DIR / "build_timing"
    out.mkdir(parents=True, exist_ok=True)
    n_src = len(list(CSRC_DIR.glob("*.cu")))
    try:
        for jobs in (1, n_src, n_src, 1):
            info = _compile(out / "libesdg_kernels.so", jobs)
            print(json.dumps({"nvcc_at_once": jobs, "sources": n_src,
                              "build_s": info.seconds}), flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)

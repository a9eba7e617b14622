"""Time K2's and the split projection's tiles against their neighbours.

    python -m esdg_cns_tpu_torch.probes.tiles

K2 (``csrc/hex_surface.cuh``) and the split path's projection (row 3,
``csrc/hex_project.cuh``) are templates on their tile: TE elements a
block, THREADS threads and MIN_BLOCKS under ``__launch_bounds__``
(``surface_tile``, ``project_tile`` pick one per type and N+1).  This
script builds each candidate tile of each case below as its own small
library (one nvcc per case, all started together, into
``build/tile_sweep/``), loads them with ctypes, holds every variant
against the plain version on seeded inputs at the paths' shapes (f32
1e-5, f64 1e-12 of max |plain|), and times them in turns with CUDA events,
the calls queued behind a sleeping kernel (median of REPS turns of 20
calls), beside the library's own choice.  Prints the card's name and
power limit, then one JSON line per variant: the case, the tile, its
device time, the blocks and warps resident an SM, registers and local
bytes.  Environment: REPS (default 5), CASES (comma-separated case names,
default all).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import time

import numpy as np

from .timing import card_label, env_int

# K2 cases: (name, dtype, N+1, K, diag, grid, split), the paths' forms at
# their shapes: the main path (N=3, k1d=32), its general and curved form
# (and both on gathered neighbour traces, the form of other meshes),
# the N=4 split modes (k1d=24), K1's N=5 (k1d=20) and N=6 (k1d=16), the N=7
# split path (k1d=16); f64 at N=3 and N=7
K2_CASES = (
    ("k2_n3", "float32", 4, 32768, True, True, False),
    ("k2_n3_general", "float32", 4, 32768, False, True, False),
    ("k2_n3_gathered", "float32", 4, 32768, True, False, False),
    ("k2_n3_general_gathered", "float32", 4, 32768, False, False, False),
    ("k2_n4_split", "float32", 5, 13824, True, True, True),
    ("k2_n5", "float32", 6, 8000, True, True, False),
    ("k2_n6", "float32", 7, 4096, True, True, False),
    ("k2_n7_split", "float32", 8, 4096, True, True, True),
    ("k2_n3_f64", "float64", 4, 32768, True, True, False),
    ("k2_n7_split_f64", "float64", 8, 4096, True, True, True),
)
# row 3 cases: (name, dtype, N+1, K)
PROJ_CASES = (
    ("proj_n4", "float32", 5, 13824),
    ("proj_n5", "float32", 6, 8000),
    ("proj_n6", "float32", 7, 4096),
    ("proj_n7", "float32", 8, 4096),
    ("proj_n7_f64", "float64", 8, 4096),
)
# candidate tiles (TE, THREADS, MIN_BLOCKS) per type
TILES = {
    "float32": ((4, 256, 2), (8, 128, 4), (8, 256, 2), (8, 256, 3),
                (8, 512, 1), (8, 512, 2), (16, 256, 2), (16, 512, 1),
                (16, 512, 2), (16, 1024, 1), (32, 256, 1), (32, 256, 2),
                (32, 512, 1), (32, 512, 2), (32, 1024, 1), (64, 512, 1)),
    "float64": ((2, 256, 2), (4, 128, 4), (4, 256, 1), (4, 256, 2),
                (4, 512, 1), (8, 256, 1), (8, 512, 1), (8, 512, 2),
                (8, 1024, 1), (16, 256, 1), (16, 512, 1), (16, 1024, 1)),
}
MAX_SMEM = 232448
TOL = {"float32": 1e-5, "float64": 1e-12}
SLEEP_CYCLES = 200_000_000


def _smem(kernel, dtype, n1, te):
    size = 4 if dtype == "float32" else 8
    pts = 6 * n1 * n1 if kernel == "k2" else n1 ** 3
    return 5 * pts * te * size


def _variants(kernel, dtype, n1):
    return [t for t in TILES[dtype]
            if t[1] % t[0] == 0 and _smem(kernel, dtype, n1, t[0]) <= MAX_SMEM]


def _source(case, kernel):
    """The C++ of one case: an entry v<i> per candidate tile."""
    ctype = {"float32": "float", "float64": "double"}[case[1]]
    n1 = case[2]
    lines = []
    if kernel == "k2":
        diag, grid, split = (str(b).lower() for b in case[4:7])
        lines.append('#include "hex_surface.cuh"')
        for i, (te, thr, mb) in enumerate(_variants(kernel, case[1], n1)):
            lines.append(
                f'extern "C" int v{i}(const void* const* p, const int* dims, '
                f"long long K, double gamma, int diss, void* st, int* occ) {{"
                f" return esdg::launch_surface_tile<{ctype}, {n1}, {diag}, "
                f"{grid}, {split}, {te}, {thr}, {mb}>(esdg::surface_args<"
                f"{ctype}>(p, dims), K, gamma, diss, (cudaStream_t)st, occ);"
                " }")
    else:
        lines.append('#include "hex_project.cuh"')
        for i, (te, thr, mb) in enumerate(_variants(kernel, case[1], n1)):
            lines.append(
                f'extern "C" int v{i}(const void* q, const void* ef, void* qh,'
                f" void* ql, void* tr, long long K, double gamma, void* st, "
                f"int* occ) {{ return esdg::launch_project_tile<{ctype}, {n1},"
                f" {te}, {thr}, {mb}>(q, ef, qh, ql, tr, K, gamma, "
                f"(cudaStream_t)st, occ); }}")
    return "\n".join(lines) + "\n"


def build_variants(cases):
    """{case name: (the loaded library, its tiles)}: one nvcc per case, all
    started together."""
    from ..kernels import ARCH_FLAGS, BUILD_DIR, CSRC_DIR, _nvcc

    out = BUILD_DIR.parent / "tile_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()

    def one(item):
        case, kernel = item
        src = out / f"{case[0]}.cu"
        lib = out / f"{case[0]}.so"
        src.write_text(_source(case, kernel))
        t = time.perf_counter()
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-shared", f"-I{CSRC_DIR}", "-o", str(lib), str(src)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
        return case[0], lib, time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        built = list(pool.map(one, cases))
    libs = {}
    for (case, kernel), (name, path, sec) in zip(cases, built):
        libs[name] = (ctypes.CDLL(str(path)),
                      _variants(kernel, case[1], case[2]), sec)
    return libs


def _timed(calls, reps):
    """Median per-call device ms of each call, timed in turns."""
    import torch

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in calls]
    for _ in range(reps):
        for j, fn in enumerate(calls):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(20):
                fn()
            stop.record()
            torch.cuda.synchronize()
            times[j].append(start.elapsed_time(stop) / 20)
    return [statistics.median(t) for t in times]


def _shape(fn):
    occ = (ctypes.c_int * 7)()
    rc = fn(occ)
    if rc != 0:
        raise RuntimeError(f"shape query failed ({rc})")
    return tuple(occ)


def _k2_inputs(case, dev):
    """Seeded K2 inputs at the case's shape: traces by the plain projection
    of a moving state, a random normal, random split parts or ph_qf."""
    import torch

    from ..core.discretization import grid_neighbours
    from ..ops import fused_volume as fv
    from ..physics import primitive_to_conservative
    from ..presets import euler_hex_3d

    name, dtype, n1, k, diag, grid, split = case
    dt = getattr(torch, dtype)
    disc, _ = euler_hex_3d(n=n1 - 1, k1d=2, dtype=dt, device=dev)
    rng = np.random.default_rng(n1)
    nq, nfp = n1 ** 3, n1 * n1
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    q = primitive_to_conservative(t(2 + 0.1 * rng.random((nq, k))),
                                  t(0.3 * rng.standard_normal((3, nq, k))),
                                  t(2 + 0.1 * rng.random((nq, k))))
    _, _, traces = fv.hex_project_plain(q, disc.vhp[nq:], 1.4)
    k1d = round(k ** (1 / 3))
    if diag:
        nxj = t(rng.uniform(0.5, 1.5, (1, 6 * nfp, k))
                * rng.choice([-1.0, 1.0], (1, 6 * nfp, k)))
        sj = inv_sj = None
        inv_jac = t(rng.uniform(0.5, 2.0, (1, k)))
    else:
        nxj = t(rng.standard_normal((3, 6 * nfp, k)))
        sj = nxj.norm(dim=0)
        inv_sj = 1.0 / sj
        inv_jac = t(rng.uniform(0.5, 2.0, (nq, k)))
    parts = ph_qf = None
    if split:
        parts = [t(rng.standard_normal((5, nq + 2 * nfp, k)))
                 for _ in range(3)]
    else:
        ph_qf = t(rng.standard_normal((5, nq, k)))
    nbr = None if grid else grid_neighbours(traces, (k1d,) * 3)
    args = (traces, nbr, nxj, sj, inv_sj, inv_jac, disc.lift, ph_qf, 1.4)
    kw = dict(dissipation=True, diag=diag, grid=(k1d,) * 3 if grid else None,
              parts=parts, line_ops=disc.line_ops)
    return args, kw


def _k2_case(case, lib, tiles, dev):
    import torch

    from ..kernels import pointer_array
    from ..ops import fused_volume as fv

    args, kw = _k2_inputs(case, dev)
    traces, nbr, nxj, sj, inv_sj, inv_jac, lift, ph_qf, gamma = args
    n1, k = case[2], case[3]
    out = torch.empty((5, n1 ** 3, k), dtype=traces.dtype, device=dev)
    iw, iwf = fv._volume_consts(kw["line_ops"], traces.dtype, dev)[2:]
    parts = kw["parts"] or [None] * 3
    ptrs = pointer_array([traces, nbr, nxj, sj, inv_sj, inv_jac, lift,
                          ph_qf, *parts, iw if kw["parts"] else None,
                          iwf if kw["parts"] else None, out])
    dims = (ctypes.c_int * 3)(*(kw["grid"] or (0, 0, 0)))
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    plain = fv.euler_surface_plain(*args, **kw)
    scale = float(plain.abs().max())
    calls, shapes, errs = [], [], []
    for i, _ in enumerate(tiles):
        fn = getattr(lib, f"v{i}")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                               ctypes.c_double, ctypes.c_int,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p]
        call = (lambda fn=fn: fn(ptrs, dims, k, 1.4, 1, stream(), None))
        rc = call()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{case[0]} tile {tiles[i]}: launch {rc}")
        errs.append(float((out - plain).abs().max()) / scale)
        calls.append(call)
        shapes.append(_shape(lambda occ, fn=fn: fn(None, None, 0, 1.4, 1,
                                                   None, occ)))
    calls.append(lambda: fv.euler_surface(*args, **kw))
    got = fv.euler_surface(*args, **kw)
    errs.append(float((got - plain).abs().max()) / scale)
    shapes.append(fv.euler_surface_shape(traces.dtype, n1, diag=case[4],
                                         grid=case[5], split=case[6]))
    return calls, shapes, errs


def _proj_case(case, lib, tiles, dev):
    import torch

    from ..ops import fused_volume as fv
    from ..physics import primitive_to_conservative
    from ..presets import euler_hex_3d

    name, dtype, n1, k = case
    dt = getattr(torch, dtype)
    disc, _ = euler_hex_3d(n=n1 - 1, k1d=2, dtype=dt, device=dev)
    rng = np.random.default_rng(n1)
    nq, nfq = n1 ** 3, 6 * n1 * n1
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    q = primitive_to_conservative(t(2 + 0.1 * rng.random((nq, k))),
                                  t(0.3 * rng.standard_normal((3, nq, k))),
                                  t(2 + 0.1 * rng.random((nq, k))))
    ef = disc.vhp[nq:].contiguous()
    plain = fv.hex_project_plain(q, ef, 1.4)
    outs = [torch.empty_like(a) for a in plain]
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    calls, shapes, errs = [], [], []
    for i, _ in enumerate(tiles):
        fn = getattr(lib, f"v{i}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_double,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p]
        call = (lambda fn=fn: fn(q.data_ptr(), ef.data_ptr(),
                                 *[a.data_ptr() for a in outs], k, 1.4,
                                 stream(), None))
        rc = call()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{case[0]} tile {tiles[i]}: launch {rc}")
        errs.append(max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(outs, plain)))
        calls.append(call)
        shapes.append(_shape(lambda occ, fn=fn: fn(None, None, None, None,
                                                   None, 0, 1.4, None, occ)))
    calls.append(lambda: fv.hex_project(q, ef, 1.4))
    got = fv.hex_project(q, ef, 1.4)
    errs.append(max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(got, plain)))
    shapes.append(fv.hex_project_shape(dt, n1))
    return calls, shapes, errs


def main():
    import torch

    from ..kernels import build, library
    from .timing import require_cuda

    dev = require_cuda("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_label(), flush=True)
    reps = env_int("REPS", 5)
    wanted = os.environ.get("CASES")
    cases = [(c, "k2") for c in K2_CASES] + [(c, "proj") for c in PROJ_CASES]
    if wanted:
        keep = set(wanted.split(","))
        cases = [c for c in cases if c[0][0] in keep]
    info = build()
    library()
    print(json.dumps({"library_build_s": round(info.seconds, 1),
                      "nvcc_s": info.source_seconds()}), flush=True)
    t0 = time.perf_counter()
    libs = build_variants(cases)
    print(json.dumps({"sweep_build_s": round(time.perf_counter() - t0, 1),
                      "nvcc_s": {n: round(v[2], 1) for n, v in libs.items()}}),
          flush=True)
    bad = []
    for case, kernel in cases:
        lib, tiles, _ = libs[case[0]]
        run = _k2_case if kernel == "k2" else _proj_case
        calls, shapes, errs = run(case, lib, tiles, dev)
        times = _timed(calls, reps)
        for tile, ms, occ, err in zip([*tiles, "library"], times, shapes,
                                      errs):
            row = {"case": case[0], "dtype": case[1], "n1": case[2],
                   "K": case[3], "tile": list(tile) if tile != "library"
                   else [occ[5], occ[1], None], "library": tile == "library",
                   "ms": round(ms, 5), "blocks_per_sm": occ[0],
                   "warps_per_sm": occ[0] * occ[1] // 32, "regs": occ[3],
                   "local_bytes": occ[4], "rel_err": err}
            print(json.dumps(row), flush=True)
            if not err <= TOL[case[1]]:
                bad.append((case[0], tile, err))
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"variants disagree with the plain version: "
                             f"{bad}")


if __name__ == "__main__":
    main()

"""Time K2's, the split projection's and the split fd's tiles against
their neighbours.

    python -m esdg_cns_tpu_torch.probes.tiles

K2 (``csrc/hex_surface.cuh``), the split path's projection (row 3,
``csrc/hex_project.cuh``) and its per-direction fd (rows 4a, 4b,
``csrc/hex_split.cuh``) are templates on their tile: TE elements a
block, THREADS threads and MIN_BLOCKS under ``__launch_bounds__``
(``surface_tile``, ``project_tile`` pick one per type and N+1); the
fd's tile is (mode, TE, LINES, MIN_BLOCKS) (``fd_tile``, per type and
N+1): the mode spreads a line's pairs over its nodes' threads
(``pairs``) or runs one thread a line, its points in shared memory
(``staged``).  This script builds each candidate tile of each case below
as its own small library (one nvcc per case, all started together, into
``build/tile_sweep/``), loads them with ctypes, holds every variant
against the plain version on seeded inputs at the paths' shapes (f32
1e-5, f64 1e-12 of max |plain|), and times them in turns with CUDA
events, the calls queued behind a sleeping kernel (median of REPS turns
of 20 calls), beside the library's own choice (the fd: each direction
on its own; the mean of the three is its time).  With PARENT, a checkout
of an earlier tree, the fd cases time that tree's own ``hex_fd_dir``
(built from its sources into its own build folder) in the same turns,
with the registers and local bytes its build log reports.  Prints the
card's name and power limit, then one JSON line per variant: the case,
the tile, its device time, the blocks and warps resident an SM,
registers and local bytes.
Environment: REPS (default 5), ROUNDS (sweeps of every case, default 1),
CASES (comma-separated case names, default all), PARENT (a directory).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import re
import statistics
import subprocess
import time

import numpy as np

from .timing import card_label, env_int, load_parent

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
# split fd cases: (name, dtype, N+1, K, form), form "diag", "general" or
# "dense" (hex_fd_dir_dense: the general kernel, held against the dense
# plain version): the 'split' modes at N=4..6 (k1d=24, 20, 16; at N=5 the
# general form too) and the N=7 path (k1d=16), its general and dense
# forms, f64 at N=7
FD_CASES = (
    ("fd_n4", "float32", 5, 13824, "diag"),
    ("fd_n5", "float32", 6, 8000, "diag"),
    ("fd_n5_general", "float32", 6, 8000, "general"),
    ("fd_n6", "float32", 7, 4096, "diag"),
    ("fd_n7", "float32", 8, 4096, "diag"),
    ("fd_n7_general", "float32", 8, 4096, "general"),
    ("fd_n4_dense", "float32", 5, 13824, "dense"),
    ("fd_n7_dense", "float32", 8, 4096, "dense"),
    ("fd_n7_f64", "float64", 8, 4096, "diag"),
)
FD_MODES = {"pairs": 0, "staged": 1}
# the one-thread-a-line candidates (TE, LINES, MIN_BLOCKS), where their
# points fit in shared memory
FD_STAGED_TILES = ((32, 8, 1), (32, 8, 2), (32, 4, 3), (32, 4, 4),
                   (32, 4, 5), (32, 4, 6))
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


def _fd_smem(mode, dtype, n1, te, lines):
    """The split fd tile's shared memory bytes (``FdLayout``)."""
    size = 4 if dtype == "float32" else 8
    pts = 7 * (n1 + 2) * lines * te
    return size * (pts + 20 * n1 * lines * te if mode == "pairs" else pts)


def _fd_variants(dtype, n1):
    """The split fd's candidate tiles (mode, TE, LINES, MIN_BLOCKS) at one
    type and N+1: the pairs tiles of 16 or 32 elements and one or two
    lines (at most 5% of the last block's lines idle), with MIN_BLOCKS for
    register caps (65536 over the threads an SM) near 64 and 96 in f32,
    96 and 128 in f64; the one-thread-a-line tiles, their points in
    shared memory, where they fit."""
    caps = (64, 96) if dtype == "float32" else (96, 128)
    nfp = n1 * n1
    room = lambda mode, te, lines, mb: (
        _fd_smem(mode, dtype, n1, te, lines) * mb <= 228 * 1024 - 1024 * mb)
    out = []
    for te in (32, 16):
        for lines in (1, 2):
            threads = te * lines * n1
            idle = -(-nfp // lines) * lines - nfp
            if threads > 1024 or threads % 32 or idle > 0.05 * nfp:
                continue
            for cap in caps:
                mb = max(1, round(65536 / (threads * cap)))
                tile = ("pairs", te, lines, mb)
                if threads * mb <= 2048 and room(*tile) and tile not in out:
                    out.append(tile)
    out += [("staged", *t) for t in FD_STAGED_TILES if room("staged", *t)]
    return out


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
    elif kernel == "fd":
        lines.append('#include "hex_split.cuh"')
        diag = str(case[4] == "diag").lower()
        for i, (mode, te, nl, mb) in enumerate(_fd_variants(case[1], n1)):
            for d in range(3):
                lines.append(
                    f'extern "C" int v{i}_{d}(const void* qh, const void* '
                    f"ql, const void* geo, const void* cv, const void* cf, "
                    f"void* out, long long K, double gamma, void* st, int* "
                    f"occ) {{ return esdg::launch_fd_dir_tile<{ctype}, {n1},"
                    f" {d}, {diag}, {FD_MODES[mode]}, {te}, {nl}, {mb}>("
                    f"qh, ql, geo, cv, cf, out, K, gamma, "
                    f"(cudaStream_t)st, occ); }}")
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
        tiles = (_fd_variants(case[1], case[2]) if kernel == "fd"
                 else _variants(kernel, case[1], case[2]))
        libs[name] = (ctypes.CDLL(str(path)), tiles, sec)
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


def _ptxas(log, prefix):
    """{template arguments: (registers, spill-store bytes)} of the kernels
    in an nvcc log (``-Xptxas -v``) whose mangled names start with
    ``prefix``."""
    out = {}
    for name, body in re.findall(r"Compiling entry function '([^']+)'"
                                 r"(.*?)(?=Compiling entry function|\Z)",
                                 log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        if name.startswith(prefix) and regs:
            out[name[len(prefix):].split("EEEv")[0]] = (
                int(regs.group(1)), int(spill.group(1)) if spill else None)
    return out


def _fd_case(case, lib, tiles, dev, parent=None):
    """The split fd at the case's path: the mesh at k1d = K^(1/3), a moving
    state's flux variables, the mesh's metric (diag, dense) or a random
    affine one (general); each variant's three directions, each its own
    call, held against the plain version; then the library's choice and,
    with ``parent`` (an earlier tree's ``ops.fused_volume``), that tree's
    ``hex_fd_dir``.  Returns per variant the three calls, its shape and
    its error."""
    import torch

    from ..ops import fused_volume as fv
    from ..physics import primitive_to_conservative
    from ..presets import euler_hex_3d

    name, dtype, n1, k, form = case
    dt = getattr(torch, dtype)
    disc, _ = euler_hex_3d(n=n1 - 1, k1d=round(k ** (1 / 3)), dtype=dt,
                           device=dev)
    rng = np.random.default_rng(n1)
    sh = (disc.np_, k)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    q = primitive_to_conservative(t(2 + 0.1 * rng.random(sh)),
                                  t(0.3 * rng.standard_normal((3, *sh))),
                                  t(2 + 0.1 * rng.random(sh)))
    qh, qlog, _ = fv.hex_project_plain(q, disc.vhp[disc.nq:], 1.4)
    geo = (t(rng.uniform(0.5, 1.5, (9, 1, k))) if form == "general"
           else disc.geo)
    lo = disc.line_ops
    cvol, cface = fv._volume_consts(lo, dt, dev)[:2]

    def wrapper(mod):
        """The three directions through a tree's public wrapper."""
        if form == "dense":
            return [lambda d=d: mod.hex_fd_dir_dense(qh, qlog, geo, 1.4,
                                                     line_ops=lo, d=d)
                    for d in range(3)]
        return [lambda d=d: mod.hex_fd_dir(qh, qlog, geo, 1.4, line_ops=lo,
                                           d=d, diag=form == "diag")
                for d in range(3)]

    plains = [fv.hex_fd_dir_dense_plain(qh, qlog, geo, 1.4, line_ops=lo,
                                        d=d) if form == "dense" else
              fv.hex_fd_dir_plain(qh, qlog, geo, 1.4, line_ops=lo, d=d,
                                  diag=form == "diag") for d in range(3)]
    outs = [torch.empty_like(p) for p in plains]
    rel = lambda got: max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(got, plains))
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [a.data_ptr() for a in (qh, qlog, geo, cvol, cface)]
    calls, shapes, errs = [], [], []
    for i, _ in enumerate(tiles):
        fns = [getattr(lib, f"v{i}_{d}") for d in range(3)]
        for fn in fns:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                   ctypes.c_double,
                                                   ctypes.c_void_p,
                                                   ctypes.c_void_p]

        def call(fn, out, tile=tiles[i]):
            rc = fn(*ptrs, out.data_ptr(), k, 1.4, stream(), None)
            if rc != 0:
                raise RuntimeError(f"{name} tile {tile}: launch {rc}")
        for out in outs:
            out.fill_(float("nan"))
        for fn, out in zip(fns, outs):
            call(fn, out)
        torch.cuda.synchronize()
        errs.append(rel(outs))
        calls.append([lambda fn=fn, out=out: call(fn, out)
                      for fn, out in zip(fns, outs)])
        shapes.append(_shape(lambda occ, fn=fns[0]: fn(*[None] * 6, 0, 1.4,
                                                       None, occ)))
    for mod in (fv, parent):
        if mod is None:
            continue
        three = wrapper(mod)
        calls.append(three)
        errs.append(rel([f() for f in three]))
        shapes.append(fv.hex_fd_dir_shape(dt, n1, diag=form == "diag")
                      if mod is fv else None)
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
    cases = ([(c, "k2") for c in K2_CASES] + [(c, "proj") for c in PROJ_CASES]
             + [(c, "fd") for c in FD_CASES])
    if wanted:
        keep = set(wanted.split(","))
        cases = [c for c in cases if c[0][0] in keep]
    info = build()
    library()
    print(json.dumps({"library_build_s": round(info.seconds, 1),
                      "nvcc_s": info.source_seconds()}), flush=True)
    parent = ptxas = None
    if os.environ.get("PARENT") and any(c[1] == "fd" for c in cases):
        par = load_parent(os.environ["PARENT"])
        pinfo = par("kernels").build()
        par("kernels").library()
        parent, ptxas = par("ops.fused_volume"), pinfo.log
        print(json.dumps({"parent": os.environ["PARENT"],
                          "parent_build_s": round(pinfo.seconds, 1)}),
              flush=True)
    t0 = time.perf_counter()
    libs = build_variants(cases)
    print(json.dumps({"sweep_build_s": round(time.perf_counter() - t0, 1),
                      "nvcc_s": {n: round(v[2], 1) for n, v in libs.items()}}),
          flush=True)
    bad = []
    for rnd, (case, kernel) in ((r, c) for r in range(env_int("ROUNDS", 1))
                                for c in cases):
        lib, tiles, _ = libs[case[0]]
        labels = [*tiles, "library"]
        if kernel == "fd":
            calls, shapes, errs = _fd_case(case, lib, tiles, dev, parent)
            flat = _timed([f for three in calls for f in three], reps)
            dirs = [flat[i:i + 3] for i in range(0, len(flat), 3)]
            times = [statistics.mean(d) for d in dirs]
            labels += ["parent"] if parent is not None else []
        else:
            run = _k2_case if kernel == "k2" else _proj_case
            calls, shapes, errs = run(case, lib, tiles, dev)
            times, dirs = _timed(calls, reps), [None] * len(calls)
        for tile, ms, ms3, occ, err in zip(labels, times, dirs, shapes, errs):
            row = {"case": case[0], "dtype": case[1], "n1": case[2],
                   "K": case[3], "round": rnd, "tile": tile,
                   "library": tile == "library", "ms": round(ms, 5),
                   "rel_err": err}
            if ms3 is not None:
                row["ms_dirs"] = [round(x, 5) for x in ms3]
            if tile == "library":
                row["tile"] = [occ[5], occ[1], None]
            if occ is not None:
                row.update(blocks_per_sm=occ[0],
                           warps_per_sm=occ[0] * occ[1] // 32,
                           regs=occ[3], local_bytes=occ[4])
            else:   # the parent's: its build log's report, every form
                t = "f" if case[1] == "float32" else "d"
                row["ptxas"] = _ptxas(
                    ptxas, f"_ZN4esdg17hex_fd_dir_kernelI{t}Li{case[2]}ELi0E")
            print(json.dumps(row), flush=True)
            if not err <= TOL[case[1]]:
                bad.append((case[0], tile, err))
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"variants disagree with the plain version: "
                             f"{bad}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: the card's name and power limit (nvidia-smi) and the TF32
     switches, which stay off;
  2. build: nvcc builds esdg_cns_tpu_torch/csrc/*.cu for sm_90a; prints the
     build time and ptxas' register/spill report of the N=3 hex kernels and
     of the tri kernels;
  3. Euler kernels: K1 (euler_volume) and K2 (euler_surface) against their
     plain PyTorch versions on the card, at the main-path shapes (N=3,
     k1d=32, f32, axis-aligned) and at N=3, k1d=8 in f64 (axis-aligned and
     general); the general variant also on a seeded random non-diagonal
     affine metric (k1d=32 f32, k1d=8 f64), where no cross term is an exact
     zero;
  4. Euler path: presets.euler_hex_3d(3, 32, f32) -> make_euler_rhs_fused ->
     lsrk45 for 20 steps with every launch counter at 0 before; checks the
     state is finite, each kernel launched once per stage, the state agrees
     with the plain twin make_euler_rhs(flux_diff_impl='lines') run from the
     same q0, and sum(wJq q) per field is conserved; then an f64 k1d=4
     entropy-conservation check (dissipation off) on the kernel path;
  5. Euler timing with CUDA events (medians of 5 repeats after warm-up): the
     rate in DOF*RK-stage/s (5 Np K stages / s, bench.py's definition) over
     1200 stages, the twin's rate over fewer stages, and per-kernel device
     times beside the plain versions; then torch.profiler over 20 stages:
     device time by kernel and the device's busy share;
  6. cavity kernels: K3 (euler_modal_volume) and K4 (cns_surface_viscous,
     both fold_tail forms) against their plain versions on seeded moving
     states (esdg_cns_tpu_torch.cavity_cases: velocity of standard
     deviation 0.3, so no velocity term multiplies zeros) at the cavity's
     shapes (tri N=3, k1d=128, f32, isothermal walls), and at k1d=8 in f64
     for every BC shape (isothermal, adiabatic, slip, an array lid profile,
     a Dirichlet region of seeded states, no BC, and all four kinds with
     array wall speeds and temperatures), and at k1d=5 (K=50, a ragged
     last tile);
  7. cavity path: presets.lid_driven_cavity(3, 128, f32) ->
     make_cns_rhs_affine (bench.py's flags) -> lsrk45 for 20 steps at
     dt=1e-4 with every launch counter at 0 before; checks K3 and K4
     launched once per stage, the state is finite f32, agrees with the twin
     make_cns_rhs run from the same q0, and conserves mass; then an f64
     k1d=8 entropy check (adiabatic walls at rest, rhstest on) on the kernel
     path;
  8. cavity timing: the rate in DOF*RK-stage/s (4 Np K stages / s,
     bench.py's cns definition) over 1200 stages at dt=1e-6, the twin's
     rate, K3 and K4 beside their plain versions, the two exchanges, the
     rest of the stage, and the profiler's split as in phase 5;
  9. 3D cavity kernels: K1 (in this use), K4 at dim=3 (both fold_tail
     forms), K8 (cns_surface) and K7 (cns_viscous) against their plain
     versions on the 3D cavity's moving states (hex N=3, k1d=16, f32,
     isothermal), at k1d=4 in f64 for every BC shape, and at k1d=3 (K=27, a
     ragged last tile); K8 and K7 also over the 2D cases of phase 6;
 10. 3D cavity path: presets.lid_driven_cavity_3d(3, 16, f32) ->
     make_cns_rhs_affine(volume_impl='fused_hex', bench.py's flags) ->
     lsrk45 for 20 steps at dt=1e-4 with every launch counter at 0 before;
     checks K1 and K4 launched once per stage, the state is finite f32 and
     agrees with the twin make_cns_rhs; the f64 kernel path conserves mass
     over 20 steps; an f64 k1d=4 entropy check (adiabatic walls, the lid at
     rest, rhstest on);
 11. 3D cavity timing, as phase 8: the rate over 1200 stages, the twin's,
     K1 and K4 beside their plain versions, the exchanges, the profiler;
 12. the split path on both cavities at full width: surface_impl='fused'
     (K3 or K1, then K8, then K7) against merged_tail on one RHS (f32, and
     f64 at k1d=8 / k1d=4), 20 steps with every counter at 0 before (K8
     and K7 launched once per stage), the rate over 1200 stages, and K8
     and K7 beside their plain versions.
A kernel's time is its device time: the timed calls are queued behind a
sleeping kernel, so the host's dispatch does not enter it.
The line before the last is {"kernels": [...]} with each kernel's bound
(the larger of its bytes over 3.35 TB/s and its operations over 67
TFLOP/s, from this run's shapes); the last line is {"ok": true,
"device": {...}}.  Without a CUDA device it exits non-zero and prints no
result: there is no CPU path.
"""

import json
import statistics
import subprocess
import sys
import time

# the Euler path: N=3, k1d=32 (K=32768, 10.5M DOF), f32
N, K1D, STEPS, DT = 3, 32, 20, 1e-3
TIMED_STEPS, TWIN_TIMED_STEPS, REPEATS = 240, 5, 5
# the cavity path: tri N=3, k1d=128 (K=32768, 1.31M DOF), f32
CAV_N, CAV_K1D, CAV_STEPS, CAV_DT = 3, 128, 20, 1e-4
CAV_TIMED_DT = 1e-6        # timing run, as bench.py's
# the 3D cavity path: hex N=3, k1d=16 (K=4096, 1.31M DOF), f32; the same
# steps and time steps as the 2D cavity
CAV3_N, CAV3_K1D = 3, 16
# kernel vs plain, max |kernel - plain| / max |plain|: the kernels sum in
# another order than the plain version and contract multiply-adds into
# FMAs, and libdevice's log/exp/pow differ from PyTorch's by an ulp or two
TOL = {"float32": 1e-5, "float64": 1e-12}
# after 20 steps (100 stages), max |fused - twin| / max |twin| in f32:
# per-stage RHS differences of ~1e-6 relative, times dt, over 100 stages
TWIN_TOL_F32 = 1e-5
# |change of sum(wJq q_f)| over 20 steps / sum(wJq rho), f32 state updates:
# the runs read <= 1.9e-10 (roundoff of the f32 updates); the limit leaves
# a factor 50 and fails a leak of 1e-10 per stage over the 100 stages
CONSERVATION_TOL_F32 = 1e-8
# f64 entropy balance with dissipation off (k1d=4)
RHSTEST_TOL_F64 = 1e-10
# the split path (K8 then K7) against the merged kernel (K4) on one RHS,
# max |split - merged| / max |merged|: the same arithmetic in two kernels
SPLIT_TOL = {"float32": 1e-5, "float64": 1e-12}
# cavity mass, |change of sum(wJq rho)| / sum(wJq rho) over 20 steps.  The
# walls carry no mass flux and rho+ = rho- on them, so the RHS conserves
# mass to roundoff: in f64 (the kernel path at k1d=128) the drift must
# stay at roundoff.  In f32 the state starts at rest and most nodes get
# increments below half an ulp of rho, which round away coherently (4.3e-8
# at k1d=128 on an H100; the f32 twin's drift is printed beside it), so the
# f32 limit lies between that reading and the coherent worst case of 100
# stages x 2^-24: 100 times looser than the 1e-8 first asked of f32, which
# the f64 limit carries instead.
CAV_MASS_TOL_F64 = 1e-12
CAV_MASS_TOL_F32 = 1e-6
# device-only timing: the stream sleeps this many cycles (about 0.1 s at
# the H100's clock) while the host queues the timed calls behind it
SLEEP_CYCLES = 200_000_000
# the card's published peaks (H100 SXM data sheet): HBM bytes/s and FP32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b):
    """(max|a - b| / max|b|, max|a - b|)."""
    d = float((a - b).abs().max())
    return d / float(b.abs().max()), d


def cuda_ms(fn, n_calls, repeats=REPEATS, device_only=False):
    """Median over repeats of the mean per-call time of fn, CUDA events.

    device_only: queue the calls behind a sleeping kernel, so the events
    bracket the device's work alone and not the host's dispatch."""
    import torch

    fn()   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n_calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n_calls)
    return statistics.median(times)


def device_profile(fn, stages):
    """torch.profiler (CUDA activity) over one call of fn: (device busy
    ms, window ms from the first kernel's start to the last one's end,
    [(kernel, device ms)] by total time), per stage; None when the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    by_name = {}
    for e in evs:
        name = e.name.split("(")[0].replace("void ", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return (busy / 1e3 / stages, window / 1e3 / stages,
            [(n, us / 1e3 / stages) for n, us in top])


def print_profile(card, label, prof):
    if prof is None:
        print(f"[{card}] {label} profile: not measured (the profiler "
              "recorded no device activity)")
        return
    busy, window, top = prof
    print(f"[{card}] {label} profile (torch.profiler, 20 stages): device "
          f"busy {busy:.4f} of {window:.4f} ms/stage ({busy / window:.1%})")
    for name, ms in top[:8]:
        print(f"    {ms:.4f} ms/stage  {name}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM peak and
    operations over the FP32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operations per element, counted by hand from the sources at the shapes
# they are given: an FMA is two operations, a division, log, exp, pow or
# sqrt one (so the bound is a floor); dense products as written; each
# two-point flux pair counted ONCE (the triangular form, the least work).
# Pair costs: the 3D EC pair with one metric direction (diag) 74, the 2D
# EC pair with both directions, the metric contraction and both rows'
# accumulation 85.
def ops_k1(n1):
    nq, nfq = n1 ** 3, 6 * n1 * n1
    pairs = 3 * n1 * n1 * (n1 * (n1 - 1) // 2 + 2 * n1)
    return (27 * nq + 2 * nfq * nq * 5 + 40 * nfq + 74 * pairs + 5 * nfq
            + 2 * nq * nfq * 5 + 15 * nq)


def ops_k2(n1):
    nq, nfq = n1 ** 3, 6 * n1 * n1
    return 120 * nfq + 2 * nq * nfq * 5 + 15 * nq


def ops_k3(np_, nq, nh):
    pairs = nq * (nq - 1) // 2 + nq * (nh - nq)
    return (2 * nq * np_ * 4 + 20 * nq + 2 * nh * nq * 4 + 40 * nh
            + 85 * pairs + 2 * np_ * nh * 4 + 4 * np_)


def ops_face(dim, rebuild_local):
    """One face node of the CNS surface stage: the traces rebuilt (the
    neighbour's conservative and entropy ones, with rebuild_local the
    local ones too), the BC ghosts and ghost logs, the EC pair and its dim
    directions contracted with the normal, LF, the entropy BC, the jump and
    the penalty rows."""
    nf = dim + 2
    cons, evars = 3 * dim + 4, 3 * dim + 7
    rebuild = cons + evars + (cons + evars if rebuild_local else 0)
    ghosts = 4 * dim + 2 + 3 * dim
    pair = 34 + 4 * dim + dim * (2 * dim + 2 + 2 * nf)
    lf = 4 * dim + 19 + 3 * nf
    return rebuild + ghosts + pair + lf + nf + 4 * dim + 6 + nf


def ops_visc(dim, np_, nq, nfq, proj):
    """One element of the viscous mid-section, each contraction formed
    once (the kernels repeat some per node; the bound counts what the
    function needs): the front product; the surface gradient term
    (0.5·dv·nxj once per face node, then its lift); per quadrature node
    the gradients, K(v) (83 operations in 2D, 190 in 3D) and the
    production; the contracted traction; the divergence (g_r = Σ_x
    geo[r,x]·σ_x once per node, then the D_r Pq products)."""
    nf = dim + 2
    sigma = 83 if dim == 2 else 190
    front = 2 * (proj + dim) * nq * nq * nf
    surface = 2 * dim * nq * nfq * nf + nfq * nf * (1 + dim)
    node = nf * dim * (2 * dim + 1) + sigma + 3 * dim * nf
    traction = nfq * (2 * dim * nf * nq + 2 * dim * nf)
    div = dim * nq * nf * (2 * dim - 1) + 2 * dim * np_ * nq * nf
    return front + surface + nq * node + traction + div


def ops_k4(dim, np_, nq, nfq, proj):
    """The tail-folded form (merged_tail), as the cavity paths run it."""
    fold = (4 * (dim + 2) * nfq + 6 * (dim + 2)) * np_   # LIFTs, assembly
    return (nfq * ops_face(dim, True) + ops_visc(dim, np_, nq, nfq, proj)
            + fold)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from esdg_cns_tpu_torch import kernels
    from esdg_cns_tpu_torch.ops import cns_surface as cs
    from esdg_cns_tpu_torch.ops import fused_volume as fv
    from esdg_cns_tpu_torch.ops import modal_volume as mv
    from esdg_cns_tpu_torch.ops import surface_viscous as sv
    from esdg_cns_tpu_torch.presets import (euler_hex_3d, lid_driven_cavity,
                                            lid_driven_cavity_3d)
    from esdg_cns_tpu_torch.solvers import (make_cns_rhs, make_cns_rhs_affine,
                                            make_euler_rhs,
                                            make_euler_rhs_fused)
    from esdg_cns_tpu_torch.timestepping import lsrk45
    # the cavity BC shapes, moving states and the kernels' arguments,
    # shared with tests/test_torch_gpu.py
    from esdg_cns_tpu_torch.cavity_cases import (CAVITY_BCS, VELOCITY,
                                                 cavity_case, k4_inputs,
                                                 k7_inputs, k8_inputs)

    wrappers = {"euler_volume": fv.euler_volume,
                "euler_surface": fv.euler_surface,
                "euler_modal_volume": mv.euler_modal_volume,
                "cns_surface_viscous": sv.cns_surface_viscous,
                "cns_surface": cs.cns_surface,
                "cns_viscous": sv.cns_viscous}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {name: w.launches for name, w in wrappers.items()}

    # ---- 1. device ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    dev = torch.device("cuda", 0)
    print(card)   # name, power limit — as nvidia-smi gives them
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ----
    info = kernels.build()
    kernels.library()
    print(f"build: {info.seconds:.1f} s -> {info.path.name}")
    entry = None
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            entry = line
            continue
        if not entry or not ("registers" in line or "spill" in line):
            continue
        report = line.split("ptxas info    :")[-1].strip()
        name = entry.split("'")[1] if "'" in entry else entry
        if "Li4E" in name:
            kind = "volume" if "volume" in name else "surface"
            variant = ("f64" if "Id" in name.split("kernel")[1][:3]
                       else "f32") + (" diag" if "Lb1E" in name
                                      else " general")
            print(f"ptxas N=3 {kind} {variant}: {report}")
        elif "tri_modal_volume" in name or "cns_" in name:
            kind = next(k for k in ("tri_modal_volume", "cns_surface_viscous",
                                    "cns_surface", "cns_viscous")
                        if k in name)
            form = name.split("kernel")[1]
            prec = "f64" if form.startswith("Id") else "f32"
            dim = "" if kind == "tri_modal_volume" else (
                " 3D" if "Li3E" in form else " 2D")
            print(f"ptxas {kind}{dim} {prec}: {report}")

    gamma = 1.4

    def random_affine(disc, seed=11):
        """Seeded non-diagonal affine geometry: geo [9, 1, K] with all nine
        entries O(1), nxj [3, Nfq, K] with sj = |nxj| and inv_sj = 1/sj,
        and inv_jac [Nq, K] varying per node."""
        rng = np.random.default_rng(seed)
        k = disc.num_elements
        geo = (rng.uniform(0.5, 1.5, (9, 1, k))
               * rng.choice([-1.0, 1.0], (9, 1, k)))
        nxj = rng.standard_normal((3, disc.nfq, k))
        sj = np.sqrt((nxj ** 2).sum(axis=0))
        inv_jac = rng.uniform(0.5, 2.0, (disc.nq, k))
        t = lambda a: torch.as_tensor(a, dtype=disc.wq.dtype, device=dev)
        return t(geo), t(nxj), t(sj), t(1.0 / sj), t(inv_jac)

    def check_kernels(disc, q, diag, tag, geom=None):
        dtype = str(q.dtype).replace("torch.", "")
        tol = TOL[dtype]
        ef = disc.vhp[disc.nq:]
        if geom is not None:
            geo, nxj, sj, inv_sj, inv_jac = geom
        elif diag:
            geo, sj, inv_sj = disc.geo, disc.sj, disc.inv_sj
            nxj = (disc.nxj[0] + disc.nxj[1] + disc.nxj[2])[None]
            inv_jac = disc.inv_jac[:1]
        else:
            geo, sj, inv_sj = disc.geo, disc.sj, disc.inv_sj
            nxj, inv_jac = torch.stack(disc.nxj), disc.inv_jac
        vargs = (q, geo, ef, disc.lift, gamma)
        vkw = dict(line_ops=disc.line_ops, diag=diag)
        p_out, p_tr = fv.euler_volume_plain(*vargs, **vkw)
        k_out, k_tr = fv.euler_volume(*vargs, **vkw)
        torch.cuda.synchronize()
        e_out, a_out = rel_err(k_out, p_out)
        e_tr, a_tr = rel_err(k_tr, p_tr)
        print(f"K1 euler_volume {tag}: ph_qf rel {e_out:.3e}, traces rel "
              f"{e_tr:.3e} (tol {tol:.0e})")
        if not (e_out <= tol and e_tr <= tol):
            raise AssertionError(f"K1 disagrees with its plain version ({tag})")
        nbr = disc.gather_traces(p_tr)
        sargs = (p_tr, nbr, nxj, sj, inv_sj, inv_jac, disc.lift, p_out,
                 gamma)
        skw = dict(dissipation=True, diag=diag)
        p_s = fv.euler_surface_plain(*sargs, **skw)
        k_s = fv.euler_surface(*sargs, **skw)
        torch.cuda.synchronize()
        e_s, a_s = rel_err(k_s, p_s)
        print(f"K2 euler_surface {tag}: rel {e_s:.3e} (tol {tol:.0e})")
        if not e_s <= tol:
            raise AssertionError(f"K2 disagrees with its plain version ({tag})")
        return max(a_out, a_tr), a_s, vargs, vkw, sargs, skw, (k_out, k_tr,
                                                               k_s)

    # ---- 3. Euler kernels against their plain versions ----
    disc, q0 = euler_hex_3d(n=N, k1d=K1D, dtype=torch.float32, device=dev)
    if not fv.detect_axis_aligned(disc):
        raise AssertionError("the k1d=32 mesh must be detected axis-aligned")
    main_abs_v, main_abs_s, vargs, vkw, sargs, skw, kouts = check_kernels(
        disc, q0, True, "N=3 k1d=32 f32 diag (main path)")
    disc8, q8 = euler_hex_3d(n=N, k1d=8, dtype=torch.float64, device=dev)
    check_kernels(disc8, q8, True, "N=3 k1d=8 f64 diag")
    check_kernels(disc8, q8, False, "N=3 k1d=8 f64 general")
    check_kernels(disc8, q8, False, "N=3 k1d=8 f64 general, random metric",
                  random_affine(disc8))
    check_kernels(disc, q0, False, "N=3 k1d=32 f32 general, random metric",
                  random_affine(disc))
    del disc8, q8

    # ---- 4. the Euler path ----
    rhs = make_euler_rhs_fused(disc, dissipation=True)
    zero_counts()
    qf, _ = lsrk45(rhs, q0, DT, STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: counts[k] for k in ("euler_volume", "euler_surface")}
    stages = 5 * STEPS
    print(f"main path: {STEPS} LSRK45 steps ({stages} stages), launches "
          f"{launches}")
    if any(v != stages for v in launches.values()):
        raise AssertionError(f"expected {stages} launches of each kernel")
    if qf.dtype != torch.float32 or not bool(torch.isfinite(qf).all()):
        raise AssertionError("main-path state not finite f32")

    twin = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)
    qt, _ = lsrk45(twin, q0, DT, STEPS)
    e_twin, _ = rel_err(qf, qt)
    print(f"fused vs plain twin after {STEPS} steps: rel {e_twin:.3e} "
          f"(tol {TWIN_TOL_F32:.0e})")
    if not e_twin <= TWIN_TOL_F32:
        raise AssertionError("fused path disagrees with the plain twin")
    del qt

    w = disc.wjq.double()[None]
    before = (w * q0.double()).sum(dim=(1, 2))
    after = (w * qf.double()).sum(dim=(1, 2))
    mass = float(before[0])
    drift = [abs(float(a - b)) / mass for a, b in zip(after, before)]
    print("conservation |d sum(wJq q_f)| / sum(wJq rho): "
          + ", ".join(f"{d:.2e}" for d in drift)
          + f" (tol {CONSERVATION_TOL_F32:.0e})")
    if not max(drift) <= CONSERVATION_TOL_F32:
        raise AssertionError("conservation violated")

    disc4, q4 = euler_hex_3d(n=N, k1d=4, dtype=torch.float64, device=dev)
    _, aux = make_euler_rhs_fused(disc4, dissipation=False,
                                  compute_rhstest=True)(q4)
    rt = float(aux["rhstest"])
    print(f"f64 k1d=4 kernel path, dissipation off: rhstest {rt:.3e} "
          f"(tol {RHSTEST_TOL_F64:.0e})")
    if not abs(rt) <= RHSTEST_TOL_F64:
        raise AssertionError("entropy conservation violated")
    del disc4, q4

    # ---- 5. Euler timing ----
    dof = 5 * disc.np_ * disc.num_elements
    step_ms = cuda_ms(lambda: lsrk45(rhs, q0, DT, TIMED_STEPS), 1)
    rate = dof * 5 * TIMED_STEPS / (step_ms / 1e3)
    twin_ms = cuda_ms(lambda: lsrk45(twin, q0, DT, TWIN_TIMED_STEPS), 1)
    twin_rate = dof * 5 * TWIN_TIMED_STEPS / (twin_ms / 1e3)
    stage_ms = step_ms / (5 * TIMED_STEPS)
    print(f"[{card}] main path (K1+exchange+K2, LSRK45): {rate:.4e} "
          f"DOF*RK-stage/s, {stage_ms:.4f} ms/stage over "
          f"{5 * TIMED_STEPS} stages, median of {REPEATS}")
    print(f"[{card}] plain twin: {twin_rate:.4e} DOF*RK-stage/s, "
          f"{twin_ms / (5 * TWIN_TIMED_STEPS):.4f} ms/stage over "
          f"{5 * TWIN_TIMED_STEPS} stages, median of {REPEATS}")

    dev_ms = lambda fn, n: cuda_ms(fn, n, device_only=True)
    k1_ms = dev_ms(lambda: fv.euler_volume(*vargs, **vkw), 20)
    k1_plain_ms = dev_ms(lambda: fv.euler_volume_plain(*vargs, **vkw), 2)
    k2_ms = dev_ms(lambda: fv.euler_surface(*sargs, **skw), 20)
    k2_plain_ms = dev_ms(lambda: fv.euler_surface_plain(*sargs, **skw), 2)
    gather_ms = dev_ms(lambda: disc.gather_traces(sargs[0]), 20)
    for name, ms, pms in (("K1 euler_volume", k1_ms, k1_plain_ms),
                          ("K2 euler_surface", k2_ms, k2_plain_ms)):
        print(f"[{card}] {name} N=3 k1d=32 f32: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms ({pms / ms:.1f}x), device times")
    print(f"[{card}] trace exchange (rolls): {gather_ms:.4f} ms; per stage "
          f"K1+exchange+K2 = {k1_ms + gather_ms + k2_ms:.4f} ms of "
          f"{stage_ms:.4f} ms")
    print_profile(card, "Euler path", device_profile(
        lambda: lsrk45(rhs, q0, DT, 4), 20))
    k_out, k_tr, k_s = kouts
    ne = disc.num_elements
    # bytes the diag variants read and write: q, geo, Ef, LIFT -> ph_qf,
    # traces; traces, neighbour traces, compact nxj, 1/J, LIFT, ph_qf -> dq
    k1_bound = bound(nbytes(q0, disc.geo, vargs[2], disc.lift, k_out, k_tr),
                     ops_k1(N + 1) * ne)
    k2_bound = bound(nbytes(*sargs[:3], sargs[5], disc.lift, sargs[7], k_s),
                     ops_k2(N + 1) * ne)
    del rhs, twin, qf, vargs, sargs, kouts, k_out, k_tr, k_s, disc, q0
    torch.cuda.empty_cache()

    # ---- 6. cavity kernels against their plain versions ----
    def held(name, tag, kern, plain, tol, names):
        """max |kernel - plain| / max |plain| per output, printed; raises
        past tol; returns the largest absolute error."""
        torch.cuda.synchronize()
        errs = []
        for a, b in zip(kern, plain):
            d, m = float((a - b).abs().max()), float(b.abs().max())
            errs.append((d / m if m > 0 else d, d))
        print(f"{name} {tag}: rel " + ", ".join(
            f"{n} {e:.3e}" for n, (e, _) in zip(names, errs))
            + f" (tol {tol:.0e})")
        if not all(e <= tol for e, _ in errs):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({tag})")
        return max(a for _, a in errs)

    def cavity_kernels(disc, q, bc, p, tag):
        """The cavity's kernels against their plain versions: the volume
        front (K3 on tris, K1 on hexes), K4 (both fold_tail forms), K8 and
        K7.  Returns ({kernel: max abs error}, {kernel: arguments}, the
        front kernel's outputs)."""
        tol = TOL[str(q.dtype).replace("torch.", "")]
        nq = disc.nq
        errs, ins = {}, {}
        if disc.dim == 2:
            args = (q, disc.geo, torch.stack(disc.q_skew), disc.vq,
                    disc.vhp, disc.ph, gamma)
            kw = dict(nq=nq)
            front_k = mv.euler_modal_volume(*args, **kw)
            errs["front"] = held(
                "K3 euler_modal_volume", tag, front_k,
                mv.euler_modal_volume_plain(*args, **kw), tol,
                ("ph_qf", "traces", "vu_q"))
        else:
            args = (q, disc.geo, disc.vhp[nq:], disc.lift, gamma)
            kw = dict(line_ops=disc.line_ops,
                      diag=fv.detect_axis_aligned(disc))
            front_k = fv.euler_volume(*args, **kw)
            errs["front"] = held("K1 euler_volume", tag, front_k,
                                 fv.euler_volume_plain(*args, **kw), tol,
                                 ("ph_qf", "traces"))
        ins["front"] = (args, kw)
        k4args, k4tail, k4kw = k4_inputs(disc, q, bc, p)
        ins["k4"] = (k4args, k4tail, k4kw)
        errs["k4"] = 0.0
        for fold in (False, True):
            tail = k4tail if fold else ()
            names = (("dq_part", "t_f", "prod", "vuq") if fold else
                     ("flux", "pen", "t_f", "div", "prod", "vuq"))
            errs["k4"] = max(errs["k4"], held(
                "K4 cns_surface_viscous", f"{tag} fold_tail={fold}",
                sv.cns_surface_viscous(*k4args, *tail, fold_tail=fold,
                                       **k4kw),
                sv.cns_surface_viscous_plain(*k4args, *tail, fold_tail=fold,
                                             **k4kw), tol, names))
        ins["k8"] = k8_inputs(disc, q, bc, p)
        errs["k8"] = held("K8 cns_surface", tag, cs.cns_surface(
            *ins["k8"][0], **ins["k8"][1]), cs.cns_surface_plain(
            *ins["k8"][0], **ins["k8"][1]), tol, ("flux", "dv", "pen"))
        ins["k7"] = k7_inputs(disc, q, bc, p)
        errs["k7"] = held("K7 cns_viscous", tag, sv.cns_viscous(
            *ins["k7"][0], **ins["k7"][1]), sv.cns_viscous_plain(
            *ins["k7"][0], **ins["k7"][1]), tol,
            ("t_f", "div", "prod", "vuq"))
        return errs, ins, front_k

    cdisc, cq, cbc, cp = cavity_case("isothermal", CAV_N, CAV_K1D,
                                     torch.float32, dev)
    cerrs, cins, k3outs = cavity_kernels(
        cdisc, cq, cbc, cp, f"tri N=3 k1d={CAV_K1D} f32 isothermal (cavity "
        "path)")
    print(f"(kernel checks on moving states: density and pressure x (1 + "
          f"0.01 n), velocity + {VELOCITY} n, n seeded standard normal; "
          f"max |u| {float((cq[1:3] / cq[0]).abs().max()):.3f} at k1d="
          f"{CAV_K1D})")
    for case in CAVITY_BCS:
        d8, q8, bc8, p8 = cavity_case(case, CAV_N, 8, torch.float64, dev)
        cavity_kernels(d8, q8, bc8, p8, f"tri N=3 k1d=8 f64 {case}")
    d5, q5, bc5, p5 = cavity_case("isothermal", CAV_N, 5, torch.float64,
                                  dev)
    cavity_kernels(d5, q5, bc5, p5, "tri N=3 k1d=5 (K=50, ragged tile) f64 "
                   "isothermal")
    del d8, q8, bc8, d5, q5, bc5

    # ---- 7. the cavity path ----
    cdisc, cq0, cbc, cp = lid_driven_cavity(CAV_N, CAV_K1D,
                                            dtype=torch.float32, device=dev)
    flags = dict(mu=cp["mu"], pr=cp["pr"], re=cp["re"], bc=cbc,
                 inviscid_dissipation=True, viscous_dissipation=True,
                 compute_rhstest=False)
    crhs = make_cns_rhs_affine(cdisc, volume_impl="fused",
                               surface_impl="auto", **flags)
    zero_counts()
    cqf, _ = lsrk45(crhs, cq0, CAV_DT, CAV_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    cav_launches = {k: counts[k] for k in ("euler_modal_volume",
                                           "cns_surface_viscous")}
    stages = 5 * CAV_STEPS
    print(f"cavity path: {CAV_STEPS} LSRK45 steps ({stages} stages) at "
          f"dt={CAV_DT:g}, launches {counts}")
    if any(v != stages for v in cav_launches.values()):
        raise AssertionError(f"expected {stages} launches of K3 and K4")
    if cqf.dtype != torch.float32 or not bool(torch.isfinite(cqf).all()):
        raise AssertionError("cavity state not finite f32")
    ctwin = make_cns_rhs(cdisc, **flags)
    cqt, _ = lsrk45(ctwin, cq0, CAV_DT, CAV_STEPS)
    e_ctwin, _ = rel_err(cqf, cqt)
    print(f"cavity fused vs twin make_cns_rhs after {CAV_STEPS} steps: rel "
          f"{e_ctwin:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_ctwin <= TWIN_TOL_F32:
        raise AssertionError("cavity path disagrees with the twin")

    def mass(disc, q):
        return float((disc.wjq.double()
                      * (disc.vq.double() @ q[0].double())).sum())

    cdrift = abs(mass(cdisc, cqf) - mass(cdisc, cq0)) / mass(cdisc, cq0)
    cdrift_twin = abs(mass(cdisc, cqt) - mass(cdisc, cq0)) / mass(cdisc, cq0)
    del cqt
    d64, q64, bc64, p64 = lid_driven_cavity(CAV_N, CAV_K1D,
                                            dtype=torch.float64, device=dev)
    zero_counts()
    q64f, _ = lsrk45(make_cns_rhs_affine(d64, **dict(flags, bc=bc64)), q64,
                     CAV_DT, CAV_STEPS)
    cdrift64 = abs(mass(d64, q64f) - mass(d64, q64)) / mass(d64, q64)
    print(f"cavity mass |d sum(wJq rho)| / sum(wJq rho) after {CAV_STEPS} "
          f"steps: f32 {cdrift:.2e} (tol {CAV_MASS_TOL_F32:.0e}; the f32 "
          f"twin make_cns_rhs from the same q0: {cdrift_twin:.2e}), f64 "
          f"kernel path (launches {read_counts()}) {cdrift64:.2e} (tol "
          f"{CAV_MASS_TOL_F64:.0e})")
    if not (cdrift <= CAV_MASS_TOL_F32 and cdrift64 <= CAV_MASS_TOL_F64):
        raise AssertionError("cavity mass not conserved")
    del d64, q64, q64f

    edisc, eq0, ebc, ep = lid_driven_cavity(CAV_N, 8, bctype="adiabatic",
                                            lid_profile=lambda x: 0.0 * x,
                                            dtype=torch.float64, device=dev)
    rng = np.random.default_rng(1)
    eq = eq0 + 1e-3 * torch.as_tensor(
        rng.standard_normal(tuple(eq0.shape)), device=dev) * torch.tensor(
        [1.0, 0.1, 0.1, 1.0], dtype=torch.float64, device=dev)[:, None, None]
    zero_counts()
    _, eaux = make_cns_rhs_affine(
        edisc, mu=ep["mu"], pr=ep["pr"], re=ep["re"], bc=ebc,
        inviscid_dissipation=True, viscous_dissipation=True,
        compute_rhstest=True)(eq)
    rtv, rt = float(eaux["rhstest_visc"]), float(eaux["rhstest"])
    print(f"f64 k1d=8 kernel path (K3 + K4 merged, launches "
          f"{read_counts()}), adiabatic walls at rest: rhstest_visc "
          f"{rtv:.3e} (>= 0), rhstest {rt:.3e} (< {RHSTEST_TOL_F64:.0e})")
    if not (rtv >= 0.0 and rt < RHSTEST_TOL_F64):
        raise AssertionError("cavity entropy stability violated")
    del edisc, eq0, eq

    # ---- 8. cavity timing ----
    def path_timing(label, rhs, q0, dof, twin):
        """(ms per stage, DOF*RK-stage/s) of rhs over 1200 stages, and the
        twin's rate, printed."""
        step_ms = cuda_ms(lambda: lsrk45(rhs, q0, CAV_TIMED_DT, TIMED_STEPS),
                          1)
        rate = dof * 5 * TIMED_STEPS / (step_ms / 1e3)
        stage_ms = step_ms / (5 * TIMED_STEPS)
        print(f"[{card}] {label}: {rate:.4e} DOF*RK-stage/s, "
              f"{stage_ms:.4f} ms/stage over {5 * TIMED_STEPS} stages, "
              f"median of {REPEATS}")
        if twin is not None:
            twin_ms = cuda_ms(lambda: lsrk45(twin, q0, CAV_TIMED_DT,
                                             TWIN_TIMED_STEPS), 1)
            print(f"[{card}] {label}, twin make_cns_rhs: "
                  f"{dof * 5 * TWIN_TIMED_STEPS / (twin_ms / 1e3):.4e} "
                  f"DOF*RK-stage/s, {twin_ms / (5 * TWIN_TIMED_STEPS):.4f} "
                  f"ms/stage over {5 * TWIN_TIMED_STEPS} stages, median of "
                  f"{REPEATS}")
        return stage_ms, rate

    def kernel_times(shape, calls):
        """Device times of each (name, kernel call, plain call), printed
        beside the host's back-to-back time; returns {name: (ms, plain
        ms)}."""
        out = {}
        for name, kcall, pcall in calls:
            ms, pms = dev_ms(kcall, 20), dev_ms(pcall, 2)
            print(f"[{card}] {name} {shape}: kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms ({pms / ms:.1f}x), device times; back to "
                  f"back from the host {cuda_ms(kcall, 20):.4f} ms")
            out[name] = (ms, pms)
        return out

    cdof = 4 * cdisc.np_ * cdisc.num_elements
    cstage_ms, _ = path_timing(
        "cavity path (K3+exchange+K4+exchange+LIFT, LSRK45)", crhs, cq0,
        cdof, ctwin)
    k3args, k3kw = cins["front"]
    k4args, k4tail, k4kw = cins["k4"]
    k3_call = lambda: mv.euler_modal_volume(*k3args, **k3kw)
    k4_call = lambda: sv.cns_surface_viscous(*k4args, *k4tail,
                                             fold_tail=True, **k4kw)
    ctimes = kernel_times(f"tri N=3 k1d={CAV_K1D} f32", [
        ("K3 euler_modal_volume", k3_call,
         lambda: mv.euler_modal_volume_plain(*k3args, **k3kw)),
        ("K4 cns_surface_viscous (fold_tail)", k4_call,
         lambda: sv.cns_surface_viscous_plain(*k4args, *k4tail,
                                              fold_tail=True, **k4kw))])
    k3_ms, k3_plain_ms = ctimes["K3 euler_modal_volume"]
    k4_ms, k4_plain_ms = ctimes["K4 cns_surface_viscous (fold_tail)"]
    tr = k3outs[1]
    k4out = k4_call()
    ex1_ms = dev_ms(lambda: cdisc.gather_traces(tr), 20)
    ex2_ms = dev_ms(lambda: cdisc.gather_traces(k4out[1]), 20)
    rest = cstage_ms - k3_ms - k4_ms - ex1_ms - ex2_ms
    print(f"[{card}] cavity stage split: K3 {k3_ms:.4f} + exchange 1 "
          f"(index_select, 6 rows) {ex1_ms:.4f} + K4 {k4_ms:.4f} + exchange "
          f"2 (index_select, 4 rows) {ex2_ms:.4f} + rest (traction BC, jump "
          f"LIFT, 1/J, LSRK45 update, host gaps) {rest:.4f} = "
          f"{cstage_ms:.4f} ms")
    cstage_dev_ms = dev_ms(lambda: lsrk45(crhs, cq0, CAV_TIMED_DT, 10),
                           1) / 50
    print(f"[{card}] cavity stage device time (queued ahead of the "
          f"device): {cstage_dev_ms:.4f} ms of {cstage_ms:.4f} ms")
    print_profile(card, "cavity path", device_profile(
        lambda: lsrk45(crhs, cq0, CAV_TIMED_DT, 4), 20))
    cne = cdisc.num_elements
    k3_bound = bound(nbytes(*k3args[:6], *k3outs),
                     ops_k3(cdisc.np_, cdisc.nq, cdisc.nh) * cne)
    k4_bound = bound(nbytes(*k4args, *k4tail, *k4out),
                     ops_k4(2, cdisc.np_, cdisc.nq, cdisc.nfq, True) * cne)
    del ctwin, k4out

    # ---- 9. 3D cavity kernels against their plain versions ----
    hdisc, hq, hbc, hp = cavity_case("isothermal", CAV3_N, CAV3_K1D,
                                     torch.float32, dev, dim=3)
    herrs, hins, k1outs = cavity_kernels(
        hdisc, hq, hbc, hp, f"hex N=3 k1d={CAV3_K1D} f32 isothermal (3D "
        "cavity path)")
    for case in CAVITY_BCS:
        d4, q4, bc4, p4 = cavity_case(case, CAV3_N, 4, torch.float64, dev,
                                      dim=3)
        cavity_kernels(d4, q4, bc4, p4, f"hex N=3 k1d=4 f64 {case}")
    d3, q3, bc3, p3 = cavity_case("isothermal", CAV3_N, 3, torch.float64,
                                  dev, dim=3)
    cavity_kernels(d3, q3, bc3, p3, "hex N=3 k1d=3 (K=27, ragged tile) f64 "
                   "isothermal")
    del d4, q4, bc4, d3, q3, bc3

    # ---- 10. the 3D cavity path ----
    hdisc, hq0, hbc, hp = lid_driven_cavity_3d(CAV3_N, CAV3_K1D,
                                               dtype=torch.float32,
                                               device=dev)
    if not fv.detect_axis_aligned(hdisc):
        raise AssertionError("the 3D cavity mesh must be detected "
                             "axis-aligned")
    hflags = dict(flags, mu=hp["mu"], pr=hp["pr"], re=hp["re"], bc=hbc)
    hrhs = make_cns_rhs_affine(hdisc, volume_impl="fused_hex",
                               surface_impl="auto", **hflags)
    zero_counts()
    hqf, _ = lsrk45(hrhs, hq0, CAV_DT, CAV_STEPS)
    torch.cuda.synchronize()
    counts = read_counts()
    cav3_launches = {k: counts[k] for k in ("euler_volume",
                                            "cns_surface_viscous")}
    print(f"3D cavity path: {CAV_STEPS} LSRK45 steps ({stages} stages) at "
          f"dt={CAV_DT:g}, launches {counts}")
    if any(v != stages for v in cav3_launches.values()):
        raise AssertionError(f"expected {stages} launches of K1 and K4")
    if hqf.dtype != torch.float32 or not bool(torch.isfinite(hqf).all()):
        raise AssertionError("3D cavity state not finite f32")
    htwin = make_cns_rhs(hdisc, **hflags)
    hqt, _ = lsrk45(htwin, hq0, CAV_DT, CAV_STEPS)
    e_htwin, _ = rel_err(hqf, hqt)
    print(f"3D cavity fused_hex vs twin make_cns_rhs after {CAV_STEPS} "
          f"steps: rel {e_htwin:.3e} (tol {TWIN_TOL_F32:.0e})")
    if not e_htwin <= TWIN_TOL_F32:
        raise AssertionError("3D cavity path disagrees with the twin")
    hdrift = abs(mass(hdisc, hqf) - mass(hdisc, hq0)) / mass(hdisc, hq0)
    del hqt
    d64, q64, bc64, p64 = lid_driven_cavity_3d(CAV3_N, CAV3_K1D,
                                               dtype=torch.float64,
                                               device=dev)
    zero_counts()
    q64f, _ = lsrk45(make_cns_rhs_affine(d64, volume_impl="fused_hex",
                                         **dict(hflags, bc=bc64)),
                     q64, CAV_DT, CAV_STEPS)
    hdrift64 = abs(mass(d64, q64f) - mass(d64, q64)) / mass(d64, q64)
    print(f"3D cavity mass |d sum(wJq rho)| / sum(wJq rho) after "
          f"{CAV_STEPS} steps: f32 {hdrift:.2e} (printed), f64 kernel path "
          f"(launches {read_counts()}) {hdrift64:.2e} (tol "
          f"{CAV_MASS_TOL_F64:.0e})")
    if not hdrift64 <= CAV_MASS_TOL_F64:
        raise AssertionError("3D cavity mass not conserved")
    del d64, q64, q64f

    edisc, eq0, ebc, ep = lid_driven_cavity_3d(CAV3_N, 4, bctype="adiabatic",
                                               dtype=torch.float64,
                                               device=dev)
    ebc.regions[0].u_wall = (0.0, 0.0, 0.0)       # the lid at rest
    rng = np.random.default_rng(1)
    eq = eq0 + 1e-3 * torch.as_tensor(
        rng.standard_normal(tuple(eq0.shape)), device=dev) * torch.tensor(
        [1.0, 0.1, 0.1, 0.1, 1.0], dtype=torch.float64,
        device=dev)[:, None, None]
    zero_counts()
    _, eaux = make_cns_rhs_affine(
        edisc, mu=ep["mu"], pr=ep["pr"], re=ep["re"], bc=ebc,
        inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl="fused_hex", surface_impl="merged",
        compute_rhstest=True)(eq)
    rtv, rt = float(eaux["rhstest_visc"]), float(eaux["rhstest"])
    print(f"f64 hex k1d=4 kernel path (K1 + K4 merged, launches "
          f"{read_counts()}), adiabatic walls, lid at rest: rhstest_visc "
          f"{rtv:.3e} (>= 0), rhstest {rt:.3e} (< {RHSTEST_TOL_F64:.0e})")
    if not (rtv >= 0.0 and rt < RHSTEST_TOL_F64):
        raise AssertionError("3D cavity entropy stability violated")
    del edisc, eq0, eq

    # ---- 11. 3D cavity timing ----
    hdof = 5 * hdisc.np_ * hdisc.num_elements
    hstage_ms, _ = path_timing(
        "3D cavity path (K1+exchange+K4+exchange+LIFT, LSRK45)", hrhs, hq0,
        hdof, htwin)
    k1args, k1kw = hins["front"]
    h4args, h4tail, h4kw = hins["k4"]
    k1_call = lambda: fv.euler_volume(*k1args, **k1kw)
    h4_call = lambda: sv.cns_surface_viscous(*h4args, *h4tail,
                                             fold_tail=True, **h4kw)
    htimes = kernel_times(f"hex N=3 k1d={CAV3_K1D} f32", [
        ("K1 euler_volume (3D cavity)", k1_call,
         lambda: fv.euler_volume_plain(*k1args, **k1kw)),
        ("K4 cns_surface_viscous dim=3 (fold_tail)", h4_call,
         lambda: sv.cns_surface_viscous_plain(*h4args, *h4tail,
                                              fold_tail=True, **h4kw))])
    h1_ms = htimes["K1 euler_volume (3D cavity)"][0]
    h4_ms, h4_plain_ms = htimes["K4 cns_surface_viscous dim=3 (fold_tail)"]
    h4out = h4_call()
    hex1_ms = dev_ms(lambda: hdisc.gather_traces(k1outs[1]), 20)
    hex2_ms = dev_ms(lambda: hdisc.gather_traces(h4out[1]), 20)
    hrest = hstage_ms - h1_ms - h4_ms - hex1_ms - hex2_ms
    print(f"[{card}] 3D cavity stage split: K1 {h1_ms:.4f} + exchange 1 "
          f"(index_select, 7 rows) {hex1_ms:.4f} + K4 {h4_ms:.4f} + "
          f"exchange 2 (index_select, 5 rows) {hex2_ms:.4f} + rest (v(U), "
          f"traction BC, jump LIFT, 1/J, LSRK45 update, host gaps) "
          f"{hrest:.4f} = {hstage_ms:.4f} ms")
    hstage_dev_ms = dev_ms(lambda: lsrk45(hrhs, hq0, CAV_TIMED_DT, 10),
                           1) / 50
    print(f"[{card}] 3D cavity stage device time (queued ahead of the "
          f"device): {hstage_dev_ms:.4f} ms of {hstage_ms:.4f} ms")
    print_profile(card, "3D cavity path", device_profile(
        lambda: lsrk45(hrhs, hq0, CAV_TIMED_DT, 4), 20))
    hne = hdisc.num_elements
    h4_bound = bound(nbytes(*h4args, *h4tail, *h4out),
                     ops_k4(3, hdisc.np_, hdisc.nq, hdisc.nfq, False) * hne)
    del htwin, h4out

    # ---- 12. the split path (K8 then K7) on both cavities ----
    split_rows = {}
    for label, disc, q0, pflags, vol, ins, small in (
            ("tri", cdisc, cq0, flags, "fused", cins,
             cavity_case("isothermal", CAV_N, 8, torch.float64, dev)),
            ("hex", hdisc, hq0, hflags, "fused_hex", hins,
             cavity_case("isothermal", CAV3_N, 4, torch.float64, dev,
                         dim=3))):
        split = make_cns_rhs_affine(disc, volume_impl=vol,
                                    surface_impl="fused", **pflags)
        merged = make_cns_rhs_affine(disc, volume_impl=vol,
                                     surface_impl="merged_tail", **pflags)
        qm_ = cq if label == "tri" else hq
        e32, _ = rel_err(split(qm_)[0], merged(qm_)[0])
        sd, sq, sbc, sp = small
        sflags = dict(pflags, mu=sp["mu"], pr=sp["pr"], re=sp["re"], bc=sbc)
        e64, _ = rel_err(
            make_cns_rhs_affine(sd, volume_impl=vol, surface_impl="fused",
                                **sflags)(sq)[0],
            make_cns_rhs_affine(sd, volume_impl=vol,
                                surface_impl="merged_tail", **sflags)(sq)[0])
        print(f"{label} split path (surface_impl='fused') vs merged_tail, "
              f"one RHS on a moving state: f32 full width rel {e32:.3e} (tol "
              f"{SPLIT_TOL['float32']:.0e}), f64 small rel {e64:.3e} (tol "
              f"{SPLIT_TOL['float64']:.0e})")
        if not (e32 <= SPLIT_TOL["float32"] and e64 <= SPLIT_TOL["float64"]):
            raise AssertionError(f"{label} split path disagrees with K4")
        zero_counts()
        sqf, _ = lsrk45(split, q0, CAV_DT, CAV_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"{label} split path: {CAV_STEPS} LSRK45 steps ({stages} "
              f"stages), launches {counts}")
        front = "euler_modal_volume" if label == "tri" else "euler_volume"
        if any(counts[k] != stages for k in (front, "cns_surface",
                                             "cns_viscous")):
            raise AssertionError(f"expected {stages} launches of the front, "
                                 "K8 and K7")
        if not bool(torch.isfinite(sqf).all()):
            raise AssertionError(f"{label} split-path state not finite")
        dof = (disc.dim + 2) * disc.np_ * disc.num_elements
        path_timing(f"{label} split path (front+exchange+K8+K7+exchange+"
                    "LIFTs, LSRK45)", split, q0, dof, None)
        a8, kw8 = ins["k8"]
        a7, kw7 = ins["k7"]
        shape = (f"tri N=3 k1d={CAV_K1D} f32" if label == "tri"
                 else f"hex N=3 k1d={CAV3_K1D} f32")
        stimes = kernel_times(shape, [
            ("K8 cns_surface", lambda: cs.cns_surface(*a8, **kw8),
             lambda: cs.cns_surface_plain(*a8, **kw8)),
            ("K7 cns_viscous", lambda: sv.cns_viscous(*a7, **kw7),
             lambda: sv.cns_viscous_plain(*a7, **kw7))])
        ne = disc.num_elements
        o8, o7 = cs.cns_surface(*a8, **kw8), sv.cns_viscous(*a7, **kw7)
        proj = disc.dim == 2
        split_rows[label] = dict(
            launches=counts, times=stimes,
            k8_bound=bound(nbytes(*a8, *o8),
                           ops_face(disc.dim, False) * disc.nfq * ne),
            k7_bound=bound(nbytes(*a7, *(o7 if proj else o7[:3])),
                           ops_visc(disc.dim, disc.np_, disc.nq, disc.nfq,
                                    proj) * ne))
        del split, merged, sqf, o8, o7

    hex_split = split_rows["hex"]
    rows = [
        ("euler_volume", "hex_volume.cu", "pallas_volume.py:87",
         launches["euler_volume"], main_abs_v, k1_ms, k1_plain_ms, k1_bound),
        ("euler_surface", "hex_surface.cu", "pallas_volume.py:1146",
         launches["euler_surface"], main_abs_s, k2_ms, k2_plain_ms, k2_bound),
        ("euler_modal_volume", "tri_modal_volume.cu",
         "pallas_modal_volume.py:45", cav_launches["euler_modal_volume"],
         cerrs["front"], k3_ms, k3_plain_ms, k3_bound),
        ("cns_surface_viscous", "cns_surface_viscous.cu",
         "pallas_viscous.py:152", cav_launches["cns_surface_viscous"],
         cerrs["k4"], k4_ms, k4_plain_ms, k4_bound),
        ("cns_surface_viscous_3d", "cns_surface_viscous.cu",
         "pallas_viscous.py:152", cav3_launches["cns_surface_viscous"],
         herrs["k4"], h4_ms, h4_plain_ms, h4_bound),
        ("cns_surface", "cns_surface.cu", "pallas_cns_surface.py:155",
         hex_split["launches"]["cns_surface"], herrs["k8"],
         *hex_split["times"]["K8 cns_surface"], hex_split["k8_bound"]),
        ("cns_viscous", "cns_viscous.cu", "pallas_viscous.py:131",
         hex_split["launches"]["cns_viscous"], herrs["k7"],
         *hex_split["times"]["K7 cns_viscous"], hex_split["k7_bound"]),
    ]
    for name, *_, ms, _, (bms, by) in rows:
        print(f"[{card}] {name}: bound {bms:.4f} ms by {by}, kernel "
              f"{ms:.4f} ms ({bms / ms:.1%} of the bound)")
    for label in ("tri",):
        sr = split_rows[label]
        for key, bkey in (("K8 cns_surface", "k8_bound"),
                          ("K7 cns_viscous", "k7_bound")):
            bms, by = sr[bkey]
            print(f"[{card}] {key} ({label} split path): bound {bms:.4f} ms "
                  f"by {by}, kernel {sr['times'][key][0]:.4f} ms "
                  f"({bms / sr['times'][key][0]:.1%} of the bound)")
    # no single PyTorch call computes any of these: library_ms is null
    kernels_line = [
        {"name": name, "route": "cuda",
         "source": f"esdg_cns_tpu_torch/csrc/{src}",
         "replaces": f"esdg_cns_tpu/ops/{rep}", "launches": n,
         "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bms,
         "bound_by": by, "library_ms": None}
        for name, src, rep, n, err, ms, pms, (bms, by) in rows
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)

#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: the card's name and power limit (nvidia-smi) and the TF32
     switches, which stay off;
  2. build: nvcc builds esdg_cns_tpu_torch/csrc/*.cu for sm_90a; prints the
     build time and ptxas' register/spill report of the N=3 kernels;
  3. kernels: K1 (euler_volume) and K2 (euler_surface) against their plain
     PyTorch versions on the card, at the main-path shapes (N=3, k1d=32,
     f32, axis-aligned) and at N=3, k1d=8 in f64 (axis-aligned and general);
     the general variant also on a seeded random non-diagonal affine metric
     (k1d=32 f32, k1d=8 f64), where no cross term is an exact zero;
  4. main path: presets.euler_hex_3d(3, 32, f32) -> make_euler_rhs_fused ->
     lsrk45 for 20 steps with every launch counter at 0 before; checks the
     state is finite, each kernel launched once per stage, the state agrees
     with the plain twin make_euler_rhs(flux_diff_impl='lines') run from the
     same q0, and sum(wJq q) per field is conserved; then an f64 k1d=4
     entropy-conservation check (dissipation off) on the kernel path;
  5. timing with CUDA events (medians of 5 repeats after warm-up): the
     main-path rate in DOF*RK-stage/s (5 Np K stages / s, bench.py's
     definition) over 1200 stages, the twin's rate over fewer stages, and
     per-kernel times beside the plain versions.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result: there is no CPU path.
"""

import json
import statistics
import subprocess
import sys
import time

# the main path: N=3, k1d=32 (K=32768, 10.5M DOF), f32
N, K1D, STEPS, DT = 3, 32, 20, 1e-3
TIMED_STEPS, TWIN_TIMED_STEPS, REPEATS = 240, 5, 5
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


def cuda_ms(fn, n_calls, repeats=REPEATS):
    """Median over repeats of the mean per-call time of fn, CUDA events."""
    import torch

    fn()   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n_calls)
    return statistics.median(times)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 2

    from esdg_cns_tpu_torch import kernels
    from esdg_cns_tpu_torch.ops import fused_volume as fv
    from esdg_cns_tpu_torch.presets import euler_hex_3d
    from esdg_cns_tpu_torch.solvers import make_euler_rhs, make_euler_rhs_fused
    from esdg_cns_tpu_torch.timestepping import lsrk45

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
        elif entry and "Li4E" in entry and ("registers" in line
                                             or "spill" in line):
            kind = "volume" if "volume" in entry else "surface"
            variant = ("f64" if "Id" in entry.split("kernel")[1][:3]
                       else "f32") + (" diag" if "Lb1E" in entry else " general")
            report = line.split("ptxas info    :")[-1].strip()
            print(f"ptxas N=3 {kind} {variant}: {report}")

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
        return max(a_out, a_tr), a_s, vargs, vkw, sargs, skw

    # ---- 3. kernels against their plain versions ----
    disc, q0 = euler_hex_3d(n=N, k1d=K1D, dtype=torch.float32, device=dev)
    if not fv.detect_axis_aligned(disc):
        raise AssertionError("the k1d=32 mesh must be detected axis-aligned")
    main_abs_v, main_abs_s, vargs, vkw, sargs, skw = check_kernels(
        disc, q0, True, "N=3 k1d=32 f32 diag (main path)")
    disc8, q8 = euler_hex_3d(n=N, k1d=8, dtype=torch.float64, device=dev)
    check_kernels(disc8, q8, True, "N=3 k1d=8 f64 diag")
    check_kernels(disc8, q8, False, "N=3 k1d=8 f64 general")
    check_kernels(disc8, q8, False, "N=3 k1d=8 f64 general, random metric",
                  random_affine(disc8))
    check_kernels(disc, q0, False, "N=3 k1d=32 f32 general, random metric",
                  random_affine(disc))
    del disc8, q8

    # ---- 4. the main path ----
    rhs = make_euler_rhs_fused(disc, dissipation=True)
    fv.euler_volume.launches = 0
    fv.euler_surface.launches = 0
    qf, _ = lsrk45(rhs, q0, DT, STEPS)
    torch.cuda.synchronize()
    launches = {"euler_volume": fv.euler_volume.launches,
                "euler_surface": fv.euler_surface.launches}
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

    # ---- 5. timing ----
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

    k1_ms = cuda_ms(lambda: fv.euler_volume(*vargs, **vkw), 20)
    k1_plain_ms = cuda_ms(lambda: fv.euler_volume_plain(*vargs, **vkw), 2)
    k2_ms = cuda_ms(lambda: fv.euler_surface(*sargs, **skw), 20)
    k2_plain_ms = cuda_ms(lambda: fv.euler_surface_plain(*sargs, **skw), 2)
    gather_ms = cuda_ms(lambda: disc.gather_traces(sargs[0]), 20)
    for name, ms, pms in (("K1 euler_volume", k1_ms, k1_plain_ms),
                          ("K2 euler_surface", k2_ms, k2_plain_ms)):
        print(f"[{card}] {name} N=3 k1d=32 f32: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms ({pms / ms:.1f}x)")
    print(f"[{card}] trace exchange (rolls): {gather_ms:.4f} ms; per stage "
          f"K1+exchange+K2 = {k1_ms + gather_ms + k2_ms:.4f} ms of "
          f"{stage_ms:.4f} ms")

    kernels_line = [
        {"name": "euler_volume", "route": "cuda",
         "source": "esdg_cns_tpu_torch/csrc/hex_volume.cu",
         "replaces": "esdg_cns_tpu/ops/pallas_volume.py:87",
         "launches": launches["euler_volume"], "max_abs_err": main_abs_v,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "euler_surface", "route": "cuda",
         "source": "esdg_cns_tpu_torch/csrc/hex_surface.cu",
         "replaces": "esdg_cns_tpu/ops/pallas_volume.py:1146",
         "launches": launches["euler_surface"], "max_abs_err": main_abs_s,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
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

"""The 2D cavity on modal triangles (``configs/cns_cavity_tri``): the frozen
reference against the port's RHS at test sizes, its blocked volume sum,
the start state, the comparison's control, and K3's and K4's roofline
shares (``roofline_tri``, ``metrics/k3_roofline.tri.py``,
``metrics/k4_roofline.tri.py``)."""

import importlib
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from h100_bench import control, devtrace, roofline, roofline_tri
from h100_bench.reference.ops.flux_differencing import (
    flux_differencing_dense, flux_differencing_xla)
from h100_bench.reference.tri_cavity import tri_cavity_problem

BENCH = Path(__file__).resolve().parents[1]
CELL = "cns_cavity_tri.n3_k384"
F64 = torch.float64


def _config():
    cfg = json.loads((BENCH / "configs" / "cns_cavity_tri.json").read_text())
    return cfg, importlib.import_module("h100_bench.configs.cns_cavity_tri")


def _port(k1d, cfg, **kw):
    from esdg_cns_tpu_torch.presets import lid_driven_cavity

    disc, _, bc, p = lid_driven_cavity(3, k1d, ma=cfg["ma"], re=cfg["re"],
                                       dtype=F64, device="cpu")
    flags = dict(mu=p["mu"], pr=cfg["pr"], re=p["re"], bc=bc,
                 inviscid_dissipation=True, viscous_dissipation=True,
                 compute_rhstest=False)
    return disc, flags


@pytest.mark.parametrize("k1d", [3, 4])
def test_reference_matches_the_port(k1d):
    """The port's RHS on the cell's path (``make_cns_rhs_affine`` with the
    modal front: K3's and K4's plain versions here) and its plain twin
    (the dense sum) against the reference, f64, on the seeded moving
    start state; the reference's nodes are the port's."""
    from esdg_cns_tpu_torch.solvers.cns import make_cns_rhs
    from esdg_cns_tpu_torch.solvers.cns_fused import make_cns_rhs_affine

    cfg, mod = _config()
    wl = {"n": 3, "k1d": k1d, "volume_impl": "fused"}
    disc, flags = _port(k1d, cfg)
    ref = mod.reference_rhs(cfg, wl, F64, "cpu")
    q = mod.start_state(cfg, wl, 2 ** 31 + 7, "cpu").to(F64)
    b = ref(q, 0.0)
    scale = float(b.abs().max())
    for rhs in (make_cns_rhs_affine(disc, volume_impl="fused", **flags),
                make_cns_rhs(disc, flux_diff_impl="xla", **flags)):
        assert float((rhs(q, 0.0)[0] - b).abs().max()) <= 1e-12 * scale
    for c, xc in zip(mod.node_coordinates(3, k1d), disc.x):
        assert float((torch.as_tensor(c) - xc).abs().max()) == 0.0


def test_blocked_volume_sum_is_the_whole_sum():
    """The reference's volume sum on blocks of elements (a ragged last
    block) against one call."""
    cfg, _ = _config()
    disc, _ = tri_cavity_problem(3, 3, ma=cfg["ma"], re=cfg["re"],
                                 pr=cfg["pr"], gamma=cfg["gamma"],
                                 dtype=F64, device="cpu")
    gen = torch.Generator().manual_seed(3)
    qh = 1.0 + torch.rand((4, disc.nh, disc.num_elements), generator=gen,
                          dtype=F64)
    qlog = torch.log(qh[[0, 3]])
    whole = flux_differencing_xla(qh, qlog, disc.q_skew, disc.geo, 1.4)
    parts = flux_differencing_dense(qh, qlog, disc.q_skew, disc.geo, 1.4,
                                    block=4)
    assert float((parts - whole).abs().max()) <= 1e-14 * float(
        whole.abs().max())


def test_start_state_comes_from_the_seed():
    cfg, mod = _config()
    wl = {"n": 3, "k1d": 3}
    a = mod.start_state(cfg, wl, 2 ** 31 + 11, "cpu")
    b = mod.start_state(cfg, wl, 2 ** 31 + 11, "cpu")
    c = mod.start_state(cfg, wl, 2 ** 31 + 12, "cpu")
    assert a.shape == (4, 10, 18) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    vel = a.double()[1:3] / a.double()[0]
    assert abs(float(vel.abs().max()) - cfg["velocity_amplitude"]) < 1e-6


# a mesh at which the control reads over the cell's limits on the CPU: its
# step_gap reads 0.50-0.71 at k1d = 4 against the limit of 0.15 (its
# rhs_gap, 0.51-0.71 there, grows with the mesh: 20.9-27.6 at k1d = 384 on
# the card, against 1.0)
SMALL = {"k1d": 4, "warmup_steps": 1}


def test_control_fails_and_program_passes():
    lines = []
    rc = control.main(["--workload", CELL, "--sides", "program,control",
                       "--seeds", "2", "--other-seeds", "2",
                       "--seconds", "0.3"], device=torch.device("cpu"),
                      overrides=SMALL, out=lines.append)
    rows = [json.loads(x) for x in lines]
    rows = [r for r in rows if not r.get("summary")]
    assert rc == 0 and len(rows) == 4
    for row in rows:
        assert row["correct"] is (row["side"] == "program"), row


def test_bounds_are_the_port_counts_and_the_kernel_table():
    """The frozen counts equal the port's pricing model on the port's own
    operators; at the kernel table's shape (k1d = 128, K = 32768) K3 is
    bound by its operations at 0.0119 ms and K4 by its bytes at 0.0198
    ms; the wall rows are the port's pool of the cavity's two isothermal
    regions."""
    from esdg_cns_tpu_torch.ops.cns_surface_bc import prepare_surface_bc
    from esdg_cns_tpu_torch.probes import counts
    from esdg_cns_tpu_torch.solvers._shared import adiabatic_mask
    from esdg_cns_tpu_torch.solvers.cns_fused import composed_operators

    cfg, _ = _config()
    disc, flags = _port(2, cfg)
    op = roofline_tri.tri_operators(3)
    assert roofline_tri.ops_k3(op) == counts.ops_k3(
        2, disc.vq, disc.vhp, disc.ph, torch.stack(disc.q_skew), disc.nq)
    front, vqlift, drpq = composed_operators(disc)
    k4 = counts.ops_k4(2, disc.np_, disc.nq, disc.nfq,
                       (front, vqlift, disc.vhp[disc.nq:], drpq), disc.lift)
    assert dict(roofline.ops_k4(2, op["np_"], op["nq"], op["nfq"],
                                op["front"], op["vqlift"], op["ef"],
                                op["drpq"], op["lift"])) == dict(k4)
    pool, _, _ = prepare_surface_bc(flags["bc"],
                                    adiabatic_mask(disc, flags["bc"]), 2)
    assert pool.shape[0] == roofline_tri.CAVITY_POOL_ROWS_2D
    k = 2 * 128 * 128
    b3, b4 = roofline_tri.k3_bound(3, k), roofline_tri.k4_bound(3, k)
    assert (b3.by, round(b3.ms, 4)) == ("operations", 0.0119)
    assert (b4.by, round(b4.ms, 4)) == ("bytes", 0.0198)
    # rows an element: K3 reads q (4 x 10) and geo (4), writes ph_qf
    # (4 x 10), the traces (6 x 12) and v(U) (4 x 12); K4 reads v (4 x
    # 12), qm, its logs, the neighbours' traces, nxj, sj, 1/sj and the six
    # wall rows (22 x 12), geo, 1/J, wJq (12) and ph_qf (4 x 10), writes
    # dq (4 x 10), the traction (4 x 12), the production and v (4 x 12)
    assert b3.n_bytes == (204 * k + 2 * 24 * 24 + 120 + 288 + 240) * 4
    assert b4.n_bytes == (
        (48 + 22 * 12 + 4 + 1 + 12 + 40 + 40 + 48 + 1 + 48) * k
        + 36 * 12 + 12 * 12 + 12 * 12 + 2 * 10 * 12 + 10 * 12) * 4


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "h100_bench_test_metric_" + name.replace(".", "_"),
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(spans_us, k):
    """A Trace of three steps of one stage, each holding the given (span
    name, device us) launches; the first and last steps are left out of
    the window, as in a run."""
    host, device, corr, clock = [], [], 0, 0.0
    for _ in range(3):
        start = clock
        for name, us in spans_us:
            corr += 1
            host.append({"ph": "X", "cat": "user_annotation", "name": name,
                         "ts": clock, "dur": 4.0})
            host.append({"ph": "X", "cat": "cuda_runtime",
                         "name": "cudaLaunchKernel", "ts": clock + 1.0,
                         "dur": 1.0, "args": {"correlation": corr}})
            device.append({"ph": "X", "cat": "kernel",
                           "name": f"void k{corr}(float*)",
                           "ts": clock + 4.0, "dur": us,
                           "args": {"correlation": corr}})
            clock += 4.0 + us
        host.append({"ph": "X", "cat": "user_annotation",
                     "name": devtrace.STEP_RANGE, "ts": start,
                     "dur": clock - start + 3.0})
        clock += 10.0
    t = devtrace.Trace(host + device, 3, 1)
    t.context = {"n": 3, "num_elements": k}
    return t


def test_shares_read_the_launch_spans_and_a_tree_without_them_none():
    k = 2 * 384 * 384
    k3, k4 = _metric("k3_roofline.tri"), _metric("k4_roofline.tri")
    b3 = roofline_tri.k3_bound(3, k).ms
    b4 = roofline_tri.k4_bound(3, k).ms
    # each launch at four times its bound: 25%
    t = _trace([(k3.SPAN, 4e3 * b3), ("core.discretization.gather_traces",
                                      50.0), (k4.SPAN, 4e3 * b4)], k)
    assert k3.read(t) == pytest.approx(25.0)
    assert k4.read(t) == pytest.approx(25.0)
    # the parent's tree: the launches carry no span
    t = _trace([("core.discretization.gather_traces", 50.0)], k)
    assert k3.read(t) is None and k4.read(t) is None

"""The curved Euler configuration (``configs/euler_hex_curved``) on the
CPU: the port's path against the configuration's reference on the warped
mesh, the free stream, the metric really curved, the kernels' forms the
program resolves to, entropy conservation, and, through the harness's own
control and comparison, the program correct while the TF32 control and a
program without the pairwise metric average are not."""

import contextlib
import functools
import json
from pathlib import Path

import pytest
import torch

from h100_bench import checks, control, harness
from h100_bench.configs import euler_hex_curved as config

ROOT = Path(__file__).resolve().parents[2]
CELL = "euler_hex_curved.n3_k32"
CPU = torch.device("cpu")
F64 = torch.float64


@functools.lru_cache(maxsize=None)
def _cell(k1d):
    return harness.load_cell(CELL, ROOT, overrides={"k1d": k1d,
                                                    "warmup_steps": 1})


@functools.lru_cache(maxsize=None)
def _problems(k1d):
    """(port, reference) as (disc, rhs), both in float64."""
    cell = _cell(k1d)
    port = config.port_problem(cell.cfg, cell.wl, F64, CPU)
    ref = config.reference_problem(cell.cfg, cell.wl, F64, CPU)
    return port, ref


def _random_state(k1d, seed, dtype=F64):
    """The EC random field with every velocity component moving."""
    cell = _cell(k1d)
    q = config.start_state(cell.cfg, cell.wl, seed, CPU).to(dtype)
    gen = torch.Generator().manual_seed(seed)
    u = 0.3 * torch.randn((3, *q.shape[1:]), generator=gen, dtype=dtype)
    rho = q[0]
    q[1:4] = rho * u
    q[4] = q[4] - 0.5 * rho + 0.5 * rho * (u * u).sum(0)
    return q


@pytest.mark.parametrize("k1d", [3, 4])
def test_port_matches_the_reference_in_f64(k1d):
    (_, port), (_, ref) = _problems(k1d)
    for seed in (2 ** 31 + 7, 3 * 2 ** 30 + 1):
        q = _random_state(k1d, seed)
        assert checks.field_gap(port(q, 0.0)[0], ref(q, 0.0)) <= 1e-12


def test_port_in_f32_within_the_cell_limit():
    k1d = 3
    cell = _cell(k1d)
    prog = config.program(cell.cfg, cell.wl, CPU)
    (_, ref) = _problems(k1d)[1]
    q = _random_state(k1d, 2 ** 31 + 9)
    gap = checks.field_gap(prog.rhs(q.float(), 0.0)[0], ref(q, 0.0))
    assert gap <= cell.wl["limits"]["rhs_gap"]
    assert prog.dof == 5 * 64 * 27


def test_free_stream_is_preserved():
    (disc, port), (_, ref) = _problems(3)
    q = torch.empty((5, disc.np_, disc.num_elements), dtype=F64)
    for f, v in enumerate((1.3, 0.39, -0.26, 0.13, 3.1)):
        q[f] = v
    assert float(port(q, 0.0)[0].abs().max()) <= 1e-12
    assert float(ref(q, 0.0).abs().max()) <= 1e-12


def test_the_metric_is_curved_and_the_program_takes_the_curved_forms():
    from esdg_cns_tpu_torch.ops.fused_volume import detect_axis_aligned
    from esdg_cns_tpu_torch.solvers.euler_fused import resolve_volume_mode

    (port_disc, _), (ref_disc, _) = _problems(3)
    for disc in (port_disc, ref_disc):
        assert not disc.affine
        assert disc.geo.shape == (9, disc.nh, disc.num_elements)
        assert disc.grid_shape == (3, 3, 3)
        # the metric varies inside each element
        spread = (disc.geo - disc.geo.mean(1, keepdim=True)).abs().amax()
        assert float(spread) > 1e-3 * float(disc.geo.abs().max())
    assert resolve_volume_mode(port_disc, "auto") == "joint"
    assert detect_axis_aligned(port_disc) is False
    assert torch.equal(port_disc.geo, ref_disc.geo)


def test_entropy_is_conserved_without_dissipation():
    from esdg_cns_tpu_torch.solvers.euler_fused import make_euler_rhs_fused

    disc = _problems(3)[0][0]
    rhs = make_euler_rhs_fused(disc, dissipation=False, compute_rhstest=True)
    _, aux = rhs(_random_state(3, 2 ** 31 + 13), 0.0)
    assert abs(float(aux["rhstest"])) <= 1e-12


@contextlib.contextmanager
def _mean_metric():
    """K1 on each element's mean metric in place of geo [9, Nh, K]: the
    pairwise average of the metric dropped."""
    from esdg_cns_tpu_torch.solvers import euler_fused

    good = euler_fused.euler_volume

    @functools.wraps(good)
    def k1(q, geo, *args, **kw):
        return good(q, geo.mean(1, keepdim=True).expand_as(geo).contiguous(),
                    *args, **kw)

    with control._patched(euler_fused, "euler_volume", k1):
        yield


def test_control_and_mean_metric_fail_and_program_passes(monkeypatch):
    monkeypatch.setitem(control.FAULTS, "mean_metric", _mean_metric)
    lines = []
    rc = control.main(["--workload", CELL, "--sides",
                       "program,control,mean_metric", "--seeds", "2",
                       "--other-seeds", "2", "--seconds", "0.3"],
                      device=CPU, overrides={"k1d": 3, "warmup_steps": 1},
                      out=lines.append)
    rows = [json.loads(x) for x in lines]
    runs = [r for r in rows if not r.get("summary")]
    assert rc == 0 and len(runs) == 6
    for row in runs:
        assert row["correct"] is (row["side"] == "program"), row

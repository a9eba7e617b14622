"""The 3D cavity RHS's tail after K4 (``ops.cns_tail``), on the CPU.

The tail kernel runs only on the card (``tests/test_torch_gpu.py`` holds
it against the plain tail there); here: the per-face-point rule that it
reads against ``WallBC.stress_normal`` and the exchange, the CPU path of
the RHS, which is the plain tail bit for bit, and where the wrapper is
called.  The kernel's own launch is replayed on a stand-in card, whose
library launches nothing, to hold where it sits among the spans.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from esdg_cns_tpu_torch import kernels, tracing
from esdg_cns_tpu_torch.cavity_cases import becker_case, cavity_case
from esdg_cns_tpu_torch.ops import cns_tail as ct
from esdg_cns_tpu_torch.solvers import make_cns_rhs_affine
from esdg_cns_tpu_torch.solvers._shared import neighbor_traction
from esdg_cns_tpu_torch.solvers.boundary import Region, make_wall_bc
from esdg_cns_tpu_torch.solvers.dg_ops import _apply

F32, F64 = torch.float32, torch.float64
TAIL = "solvers.cns_fused.tail"
WRAPPER = ct.cns_traction_tail     # the counters' holder, whatever a spy


def _traction(disc, dtype, seed=0):
    """A seeded traction t_f [5, Nfq, K]."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((5, disc.nfq,
                                                disc.num_elements)),
                           dtype=dtype)


def _ordered_walls(disc, dtype):
    """Every kind the rule has a code for, on walls that share their edge
    nodes: the z walls adiabatic (array wall speeds at z = -1), then the
    x = 1 wall isothermal over them, then the y walls adiabatic with
    scalar speeds over both, then a Dirichlet x = -1 wall without ghost
    stresses.  Returns the WallBC."""
    rng = np.random.default_rng(4)
    xf = disc.xf
    wall = lambda axis, side: disc.bmask & ((xf[axis] - side).abs() < 1e-10)
    sh = (disc.nfq, disc.num_elements)
    arr = lambda: torch.as_tensor(0.2 * rng.standard_normal(sh), dtype=dtype)
    state = torch.ones((5, *sh), dtype=dtype)
    return make_wall_bc(disc, [
        Region(mask=wall(2, 1.0), kind="adiabatic", u_wall=(1.0, 0.0, 0.0)),
        Region(mask=wall(2, -1.0), kind="adiabatic",
               u_wall=(arr(), arr(), 0.25)),
        Region(mask=wall(0, 1.0), kind="isothermal", u_wall=(0.0,) * 3,
               theta=1.0),
        Region(mask=wall(1, 1.0) | wall(1, -1.0), kind="adiabatic",
               u_wall=(0.5, -0.3, 0.1)),
        Region(mask=wall(0, -1.0), kind="dirichlet",
               state=lambda t: state)])


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("case", ["isothermal", "adiabatic", "lid_profile",
                                  "dirichlet", "nobc", "ordered", "becker"])
def test_rule_gives_the_plain_neighbour_traction(case, dtype):
    """The rule's traction is the exchange and stress_normal, bit for
    bit, and so is the plain tail on it; interior points carry map_p."""
    if case == "becker":
        disc, _, bc, _ = becker_case(3, 2, 3, dtype, "cpu", wall=True)
    else:
        disc, _, bc, _ = cavity_case(
            "isothermal" if case == "ordered" else case, 2, 3, dtype, "cpu",
            dim=3)
        if case == "ordered":
            bc = _ordered_walls(disc, dtype)
    rule = ct.traction_rule(disc, bc)
    code = rule.code
    assert code.dtype == torch.int32 and code.shape == disc.map_p.shape
    inside = ~disc.bmask
    assert torch.equal(code[inside], disc.map_p[inside])
    assert bool((code[disc.bmask] < 0).all())
    t_f = _traction(disc, dtype)
    t_pn = neighbor_traction(disc, bc, t_f, disc.gather_traces(t_f))
    assert torch.equal(ct.rule_traction(t_f, rule), t_pn)
    dq_part = torch.randn((5, disc.nq, disc.num_elements), dtype=dtype)
    inv_j = disc.inv_jac[:1]
    want = dq_part + _apply(disc.lift, 0.5 * (t_pn - t_f)) * inv_j[None]
    got = ct.cns_traction_tail_plain(dq_part, t_f, disc.lift, inv_j,
                                     rule=rule)
    assert torch.equal(got, want)


def test_rule_codes_follow_the_region_order():
    """Each boundary point takes the code of the last region over it:
    natural where that is isothermal or Dirichlet, else the row of its
    adiabatic region's 2 u_wall."""
    disc, _, _, _ = cavity_case("isothermal", 2, 3, F64, "cpu", dim=3)
    bc = _ordered_walls(disc, F64)
    rule = ct.traction_rule(disc, bc)
    last = torch.full(disc.bmask.shape, -1)
    for i, r in enumerate(bc.regions):
        last = torch.where(r.mask, i, last)
    code, wall = rule.code, rule.wall
    natural = (last == 2) | (last == 4)
    assert bool((code[natural] == ct.NATURAL).all())
    row = -2 - code.long()
    # scalar speeds: one row a region
    for i, u in ((0, (1.0, 0.0, 0.0)), (3, (0.5, -0.3, 0.1))):
        rows = row[last == i]
        assert bool((rows == rows[0]).all())
        assert torch.equal(wall[rows[0]], 2.0 * torch.tensor(u, dtype=F64))
    # array speeds: a row a point, its own
    m = last == 1
    u = bc.regions[1].u_wall
    assert torch.equal(wall[row[m]], torch.stack(
        [2.0 * u[0][m], 2.0 * u[1][m], torch.full_like(u[0][m], 0.5)],
        dim=1))
    assert len(set(row[m].tolist())) == int(m.sum())


@pytest.mark.parametrize("case", ["slip", "mixed", "stress_state"])
def test_rule_has_no_code_for_slip_or_ghost_stresses(case):
    disc, _, bc, _ = cavity_case("isothermal" if case == "stress_state"
                                 else case, 2, 3, F64, "cpu", dim=3)
    if case == "stress_state":
        bc = make_wall_bc(disc, list(bc.regions) + [Region(
            mask=bc.regions[0].mask, kind="dirichlet",
            state=lambda t: None, stress_state=lambda t: None)])
    assert ct.traction_rule(disc, bc) is None


def _spy(monkeypatch):
    """Wraps the tail wrapper: the inputs, output and open spans of each
    call."""
    calls = []

    def spy(dq_part, t_f, lift, inv_j, **kw):
        dq_in = dq_part.clone()
        spans = [r.name for r in tracing._store.open]
        out = WRAPPER(dq_part, t_f, lift, inv_j, **kw)
        calls.append((dq_in, t_f, lift, inv_j, kw, spans, out))
        return out

    # the wrapper counts through its module's name: the spy holds the
    # same counters
    spy.forms, spy.launches = WRAPPER.forms, WRAPPER.launches
    monkeypatch.setattr(ct, "cns_traction_tail", spy)
    return calls


def _rhs(disc, bc, p, **kw):
    return make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl="fused_hex", **kw)


@pytest.mark.parametrize("case", ["isothermal", "adiabatic", "mixed"])
def test_cpu_rhs_runs_the_plain_tail_bit_for_bit(monkeypatch, case):
    """On the CPU the fold_tail RHS hands the wrapper the plain t_pn, and
    the wrapper returns the plain tail's lines, inside the tail span, and
    counts plain."""
    disc, q, bc, p = cavity_case(case, 2, 3, F64, "cpu", dim=3)
    calls = _spy(monkeypatch)
    forms = dict(WRAPPER.forms)
    launches = WRAPPER.launches
    tracing.reset()
    tracing.enable(True)
    try:
        dq, aux = _rhs(disc, bc, p, compute_rhstest=False)(q, 0.0)
    finally:
        tracing.enable(False)
        tracing.reset()
    assert set(aux) == {"rhstest_visc"}
    assert WRAPPER.forms == dict(forms, plain=forms["plain"] + 1)
    assert ct.cns_traction_tail.launches == launches
    (dq_in, t_f, lift, inv_j, kw, spans, out), = calls
    assert kw["rule"] is None and spans == [TAIL]
    t_pn = neighbor_traction(disc, bc, t_f, disc.gather_traces(t_f))
    want = dq_in + _apply(disc.lift, 0.5 * (t_pn - t_f)) * inv_j[None]
    assert out is dq and torch.equal(dq, want)


def test_rhstest_path_never_calls_the_wrapper(monkeypatch):
    disc, q, bc, p = cavity_case("adiabatic", 2, 3, F64, "cpu", dim=3)
    calls = _spy(monkeypatch)
    forms = dict(WRAPPER.forms)
    _, aux = _rhs(disc, bc, p, compute_rhstest=True)(q, 0.0)
    assert "rhstest" in aux
    assert calls == [] and WRAPPER.forms == forms


def test_wrapper_takes_one_of_rule_and_t_pn():
    disc, _, bc, _ = cavity_case("isothermal", 2, 3, F64, "cpu", dim=3)
    t_f = _traction(disc, F64)
    dq_part = torch.zeros((5, disc.nq, disc.num_elements), dtype=F64)
    rule = ct.traction_rule(disc, bc)
    for kw in ({}, {"rule": rule, "t_pn": t_f}):
        with pytest.raises(ValueError):
            ct.cns_traction_tail(dq_part, t_f, disc.lift, disc.inv_jac[:1],
                                 **kw)


# ---- the kernel's launch on a stand-in card ----
class _Card:
    type = "cuda"


class _OnCard(torch.Tensor):
    """A CPU tensor that reports the stand-in card as its device."""

    @property
    def device(self):
        return _Card


class _TorchOnCard:
    cuda = types.SimpleNamespace(
        device=lambda device: contextlib.nullcontext(),
        current_stream=lambda device: types.SimpleNamespace(cuda_stream=0))

    def __getattr__(self, name):
        return getattr(torch, name)


def test_kernel_launches_inside_the_callers_span_and_counts(monkeypatch):
    """The wrapper opens no span of its own around the launch (the tail
    span's self time reads it), passes the kernel its six arrays and
    counts the launch and its form."""
    calls = []

    class Library:
        def esdg_cns_tail(self, dtype, n1, ptrs, k, stream):
            calls.append((dtype, n1, list(ptrs), k,
                          [r.name for r in tracing._store.open]))
            return 0

    monkeypatch.setattr(kernels, "library", Library)
    monkeypatch.setattr(ct, "torch", _TorchOnCard())
    disc, _, bc, _ = cavity_case("adiabatic", 2, 3, F32, "cpu", dim=3)
    rule = ct.TractionRule(*(t.as_subclass(_OnCard)
                             for t in ct.traction_rule(disc, bc)))
    args = [t.contiguous().as_subclass(_OnCard) for t in (
        torch.zeros((5, disc.nq, disc.num_elements), dtype=F32),
        _traction(disc, F32), disc.lift, disc.inv_jac[:1])]
    forms = dict(WRAPPER.forms)
    launches = WRAPPER.launches
    tracing.reset()
    tracing.enable(True)
    try:
        with tracing.span(TAIL):
            out = ct.cns_traction_tail(*args, rule=rule)
    finally:
        tracing.enable(False)
        tracing.reset()
    assert out is args[0]
    (dtype, n1, ptrs, k, spans), = calls
    assert (dtype, n1, k, spans) == (0, 3, disc.num_elements, [TAIL])
    assert ptrs == [t.data_ptr() for t in (args[0], args[1], rule.code,
                                           rule.wall, args[2], args[3])]
    assert WRAPPER.launches == launches + 1
    assert WRAPPER.forms == dict(forms, kernel=forms["kernel"] + 1)

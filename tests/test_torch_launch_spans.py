"""The launch spans and launch counts by form of K1 and K2 (the Euler
paths) and of K3 and K4 (the cavities), on the CPU.

The wrappers take their plain versions for CPU tensors, so here their
CUDA branch runs on a stand-in card: tensors that report a CUDA device,
``torch`` as ``ops.fused_volume`` sees it with device guards and streams
that do nothing, and a kernel library whose entries launch nothing and
return 0.  The fused RHS's own calls to the wrappers are replayed on it,
so each test holds the forms that the path itself asks for.
``tests/test_torch_gpu.py`` holds the same counts on the card.
"""

import contextlib
import dataclasses
import functools
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esdg_cns_tpu_torch import kernels, tracing
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.ops import modal_volume as mv
from esdg_cns_tpu_torch.ops import surface_viscous as sv
from esdg_cns_tpu_torch.presets import (euler_hex_3d, lid_driven_cavity,
                                        lid_driven_cavity_3d)
from esdg_cns_tpu_torch.solvers import euler_fused
from esdg_cns_tpu_torch.solvers.cns_fused import make_cns_rhs_affine

CPU = torch.device("cpu")
F64 = torch.float64
K1 = "ops.fused_volume.euler_volume"
K2 = "ops.fused_volume.euler_surface"
PROJECT = "ops.fused_volume.hex_project"
GATHER = "core.discretization.gather_traces"
K3 = "ops.modal_volume.euler_modal_volume"
K4 = "ops.surface_viscous.cns_surface_viscous"
TAIL = "solvers.cns_fused.tail"


class _Card:
    """Stands in for a CUDA device."""
    type = "cuda"


CARD = _Card()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports the stand-in card as its device."""

    @property
    def device(self):
        return CARD


def _on_card(x):
    if isinstance(x, torch.Tensor):
        return x.as_subclass(_OnCard)
    if isinstance(x, (list, tuple)):
        return type(x)(_on_card(v) for v in x)
    return x


class _TorchOnCard:
    """``torch`` as the wrappers see it on the stand-in card."""

    cuda = types.SimpleNamespace(
        device=lambda device: contextlib.nullcontext(),
        current_stream=lambda device: types.SimpleNamespace(cuda_stream=0))

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(shape, dtype, device):
        return _on_card(torch.empty(shape, dtype=dtype))

    @staticmethod
    def as_tensor(a, dtype=None, device=None):
        return _on_card(torch.as_tensor(a, dtype=dtype))


class _Library:
    """A kernel library whose entries launch nothing; it notes each
    entry called and whether a span was open around it."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, [r.name for r in tracing._store.open]))
            self.args.append(args)
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    """The stand-in card under the fused RHS's wrapper calls; yields the
    library."""
    lib = _Library()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(fv, "torch", _TorchOnCard())
    for name in ("euler_volume", "euler_surface",
                 "euler_volume_split_parts"):
        real = getattr(fv, name)

        def on_card(*args, _real=real, **kw):
            return _real(*_on_card(args),
                         **{k: _on_card(v) for k, v in kw.items()})

        monkeypatch.setattr(euler_fused, name, on_card)
    tracing.enable(False)
    tracing.reset()
    yield lib
    tracing.enable(False)
    tracing.reset()


def _disc(curved, n=3, gather=False):
    disc, q = euler_hex_3d(n, 2, curved=curved, dtype=F64, device=CPU)
    if gather:
        disc = dataclasses.replace(disc, grid_shape=None)
    return disc, q


# esdg_hex_volume's argument that takes v(U)'s pointer, null for none
_VOUT = 14


def _forms(before, wrapper):
    return {k: v - before[k] for k, v in wrapper.forms.items()
            if v != before[k]}


def _rhs_forms(disc, q, **kw):
    """K1's and K2's launches by form in one RHS call."""
    rhs = euler_fused.make_euler_rhs_fused(disc, dissipation=True, **kw)
    v0, s0 = dict(fv.euler_volume.forms), dict(fv.euler_surface.forms)
    rhs(q, 0.0)
    return _forms(v0, fv.euler_volume), _forms(s0, fv.euler_surface)


@pytest.mark.parametrize("curved, gather, k1, k2", [
    (True, False, "curved", "general.grid"),
    (False, False, "diag", "diag.grid"),
    (True, True, "curved", "general.gather"),
    (False, True, "diag", "diag.gather"),
])
def test_rhs_counts_its_launches_by_form(card, curved, gather, k1, k2):
    disc, q = _disc(curved, gather=gather)
    launches = fv.euler_volume.launches, fv.euler_surface.launches
    with_v = fv.euler_volume.with_v
    assert _rhs_forms(disc, q) == ({k1: 1}, {k2: 1})
    assert (fv.euler_volume.launches, fv.euler_surface.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert [name for name, _ in card.calls] == ["esdg_hex_volume",
                                                "esdg_hex_surface"]
    # the Euler front asks K1 for no v(U)
    assert card.args[0][_VOUT] is None
    assert fv.euler_volume.with_v == with_v


@pytest.mark.parametrize("with_v", [False, True])
def test_k1_writes_v_only_when_asked(card, with_v):
    disc, q = _disc(False)
    args = _on_card((q, disc.geo, disc.vhp[disc.nq:].contiguous(),
                     disc.lift))
    before = (fv.euler_volume.launches, fv.euler_volume.with_v)
    res = fv.euler_volume(*args, 1.4, line_ops=disc.line_ops, diag=True,
                          with_v=with_v)
    assert len(res) == (3 if with_v else 2)
    (name, _), = card.calls
    assert name == "esdg_hex_volume"
    if with_v:
        assert res[2].shape == q.shape
        assert card.args[0][_VOUT] == res[2].data_ptr()
    else:
        assert card.args[0][_VOUT] is None
    assert (fv.euler_volume.launches, fv.euler_volume.with_v) == (
        before[0] + 1, before[1] + with_v)


def test_general_affine_and_split_forms(card):
    disc, q = _disc(False)
    assert _rhs_forms(disc, q, axis_aligned=False) == (
        {"general": 1}, {"general.grid": 1})
    # the split front: no K1, K2 takes the three parts
    assert _rhs_forms(disc, q, volume_mode="split") == (
        {}, {"diag.grid": 1, "split": 1})


def test_spans_off_record_nothing(card):
    disc, q = _disc(True)
    _rhs_forms(disc, q)
    assert tracing.records() == []
    assert [spans for _, spans in card.calls] == [[], []]


def test_each_launch_records_its_span_once_a_call(card):
    disc, q = _disc(True)
    rhs = euler_fused.make_euler_rhs_fused(disc, dissipation=True)
    tracing.enable(True)
    for _ in range(2):
        rhs(q, 0.0)
    recs = tracing.records()
    assert [r.name for r in recs] == [K1, K2] * 2
    assert all(r.parent is None and r.host_ms is not None for r in recs)
    # each library call ran inside its own span, and nothing else did
    assert card.calls == [("esdg_hex_volume", [K1]),
                          ("esdg_hex_surface", [K2])] * 2
    # no CUDA here: host stamps only
    assert all(r.device_ms is None for r in recs)


def test_gather_and_split_paths_nest_nothing_in_the_launch_spans(card):
    disc, q = _disc(True, gather=True)
    tracing.enable(True)
    euler_fused.make_euler_rhs_fused(disc, dissipation=True)(q, 0.0)
    assert [r.name for r in tracing.records()] == [K1, GATHER, K2]
    tracing.reset()
    disc, q = _disc(False)
    euler_fused.make_euler_rhs_fused(disc, dissipation=True,
                                     volume_mode="split")(q, 0.0)
    assert [r.name for r in tracing.records()] == [PROJECT, K2]


def test_profiler_sees_the_launch_spans(card, tmp_path):
    disc, q = _disc(True)
    rhs = euler_fused.make_euler_rhs_fused(disc, dissipation=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rhs(q, 0.0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count(K1) == 1 and names.count(K2) == 1


@pytest.fixture
def cavity_card(card, monkeypatch):
    """The stand-in card under the cavity RHS's calls of K3 and K4: the
    wrappers, as ``make_cns_rhs_affine`` imports them when it builds the
    RHS, take their arguments on the card; their counters are the real
    wrappers' (``functools.wraps`` shares the forms).  Yields the
    library."""
    from esdg_cns_tpu_torch.ops.cns_surface_bc import region_table

    for mod in (mv, sv):
        monkeypatch.setattr(mod, "torch", _TorchOnCard())
    monkeypatch.setattr(sv, "region_table",
                        lambda recipe, device: region_table(recipe, CPU))
    for mod, name in ((mv, "euler_modal_volume"),
                      (sv, "cns_surface_viscous")):
        real = getattr(mod, name)

        @functools.wraps(real)
        def on_card(*args, _real=real, **kw):
            return _real(*_on_card(args),
                         **{k: _on_card(v) for k, v in kw.items()})

        monkeypatch.setattr(mod, name, on_card)
    yield card


def _cavity(dim, volume_impl, rhstest=False):
    """A cavity's RHS (isothermal walls, N=3, both dissipations) and its
    state at rest."""
    make = lid_driven_cavity if dim == 2 else lid_driven_cavity_3d
    disc, q0, bc, p = make(3, 2, dtype=F64, device=CPU)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl=volume_impl, compute_rhstest=rhstest)
    return rhs, q0


@pytest.mark.parametrize("dim, volume_impl, rhstest, k3, k4", [
    # the 2D cavity cell's path: K3, then K4 with the LIFTs folded in
    (2, "fused", False, {"dim2.affine": 1}, {"dim2.proj.fold_tail": 1}),
    (2, "fused", True, {"dim2.affine": 1}, {"dim2.proj.unfolded": 1}),
    (3, "fused", False, {"dim3.affine": 1}, {"dim3.proj.fold_tail": 1}),
    # K1's front (its plain version here, the state being on the CPU)
    (3, "fused_hex", False, {}, {"dim3.no_proj.fold_tail": 1}),
])
def test_cavity_rhs_counts_k3_and_k4_by_form(cavity_card, dim, volume_impl,
                                             rhstest, k3, k4):
    rhs, q = _cavity(dim, volume_impl, rhstest)
    launches = mv.euler_modal_volume.launches, sv.cns_surface_viscous.launches
    v0, s0 = dict(mv.euler_modal_volume.forms), dict(
        sv.cns_surface_viscous.forms)
    rhs(q, 0.0)
    assert (_forms(v0, mv.euler_modal_volume),
            _forms(s0, sv.cns_surface_viscous)) == (k3, k4)
    assert (mv.euler_modal_volume.launches,
            sv.cns_surface_viscous.launches) == (launches[0] + len(k3),
                                                 launches[1] + 1)
    assert [name for name, _ in cavity_card.calls] == (
        ["esdg_modal_volume"] * len(k3) + ["esdg_cns_surface_viscous"])


def test_cavity_launch_spans_hold_their_launches_alone(cavity_card):
    rhs, q = _cavity(2, "fused")
    rhs(q, 0.0)
    # off: no record, no span around either launch
    assert tracing.records() == []
    assert [spans for _, spans in cavity_card.calls] == [[], []]
    cavity_card.calls.clear()
    tracing.enable(True)
    for _ in range(2):
        rhs(q, 0.0)
    recs = tracing.records()
    # exchange 1 between the launches; the plain tail's exchange 2 in it
    assert [r.name for r in recs] == [K3, GATHER, K4, TAIL, GATHER] * 2
    assert [r.parent is None for r in recs] == [True] * 4 + [False] + (
        [True] * 4 + [False])
    assert cavity_card.calls == [("esdg_modal_volume", [K3]),
                                 ("esdg_cns_surface_viscous", [K4])] * 2

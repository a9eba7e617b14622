"""The port's spans (``esdg_cns_tpu_torch.tracing``) on the CPU.

Spans are off by default and then open no profiler range; a torch
profiler or ``enable(True)`` turns them on; one LSRK45 step holds its 5
updates, and on the 3D cavity each RHS call's v(U), both exchanges and
its tail; the numerics are bitwise the same with spans on and off;
device times exist only on the card, and only after ``enable(True)``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esdg_cns_tpu_torch import tracing
from esdg_cns_tpu_torch.cavity_cases import moving_state
from esdg_cns_tpu_torch.presets import euler_hex_3d, lid_driven_cavity_3d
from esdg_cns_tpu_torch.solvers.cns_fused import make_cns_rhs_affine
from esdg_cns_tpu_torch.solvers.euler_fused import make_euler_rhs_fused
from esdg_cns_tpu_torch.timestepping.explicit import lsrk45

CPU = torch.device("cpu")
F64 = torch.float64
STEP = "timestepping.explicit.lsrk45.step"
UPDATE = "timestepping.explicit.lsrk45.update"
ENTROPY_VARS = "solvers.cns_fused.entropy_vars"
GATHER = "core.discretization.gather_traces"
TAIL = "solvers.cns_fused.tail"
# the spans of one RHS call, outermost ones, in order (the cavity's K1
# front hands on its own v(U), so no entropy_vars span opens there)
RHS_SPANS = {"euler": [], "cavity": [GATHER, TAIL]}


def _euler():
    disc, q0 = euler_hex_3d(3, 2, dtype=F64, device=CPU)
    return make_euler_rhs_fused(disc, dissipation=True), q0


def _cavity():
    # the benchmark cavity's path: the fused_hex front (K1), K4 with the
    # tail folded, both dissipations, isothermal walls
    disc, q0, bc, p = lid_driven_cavity_3d(3, 2, dtype=F64, device=CPU)
    rhs = make_cns_rhs_affine(
        disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
        inviscid_dissipation=True, viscous_dissipation=True,
        volume_impl="fused_hex", compute_rhstest=False)
    return rhs, moving_state(q0, np.random.default_rng(5))


PATHS = {"euler": _euler, "cavity": _cavity}


@pytest.fixture(scope="module")
def problems():
    return {name: make() for name, make in PATHS.items()}


@pytest.fixture(autouse=True)
def empty_store():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture
def entered(monkeypatch):
    """Counts the profiler ranges (record_function's) the spans open."""
    calls = []
    real = tracing.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    return calls


def _step(rhs, q):
    return lsrk45(rhs, q, 1e-4, 1)[0]


def _children(recs):
    out = {}
    for r in recs:
        out.setdefault(r.parent, []).append(r)
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_off_by_default_record_nothing(problems, entered, path):
    rhs, q = problems[path]
    rhs(q, 0.0)
    _step(rhs, q)
    assert tracing.records() == []
    assert tracing.summary() == {}
    assert entered == []
    # off, every span is the one shared no-op context
    assert tracing.span("a") is tracing.span("b")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_profiled_step_nests_stages_rhs_and_update(problems, entered, path,
                                                   tmp_path):
    rhs, q = problems[path]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(rhs, q)
    recs = tracing.records()
    assert entered == [r.name for r in recs]
    kids = _children(recs)
    steps = [r for r in recs if r.name == STEP]
    assert len(steps) == 1 and steps[0].parent is None
    assert [r.name for r in kids[steps[0].id]] == (
        RHS_SPANS[path] + [UPDATE]) * 5
    assert all(r.host_ms is not None and r.host_ms >= 0 for r in recs)
    # each name is on the profiler's timeline as a user annotation
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert {r.name for r in recs} <= annotated


def test_cavity_rhs_holds_front_exchanges_and_tail(problems):
    rhs, q = problems["cavity"]
    with profile(activities=[ProfilerActivity.CPU]):
        rhs(q, 0.0)
    recs = tracing.records()
    kids = _children(recs)
    # exchange 1 after the volume front, then the tail holding exchange 2
    # (no kernel launches on the CPU, so no launch spans; the front's v(U)
    # is K1's, so no entropy_vars span)
    assert [r.name for r in kids[None]] == RHS_SPANS["cavity"]
    assert ENTROPY_VARS not in {r.name for r in recs}
    tail = kids[None][-1]
    assert [r.name for r in kids[tail.id]] == [GATHER]
    assert sum(r.name == GATHER for r in recs) == 2
    assert len(recs) == 3


@pytest.mark.parametrize("path", sorted(PATHS))
def test_numerics_bitwise_equal_with_spans_on(problems, path):
    rhs, q = problems[path]
    dq_off, q_off = rhs(q, 0.0)[0], _step(rhs, q)
    tracing.enable(True)
    dq_on, q_on = rhs(q, 0.0)[0], _step(rhs, q)
    assert tracing.records()
    assert torch.equal(dq_on, dq_off)
    assert torch.equal(q_on, q_off)


def test_enable_and_reset(entered):
    tracing.enable(True)
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    outer, inner = tracing.records()
    assert (outer.name, outer.parent) == ("outer", None)
    assert (inner.name, inner.parent) == ("inner", outer.id)
    # no profiler records: no range is opened
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    assert entered == ["outer", "inner"]
    assert tracing.summary()["inner"]["calls"] == 2
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0
    tracing.enable(False)
    with tracing.span("off"):
        pass
    assert tracing.records() == []
    assert entered == ["outer", "inner"]


def test_store_keeps_the_newest_cap_records(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    tracing.enable(True)
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in tracing.records()] == ["s2", "s3", "s4"]
    assert tracing.dropped() == 2
    tracing.reset()
    assert tracing.dropped() == 0


class _ClockEvent:
    """Stands in for a CUDA timing event: the host clock at record()."""

    def __init__(self, enable_timing=False):
        pass

    def record(self, stream=None):
        self.t = tracing.time.perf_counter_ns()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_summary_self_time_is_duration_less_children(monkeypatch):
    # CUDA as the spans see it, with host-clock events in a pool of the
    # test's own
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    monkeypatch.setattr(tracing._store, "pool", [])
    tracing.enable(True)
    for _ in range(2):
        with tracing.span("parent"):
            with tracing.span("child"):
                sum(range(20000))
            with tracing.span("child"):
                with tracing.span("grandchild"):
                    sum(range(20000))
            sum(range(20000))
    recs = tracing.records()
    kids = _children(recs)
    s = tracing.summary()
    assert s["parent"]["calls"] == 2 and s["child"]["calls"] == 4
    for name in ("parent", "child", "grandchild"):
        own = [r for r in recs if r.name == name]
        total = sum(r.device_ms for r in own)
        covered = sum(c.device_ms for r in own for c in kids.get(r.id, []))
        assert s[name]["device_ms"] == pytest.approx(total)
        assert s[name]["self_device_ms"] == pytest.approx(total - covered)
        assert 0 < s[name]["self_device_ms"] <= s[name]["device_ms"]
    assert s["grandchild"]["self_device_ms"] == pytest.approx(
        s["grandchild"]["device_ms"])
    assert s["child"]["device_calls"] == 4
    # the second outermost span took the first's events again: 4 pairs
    # made, all back in the pool once resolved
    assert len(tracing._store.pool) == 4
    tracing.reset()  # while the test's own pool is in place


def test_a_profiler_alone_records_no_device_events(monkeypatch):
    # the profiler times the device itself: spans it turns on stamp the
    # host clock only, even where CUDA is up
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kw: made.append(kw) or _ClockEvent())
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("step"):
            with tracing.span("update"):
                pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["step", "update"]
    assert made == [] and all(r.device_ms is None for r in recs)
    assert all(r.host_ms is not None for r in recs)


def test_outermost_spans_take_the_passed_events_again(monkeypatch):
    made = []

    def event(**kw):
        made.append(kw)
        return _ClockEvent()

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(tracing._store, "pool", [])
    tracing.enable(True)
    for _ in range(7):
        with tracing.span("step"):
            with tracing.span("update"):
                pass
    # every span is stamped; each step hands the events of the one
    # before back first, so two pairs serve all seven
    assert len(made) == 4 and all(kw == {"enable_timing": True}
                                  for kw in made)
    s = tracing.summary()
    assert (s["update"]["calls"], s["update"]["device_calls"]) == (7, 7)
    assert len(tracing._store.pool) == 2
    tracing.reset()  # while the test's own pool is in place


def test_device_times_are_none_on_the_cpu(problems):
    rhs, q = problems["euler"]
    tracing.enable(True)
    _step(rhs, q)
    recs = tracing.records()
    assert recs and all(r.device_ms is None for r in recs)
    s = tracing.summary()
    assert s[STEP]["calls"] == 1 and s[UPDATE]["calls"] == 5
    assert all(v["device_ms"] is None and v["self_device_ms"] is None
               for v in s.values())

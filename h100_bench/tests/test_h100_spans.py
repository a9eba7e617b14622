"""The readers of the program's spans (``spans.py`` and the metrics that
use it) on hand-made profiler traces read through ``devtrace.Trace``, and
the bounds of the two new roofline shares against PERF.md's figures."""

import importlib.util
from pathlib import Path

import pytest

from h100_bench import devtrace, spans

METRICS = Path(__file__).resolve().parents[1] / "metrics"
UPDATE = "timestepping.explicit.lsrk45.update"
PROJECT = "ops.fused_volume.hex_project"
CTX = {"n": 7, "num_elements": 4096}


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "h100_bench_test_metric_" + name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Wait(float):
    """Host time (us) that passes between two launches."""


def trace(steps, stages=5, reverse=False, lag=3.0):
    """A Trace of hand-made chrome events.  ``steps`` holds each step's
    stage: a list of items, each a device operation's duration in us (a
    launch), a Wait, or (span name, [items]) for a program span around
    its items.  Each operation starts ``lag`` us after its launch or when
    the one before it ends (one stream); with ``reverse`` the device
    events come in the trace in reverse order."""
    host, device = [], []
    clock, dev_end, corr = [0.0], [0.0], [0]

    def annotation(name, items):
        a = clock[0]
        clock[0] += 1.0
        emit(items)
        clock[0] += 1.0
        host.append({"ph": "X", "cat": "user_annotation", "name": name,
                     "ts": a, "dur": clock[0] - a})

    def emit(items):
        for it in items:
            if isinstance(it, tuple):
                annotation(*it)
            elif isinstance(it, Wait):
                clock[0] += it
            else:
                corr[0] += 1
                t = clock[0]
                clock[0] += 2.0
                host.append({"ph": "X", "cat": "cuda_runtime",
                             "name": "cudaLaunchKernel", "ts": t, "dur": 1.0,
                             "args": {"correlation": corr[0]}})
                start = max(dev_end[0], t + lag)
                dev_end[0] = start + it
                device.append({"ph": "X", "cat": "kernel",
                               "name": f"void k{corr[0]}(float*)",
                               "ts": start, "dur": float(it),
                               "args": {"correlation": corr[0]}})

    for stage in steps:
        annotation(devtrace.STEP_RANGE, [
            ("timestepping.explicit.lsrk45.step", list(stage) * stages)])
    events = host + (device[::-1] if reverse else device)
    t = devtrace.Trace(events, len(steps), stages)
    t.context = dict(CTX)
    return t


def stage(update_us=50.0):
    """An RHS span of 150 us (100 its own, 50 in a child span) and an
    update span of two operations."""
    return [("rhs", [100.0, ("child", [50.0])]),
            (UPDATE, [20.0, update_us - 20.0])]


def test_first_and_last_steps_are_dropped_and_stages_divide():
    t = trace([stage(900.0), stage(40.0), stage(50.0), stage(60.0),
               stage(900.0)])
    assert spans.span_ms(t, UPDATE) == pytest.approx(0.05)
    assert spans.span_ms(t, "rhs") == pytest.approx(0.15)


def test_self_time_leaves_out_the_children():
    t = trace([stage()] * 3)
    assert spans.span_ms(t, "rhs", self_time=True) == pytest.approx(0.1)
    assert spans.span_ms(t, "child", self_time=True) == pytest.approx(0.05)
    # the step holds every operation, none as its innermost span
    step = "timestepping.explicit.lsrk45.step"
    assert spans.span_ms(t, step) == pytest.approx(0.2)
    assert spans.span_ms(t, step, self_time=True) is None


def test_per_call_divides_by_the_span_count():
    t = trace([[(PROJECT, [80.0]), (PROJECT, [40.0]), (UPDATE, [10.0])]] * 3)
    assert spans.span_ms(t, PROJECT, per="call") == pytest.approx(0.06)
    assert spans.span_ms(t, PROJECT) == pytest.approx(0.12)


@pytest.mark.parametrize("steps", [
    [[100.0, 10.0]] * 3,                        # no program spans at all
    [stage()] * 3,                              # another span's name
    [[("missing", [Wait(5.0)]), 10.0]] * 3,     # the span launched nothing
])
def test_none_without_the_span(steps):
    assert spans.span_ms(trace(steps), "missing") is None


def test_device_events_out_of_start_order_pair_with_their_launches():
    steps = [[("a", [30.0]), ("b", [10.0, 10.0]), ("c", [70.0])]] * 4
    for reverse in (False, True):
        t = trace(steps, reverse=reverse)
        assert spans.span_ms(t, "a") == pytest.approx(0.03)
        assert spans.span_ms(t, "b", per="call") == pytest.approx(0.02)
        assert spans.span_ms(t, "c") == pytest.approx(0.07)


def test_none_where_the_pairing_breaks():
    t = trace([stage()] * 3)
    assert len(spans.launched(t)) == len(t.ops)
    # a launch without its operation
    t.launch_of[-1] = 0.0
    assert spans.launched(t) is None
    assert spans.span_ms(t, UPDATE) is None


def test_a_start_read_before_its_launch_still_pairs():
    # the device clock a few us behind the host's: each operation starts
    # 2 us "before" its launch, and still pairs with it
    t = trace([stage()] * 3, lag=-2.0)
    assert spans.span_ms(t, "rhs", self_time=True) == pytest.approx(0.1)
    assert spans.span_ms(t, UPDATE) == pytest.approx(0.05)


def test_host_waits_inside_a_span_are_not_counted():
    # the card idles 1 ms inside the span while the host is away: the
    # span's device time is its operations' time alone
    t = trace([[(PROJECT, [40.0, Wait(1000.0), 40.0])]] * 3)
    assert spans.span_ms(t, PROJECT, per="call") == pytest.approx(0.08)
    assert t.idle_share() > 0.5


def test_metrics_on_a_tree_without_tracing():
    # the parent's program opens no spans: every reader gives None
    t = trace([[100.0, 10.0, 10.0]] * 12)
    for name in ("cns_entropy_vars_ms", "cns_exchange_ms", "cns_tail_ms",
                 "update_roofline", "project_roofline"):
        assert metric(name).read(t) is None


def test_update_bound_at_the_main_path():
    b = metric("update_roofline").bound(3, 32 ** 3)
    assert b.by == "bytes"
    # 24 passes every 5 stages (4 at the first, where A = 0)
    assert b.n_bytes == 24 * 5 * 64 * 32 ** 3 * 4 // 5
    assert abs(b.ms - 0.0601) <= 5e-5


def test_project_bound_at_the_split_path():
    b = metric("project_roofline").bound(7, 16 ** 3)
    assert b.by == "bytes"
    assert abs(b.ms - 0.0566) <= 0.01 * 0.0566


def test_shares_read_the_spans():
    t = trace([[("rhs", [300.0, (PROJECT, [80.0])]),
                (UPDATE, [100.0, 70.0])]] * 3)
    proj = metric("project_roofline")
    upd = metric("update_roofline")
    assert proj.read(t) == pytest.approx(100 * proj.bound(7, 4096).ms / 0.08)
    assert upd.read(t) == pytest.approx(100 * upd.bound(7, 4096).ms / 0.17)
    cavity = trace([[("solvers.cns_fused.entropy_vars", [250.0]),
                     ("core.discretization.gather_traces", [100.0]),
                     600.0,
                     ("solvers.cns_fused.tail", [
                         20.0, ("core.discretization.gather_traces", [90.0]),
                         500.0])]] * 3)
    assert metric("cns_entropy_vars_ms").read(cavity) == pytest.approx(0.25)
    assert metric("cns_exchange_ms").read(cavity) == pytest.approx(0.19)
    assert metric("cns_tail_ms").read(cavity) == pytest.approx(0.52)

"""The curved forms' roofline shares (``metrics/k1c_roofline.py``,
``metrics/k2c_roofline.py``): their bounds against hand counts at the
cell's shape, N = 3 and K = 32768, and their reading of the program's
launch spans in a traced window.

A share above 105% is refused by the benchmark's check: it would mean the
bound counts bytes or operations the launch does not need, or that the
span's device time leaves out part of the launch's work."""

import importlib.util
from pathlib import Path

import pytest

from h100_bench import devtrace, roofline

METRICS = Path(__file__).resolve().parents[1] / "metrics"
K = 32768
ITEM = 4
# Ef and LIFT of the N = 3 hex, [96, 64] each
OPERATOR = 96 * 64


def metric(name):
    spec = importlib.util.spec_from_file_location(
        "h100_bench_test_metric_" + name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# rows an element: K1c reads q (5 x 64), the nine metric rows at the 64
# volume nodes and the three of the face's direction at the 96 face
# points, writes ph_qf (5 x 64) and the traces (7 x 96); K2c reads the
# traces (7 x 96), nxj (3 x 96), sj and 1/sj (96 each), 1/J (64), ph_qf
# (5 x 64) and writes dq (5 x 64)
@pytest.mark.parametrize("name, rows, operators, ms", [
    ("k1c_roofline", 320 + 9 * 64 + 3 * 96 + 320 + 7 * 96, 2, 0.0852),
    ("k2c_roofline", 672 + 288 + 2 * 96 + 64 + 320 + 320, 1, 0.0726),
])
def test_bounds_match_the_hand_counts(name, rows, operators, ms):
    assert rows == {"k1c_roofline": 2176, "k2c_roofline": 1856}[name]
    b = metric(name).bound(3, K)
    assert b.n_bytes == (rows * K + operators * OPERATOR) * ITEM
    assert b.by == "bytes"
    assert b.ms == pytest.approx(b.n_bytes / roofline.HBM_BYTES_PER_S * 1e3)
    assert abs(b.ms - ms) <= 5e-5


def test_operations_are_the_curved_and_general_counts():
    op = roofline.hex_operators(3)
    ef, lift = roofline.entries(op["ef"]), roofline.entries(op["lift"])
    k1c = metric("k1c_roofline").bound(3, K)
    assert k1c.ops == roofline.ops_k1(4, ef, lift, form="curved") * K
    # the curved pair costs more than the diag pair: 112 against 74
    assert k1c.ops.flops() > roofline.k1_bound(3, K).ops.flops()
    k2c = metric("k2c_roofline").bound(3, K)
    assert k2c.ops == roofline.ops_k2(4, lift, diag=False) * K
    # both forms read more than the affine twin's
    assert k1c.ms > roofline.k1_bound(3, K).ms
    assert k2c.ms > roofline.k2_bound(3, K).ms


def _trace(spans_us, lag=3.0):
    """A Trace of three steps of one stage, each holding the given
    (span name, device us) launches; the first and last steps are left
    out of the window, as in a run."""
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
                           "ts": clock + 1.0 + lag, "dur": us,
                           "args": {"correlation": corr}})
            clock += 4.0 + us
        host.append({"ph": "X", "cat": "user_annotation",
                     "name": devtrace.STEP_RANGE, "ts": start,
                     "dur": clock - start + lag})
        clock += 10.0
    t = devtrace.Trace(host + device, 3, 1)
    t.context = {"n": 3, "num_elements": K}
    return t


def test_shares_read_the_launch_spans():
    k1c, k2c = metric("k1c_roofline"), metric("k2c_roofline")
    b1, b2 = k1c.bound(3, K).ms, k2c.bound(3, K).ms
    # each launch at twice its bound: 50%
    t = _trace([(k1c.SPAN, 2e3 * b1), (k2c.SPAN, 2e3 * b2)])
    assert k1c.read(t) == pytest.approx(50.0)
    assert k2c.read(t) == pytest.approx(50.0)


def test_no_span_no_reading():
    # the parent's tree: the launches carry no span
    t = _trace([("ops.fused_volume.hex_project", 100.0)])
    assert metric("k1c_roofline").read(t) is None
    assert metric("k2c_roofline").read(t) is None

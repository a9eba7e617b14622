"""The harness on the CPU: cells and metrics found by name, the window's
statistics, the import guard, and no result without a card."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from h100_bench import harness
from h100_bench.devtrace import Trace, union_seconds

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "esdg_cns_tpu.ops", "esdg_cns_tpu_torch", "esdg_cns_tpu_torch.ops",
             "jaxtyping", "esdg_cns_tpux", "numpy"]
    assert harness.forbidden_modules(names) == ["esdg_cns_tpu", "flax",
                                                "jax", "jaxlib"]
    assert harness.forbidden_modules(["esdg_cns_tpu_torch.solvers"]) == []


def test_every_cell_and_metric_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        e2e = [m["name"] for m in harness.cell_metrics(cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        for name in e2e:
            assert name == "setup_s" or (
                cell.wl["end_to_end"][name] in harness.QUANTITIES)
        layer = harness.cell_metrics(cell, True)
        assert layer
        for m in layer:
            assert m["moves"] in names and m["moves"] in e2e
            assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    files = tmp_path / "files"
    shutil.copytree(BENCH / "configs", files / "configs")
    (files / "workloads").mkdir()
    (files / "metrics").mkdir()
    wl = json.loads((BENCH / "workloads" / "euler_hex.n3_k32.json")
                    .read_text())
    wl["k1d"] = 24
    (files / "workloads" / "euler_hex.n3_k24.json").write_text(
        json.dumps(wl))
    (files / "metrics" / "steps_traced.py").write_text(
        "def read(trace):\n    return trace.steps\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "euler_hex.n3_k24",
                               "config": "euler_hex", "traffic": "n3_k24",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("euler_"):
            m["workloads"].append("euler_hex.n3_k24")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "euler_dof_stages_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("euler_hex.n3_k24", tmp_path, files=files)
    assert cell.wl["k1d"] == 24 and cell.cfg["name"] == "euler_hex"
    layer = [m["name"] for m in harness.cell_metrics(cell, True)]
    # without a workloads key, every cell reporting the rate reports it
    assert "steps_traced" in layer
    read = harness.metric_reader("steps_traced", files=files)
    assert read(type("T", (), {"steps": 7})()) == 7


def _ssprk33_stepper():
    """A stepper module as a later configuration would add one."""
    mod = types.ModuleType("h100_bench.steppers.ssprk33_test")
    mod.STAGES = 3

    def step(rhs, q, dt, t):
        from esdg_cns_tpu_torch.timestepping import explicit

        return explicit.ssprk33(rhs, q, dt, 1, t0=t)[0]

    def reference_step(rhs, q, dt, t):
        q1 = q + dt * rhs(q, t)
        q2 = 0.75 * q + 0.25 * (q1 + dt * rhs(q1, t + dt))
        return q / 3 + 2 / 3 * (q2 + dt * rhs(q2, t + dt / 2))

    mod.step, mod.reference_step = step, reference_step
    return mod


def test_a_new_stepper_is_found_by_name(tmp_path, monkeypatch):
    mod = _ssprk33_stepper()
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    files = tmp_path / "files"
    shutil.copytree(BENCH / "configs", files / "configs")
    shutil.copytree(BENCH / "workloads", files / "workloads")
    cfg_path = files / "configs" / "euler_hex.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["stepper"] = "ssprk33_test"
    cfg_path.write_text(json.dumps(cfg))
    cell = harness.load_cell("euler_hex.n3_k32", ROOT, files=files,
                             overrides={"k1d": 2, "warmup_steps": 1})
    assert cell.stepper is mod
    logs = []
    res = harness.run(cell, 2 ** 31 + 11, 0.3, False,
                      device=torch.device("cpu"), t_start=0.0,
                      log=logs.append)
    assert res["correct"] is True
    info = json.loads(logs[0])
    # the rate counts the stepper's own stages a step
    assert info["dof_stages_per_s"] == pytest.approx(
        5 * 64 * 8 * 3 * info["steps"] / info["window_s"])


def test_rate_and_p95_cover_every_step():
    # 100 steps: 94 of 2 ms and six of 10 ms, spread out; the p95 falls
    # among the slow ones, which a mean over chunks of 20 would hide
    step_ms = [10.0 if i % 17 == 5 else 2.0 for i in range(100)]
    assert step_ms.count(10.0) == 6
    rate, p95, median = harness.window_stats(step_ms, 0.248, 1000, 5)
    assert rate == pytest.approx(1000 * 5 * 100 / 0.248)
    assert p95 == pytest.approx(10.0)
    assert median == 2.0
    chunks = [sum(step_ms[i:i + 20]) / 20 for i in range(0, 100, 20)]
    assert max(chunks) < 5.0


def _trace_events():
    """A synthetic chrome trace: three steps of one RHS and one update
    kernel each, every kernel tied to its launch."""
    ev, corr, t = [], 0, 0.0
    for s in range(3):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": "h100_bench.step", "ts": t, "dur": 100.0})
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": "h100_bench.rhs", "ts": t + 10, "dur": 40.0})
        for launch, name, dur in ((t + 20, "void esdg::hex_volume_kernel"
                                   "<float, 4>(float const*)", 30.0),
                                  (t + 60, "void at::native::add_kernel()",
                                   10.0)):
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launch, "dur": 2.0,
                       "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": launch + 500.0, "dur": dur,
                       "args": {"correlation": corr}})
        t += 100.0
    return ev


def test_trace_places_each_kernel_by_its_launch():
    tr = Trace(_trace_events(), steps=3, stages_per_step=5)
    assert tr.unmatched == 0 and tr.steps == 1 and tr.stages == 5
    assert tr.kernel("hex_volume_kernel") == (30e-6, 1)
    assert tr.device_ms_per_stage(True) == pytest.approx(0.030 / 5)
    assert tr.device_ms_per_stage(False) == pytest.approx(0.010 / 5)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.window_s == pytest.approx(50e-6)
    assert tr.idle_share() == pytest.approx(0.2)
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4


def test_cpu_run_reports_no_device_timing():
    cell = harness.load_cell("euler_hex.n3_k32", ROOT,
                             overrides={"k1d": 2, "warmup_steps": 1})
    res = harness.run(cell, 2 ** 31 + 3, 0.5, False,
                      device=torch.device("cpu"), t_start=0.0,
                      log=lambda s: None)
    assert res["correct"] is True
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"


def _cli(cwd, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "h100_bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    out = _cli(ROOT, "--workload", "euler_hex.n3_k32", "--seed",
               str(2 ** 31 + 5), "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "--workload", "cns_cavity_3d.n3_k32", "--seed", "9",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert "correct" not in out.stdout

"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the comparison that decides ``correct``, the result.

Everything that belongs to a cell comes from its files: the entry in
``BENCHMARK.json`` names its configuration; ``workloads/<cell>.json``
holds its sizes, time step, kernel settings, the end-to-end quantity
behind each of its end-to-end metrics and its comparison limits;
``configs/<config>.json`` and ``configs/<config>.py`` the configuration
(the program as a ``Program``, the start state, the reference);
``steppers/<stepper>.py`` the time stepper the configuration names;
``metrics/<metric>.py`` each per-layer metric's reader.  A new cell,
configuration, stepper or metric is new files and entries, with no edit
here.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run: JAX, its
# relatives, and the JAX package the port was made from (compared whole:
# the port's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "esdg_cns_tpu")
# the quantities an end-to-end metric of a workload file can name
QUANTITIES = ("dof_stages_per_s", "step_ms_p95")


class RunError(Exception):
    """A run that may print no result; ``code`` is its exit code."""

    def __init__(self, message, code=2):
        super().__init__(message)
        self.code = code


def forbidden_modules(names):
    """The FORBIDDEN top-level names among module names (the part before
    the first dot, compared whole)."""
    return sorted({name.split(".", 1)[0] for name in names}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Program:
    """What a configuration's ``program(cfg, wl, device)`` hands the
    harness."""
    rhs: object          # rhs(q, t) -> (dq, aux), the port's RHS
    dof: int             # degrees of freedom of the state (5 Np K)
    context: dict        # what the metric readers take: n, num_elements


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    wl: dict             # workloads/<cell>.json
    cfg: dict            # configs/<config>.json
    module: object       # configs/<config>.py
    stepper: object      # steppers/<cfg["stepper"]>.py
    bench: dict          # BENCHMARK.json


def load_cell(name, root, overrides=None, files=HERE):
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files under
    ``files``; ``overrides`` replaces keys of its workload file (tests)."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    files = Path(files)
    wl = json.loads((files / "workloads" / f"{name}.json").read_text())
    wl.update(overrides or {})
    unknown = set(wl["end_to_end"].values()) - set(QUANTITIES)
    if unknown:
        raise RunError(f"{name}: unknown end-to-end quantities {unknown}")
    cfg_name = entry["config"]
    cfg = json.loads((files / "configs" / f"{cfg_name}.json").read_text())
    module = importlib.import_module(f"h100_bench.configs.{cfg_name}")
    stepper = importlib.import_module(f"h100_bench.steppers.{cfg['stepper']}")
    return Cell(name, entry, wl, cfg, module, stepper, bench)


def _reports(metric, cell, bench):
    """Whether ``cell`` reports ``metric`` (an entry of BENCHMARK.json):
    listed in its ``workloads``, or, without that key, every cell (an
    end-to-end metric) or every cell reporting the end-to-end metric it
    moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return _reports(moved, cell, bench)


def cell_metrics(cell, trace):
    """The names of the cell's end-to-end (trace 0) or per-layer (trace 1)
    metrics, in BENCHMARK.json's order."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in cell.bench[key] if _reports(m, cell.name, cell.bench)]


def metric_reader(name, files=HERE):
    """read(trace) of ``metrics/<name>.py`` under ``files``."""
    path = Path(files) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window_stats(step_ms, wall_s, dof, stages):
    """(DOF-stages/s over the whole window, the 95th percentile of all
    steps' times, the median step), with ``stages`` RHS calls a step."""
    import numpy as np

    rate = dof * stages * len(step_ms) / wall_s
    return (rate, float(np.percentile(step_ms, 95)),
            float(np.median(step_ms)))


def card_label():
    """'name, power limit' as nvidia-smi reads them, or 'not read'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class _Marks:
    """Time marks after each step: CUDA events on the card (recorded, never
    waited on, inside the window), the host clock elsewhere (tests)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.torch = torch

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


def run(cell, seed, seconds, trace, *, device, t_start, log=print,
        control=False, built=None):
    """One run; returns the result dict (the last line's keys).  Prints
    the run's other numbers with ``log``.

    control: the reference one precision below the configuration's
    (``configs/<config>.py``'s ``control_rhs``), stepped by the
    reference's stepper, takes the program's place; the comparison is the
    same.  built: a dict that keeps the program and the references across
    calls in one process (``control.py``); a benchmark run builds them
    anew."""
    import torch

    from . import checks
    from . import devtrace as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl, cfg, stepper = cell.wl, cell.cfg, cell.stepper
    on_card = device.type == "cuda"
    built = {} if built is None else built
    marks = _Marks(device)
    parts = {"imports_s": time.perf_counter() - t_start}

    if on_card:
        # the port's kernel library: built by nvcc in a checkout's first
        # run, loaded from the checkout's build/ after that
        from esdg_cns_tpu_torch import kernels

        t = time.perf_counter()
        kernels.library()
        parts["library_s"] = time.perf_counter() - t
    t = time.perf_counter()
    q0 = cell.module.start_state(cfg, wl, seed, device)
    parts["start_state_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if control:
        if "control" not in built:
            ref = cell.module.control_rhs(cfg, wl, device)
            built["control"] = Program(lambda q, t_: (ref(q, t_), {}),
                                       q0.numel(), {})
        prog = built["control"]

        def advance(rhs, q, dt_, t_):
            return stepper.reference_step(lambda x, s: rhs(x, s)[0], q, dt_,
                                          t_)
    else:
        if "program" not in built:
            built["program"] = cell.module.program(cfg, wl, device)
        prog = built["program"]
        advance = stepper.step
    parts["program_s"] = time.perf_counter() - t
    # the step size as the stepper rounds it to the state's dtype
    dt = float(torch.tensor(wl["dt"], dtype=q0.dtype))
    rec = checks.Recorder(prog.rhs)

    def step(q, t_sim):
        return advance(rec, q, dt, t_sim)

    # warm-up, which builds the kernels at first use: the first step from
    # the start state is the check's first sample
    t = time.perf_counter()
    rec.stages = []
    q = step(q0, 0.0)
    samples = [(rec.stages, q)]
    rec.stages = None
    t_sim = dt
    for _ in range(wl["warmup_steps"]):
        q = step(q, t_sim)
        t_sim += dt
    marks.sync()
    parts["warmup_s"] = time.perf_counter() - t
    del q0
    # what set-up made stays: frozen, the garbage collector's full passes
    # in the window scan only what the window made (unfrozen, a full pass
    # over everything the imports made stalled the host for 150 ms)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # ---- the measured window ----
    sampler = checks.Sampler(seed, wl["check_samples"])
    kept = [None] * wl["check_samples"]
    stamps = [marks.mark()]
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        slot = sampler.offer()
        if slot is not None:
            rec.stages = []
        q = step(q, t_sim)
        t_sim += dt
        stamps.append(marks.mark())
        if slot is not None:
            kept[slot] = (rec.stages, q)
            rec.stages = None
        if time.perf_counter() >= deadline:
            break
    marks.sync()
    wall_s = time.perf_counter() - t0
    step_ms = [marks.ms(a, b) for a, b in zip(stamps, stamps[1:])]
    del stamps
    steps = len(step_ms)
    rate, p95, median = window_stats(step_ms, wall_s, prog.dof,
                                     stepper.STAGES)
    # steps over 1.5 medians: where the card waited on a stalled host
    long_ms = [ms for ms in step_ms if ms > 1.5 * median]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    result = {"correct": False, "attempted": steps, "failed": 0,
              "metrics": {}, "device": {}}
    values = {"setup_s": setup_s, "dof_stages_per_s": rate,
              "step_ms_p95": p95}

    # ---- the traced window ----
    traced = None
    if trace and on_card:
        traced, q, t_sim = tr.capture(step, q, t_sim, dt,
                                      wl["trace_steps"], rec, stepper.STAGES)
        per_stage = max(1.0, len(traced.ops) / max(traced.stages, 1))
        enq_steps = max(1, min(10, int(800 // (stepper.STAGES * per_stage))))
        traced.enqueue_ms, q, t_sim = tr.enqueue_ms(
            step, q, t_sim, dt, enq_steps, stepper.STAGES)
        traced.context = dict(prog.context)
        for m in cell_metrics(cell, True):
            value = metric_reader(m["name"])(traced)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    elif on_card:
        for m in cell_metrics(cell, False):
            key = "setup_s" if m["name"] == "setup_s" else \
                wl["end_to_end"][m["name"]]
            result["metrics"][m["name"]] = {"value": values[key],
                                            "unit": m["unit"]}
    if on_card:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device),
                            "count": cell.entry["chips"],
                            "memory_peak_bytes": peak,
                            **result["device"]}
    else:
        result["device"] = {"platform": device.type, "count": 0}
    log(json.dumps({
        "cell": cell.name, "seed": seed, "control": control,
        "card": card_label() if on_card else "none", "steps": steps,
        "window_s": wall_s, "step_ms_median": median, "step_ms_p95": p95,
        "dof_stages_per_s": rate, "setup_s": setup_s, "setup_parts": parts,
        "long_steps": len(long_ms),
        "long_steps_over_median_ms": sum(ms - median for ms in long_ms),
        "memory_peak_bytes": peak, "simulated_time": t_sim,
        "trace_unmatched_ops": None if traced is None else traced.unmatched,
        "trace_ops_per_stage": None if traced is None
        else len(traced.ops) / max(traced.stages, 1),
        "enqueue_ms_per_stage": None if traced is None
        else traced.enqueue_ms}))

    # ---- the comparison, after the program's state is freed ----
    samples += [k for k in kept if k is not None]
    finite = bool(torch.isfinite(q).all())
    del q, prog, step
    rec.rhs = None
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    if "reference" not in built:
        built["reference"] = cell.module.reference_rhs(cfg, wl, torch.float64,
                                                       device)
    rhs_gap, step_gap = checks.compare(samples, built["reference"], dt,
                                       stepper.reference_step)
    check_s = time.perf_counter() - t
    limits = wl["limits"]
    checks_out = {
        "rhs_gap": {"value": rhs_gap, "limit": limits["rhs_gap"]},
        "step_gap": {"value": step_gap, "limit": limits["step_gap"]},
        "finite": {"value": int(finite), "limit": 1},
    }
    over = [k for k, c in checks_out.items()
            if not (c["value"] <= c["limit"] if k != "finite"
                    else c["value"] >= c["limit"])
            or (isinstance(c["value"], float) and math.isnan(c["value"]))]
    result["correct"] = not over
    result["failed"] = len(over)
    result["checks"] = checks_out
    log(json.dumps({"check_s": check_s, "samples": len(samples),
                    "over_limit": over}))
    return result


def main(argv=None, t_start=None):
    """The command line; returns the exit code."""
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload, HERE.parent)
        import torch

        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card "
                           "and reports nothing without one")
        if torch.cuda.device_count() < cell.entry["chips"]:
            raise RunError(f"the cell asks for {cell.entry['chips']} "
                           f"devices, {torch.cuda.device_count()} found")
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     device=torch.device("cuda", 0), t_start=t_start,
                     log=lambda s: print(s, flush=True))
        found = forbidden_modules(list(sys.modules))
        if found:
            raise RunError(f"modules that may not load in a run were "
                           f"loaded: {', '.join(found)}", code=3)
    except RunError as exc:
        print(f"h100_bench: {exc}", file=sys.stderr, flush=True)
        return exc.code
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0

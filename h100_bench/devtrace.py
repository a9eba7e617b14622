"""The traced window: torch.profiler over whole steps, read back from its
chrome trace, and the host's enqueue time behind a sleeping stream.

Each device operation (kernel, copy, fill) is tied to the host call that
launched it by the profiler's correlation id, and through the launch's
time to the benchmark's own ranges: ``h100_bench.step`` around each
step and ``h100_bench.rhs`` around each RHS call.  So a kernel is in the
RHS or in the stepper's update by where the program launched it, not by
its name.  The metric readers (``metrics/*.py``) take a ``Trace``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

STEP_RANGE = "h100_bench.step"
RHS_RANGE = "h100_bench.rhs"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the stream sleeps this many cycles (about 0.1 s at the H100's clock)
# while the host enqueues the steps it times
SLEEP_CYCLES = 200_000_000


def short_name(name):
    """A kernel's name without 'void ', its template arguments and its
    parameter list (namespaces kept: ``esdg::hex_volume_kernel``)."""
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip()


def base_name(short):
    """The last component of a short name: ``hex_volume_kernel``."""
    return short.rsplit("::", 1)[-1]


def union_seconds(spans):
    """Total length of the union of (start, end) intervals."""
    total, hi = 0.0, None
    lo = None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        total += hi - lo
    return total


class Trace:
    """The device operations of the steady steps of a traced window.

    ops: [(name, short name, start us, duration us, in_rhs)] of the steps
    after the first and before the last (each op placed by its launch);
    stages: the RK stages those steps hold; unmatched: device operations
    whose launch the trace does not show (left out of ops).
    """

    def __init__(self, events, steps, stages_per_step):
        ranges = {STEP_RANGE: [], RHS_RANGE: []}
        launches = {}
        host_ops = []
        device = []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            if cat == "user_annotation" and e.get("name") in ranges:
                ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e["ts"]
            elif cat in DEVICE_CATS:
                device.append(e)
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                host_ops.append(e)
        step_spans = sorted(ranges[STEP_RANGE])
        rhs_spans = sorted(ranges[RHS_RANGE])
        if len(step_spans) != steps:
            raise RuntimeError(f"the trace holds {len(step_spans)} step "
                               f"ranges of {steps}")
        starts = [a for a, _ in step_spans]
        rhs_starts = [a for a, _ in rhs_spans]

        def inside(spans, starts_, t):
            i = bisect.bisect_right(starts_, t) - 1
            return i if i >= 0 and t <= spans[i][1] else None

        self.ops, self.unmatched = [], 0
        self.launch_of = {}
        for e in device:
            t = launches.get(e.get("args", {}).get("correlation"))
            if t is None:
                self.unmatched += 1
                continue
            step = inside(step_spans, starts, t)
            if step is None or step == 0 or step == steps - 1:
                continue
            in_rhs = inside(rhs_spans, rhs_starts, t) is not None
            self.ops.append((e["name"], short_name(e["name"]), e["ts"],
                             e["dur"], in_rhs))
            self.launch_of[len(self.ops) - 1] = t
        self.ops.sort(key=lambda op: op[2])
        self.steps = steps - 2
        self.stages = stages_per_step * self.steps
        self.host_ops = host_ops
        spans = [(s, s + d) for _, _, s, d, _ in self.ops]
        if spans:
            self.window_s = (max(b for _, b in spans)
                             - min(a for a, _ in spans)) / 1e6
            self.busy_s = union_seconds(spans) / 1e6
        else:
            self.window_s = self.busy_s = 0.0
        self.enqueue_ms = None
        self.context = {}

    def kernel(self, prefix):
        """(device seconds, launches) of the ops whose name, namespaces
        left out, starts with prefix; None when none ran."""
        hits = [d for _, s, _, d, _ in self.ops
                if base_name(s).startswith(prefix)]
        if not hits:
            return None
        return sum(hits) / 1e6, len(hits)

    def device_ms_per_stage(self, in_rhs):
        """Device ms a stage of the ops launched inside (or outside) the
        RHS range; None when the trace could not place every op."""
        if self.unmatched or not self.ops:
            return None
        total = sum(d for _, _, _, d, r in self.ops if r == in_rhs)
        return total / 1e3 / self.stages

    def idle_share(self):
        """1 - busy / window over the steady steps; None without ops."""
        if not self.ops or self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self, top=10):
        """The device operations that took most time and the longest idle
        gaps by what the host was doing (the innermost host range around
        the launch that ended the gap), in seconds over the steady
        steps."""
        by_name = {}
        for name, short, _, d, _ in self.ops:
            by_name[short] = by_name.get(short, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in self.host_ops), key=lambda h: h[0])
        gaps = {}
        end = None
        for i, (_, _, s, d, _) in enumerate(self.ops):
            if end is not None and s > end:
                t = self.launch_of[i]
                name = "host"
                best = None
                for a, b, nm in host:
                    if a > t:
                        break
                    if b >= t and (best is None or b - a < best):
                        best, name = b - a, nm
                gaps[name] = gaps.get(name, 0.0) + (s - end) / 1e6
            end = s + d if end is None else max(end, s + d)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}


def capture(step, q, t, dt, steps, recorder, stages_per_step):
    """Runs ``steps`` steps under torch.profiler; returns (Trace, q, t).
    The recorder puts each RHS call in the RHS range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    recorder.annotate = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                with record_function(STEP_RANGE):
                    q = step(q, t)
                t += dt
            torch.cuda.synchronize()
    finally:
        recorder.annotate = False
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return Trace(events, steps, stages_per_step), q, t


def enqueue_ms(step, q, t, dt, steps, stages_per_step, repeats=5):
    """Host ms a stage to enqueue ``steps`` steps while the stream sleeps
    (so the host never waits on the device), the median of ``repeats``;
    returns (ms, q, t)."""
    import statistics

    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(steps):
            q = step(q, t)
            t += dt
        times.append((time.perf_counter() - t0) * 1e3
                     / (stages_per_step * steps))
        torch.cuda.synchronize()
    return statistics.median(times), q, t

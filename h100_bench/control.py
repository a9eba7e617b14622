"""The readings that set a cell's comparison limits, on the card:

    python3 h100_bench/control.py --workload <cell> \
        --sides program,control,k4_inviscid --seeds 12 --other-seeds 3 \
        --seconds 2

Each side runs the cell through ``harness.run`` once a seed, with a short
window, and prints the run's ``correct`` and its compared numbers beside
their limits.  ``program`` is the cell as the benchmark runs it (the
lower readings); ``control`` puts the reference one precision below the
configuration's in the program's place (the upper readings: it has to
come out not correct); any other side is one of FAULTS planted in the
program underneath (each has to come out not correct).  One process
builds the program once a side and the float64 reference once for all
sides.  One JSON line per run, then a summary line a side.  Runs on the
CPU too, at a workload's small override (``tests/test_h100_control.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _broken_step(kind):
    """The port's lsrk45 with its step broken as ``kind`` says."""
    from esdg_cns_tpu_torch.timestepping import explicit

    good = explicit.lsrk45

    def lsrk45(rhs, q0, dt, num_steps, t0=0.0):
        if kind == "altered_answer":
            def rhs_bad(q, t):
                dq, aux = rhs(q, t)
                dq = dq.clone()
                dq[1, 0, dq.shape[-1] // 2] += dq.abs().max()
                return dq, aux
            return good(rhs_bad, q0, dt, num_steps, t0)
        q, aux = good(rhs, q0, dt, num_steps, t0)
        if kind == "state_unchanged":
            return q0, aux
        q = q.clone()
        half = q.shape[-1] // 2
        q[..., half:] = q0[..., half:]
        return q, aux

    return _patched(explicit, "lsrk45", lsrk45)


def _k4_inviscid():
    """K4 (``ops.surface_viscous.cns_surface_viscous``) with mu = 0: the
    BR1 viscous stress and heat flux dropped, the inviscid surface terms
    kept.  The program takes the patched function when it is built."""
    from esdg_cns_tpu_torch.ops import surface_viscous

    good = surface_viscous.cns_surface_viscous

    @functools.wraps(good)    # with its launch counter
    def k4(*args, **kw):
        return good(*args, **dict(kw, mu=0.0, lam=0.0))

    return _patched(surface_viscous, "cns_surface_viscous", k4)


# the faults a side can plant: a step that returns its state unchanged,
# half of the elements left at their old state, one RHS value altered
# where it is produced, the cavity's viscous surface terms dropped
FAULTS = {
    "state_unchanged": lambda: _broken_step("state_unchanged"),
    "half_batch": lambda: _broken_step("half_batch"),
    "altered_answer": lambda: _broken_step("altered_answer"),
    "k4_inviscid": _k4_inviscid,
}


def main(argv=None, device=None, overrides=None, out=print):
    import torch

    from h100_bench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--seeds", type=int, default=12,
                    help="seeds of the program side")
    ap.add_argument("--other-seeds", type=int, default=3,
                    help="seeds of the control and of each fault")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    sides = args.sides.split(",")
    unknown = set(sides) - {"program", "control", *FAULTS}
    if unknown:
        ap.error(f"unknown sides {sorted(unknown)}")
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, Path(__file__).resolve()
                             .parent.parent, overrides)
    reference = None
    bad = 0
    for side in sides:
        built = {} if reference is None else {"reference": reference}
        fault = FAULTS[side]() if side in FAULTS else contextlib.nullcontext()
        rows = []
        with fault:
            for i in range(args.seeds if side == "program"
                           else args.other_seeds):
                seed = args.first_seed + i
                t = time.perf_counter()
                res = harness.run(cell, seed, args.seconds, False,
                                  device=device, t_start=t,
                                  log=lambda s: None,
                                  control=side == "control", built=built)
                row = {"cell": cell.name, "side": side, "seed": seed,
                       "correct": res["correct"], "steps": res["attempted"],
                       **{k: c["value"] for k, c in res["checks"].items()},
                       "seconds": time.perf_counter() - t}
                rows.append(row)
                out(json.dumps(row))
        reference = built.get("reference")
        del built
        # the program has to pass and the control and every fault fail
        bad += sum(r["correct"] != (side == "program") for r in rows)
        summary = {"cell": cell.name, "side": side, "summary": True,
                   "correct": [r["correct"] for r in rows]}
        for name, limit in cell.wl["limits"].items():
            values = [r[name] for r in rows]
            summary[name] = {"max": max(values), "min": min(values),
                             "limit": limit}
        out(json.dumps(summary))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())

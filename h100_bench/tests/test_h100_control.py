"""The comparison's control and faults, at a size a test run holds, each
through the harness's own run and comparison: the reference one precision
below the configuration (TF32 operand rounding) in the program's place
comes out not correct, and so does a run whose timed path is broken
underneath, while the program itself comes out correct."""

import json

import pytest
import torch

from h100_bench import control

CELLS = ["euler_hex.n3_k32", "cns_cavity_3d.n3_k32"]
# the smallest meshes at which the control reads over the limits: the
# cavity's f32 gap to the reference grows with the mesh (its control
# reads 7.7 at k1d = 32 on the card; on the CPU 0.35 at k1d = 4, 0.83 at
# 6, against the cell's limit of 0.5)
SMALL = {"euler_hex.n3_k32": {"k1d": 3, "warmup_steps": 1},
         "cns_cavity_3d.n3_k32": {"k1d": 6, "warmup_steps": 1}}


def _sides(cell, sides, overrides, seeds):
    lines = []
    rc = control.main(["--workload", cell, "--sides", sides, "--seeds",
                       str(seeds), "--other-seeds", str(seeds),
                       "--seconds", "0.3"],
                      device=torch.device("cpu"), overrides=overrides,
                      out=lines.append)
    rows = [json.loads(x) for x in lines]
    return rc, [r for r in rows if not r.get("summary")]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    rc, rows = _sides(cell, "program,control", SMALL[cell], 2)
    assert rc == 0
    assert len(rows) == 4
    for row in rows:
        assert row["correct"] is (row["side"] == "program"), row


@pytest.mark.parametrize("cell, kind, k1d", [
    *[(c, k, 3) for c in CELLS
      for k in ("state_unchanged", "half_batch", "altered_answer")],
    # the viscous terms' share of the RHS grows with the mesh: K4 without
    # them reads 0.38 at k1d = 6, 0.77 at 8 and 1.0 at 32 on the card
    ("cns_cavity_3d.n3_k32", "k4_inviscid", 8)])
def test_a_broken_step_is_not_correct(cell, kind, k1d):
    rc, rows = _sides(cell, kind, dict(SMALL[cell], k1d=k1d), 1)
    assert rc == 0
    assert [r["correct"] for r in rows] == [False]

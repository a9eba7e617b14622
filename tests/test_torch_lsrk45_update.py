"""LSRK45's update on the CPU: ``ops.lsrk45_update`` takes the plain
PyTorch lines there (the kernel runs only on the card, where
``tests/test_torch_gpu.py`` holds it to the same lines)."""

import pytest
import torch

from esdg_cns_tpu_torch.ops.lsrk45_update import lsrk45_update
from esdg_cns_tpu_torch.timestepping.explicit import (LSRK45_A, LSRK45_B,
                                                      LSRK45_C, lsrk45)

INTS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _same_bits(a, b):
    return torch.equal(a.view(INTS[a.dtype]), b.view(INTS[b.dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_update_launches_nothing_and_equals_the_plain_lines(dtype):
    """Each stage from random inputs, bit for bit against res = A res +
    dt dq, q = q + B res; at the first stage against res = 0, with NaN in
    the buffer it is given (never read).  A -0 product comes out +0."""
    g = torch.Generator().manual_seed(0)
    q, res, dq = (torch.randn(5, 7, 13, dtype=dtype, generator=g)
                  for _ in range(3))
    dq[0, 0, :2] = torch.tensor([0.0, -0.0], dtype=dtype)
    dt = torch.tensor(2.5e-4, dtype=dtype).item()
    before = lsrk45_update.launches
    for s in range(5):
        a, b = float(LSRK45_A[s]), float(LSRK45_B[s])
        r0 = res if s else torch.zeros_like(q)
        want_res = a * r0 + dt * dq
        want_q = q + b * want_res
        given = res.clone() if s else torch.full_like(q, float("nan"))
        got_q, got_res = lsrk45_update(q, given, dq, a, b, dt, s == 0)
        assert _same_bits(got_res, want_res) and _same_bits(got_q, want_q)
    assert lsrk45_update.launches == before


@pytest.mark.parametrize("strided", [False, True])
def test_cpu_lsrk45_keeps_each_stage_input(strided):
    """A step's stage inputs stay as they were and are distinct tensors;
    the step equals the plain lines' loop, also where q0 and every dq
    are non-contiguous."""
    g = torch.Generator().manual_seed(1)
    q0 = torch.randn(5, 4, 6, dtype=torch.float64, generator=g)
    if strided:
        q0 = q0.transpose(1, 2).contiguous().transpose(1, 2)
    seen = []

    def rhs(q, t):
        seen.append((q, q.clone()))
        dq = -torch.sin(q) * (1.0 + t)
        return (dq.transpose(1, 2).contiguous().transpose(1, 2) if strided
                else dq), {}

    got, _ = lsrk45(rhs, q0, 1e-3, 1)
    assert len({q.data_ptr() for q, _ in seen} | {got.data_ptr()}) == 6
    assert all(_same_bits(q, copy) for q, copy in seen)
    q, res = q0, torch.zeros_like(q0)
    for s in range(5):
        dq, _ = rhs(q, float(LSRK45_C[s]) * 1e-3)
        res = float(LSRK45_A[s]) * res + 1e-3 * dq
        q = q + float(LSRK45_B[s]) * res
    assert _same_bits(got, q)

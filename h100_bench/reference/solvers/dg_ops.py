"""Operator application and first-order DG building blocks.

Port of ``esdg_cns_tpu/solvers/dg_ops.py``: ``_apply`` (a plain matrix
product of small dense reference operators with [..., Np, K] fields,
outside any kernel) and the strong-form gradient / divergence with
central (BR1) interface corrections (reference dg_grad!/dg_div!,
dg2D_CNS_cavity_optimized.jl:548-611).  On the card the products run in
full f32/f64; the caller keeps ``torch.backends.cuda.matmul.allow_tf32``
False, because TF32 products (like the TPU's one-pass bf16 default)
break the discrete SBP and entropy identities.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# the rounding of the operands of every operator product: None (the
# state's own precision) or "tf32" (both operands rounded to TF32's 10
# mantissa bits, the products summed in float32, as a TF32 matrix unit
# does); the lower-precision control of the benchmark sets it
_MATMUL_ROUNDING = contextvars.ContextVar("matmul_rounding", default=None)


def to_tf32(x):
    """x (float32) rounded to TF32: the 13 low mantissa bits dropped,
    rounding to nearest, ties away from zero (cvt.rna.tf32.f32)."""
    if x.dtype != torch.float32:
        raise ValueError("TF32 rounding applies to float32 operands")
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_rounding(mode):
    """Within the block every operator product rounds its operands as
    ``mode`` says (None or "tf32")."""
    if mode not in (None, "tf32"):
        raise ValueError(f"unknown matmul rounding {mode!r}")
    token = _MATMUL_ROUNDING.set(mode)
    try:
        yield
    finally:
        _MATMUL_ROUNDING.reset(token)


def _apply(mat, x):
    """mat [i, j] applied to x [..., j, k] -> [..., i, k]."""
    if _MATMUL_ROUNDING.get() == "tf32":
        mat, x = to_tf32(mat), to_tf32(x)
    return torch.einsum("ij,...jk->...ik", mat, x)


def physical_derivatives(disc, u):
    """Strong-form physical derivatives (times J): tuple over x-dirs of
    sum_r geo[r*dim+x] * (D_r u), shape like u."""
    dim = disc.dim
    du_ref = [_apply(d, u) for d in disc.d]
    out = []
    for xdir in range(dim):
        acc = None
        for rdir in range(dim):
            g = disc.geo_nodal[rdir * dim + xdir]  # [Ngn, K]
            term = g * du_ref[rdir]
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)


def dg_grad(disc, u, uf, up):
    """BR1 gradient: strong volume derivative + 1/2 LIFT of the jump.

    u [..., Np, K] nodal field; uf its trace [..., Nfq, K]; up the
    neighbour (or ghost) trace.  Returns a tuple over x-dirs of
    [..., Np, K].
    """
    vol = physical_derivatives(disc, u)
    out = []
    for xdir in range(disc.dim):
        surf = _apply(disc.lift, 0.5 * (up - uf) * disc.nxj[xdir])
        out.append((vol[xdir] + surf) * disc.inv_jac)
    return tuple(out)


def dg_div(disc, flux_vols, flux_fs, flux_ps):
    """BR1 divergence of a vector field given per-direction components.

    flux_vols: tuple over x-dirs of [..., Np, K]; flux_fs / flux_ps:
    tuples of the own and neighbour traces [..., Nfq, K].
    """
    jump_n = sum(0.5 * (flux_ps[x] - flux_fs[x]) * disc.nxj[x]
                 for x in range(disc.dim))
    return dg_div_contracted(disc, flux_vols, jump_n)


def dg_div_contracted(disc, flux_vols, jump_n):
    """``dg_div`` with the interface jump already normal-contracted
    (jump_n [..., Nfq, K]): only sum_x flux_x nxj_x crosses the
    exchange."""
    acc = None
    for xdir in range(disc.dim):
        d = physical_derivatives(disc, flux_vols[xdir])[xdir]
        acc = d if acc is None else acc + d
    return (acc + _apply(disc.lift, jump_n)) * disc.inv_jac

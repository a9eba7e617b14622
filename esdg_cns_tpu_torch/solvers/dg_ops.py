"""Operator application on stacked K-last fields.

Port of ``esdg_cns_tpu/solvers/dg_ops._apply``.  A plain matrix product
outside any kernel: small dense reference operators applied to
[..., Np, K] fields.  On the card it runs in full f32/f64; the caller
keeps ``torch.backends.cuda.matmul.allow_tf32`` False, because TF32
products (like the TPU's one-pass bf16 default) break the discrete SBP
and entropy identities.
"""

from __future__ import annotations

import torch


def _apply(mat, x):
    """mat [i, j] applied to x [..., j, k] -> [..., i, k]."""
    return torch.einsum("ij,...jk->...ik", mat, x)

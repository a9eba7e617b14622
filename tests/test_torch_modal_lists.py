"""K3's operator lists (``ops.modal_volume.modal_lists``), which the CUDA
kernel reads in place of the dense operators: the partners of each row
whose Q_r entry is above roundoff in some direction, and the entries of
Vq, Vh Pq and Ph above roundoff.

On the Gauss-collocated hex the partners are the points of the row's node
lines: at N=3 the 672 pairs of chip_smoke.py's ``needed_pairs``, each
listed from both sides; on lines and tris every partner.  Dropping the
other entries changes the function by roundoff: the plain version with
them set to zero equals the full plain version to 1e-12 of max |out| in
f64.  The lists decode back to exactly the kept entries, in the layout
``csrc/modal_volume.cuh`` (``ModalLists``) reads.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from esdg_cns_tpu_torch import presets
from esdg_cns_tpu_torch.cavity_cases import moving_state
from esdg_cns_tpu_torch.ops.modal_volume import (ROUNDOFF,
                                                 euler_modal_volume_plain,
                                                 modal_lists, partner_mask)

F64 = torch.float64
GAMMA = 1.4


def _disc(dim, n):
    if dim == 3:
        return presets.lid_driven_cavity_3d(n, 2, dtype=F64, device="cpu")[:2]
    if dim == 2:
        return presets.lid_driven_cavity(n, 2, dtype=F64, device="cpu")[:2]
    return presets.becker_shocktube_1d(n, 6, dtype=F64, device="cpu")[:2]


def _decode(lists, dim, np_, nq, nh):
    """The dense operators the lists hold: (Q [dim, nh, nh], Vq, Vh Pq,
    Ph), zero off the lists."""
    idx = lists.idx.numpy()
    vals = lists.vals.numpy()
    shapes = ((nh, nh), (nq, np_), (nh, nq), (np_, nh))
    rps, at = [], 0
    for rows, _ in shapes:
        rps.append(idx[at:at + rows + 1])
        at += rows + 1
    assert at + sum(int(rp[-1]) for rp in rps) == idx.size
    out, vat = [], 0
    for k, ((rows, cols), rp) in enumerate(zip(shapes, rps)):
        width = dim if k == 0 else 1
        dense = np.zeros((width, rows, cols))
        cidx = idx[at:at + rp[-1]]
        at += rp[-1]
        v = vals[vat:vat + rp[-1] * width].reshape(-1, width)
        vat += rp[-1] * width
        for i in range(rows):
            seg = slice(rp[i], rp[i + 1])
            assert np.all(np.diff(cidx[seg]) > 0)   # ascending partners
            dense[:, i, cidx[seg]] = v[seg].T
        out.append(dense if k == 0 else dense[0])
    assert vat == vals.size
    return out


def _kept(op):
    a = np.abs(op)
    return np.where(a > ROUNDOFF * a.max(), op, 0.0)


@pytest.mark.parametrize("dim,n", [(1, 4), (2, 3), (3, 2), (3, 3)])
def test_lists_hold_the_needed_entries_in_the_kernels_layout(dim, n):
    disc, _ = _disc(dim, n)
    qs = torch.stack(disc.q_skew)
    lists = modal_lists(qs, disc.vq, disc.vhp, disc.ph, disc.nq)
    assert lists.idx.dtype == torch.int32 and lists.vals.dtype == F64
    q, vq, vhp, ph = _decode(lists, dim, disc.np_, disc.nq, disc.nh)
    mask = partner_mask(qs.numpy(), disc.nq)
    np.testing.assert_array_equal(q, np.where(mask, qs.numpy(), 0.0))
    for got, op in ((vq, disc.vq), (vhp, disc.vhp), (ph, disc.ph)):
        np.testing.assert_array_equal(got, _kept(op.numpy()))
        assert np.count_nonzero(got) == chip_smoke.entries(op)


@pytest.mark.parametrize("dim,n", [(1, 4), (2, 3), (3, 3)])
def test_partners_are_the_pairs_the_operator_needs(dim, n):
    disc, _ = _disc(dim, n)
    qs = torch.stack(disc.q_skew)
    nq, nh = disc.nq, disc.nh
    mask = partner_mask(qs.numpy(), nq)
    lists = modal_lists(qs, disc.vq, disc.vhp, disc.ph, nq)
    # every pair from both sides: the sum's rows each own their partners
    np.testing.assert_array_equal(mask, mask.T)
    assert lists.pairs == int(mask.sum()) == 2 * chip_smoke.needed_pairs(
        qs, nq)
    if dim == 3:
        # the collocated hex: the points of each row's node lines, 672
        # pairs an element at N=3 (3 x 16 lines x (6 + 8))
        assert chip_smoke.needed_pairs(qs, nq) == 672
        assert lists.pairs == 1344
    else:
        # lines and tris: every partner (the diagonal and the face-face
        # block are zero)
        full = np.ones((nh, nh), dtype=bool)
        np.fill_diagonal(full, False)
        full[nq:, nq:] = False
        np.testing.assert_array_equal(mask, full)


@pytest.mark.parametrize("dim,n", [(2, 3), (3, 3)])
def test_dropped_entries_change_the_plain_version_by_roundoff(dim, n):
    disc, q0 = _disc(dim, n)
    q = moving_state(q0, np.random.default_rng(7))
    qs = torch.stack(disc.q_skew)
    mask = torch.as_tensor(partner_mask(qs.numpy(), disc.nq))
    nq = disc.nq
    # the face-face block and the diagonal are exact zeros the plain sum
    # also skips or multiplies by zero; the rest of the mask's complement
    # is what the kernel drops
    q_kept = torch.where(mask[None], qs, torch.zeros_like(qs))
    q_kept[:, nq:, nq:] = qs[:, nq:, nq:]
    ops = [torch.as_tensor(_kept(op.numpy())) for op in
           (disc.vq, disc.vhp, disc.ph)]
    full = euler_modal_volume_plain(q, disc.geo, qs, disc.vq, disc.vhp,
                                    disc.ph, GAMMA, nq=nq)
    kept = euler_modal_volume_plain(q, disc.geo, q_kept, *ops, GAMMA, nq=nq)
    for a, b in zip(kept, full):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-12, err
    if dim == 3:
        # the hex's dropped entries are not all exact zeros: the test
        # drops something
        assert bool((q_kept != qs).any())

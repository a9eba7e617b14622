"""The viscous operators' lists (``ops.surface_viscous.visc_lists``), which
the CUDA kernels K4 and K7 read on hexes in place of the dense operators:
each row's entries above roundoff of Vq Pq, the gradient rows Vq D_r Pq,
Vq LIFT, Ef, D_r Pq and LIFT, padded to the longest row of its operator.

On the Gauss-collocated hex the operators couple a point only to its node
lines: at N=3 the five keep 2,752 of 47,104 entries with the projection
block and 2,688 of 43,008 without.  On lines and tris every entry of a
full operator is kept.  The lists decode back to exactly the kept
entries, in the layout ``csrc/cns_stages.cuh`` (``ViscListLayout``)
reads; the plain K4 and K7 on the kept entries equal the full ones to
1e-12 of max |out| in f64; and the 3D cavity's RHS on the kept entries
stays within the JAX comparison's tolerance of ``tests/test_torch_cns3d.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.presets import lid_driven_cavity_3d as jax_cavity_3d
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_make_cns_rhs_affine
from esdg_cns_tpu_torch import presets
from esdg_cns_tpu_torch.cavity_cases import (cavity_case, k4_inputs,
                                             k7_inputs, moving_state)
from esdg_cns_tpu_torch.ops import surface_viscous as sv
from esdg_cns_tpu_torch.ops.modal_volume import ROUNDOFF
from esdg_cns_tpu_torch.solvers import make_cns_rhs_affine
from esdg_cns_tpu_torch.solvers.cns_fused import composed_operators

F64 = torch.float64
TOL_JAX = 1e-11     # tests/test_torch_cns3d.py's port-vs-JAX tolerance


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _disc(dim):
    """hex N=3 k1d=2, tri N=3 k1d=2, line N=4 K=6 (f64, CPU)."""
    if dim == 3:
        return presets.lid_driven_cavity_3d(3, 2, dtype=F64, device="cpu")
    if dim == 2:
        return presets.lid_driven_cavity(3, 2, dtype=F64, device="cpu")
    return presets.becker_shocktube_1d(4, 6, dtype=F64, device="cpu")


def _operators(disc, proj):
    """(front, vqlift, ef, drpq, lift) as make_cns_rhs_affine hands them
    to the kernels."""
    front, vqlift, drpq = composed_operators(disc, proj=proj)
    return front, vqlift, disc.vhp[disc.nq:].contiguous(), drpq, disc.lift


def _decode(lists, dim, np_, nq, nfq):
    """The dense operators the lists hold, read as the kernels read them
    (list l is [rows][w_l] slots after the previous list): (front,
    vqlift, ef, drpq, lift), zero off the lists; front without its
    projection block when the lists have none, lift None without LIFT's
    list.  Checks each row's columns ascending among its entries."""
    rows = (nq, dim * nq, nq, nfq, dim * np_, np_)
    cols = (nq, nq, nfq, nq, nq, nfq)
    vals = lists.vals.numpy()
    idx = lists.cols.numpy().astype(np.int64)
    assert vals.size == idx.size == sum(r * w for r, w in
                                        zip(rows, lists.widths))
    out, at = [], 0
    for r, c, w in zip(rows, cols, lists.widths):
        v = vals[at:at + r * w].reshape(r, w)
        j = idx[at:at + r * w].reshape(r, w)
        at += r * w
        dense = np.zeros((r, c), dtype=vals.dtype)
        for i in range(r):
            live = v[i] != 0
            # the entries first, ascending; then the zero pads
            assert np.all(np.diff(j[i][live]) > 0)
            assert not live[live.sum():].any()
            np.add.at(dense[i], j[i], v[i])
        out.append(torch.as_tensor(dense) if w else None)
    vqpq, grad, vqlift, ef, drpq, lift = out
    front = grad if vqpq is None else torch.cat([vqpq, grad])
    return front, vqlift, ef, drpq.reshape(dim, np_, nq), lift


def _kept(op):
    a = op.numpy()
    return torch.as_tensor(
        np.where(np.abs(a) > ROUNDOFF * np.abs(a).max(), a, 0.0))


# (dim, proj): the forms make_cns_rhs_affine reaches
FORMS = [(3, True), (3, False), (2, True), (1, True)]


@pytest.mark.parametrize("dim,proj", FORMS)
def test_lists_decode_to_the_kept_entries_in_the_kernels_layout(dim, proj):
    disc = _disc(dim)[0]
    ops = _operators(disc, proj)
    lists = sv.visc_lists(*ops, nq=disc.nq, proj=proj)
    assert lists.cols.dtype == torch.int16 and lists.vals.dtype == F64
    got = _decode(lists, dim, disc.np_, disc.nq, disc.nfq)
    want = [_kept(op.reshape(-1, op.shape[-1])).reshape(op.shape)
            for op in ops]
    # the projection block is kept as its own list: its rows' entries
    front = ops[0]
    if proj:
        want[0] = torch.cat([_kept(front[:disc.nq]),
                             _kept(front[disc.nq:])])
    else:
        want[0] = _kept(front)
    want[3] = _kept(ops[3].reshape(-1, disc.nq)).reshape(ops[3].shape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # each list is as wide as its longest row
    kept_rows = [(op != 0).sum(1).max().item() for op in
                 ([want[0][:disc.nq]] if proj else [])
                 + [want[0][disc.nq:] if proj else want[0], want[1],
                    want[2], want[3].reshape(-1, disc.nq), want[4]]]
    assert tuple(w for w in lists.widths if w) == tuple(kept_rows)
    assert lists.entries == sum(int((w != 0).sum()) for w in want)


@pytest.mark.parametrize("proj,count", [(True, 2752), (False, 2688)])
def test_hex_n3_keeps_the_node_line_entries(proj, count):
    disc = _disc(3)[0]
    ops = _operators(disc, proj)
    lists = sv.visc_lists(*ops, nq=disc.nq, proj=proj)
    assert lists.entries == count
    dense = sum(op.numel() for op in ops)
    assert dense == (47104 if proj else 43008)
    # every row of a list holds the same count: no padding at N=3
    assert lists.vals.numel() == count
    assert lists.widths == ((1,) if proj else (0,)) + (4, 6, 4, 4, 6)


@pytest.mark.parametrize("dim", [1, 2])
def test_full_operators_lose_nothing_on_lines_and_tris(dim):
    disc = _disc(dim)[0]
    ops = _operators(disc, True)
    lists = sv.visc_lists(*ops, nq=disc.nq, proj=True)
    got = _decode(lists, dim, disc.np_, disc.nq, disc.nfq)
    full = 0
    for g, op in zip(got, ops):
        a = op.numpy()
        if np.all(np.abs(a) > ROUNDOFF * np.abs(a).max()):
            full += 1
            np.testing.assert_array_equal(g.numpy(), a)
        else:
            # the entries not kept are the operator's zeros and roundoff
            dropped = np.abs(a[g.numpy() == 0])
            assert dropped.max(initial=0.0) <= ROUNDOFF * np.abs(a).max()
    assert full >= 3          # Vq LIFT, Ef and LIFT at least


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dim,proj", FORMS)
def test_plain_versions_on_the_kept_entries_match_the_full_ones(dim, proj):
    if dim == 3:
        disc, q, bc, p = cavity_case("mixed", 3, 2, F64, "cpu", dim=3)
    elif dim == 2:
        disc, q, bc, p = cavity_case("mixed", 3, 2, F64, "cpu")
    else:
        disc, q0, bc, shock = _disc(1)
        q = moving_state(q0, np.random.default_rng(7), velocity=0.1)
        p = {"mu": shock.mu, "pr": shock.pr, "re": 1.0 / shock.mu}
    args, tail, kw = k4_inputs(disc, q, bc, p, t=0.003, proj=proj)
    lists = sv.visc_lists(*args[11:15], tail[1], nq=disc.nq, proj=proj)
    front, vqlift, ef, drpq, lift = _decode(lists, dim, disc.np_, disc.nq,
                                            disc.nfq)
    kept_args = args[:11] + (front, vqlift, ef, drpq)
    dropped = any(bool((a != b).any()) for a, b in
                  zip((front, vqlift, ef, drpq, lift),
                      args[11:15] + (tail[1],)))
    # the hex drops entries that are not exact zeros: the test drops
    # something
    assert dropped or dim != 3
    for fold in (False, True):
        extra, kept_extra = ((tail, (tail[0], lift)) if fold else ((), ()))
        full = sv.cns_surface_viscous_plain(*args, *extra, fold_tail=fold,
                                            **kw)
        kept = sv.cns_surface_viscous_plain(*kept_args, *kept_extra,
                                            fold_tail=fold, **kw)
        for a, b in zip(kept, full):
            if b is not None:
                assert _rel(a, b) <= 1e-12, (dim, proj, fold)
    a7, kw7 = k7_inputs(disc, q, bc, p, t=0.003, proj=proj)
    for contract in (True, False):
        k = dict(kw7, contract=contract)
        full = sv.cns_viscous_plain(*a7, **k)
        kept = sv.cns_viscous_plain(*a7[:6], front, vqlift, ef, drpq, **k)
        for a, b in zip(kept, full):
            assert _rel(a, b) <= 1e-12, (dim, proj, contract)


@functools.lru_cache(maxsize=1)
def _jax_cavity_rhs():
    """(port disc, state, bc, params, JAX's dq) on the hex N=3 k1d=2
    cavity, one moving state; JAX's default front ('xla', no Pallas)."""
    jd, _, jbc, p = jax_cavity_3d(n=3, k1d=2)
    td, tq0, tbc, _ = presets.lid_driven_cavity_3d(3, 2, dtype=F64,
                                                   device="cpu")
    q = moving_state(tq0, np.random.default_rng(11))
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True,
                 compute_rhstest=False)
    jdq, _ = jax_make_cns_rhs_affine(jd, bc=jbc, interpret=True, **flags)(
        jnp.asarray(q.numpy()), 0.0)
    return td, q, tbc, flags, np.asarray(jdq)


@pytest.mark.parametrize("volume_impl", ["fused", "fused_hex"])
@pytest.mark.parametrize("surface_impl", ["merged_tail", "fused"])
def test_cavity_3d_rhs_on_the_lists_matches_jax(monkeypatch, volume_impl,
                                                 surface_impl):
    """make_cns_rhs_affine with K4 (merged_tail) or K7 (after K8) reading
    the operators through their lists: here the plain versions on the
    operators the lists decode to."""
    td, q, tbc, flags, jdq = _jax_cavity_rhs()
    dims = (3, td.np_, td.nq, td.nfq)
    calls = []

    def k4(*args, lists=None, fold_tail=False, **kw):
        ops = args[11:15] + ((args[16],) if fold_tail else ())
        lists = sv.visc_lists(*ops, nq=kw["nq"], proj=kw["proj"])
        front, vqlift, ef, drpq, lift = _decode(lists, *dims)
        calls.append("K4")
        tail = (args[15], lift) if fold_tail else ()
        return sv.cns_surface_viscous_plain(*args[:11], front, vqlift, ef,
                                            drpq, *tail,
                                            fold_tail=fold_tail, **kw)

    def k7(*args, lists=None, **kw):
        lists = sv.visc_lists(*args[6:10], nq=kw["nq"], proj=kw["proj"])
        front, vqlift, ef, drpq, _ = _decode(lists, *dims)
        calls.append("K7")
        return sv.cns_viscous_plain(*args[:6], front, vqlift, ef, drpq,
                                    **kw)

    monkeypatch.setattr(sv, "cns_surface_viscous", k4)
    monkeypatch.setattr(sv, "cns_viscous", k7)
    dq, aux = make_cns_rhs_affine(td, bc=tbc, volume_impl=volume_impl,
                                  surface_impl=surface_impl, **flags)(q, 0.0)
    assert calls == (["K4"] if surface_impl == "merged_tail" else ["K7"])
    err = np.abs(dq.numpy() - jdq).max() / np.abs(jdq).max()
    assert err <= TOL_JAX, (volume_impl, surface_impl, err)
    assert float(aux["rhstest_visc"]) >= 0.0

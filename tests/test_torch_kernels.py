"""Plain versions of the port's fused kernels against the JAX Pallas
kernels run in interpret mode (f64, CPU).

``euler_volume_plain`` / ``euler_surface_plain`` are what the CUDA
wrappers take on CPU tensors, and what the card compares the kernels
with.  Both packages get the same operators (through
``interop.discretization_from_arrays``) and the same seeded state.
Tolerance 1e-11 of max |out|: the two sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.pallas_volume import (
    euler_surface_pallas,
    euler_volume_pallas,
)
from esdg_cns_tpu.physics import primitive_to_conservative
from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.core.discretization import ARRAY_FIELDS, META_FIELDS
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.physics.euler import v_ufun

F64 = torch.float64
GAMMA = 1.4
TOL = 1e-11


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """(JAX disc, port disc, JAX state, port state): N=3, k1d=2, a seeded
    state with all velocity components nonzero."""
    jd, _ = jax_preset(n=3, k1d=2)
    td = interop.discretization_from_arrays(
        {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS},
        {f: getattr(jd, f) for f in META_FIELDS}, device="cpu", dtype=F64)
    rng = np.random.default_rng(7)
    sh = (jd.np_, jd.num_elements)
    q = np.asarray(primitive_to_conservative(
        jnp.asarray(2 + 0.1 * rng.random(sh)),
        jnp.asarray(0.3 * rng.standard_normal((3, *sh))),
        jnp.asarray(2 + 0.1 * rng.random(sh))))
    return jd, td, jnp.asarray(q), interop.state_from_numpy(
        q, device="cpu", dtype=F64)


def _random_affine(jd, seed=11):
    """Non-diagonal affine geometry, numpy-seeded: geo [9, 1, K] with all
    nine entries O(1), nxj [3, Nfq, K] with sj = |nxj| and inv_sj = 1/sj,
    and inv_jac [Nq, K] varying per node.  Unlike the uniform mesh, no
    cross term is an exact zero, so a swapped metric index or a wrong
    normal row shows."""
    rng = np.random.default_rng(seed)
    k = jd.num_elements
    geo = rng.uniform(0.5, 1.5, (9, 1, k)) * rng.choice([-1.0, 1.0], (9, 1, k))
    nxj = rng.standard_normal((3, jd.nfq, k))
    sj = np.sqrt((nxj ** 2).sum(axis=0))
    inv_jac = rng.uniform(0.5, 2.0, (jd.nq, k))
    return geo, nxj, sj, 1.0 / sj, inv_jac


def _rel(t, j):
    j = np.asarray(j)
    return np.abs(interop.state_to_numpy(t) - j).max() / np.abs(j).max()


@pytest.mark.parametrize("diag,pad_x,packed", [
    (False, False, False), (True, False, False),
    (True, True, True),      # the main path's joint_packed mode
    (False, True, True),
])
def test_volume_plain_matches_pallas(pair, diag, pad_x, packed):
    jd, td, jq, tq = pair
    nq = jd.nq
    j_out, j_tr = euler_volume_pallas(
        jq, jd.geo, jd.vhp[nq:], jd.lift, GAMMA, nq=nq,
        line_ops=jd.line_ops, block_k=8, interpret=True, diag=diag,
        pad_x=pad_x, packed=packed)
    t_out, t_tr = fv.euler_volume_plain(
        tq, td.geo, td.vhp[nq:], td.lift, GAMMA, line_ops=td.line_ops,
        diag=diag)
    assert _rel(t_out, j_out) <= TOL
    assert _rel(t_tr, j_tr) <= TOL


@pytest.mark.parametrize("diag", [True, False])
def test_surface_plain_matches_pallas(pair, diag):
    jd, td, jq, _ = pair
    nq = jd.nq
    j_out, j_tr = euler_volume_pallas(
        jq, jd.geo, jd.vhp[nq:], jd.lift, GAMMA, nq=nq,
        line_ops=jd.line_ops, block_k=8, interpret=True)
    j_nbr = jd.gather_traces(j_tr)
    if diag:
        j_nxj = (jd.nxj[0] + jd.nxj[1] + jd.nxj[2])[None]
        j_ij = jd.inv_jac[:1]
    else:
        j_nxj, j_ij = jnp.stack(jd.nxj), jd.inv_jac
    ref = euler_surface_pallas(j_tr, j_nbr, j_nxj, jd.sj, jd.inv_sj, j_ij,
                               jd.lift, j_out, GAMMA, dissipation=True,
                               block_k=8, interpret=True, diag=diag)
    t = lambda a: interop.state_from_numpy(a, device="cpu", dtype=F64)
    got = fv.euler_surface_plain(
        t(j_tr), t(j_nbr), t(j_nxj), td.sj, td.inv_sj, t(j_ij), td.lift,
        t(j_out), GAMMA, dissipation=True, diag=diag)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("pad_x,packed", [(False, False), (True, True)])
def test_general_variant_on_random_affine_metric(pair, pad_x, packed):
    jd, td, jq, tq = pair
    nq = jd.nq
    geo, nxj, sj, inv_sj, inv_jac = _random_affine(jd)
    t = lambda a: interop.state_from_numpy(a, device="cpu", dtype=F64)
    j_out, j_tr = euler_volume_pallas(
        jq, jnp.asarray(geo), jd.vhp[nq:], jd.lift, GAMMA, nq=nq,
        line_ops=jd.line_ops, block_k=8, interpret=True, diag=False,
        pad_x=pad_x, packed=packed)
    t_out, t_tr = fv.euler_volume_plain(
        tq, t(geo), td.vhp[nq:], td.lift, GAMMA, line_ops=td.line_ops,
        diag=False)
    assert _rel(t_out, j_out) <= TOL
    assert _rel(t_tr, j_tr) <= TOL

    j_nbr = jd.gather_traces(j_tr)
    for dissipation in (True, False):
        ref = euler_surface_pallas(
            j_tr, j_nbr, jnp.asarray(nxj), jnp.asarray(sj),
            jnp.asarray(inv_sj), jnp.asarray(inv_jac), jd.lift, j_out, GAMMA,
            dissipation=dissipation, block_k=8, interpret=True, diag=False)
        got = fv.euler_surface_plain(
            t(j_tr), t(j_nbr), t(nxj), t(sj), t(inv_sj), t(inv_jac), td.lift,
            t(j_out), GAMMA, dissipation=dissipation, diag=False)
        assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("diag", [True, False])
def test_volume_plain_hands_on_v_ufun_when_asked(pair, diag):
    """with_v: the same ph_qf and traces, bit for bit, and v(U) exactly
    v_ufun(q); on CPU tensors no launch and no count."""
    _, td, _, tq = pair
    args = (tq, td.geo, td.vhp[td.nq:], td.lift, GAMMA)
    kw = dict(line_ops=td.line_ops, diag=diag)
    before = (fv.euler_volume.launches, fv.euler_volume.with_v)
    out, tr = fv.euler_volume(*args, **kw)
    v_out, v_tr, v = fv.euler_volume(*args, with_v=True, **kw)
    assert torch.equal(v_out, out) and torch.equal(v_tr, tr)
    assert torch.equal(v, v_ufun(tq, GAMMA))
    assert (fv.euler_volume.launches, fv.euler_volume.with_v) == before


def test_cpu_tensors_take_the_plain_version_without_a_launch(pair):
    _, td, _, tq = pair
    ef = td.vhp[td.nq:]
    before = (fv.euler_volume.launches, fv.euler_surface.launches)
    out, tr = fv.euler_volume(tq, td.geo, ef, td.lift, GAMMA,
                              line_ops=td.line_ops, diag=True)
    p_out, p_tr = fv.euler_volume_plain(tq, td.geo, ef, td.lift, GAMMA,
                                        line_ops=td.line_ops, diag=True)
    assert torch.equal(out, p_out) and torch.equal(tr, p_tr)
    nbr = td.gather_traces(tr)
    nxj = (td.nxj[0] + td.nxj[1] + td.nxj[2])[None]
    args = (tr, nbr, nxj, td.sj, td.inv_sj, td.inv_jac[:1], td.lift, out,
            GAMMA)
    assert torch.equal(fv.euler_surface(*args, diag=True),
                       fv.euler_surface_plain(*args, diag=True))
    assert (fv.euler_volume.launches, fv.euler_surface.launches) == before

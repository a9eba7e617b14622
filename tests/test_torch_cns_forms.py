"""The dim-generic forms of the CNS kernels' plain versions, and the
affine CNS RHS through them, against the JAX package (f64, CPU; Pallas in
interpret mode).

``make_cns_rhs_affine(volume_impl='fused')`` on a line or hex mesh runs K3
(``ops.modal_volume``) at dim 1 or 3 and then K4 (``ops.surface_viscous.
cns_surface_viscous``) with the projected front, or on the split path K8
(``ops.cns_surface``) and K7 (``cns_viscous``) at that dim; K7's
``contract=False`` (the component stress traces) is its public default.
The plain versions are what the CUDA wrappers take on CPU tensors and what
the card holds the kernels against.  Both packages get the same inputs
(``cavity_cases.becker_case`` / ``cavity_case``: moving states, the plain
volume front, one exchange, the BC pool and its recipe); the whole RHS
compares the port's preset with JAX's, which is bit-equal in f64.
Tolerances: 1e-12 of max |JAX| per kernel (the two sum in different
orders), 1e-10 for the whole RHS (its 1D tube reads about 1.5e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu import presets as jax_presets
from esdg_cns_tpu.ops.pallas_cns_surface import cns_surface_pallas
from esdg_cns_tpu.ops.pallas_modal_volume import euler_modal_volume_pallas
from esdg_cns_tpu.ops.pallas_viscous import (
    cns_surface_viscous_pallas,
    cns_viscous_pallas,
)
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_cns_affine
from esdg_cns_tpu_torch import presets
from esdg_cns_tpu_torch.cavity_cases import (
    becker_case,
    cavity_case,
    k4_inputs,
    k7_inputs,
    k8_inputs,
)
from esdg_cns_tpu_torch.ops.cns_surface import cns_surface_plain
from esdg_cns_tpu_torch.ops.modal_volume import euler_modal_volume_plain
from esdg_cns_tpu_torch.ops.surface_viscous import (
    cns_surface_viscous_plain,
    cns_viscous_plain,
)
from esdg_cns_tpu_torch.solvers import make_cns_rhs_affine

F64 = torch.float64
TOL = 1e-12
TOL_RHS = 1e-10
GAMMA = 1.4
# the Dirichlet ghosts' time: the exact wave has moved
T = 0.003


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _j(a):
    return None if a is None else jnp.asarray(a.numpy())


def _assert_match(tout, jout, what, tol=TOL):
    assert len(tout) == len(jout), what
    for a, b in zip(tout, jout):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, what
        err = np.abs(a - b).max()
        assert err <= tol * max(np.abs(b).max(), 1e-300), (what, err)


# (dim, case): the Becker tube's Dirichlet ghosts (lines: N=4, K=5; hexes:
# N=1, k1d=3, K=3), a wall recipe on the line (isothermal with array wall
# speeds and temperatures, adiabatic) and on the hex cavity (all four
# kinds, N=2, K=8)
CASES = {
    (1, "becker"): lambda: becker_case(1, 4, 5, F64, "cpu"),
    (1, "wall"): lambda: becker_case(1, 3, 5, F64, "cpu", wall=True),
    (3, "becker"): lambda: becker_case(3, 1, 3, F64, "cpu"),
    (3, "wall"): lambda: cavity_case("mixed", 2, 2, F64, "cpu", dim=3),
}


@pytest.mark.parametrize("dim", [1, 3])
def test_modal_volume_plain_matches_pallas(dim):
    """K3 at dim 1 (line N=4, K=5) and dim 3 (hex N=1, K=3), with a
    block_k that leaves a ragged last block."""
    disc, q, _, _ = CASES[dim, "becker"]()
    args = (q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA)
    tout = euler_modal_volume_plain(*args, nq=disc.nq)
    jout = euler_modal_volume_pallas(
        _j(q), _j(disc.geo), tuple(map(_j, disc.q_skew)), _j(disc.vq),
        _j(disc.vhp), _j(disc.ph), GAMMA, nq=disc.nq, block_k=2,
        interpret=True)
    nf = dim + 2
    assert tout[0].shape == (nf, disc.np_, disc.num_elements)
    assert tout[1].shape == (nf + 2, disc.nfq, disc.num_elements)
    _assert_match(tout, jout, dim)


@pytest.mark.parametrize("case", list(CASES))
def test_surface_viscous_projected_plain_matches_pallas(case):
    """K4 with the projected front at (1, True) and (3, True), both
    fold_tail forms, on the Becker pool (its Dirichlet evaluations at
    t > 0) and on a wall recipe."""
    disc, q, bc, p = CASES[case]()
    args, tail, kw = k4_inputs(disc, q, bc, p, t=T, proj=True)
    jargs = list(map(_j, args))
    jargs[4] = list(jargs[4])                       # nxj as dim rows
    for fold in (False, True):
        extra = tail if fold else ()
        tout = cns_surface_viscous_plain(*args, *extra, fold_tail=fold,
                                         **kw)
        jout = cns_surface_viscous_pallas(*jargs, *map(_j, extra),
                                          interpret=True, fold_tail=fold,
                                          **kw)
        _assert_match(tout, jout, (case, fold))


# (dim, proj): every form the CUDA kernels are built for, on the line's
# wall recipe and the cavities' four wall kinds (tri N=2 K=18, hex N=2 K=8)
FORMS = {
    (1, True): CASES[1, "wall"],
    (2, True): lambda: cavity_case("mixed", 2, 3, F64, "cpu", dim=2),
    (3, True): CASES[3, "wall"],
    (3, False): CASES[3, "wall"],
}


@pytest.mark.parametrize("contract", [True, False])
@pytest.mark.parametrize("form", list(FORMS))
def test_viscous_forms_plain_match_pallas(form, contract):
    """K7 at every (dim, proj) form, with the contracted traction and with
    the component stress traces [dim Nf, Nfq, K] (rows x Nf + f)."""
    dim, proj = form
    disc, q, bc, p = FORMS[form]()
    args, kw = k7_inputs(disc, q, bc, p, t=T, proj=proj)
    kw["contract"] = contract
    tout = cns_viscous_plain(*args, **kw)
    rows = (dim + 2) * (1 if contract else dim)
    assert tout[0].shape == (rows, disc.nfq, disc.num_elements)
    jout = cns_viscous_pallas(*map(_j, args), interpret=True, **kw)
    _assert_match(tout, jout, (form, contract))


@pytest.mark.parametrize("case", ["becker", "wall"])
def test_surface_dim1_plain_matches_pallas(case):
    """K8 at dim 1 on the Becker pool and on the line's wall recipe."""
    disc, q, bc, p = CASES[1, case]()
    args, kw = k8_inputs(disc, q, bc, p, t=T)
    assert kw["dim"] == 1
    tout = cns_surface_plain(*args, **kw)
    qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool = map(_j, args)
    jout = cns_surface_pallas(qm, uf, qm_log, vuf, nbr, list(nxj), sj,
                              inv_sj, pool, interpret=True, **kw)
    _assert_match(tout, jout, case)


def _rhs_pair(name, size, **flags):
    jd, jq0, jbc, shock = getattr(jax_presets, name)(**size)
    td, tq0, tbc, _ = getattr(presets, name)(**size, dtype=F64,
                                             device="cpu")
    flags = dict(mu=shock.mu, pr=shock.pr, inviscid_dissipation=True,
                 volume_impl="fused", **flags)
    ref = jax_cns_affine(jd, bc=jbc, interpret=True, **flags)(jq0, T)
    got = make_cns_rhs_affine(td, bc=tbc, **flags)(tq0, T)
    return got, ref


def _assert_rhs(got, ref, what):
    (dq, aux), (jdq, jaux) = got, ref
    scale = np.abs(np.asarray(jdq)).max()
    assert np.abs(dq.numpy() - np.asarray(jdq)).max() <= TOL_RHS * scale, \
        what
    assert set(aux) == set(jaux), what
    for key in aux:
        a, b = float(aux[key]), float(jaux[key])
        # rhstest sits at the roundoff of sum(wJq v dq): scale by the RHS
        assert abs(a - b) <= TOL_RHS * max(abs(b), scale), (what, key, a, b)


@pytest.mark.parametrize("flags", [
    dict(),                                   # 'auto': merged, rhstest
    dict(surface_impl="fused"),               # the split path: K8, K7
    dict(compute_rhstest=False),              # merged_tail
], ids=["merged", "split", "merged_tail"])
def test_fused_rhs_on_line_matches_jax(flags):
    """The whole 'fused' RHS on becker_shocktube_1d(n=4, k=16) with the
    exact-wave ghosts at t > 0, with the rhstest terms."""
    got, ref = _rhs_pair("becker_shocktube_1d", dict(n=4, k=16), **flags)
    _assert_rhs(got, ref, flags)


def test_fused_rhs_on_hex_matches_jax():
    """The whole 'fused' RHS on becker_shocktube_3d(n=1, k1d=3) (K3 at
    dim 3, K4 at (3, True)), with the rhstest terms."""
    got, ref = _rhs_pair("becker_shocktube_3d", dict(n=1, k1d=3))
    _assert_rhs(got, ref, "3d")

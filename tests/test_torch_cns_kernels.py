"""Plain versions of the port's CNS kernels (K3, K4) and the fused cavity
RHS against the JAX Pallas kernels in interpret mode (f64, CPU).

``euler_modal_volume_plain`` and ``cns_surface_viscous_plain`` are what
the CUDA wrappers take on CPU tensors and what the card holds the
kernels against.  Both packages get the same operators, states and
boundary conditions (the JAX BC pool and recipe handed over through
numpy), over the seven BC shapes of tests/test_cns_fused.py: the three
wall kinds, an array lid profile, time-dependent Dirichlet ghosts, no BC
and a lane-padded JAX block split; the kernel itself also over a mixed
BC with all four kinds, array wall speeds and temperatures and
overlapping regions.  Tolerance 1e-11 of max |out|: the two sum in
different orders.  States are moving fluids (``moving_state``), so every
velocity term of the kernels is exercised.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.pallas_cns_surface import (
    prepare_surface_bc as jax_prepare_surface_bc,
)
from esdg_cns_tpu.ops.pallas_modal_volume import euler_modal_volume_pallas
from esdg_cns_tpu.ops.pallas_viscous import cns_surface_viscous_pallas
from esdg_cns_tpu.physics import BeckerShock
from esdg_cns_tpu.presets import becker_shocktube_2d
from esdg_cns_tpu.presets import lid_driven_cavity as jax_cavity
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_make_cns_rhs_affine
from esdg_cns_tpu.solvers._shared import adiabatic_mask as jax_adiabatic_mask
from esdg_cns_tpu.solvers.boundary import Region as JRegion
from esdg_cns_tpu.solvers.boundary import make_wall_bc as jax_make_wall_bc
from esdg_cns_tpu.verification import regularized_lid
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.cavity_cases import moving_state
from esdg_cns_tpu_torch.core.discretization import ARRAY_FIELDS, META_FIELDS
from esdg_cns_tpu_torch.ops.cns_surface_bc import prepare_surface_bc
from esdg_cns_tpu_torch.ops.modal_volume import euler_modal_volume_plain
from esdg_cns_tpu_torch.ops.surface_viscous import cns_surface_viscous_plain
from esdg_cns_tpu_torch.presets import lid_driven_cavity
from esdg_cns_tpu_torch.solvers import make_cns_rhs, make_cns_rhs_affine
from esdg_cns_tpu_torch.solvers._shared import adiabatic_mask

F64 = torch.float64
GAMMA = 1.4
TOL = 1e-11
CASES = ["adiabatic", "isothermal", "slip", "lid_profile", "dirichlet",
         "nobc", "padded"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _port_disc(jd):
    return interop.discretization_from_arrays(
        {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS},
        {f: getattr(jd, f) for f in META_FIELDS}, device="cpu", dtype=F64)


def _port_bc(jbc, t):
    """The port's WallBC from the JAX one: leaves as numpy, Dirichlet
    states evaluated at t."""
    if jbc is None:
        return None

    def val(v):
        return v if v is None or isinstance(v, (int, float)) else np.asarray(v)

    specs = [dict(kind=r.kind, mask=np.asarray(r.mask),
                  u_wall=tuple(val(c) for c in r.u_wall), theta=val(r.theta),
                  state=None if r.state is None else np.asarray(r.state(t)),
                  entropy_state=(None if r.entropy_state is None
                                 else np.asarray(r.entropy_state(t))))
             for r in jbc.regions]
    return interop.wall_bc_from_arrays(
        specs, [np.asarray(n) for n in jbc.nhat], np.asarray(jbc.bmask),
        jbc.dim, device="cpu", dtype=F64)


def _mixed_bc(jd, rng):
    """Lid isothermal with array u_wall and theta, bottom adiabatic with an
    array wall speed, left slip, right Dirichlet (seeded states, t-free);
    the side walls share the corner nodes with lid and bottom, so the
    region order decides them."""
    xf, yf = (np.asarray(c) for c in jd.xf)
    bm = np.asarray(jd.bmask)
    sh = bm.shape
    on = lambda m: jnp.asarray(bm & m)
    qbc = np.stack([1 + 0.1 * rng.random(sh), rng.standard_normal(sh),
                    rng.standard_normal(sh), 1 + 0.1 * rng.random(sh)])
    vbc = rng.standard_normal((4, *sh))
    vbc[-1] = -(0.5 + rng.random(sh))
    const = lambda a: (lambda t, v=jnp.asarray(a): v)
    return jax_make_wall_bc(jd, [
        JRegion(mask=on(np.abs(yf - 1) < 1e-10), kind="isothermal",
                u_wall=(jnp.asarray(1 + 0.1 * rng.standard_normal(sh)),
                        jnp.asarray(0.1 * rng.standard_normal(sh))),
                theta=jnp.asarray(20 + rng.random(sh))),
        JRegion(mask=on(np.abs(yf + 1) < 1e-10), kind="adiabatic",
                u_wall=(jnp.asarray(0.2 * rng.standard_normal(sh)), 0.0)),
        JRegion(mask=on(np.abs(xf + 1) < 1e-10), kind="slip"),
        JRegion(mask=on(np.abs(xf - 1) < 1e-10), kind="dirichlet",
                state=const(qbc), entropy_state=const(vbc)),
    ])


def _case(case):
    """(JAX disc, port disc, JAX bc, port bc, viscous kw, t, block_k,
    moving state as numpy), the cases of tests/test_cns_fused.py."""
    t, block_k = 0.0, None
    if case == "mixed":
        jd, q0, _, p = jax_cavity(n=2, k1d=3)
        jbc = _mixed_bc(jd, np.random.default_rng(4))
        td, tbc = _port_disc(jd), _port_bc(jbc, t)
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    elif case in ("dirichlet", "nobc"):
        jd, q0, jbc, shock = becker_shocktube_2d(
            n=2, k1d=3, shock=BeckerShock(mu=0.1))
        kw = dict(mu=shock.mu, pr=shock.pr, re=1.0 / shock.mu)
        if case == "dirichlet":
            t = 0.037
        else:
            jbc = None
        td, tbc = _port_disc(jd), _port_bc(jbc, t)
    elif case == "lid_profile":
        jd, q0, jbc, p = jax_cavity(n=2, k1d=3, bctype="isothermal",
                                    lid_profile=regularized_lid)
        td, _, tbc, _ = lid_driven_cavity(n=2, k1d=3, bctype="isothermal",
                                          lid_profile=regularized_lid,
                                          dtype=F64, device="cpu")
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    else:
        bctype = "adiabatic" if case == "padded" else case
        jd, q0, jbc, p = jax_cavity(n=2, k1d=3, bctype=bctype)
        td, _, tbc, _ = lid_driven_cavity(n=2, k1d=3, bctype=bctype,
                                          dtype=F64, device="cpu")
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
        if case == "padded":
            block_k = 16   # K = 18: the JAX kernel pads its last block
    q = moving_state(_t(q0), np.random.default_rng(3)).numpy()
    return jd, td, jbc, tbc, kw, t, block_k, q


def _composed(td):
    """front, vqlift, drpq as numpy f64 (setup-time operator algebra)."""
    vq, pq = td.vq.numpy(), td.pq.numpy()
    drpq = [d.numpy() @ pq for d in td.d]
    front = np.concatenate([vq @ pq] + [vq @ dp for dp in drpq])
    return front, vq @ td.lift.numpy(), np.stack(drpq)


@pytest.mark.parametrize("n", [2, 3])
def test_modal_volume_plain_matches_pallas(n):
    jd, q0, _, _ = jax_cavity(n=n, k1d=3)
    td = _port_disc(jd)
    q = moving_state(_t(q0), np.random.default_rng(n)).numpy()
    j = euler_modal_volume_pallas(jnp.asarray(q), jd.geo, jd.q_skew, jd.vq,
                                  jd.vhp, jd.ph, GAMMA, nq=jd.nq,
                                  interpret=True)
    p = euler_modal_volume_plain(_t(q), td.geo, td.q_skew, td.vq, td.vhp,
                                 td.ph, GAMMA, nq=td.nq)
    for a, b in zip(p, j):
        assert _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("case", CASES + ["mixed"])
def test_surface_viscous_plain_matches_pallas(case):
    jd, td, jbc, tbc, kw, t, block_k, q = _case(case)
    ph_qf, tr, vu_q = euler_modal_volume_plain(
        _t(q), td.geo, td.q_skew, td.vq, td.vhp, td.ph, GAMMA, nq=td.nq)
    nbr = td.gather_traces(tr)
    front, vqlift, drpq = _composed(td)
    ef = td.vhp[td.nq:].numpy()
    jpool = recipe = None
    if jbc is not None:
        jpool, recipe, evals = jax_prepare_surface_bc(
            jbc, jax_adiabatic_mask(jd, jbc), 2)
        jpool = jnp.concatenate([jpool] + [e(t) for e in evals], axis=0)
        # the port flattens its own BC to the same pool and recipe
        tpool, trecipe, tevals = prepare_surface_bc(
            tbc, adiabatic_mask(td, tbc), 2)
        tpool = torch.cat([tpool] + [e(t) for e in tevals])
        assert trecipe == recipe
        assert np.array_equal(tpool.numpy(), np.asarray(jpool))
    arrays = [vu_q, tr[:4], tr[4:6], nbr]
    jin = [jnp.asarray(a.numpy()) for a in arrays]
    tin = list(arrays)
    common = dict(gamma=GAMMA, lam=None, nq=td.nq, dissipation=True,
                  with_penalty=True, recipe=recipe, **kw)
    for fold in (False, True):
        tail_t = (ph_qf, td.lift) if fold else ()
        tail_j = (jnp.asarray(ph_qf.numpy()), jd.lift) if fold else ()
        jout = cns_surface_viscous_pallas(
            *jin, list(jd.nxj), jd.sj, jd.inv_sj, jpool, jd.geo,
            jd.inv_jac[:1], jd.wjq, jnp.asarray(front), jnp.asarray(vqlift),
            jnp.asarray(ef), jnp.asarray(drpq), *tail_j, interpret=True,
            fold_tail=fold, **({} if block_k is None else
                               {"block_k": block_k}), **common)
        tout = cns_surface_viscous_plain(
            *tin, torch.stack(td.nxj), td.sj, td.inv_sj,
            None if jpool is None else _t(jpool), td.geo, td.inv_jac[:1],
            td.wjq, _t(front), _t(vqlift), _t(ef), _t(drpq), *tail_t,
            fold_tail=fold, **common)
        assert len(jout) == len(tout)
        for a, b in zip(tout, jout):
            assert _rel(a.numpy(), b) <= TOL, (case, fold)


@pytest.mark.parametrize("case", CASES)
def test_fused_cavity_rhs_matches_jax_and_twin(case):
    """The port's make_cns_rhs_affine (K3 and K4 as plain versions) vs
    JAX's fused path (Pallas in interpret mode, merged_tail) and vs the
    port's twin, in its merged_tail form and in its merged form with the
    entropy diagnostics on."""
    jd, td, jbc, tbc, kw, t, block_k, q = _case(case)
    flags = dict(inviscid_dissipation=True, viscous_dissipation=True, **kw)
    twin, twin_aux = make_cns_rhs(td, bc=tbc, **flags)(_t(q), t)
    jdq, jaux = jax_make_cns_rhs_affine(
        jd, bc=jbc, volume_impl="fused", interpret=True,
        compute_rhstest=False, **flags,
        **({} if block_k is None else {"block_k": block_k}))(jnp.asarray(q), t)
    for rhstest in (False, True):
        tdq, taux = make_cns_rhs_affine(td, bc=tbc, volume_impl="fused",
                                        compute_rhstest=rhstest,
                                        **flags)(_t(q), t)
        assert _rel(tdq.numpy(), jdq) <= TOL, case
        assert _rel(tdq.numpy(), twin.numpy()) <= TOL, case
        for key, val in taux.items():
            ref = float(jaux[key]) if key in jaux else float(twin_aux[key])
            assert abs(float(val) - ref) <= 1e-9 * max(abs(ref), 1.0), key
            assert abs(float(val) - float(twin_aux[key])) <= 1e-9 * max(
                abs(float(twin_aux[key])), 1.0), (case, key)


def test_fused_rhs_refuses_what_it_does_not_port():
    """Every path of make_cns_rhs_affine is ported; what it refuses is
    what the JAX one refuses, with the same ValueErrors."""
    from esdg_cns_tpu_torch.presets import euler_hex_3d

    td, _, tbc, p = lid_driven_cavity(n=2, k1d=2, dtype=F64, device="cpu")
    kw = dict(mu=p["mu"], bc=tbc)
    bad = [dict(surface_impl="merged_tail", compute_rhstest=True),
           dict(surface_impl="merged", viscous_impl="xla"),
           dict(volume_impl="fused_hex"),                # tris
           dict(volume_impl="xla", viscous_impl="fused"),
           dict(volume_impl="xla", surface_impl="merged"),
           dict(rhstest_mode="f64", viscous_impl="fused"),
           dict(surface_impl="bogus"), dict(viscous_impl="bogus")]
    for flags in bad:
        with pytest.raises(ValueError):
            make_cns_rhs_affine(td, **flags, **kw)
    curved, _ = euler_hex_3d(n=2, k1d=2, curved=True, dtype=F64,
                             device="cpu")
    with pytest.raises(ValueError):
        make_cns_rhs_affine(curved, mu=0.01, volume_impl="fused_hex")
    # the paths that once raised NotImplementedError now build and run
    q = lid_driven_cavity(n=2, k1d=2, dtype=F64, device="cpu")[1] * 1.01
    for flags in (dict(volume_impl="xla"), dict(surface_impl="xla"),
                  dict(surface_impl="fused")):
        dq, _ = make_cns_rhs_affine(td, **flags, **kw)(q)
        assert bool(torch.isfinite(dq).all()), flags

"""The 3D CNS lid-driven cavity and the rest of ``make_cns_rhs_affine`` on
the port against the JAX package (f64, CPU).

The port's ``lid_driven_cavity_3d`` builds what JAX's builds, bit for bit;
``make_cns_rhs_affine`` with ``volume_impl='fused_hex'`` (K1 as the front)
and each surface form (K4 merged and merged_tail, K8 + K7 'fused', the
plain 'xla') equals JAX's same path (Pallas in interpret mode) to 1e-11
of max |dq| and the port's twin ``make_cns_rhs`` to 1e-9 (the twin takes
v(U) through Vq Pq, which is the identity on collocated hexes up to
setup roundoff); the entropy diagnostics agree to 1e-9.  On the 2D tri
cavity, the split surface path ('fused', K8 + K7), the plain surface
('xla') and the plain volume path ('xla') equal JAX's too.  States are
moving fluids (``moving_state``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.pallas_cns_surface import (
    prepare_surface_bc as jax_prepare_surface_bc,
)
from esdg_cns_tpu.physics import BeckerShock
from esdg_cns_tpu.presets import becker_shocktube_2d
from esdg_cns_tpu.presets import lid_driven_cavity as jax_cavity
from esdg_cns_tpu.presets import lid_driven_cavity_3d as jax_cavity_3d
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_make_cns_rhs_affine
from esdg_cns_tpu.solvers._shared import adiabatic_mask as jax_adiabatic_mask
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.cavity_cases import (
    CAVITY_BCS,
    cavity_case,
    k4_inputs,
    k7_inputs,
    k8_inputs,
    moving_state,
)
from esdg_cns_tpu_torch.core.discretization import ARRAY_FIELDS, META_FIELDS
from esdg_cns_tpu_torch.ops import cns_surface as cs
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.ops import surface_viscous as sv
from esdg_cns_tpu_torch.ops.cns_surface_bc import prepare_surface_bc
from esdg_cns_tpu_torch.ops.fused_volume import detect_axis_aligned
from esdg_cns_tpu_torch.physics.euler import v_ufun
from esdg_cns_tpu_torch.presets import lid_driven_cavity, lid_driven_cavity_3d
from esdg_cns_tpu_torch.solvers import (cns_fused, make_cns_rhs,
                                        make_cns_rhs_affine)
from esdg_cns_tpu_torch.solvers._shared import adiabatic_mask

F64 = torch.float64
TOL = 1e-11


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


def _close_scalar(a, b, tol=1e-9):
    assert abs(float(a) - float(b)) <= tol * max(abs(float(b)), 1.0), (a, b)


@functools.lru_cache(maxsize=4)
def _cavity_pair(n, k1d, bctype="isothermal"):
    """(JAX disc, q0, bc, params), (port disc, q0, bc, params)."""
    return (jax_cavity_3d(n=n, k1d=k1d, bctype=bctype),
            lid_driven_cavity_3d(n=n, k1d=k1d, bctype=bctype, dtype=F64,
                                 device="cpu"))


@pytest.mark.parametrize("bctype", ["isothermal", "adiabatic", "slip"])
def test_cavity_3d_preset_matches_jax(bctype):
    """Every array of the discretization, the state, the region masks and
    wall values, nhat, bmask, the parameters and the kernels' BC pool and
    recipe: bit-equal in f64."""
    (jd, jq, jbc, jp), (td, tq, tbc, tp) = _cavity_pair(2, 2, bctype)
    for f in ARRAY_FIELDS:
        a, b = getattr(td, f), getattr(jd, f)
        if isinstance(a, tuple):
            assert all(np.array_equal(x.numpy(), np.asarray(y))
                       for x, y in zip(a, b)), f
        else:
            assert np.array_equal(a.numpy(), np.asarray(b)), f
    assert td.affine and td.line_ops is not None and td.grid_shape is None
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert tp == jp and tp["re"] == 100.0
    assert np.array_equal(tbc.bmask.numpy(), np.asarray(jbc.bmask))
    for x in range(3):
        assert np.array_equal(tbc.nhat[x].numpy(), np.asarray(jbc.nhat[x]))
    for jr, tr in zip(jbc.regions, tbc.regions):
        assert jr.kind == tr.kind and jr.theta == tr.theta
        assert np.array_equal(tr.mask.numpy(), np.asarray(jr.mask))
        assert tr.u_wall == jr.u_wall
    pool, recipe, _ = prepare_surface_bc(tbc, adiabatic_mask(td, tbc), 3)
    jpool, jrecipe, _ = jax_prepare_surface_bc(
        jbc, jax_adiabatic_mask(jd, jbc), 3)
    assert recipe == jrecipe
    assert np.array_equal(pool.numpy(), np.asarray(jpool))


def test_interop_carries_the_3d_cavity():
    """A JAX 3D cavity handed over as numpy (discretization_from_arrays,
    wall_bc_from_arrays) gives the port's preset, bit for bit, and the same
    RHS."""
    (jd, _, jbc, p), (td, tq0, tbc, _) = _cavity_pair(2, 2)
    d = interop.discretization_from_arrays(
        {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS},
        {f: getattr(jd, f) for f in META_FIELDS}, device="cpu", dtype=F64)
    bc = interop.wall_bc_from_arrays(
        [dict(kind=r.kind, mask=np.asarray(r.mask), u_wall=r.u_wall,
              theta=r.theta) for r in jbc.regions],
        [np.asarray(n) for n in jbc.nhat], np.asarray(jbc.bmask), 3,
        device="cpu", dtype=F64)
    assert d.line_ops == td.line_ops and d.grid_shape is None
    q = moving_state(tq0, np.random.default_rng(7))
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], volume_impl="fused_hex",
              inviscid_dissipation=True, viscous_dissipation=True)
    a, _ = make_cns_rhs_affine(d, bc=bc, **kw)(q)
    b, _ = make_cns_rhs_affine(td, bc=tbc, **kw)(q)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_axis_aligned_at_the_path_size(dtype):
    """The snap gate at the 3D cavity's own size (hex N=3, k1d=16): K1
    takes its diagonal variant on the card."""
    disc, _, _, _ = lid_driven_cavity_3d(n=3, k1d=16, dtype=dtype,
                                         device="cpu")
    assert detect_axis_aligned(disc)


@pytest.mark.parametrize("surface", ["merged_tail", "merged", "fused", "xla"])
@pytest.mark.parametrize("n", [2, 3])
def test_fused_hex_rhs_matches_jax_and_twin(n, surface):
    (jd, jq0, jbc, p), (td, tq0, tbc, _) = _cavity_pair(n, 2)
    q = moving_state(tq0, np.random.default_rng(n))
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True,
                 volume_impl="fused_hex", surface_impl=surface,
                 compute_rhstest=surface != "merged_tail")
    jdq, jaux = jax_make_cns_rhs_affine(jd, bc=jbc, interpret=True,
                                        **flags)(jnp.asarray(q.numpy()), 0.0)
    tdq, taux = make_cns_rhs_affine(td, bc=tbc, **flags)(q, 0.0)
    twin, twin_aux = make_cns_rhs(td, bc=tbc, mu=p["mu"], pr=p["pr"],
                                  re=p["re"], inviscid_dissipation=True,
                                  viscous_dissipation=True)(q, 0.0)
    assert _rel(tdq.numpy(), jdq) <= TOL
    assert _rel(tdq.numpy(), twin.numpy()) <= 1e-9
    assert set(taux) == set(jaux)
    for key, val in taux.items():
        _close_scalar(val, jaux[key])
        _close_scalar(val, twin_aux[key])


@pytest.mark.parametrize("fd", ["lines", "xla"])
def test_xla_volume_hex_rhs_matches_jax_and_twin(fd):
    """The plain volume front on the hex cavity (``volume_impl='xla'``,
    whose surface resolves to the plain one), with each flux
    differencing the hex mesh offers."""
    (jd, _, jbc, p), (td, tq0, tbc, _) = _cavity_pair(2, 2)
    q = moving_state(tq0, np.random.default_rng(11))
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True,
                 volume_impl="xla", flux_diff_impl=fd)
    jdq, jaux = jax_make_cns_rhs_affine(jd, bc=jbc, interpret=True,
                                        **flags)(jnp.asarray(q.numpy()), 0.0)
    tdq, taux = make_cns_rhs_affine(td, bc=tbc, **flags)(q, 0.0)
    twin, _ = make_cns_rhs(td, bc=tbc, mu=p["mu"], pr=p["pr"], re=p["re"],
                           inviscid_dissipation=True,
                           viscous_dissipation=True)(q, 0.0)
    assert _rel(tdq.numpy(), jdq) <= TOL
    assert _rel(tdq.numpy(), twin.numpy()) <= 1e-9
    assert set(taux) == set(jaux)
    for key, val in taux.items():
        _close_scalar(val, jaux[key])


def _jax_2d_case(case):
    """(JAX disc, port disc, JAX bc, port bc, viscous kw, t, moving state)
    on the tri cavity or, for the Dirichlet case, the Becker shocktube."""
    t = 0.0
    if case == "dirichlet":
        jd, q0, jbc, shock = becker_shocktube_2d(
            n=2, k1d=3, shock=BeckerShock(mu=0.1))
        kw = dict(mu=shock.mu, pr=shock.pr, re=1.0 / shock.mu)
        t = 0.037
        td = interop.discretization_from_arrays(
            {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS},
            {f: getattr(jd, f) for f in META_FIELDS}, device="cpu",
            dtype=F64)
        tbc = interop.wall_bc_from_arrays(
            [dict(kind=r.kind, mask=np.asarray(r.mask), u_wall=r.u_wall,
                  theta=r.theta, state=np.asarray(r.state(t)),
                  entropy_state=np.asarray(r.entropy_state(t)))
             for r in jbc.regions],
            [np.asarray(a) for a in jbc.nhat], np.asarray(jbc.bmask), 2,
            device="cpu", dtype=F64)
    else:
        jd, q0, jbc, p = jax_cavity(n=2, k1d=3, bctype=case)
        td, _, tbc, _ = lid_driven_cavity(n=2, k1d=3, bctype=case,
                                          dtype=F64, device="cpu")
        kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"])
    q = moving_state(_t(q0), np.random.default_rng(5))
    return jd, td, jbc, tbc, kw, t, q


@pytest.mark.parametrize("path", ["surface_fused", "surface_xla",
                                  "volume_xla"])
@pytest.mark.parametrize("case", ["adiabatic", "dirichlet"])
def test_tri_split_and_plain_paths_match_jax(case, path):
    """The 2D cavity's split surface path (K8 then K7), the plain surface
    section, and the plain volume front (dense fd), against JAX's."""
    jd, td, jbc, tbc, kw, t, q = _jax_2d_case(case)
    impl = dict(surface_fused=dict(surface_impl="fused"),
                surface_xla=dict(surface_impl="xla"),
                volume_xla=dict(volume_impl="xla"))[path]
    flags = dict(inviscid_dissipation=True, viscous_dissipation=True,
                 compute_rhstest=True, **kw, **impl)
    if path != "volume_xla":
        flags["volume_impl"] = "fused"
    jdq, jaux = jax_make_cns_rhs_affine(jd, bc=jbc, interpret=True,
                                        **flags)(jnp.asarray(q.numpy()), t)
    tdq, taux = make_cns_rhs_affine(td, bc=tbc, **flags)(q, t)
    assert _rel(tdq.numpy(), jdq) <= TOL, (case, path)
    assert set(taux) == set(jaux)
    for key, val in taux.items():
        _close_scalar(val, jaux[key])


def test_cavity_3d_entropy_stable():
    """Adiabatic walls with the lid at rest, both dissipations on: the
    viscous entropy production is nonnegative and the total balance is
    nonpositive, on the fused_hex merged path and on the twin."""
    disc, q0, bc, p = lid_driven_cavity_3d(n=3, k1d=3, bctype="adiabatic",
                                           dtype=F64, device="cpu")
    bc.regions[0].u_wall = (0.0, 0.0, 0.0)
    rng = np.random.default_rng(1)
    q = q0 + 1e-3 * _t(rng.standard_normal(tuple(q0.shape))) \
        * _t([1.0, 0.1, 0.1, 0.1, 1.0])[:, None, None]
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True)
    for rhs in (make_cns_rhs_affine(disc, volume_impl="fused_hex",
                                    surface_impl="merged", **kw),
                make_cns_rhs(disc, **kw)):
        _, aux = rhs(q, 0.0)
        assert float(aux["rhstest_visc"]) >= 0.0
        assert float(aux["rhstest"]) < 1e-10


@pytest.mark.parametrize("case", CAVITY_BCS)
def test_cavity_cases_3d_move_and_take_the_plain_path_on_cpu(case):
    """The 3D cases the card holds K4, K7 and K8 against: the state moves
    in all three directions with positive pressure, and on CPU tensors the
    wrappers return their plain versions' outputs without a launch."""
    from esdg_cns_tpu_torch.physics import pfun

    disc, q, bc, p = cavity_case(case, 2, 2, F64, "cpu", dim=3)
    assert q.shape[0] == 5
    assert bool((q[1:4] != 0).all()) and bool((pfun(q) > 0).all())
    counts = (sv.cns_surface_viscous.launches, sv.cns_viscous.launches,
              cs.cns_surface.launches)
    args, tail, kw = k4_inputs(disc, q, bc, p)
    assert not kw["proj"] and args[11].shape == (3 * disc.nq, disc.nq)
    pairs = []
    for fold in (False, True):
        extra = tail if fold else ()
        pairs.append((sv.cns_surface_viscous(*args, *extra, fold_tail=fold,
                                             **kw),
                      sv.cns_surface_viscous_plain(*args, *extra,
                                                   fold_tail=fold, **kw)))
    args, kw = k8_inputs(disc, q, bc, p)
    pairs.append((cs.cns_surface(*args, **kw),
                  cs.cns_surface_plain(*args, **kw)))
    args, kw = k7_inputs(disc, q, bc, p)
    pairs.append((sv.cns_viscous(*args, **kw),
                  sv.cns_viscous_plain(*args, **kw)))
    for kern, plain in pairs:
        assert len(kern) == len(plain)
        for a, b in zip(kern, plain):
            assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert counts == (sv.cns_surface_viscous.launches,
                      sv.cns_viscous.launches, cs.cns_surface.launches)


# where the viscous terms take v(U): K4 (merged), K7 after K8 (fused), the
# plain mid-section (xla), whose gradient rows are computed from it
_TAKES_V = {"merged_tail": (sv, "cns_surface_viscous"),
            "fused": (sv, "cns_viscous"),
            "xla": (cns_fused, "viscous_flux_nd")}


@pytest.mark.parametrize("surface,viscous", [
    ("merged_tail", "auto"), ("fused", "auto"), ("xla", "xla")])
def test_fused_hex_front_hands_on_k1s_own_v(monkeypatch, surface, viscous):
    """The K1 front asks K1 for v(U) and hands that very tensor to the
    viscous terms, so no v_ufun runs on that front; on the CPU it is
    v_ufun(q), and the RHS equals the twin."""
    (_, _, _, p), (td, tq0, tbc, _) = _cavity_pair(2, 2)
    q = moving_state(tq0, np.random.default_rng(11))
    seen = {}
    real_k1 = fv.euler_volume

    def k1(*args, **kw):
        out = real_k1(*args, **kw)
        seen["k1"] = out[2] if kw.get("with_v") else None
        return out

    module, name = _TAKES_V[surface]
    real_viscous = getattr(module, name)

    def viscous_terms(vuq, *args, **kw):
        seen["viscous"] = vuq
        return real_viscous(vuq, *args, **kw)

    monkeypatch.setattr(fv, "euler_volume", k1)
    monkeypatch.setattr(module, name, viscous_terms)
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=tbc,
                 inviscid_dissipation=True, viscous_dissipation=True)
    got, _ = make_cns_rhs_affine(
        td, volume_impl="fused_hex", surface_impl=surface,
        viscous_impl=viscous, compute_rhstest=surface != "merged_tail",
        **flags)(q, 0.0)
    assert seen["k1"] is not None and seen["viscous"] is seen["k1"]
    assert torch.equal(seen["k1"], v_ufun(q))
    twin, _ = make_cns_rhs(td, **flags)(q, 0.0)
    assert _rel(got.numpy(), twin.numpy()) <= 1e-9

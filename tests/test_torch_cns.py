"""The port's CNS twin, viscous physics and wall BCs against the JAX
package (f64, CPU).

The twin (``solvers.cns.make_cns_rhs``) must reproduce the stored
one-step fixtures of the CNS cavity and the periodic tri Euler RHS, and
every BC hook and the viscous flux must equal the JAX ones on the same
seeded inputs.  Inputs are made with numpy and handed to both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.flux_differencing import (
    flux_differencing_xla as jax_fd_xla,
)
from esdg_cns_tpu.physics.viscous import viscous_flux_nd as jax_viscous_nd
from esdg_cns_tpu.presets import lid_driven_cavity as jax_cavity
from esdg_cns_tpu.solvers._shared import (
    inviscid_surface as jax_inviscid_surface,
)
from esdg_cns_tpu.solvers.boundary import Region as JRegion
from esdg_cns_tpu.solvers.boundary import make_wall_bc as jax_make_wall_bc
from esdg_cns_tpu.solvers.cns import make_viscous_rhs as jax_make_viscous_rhs
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.cavity_cases import (
    CAVITY_BCS,
    cavity_case,
    k4_inputs,
    moving_state,
)
from esdg_cns_tpu_torch.core import build_discretization, ref_tri
from esdg_cns_tpu_torch.mesh import uniform_tri_mesh
from esdg_cns_tpu_torch.ops.cns_surface_bc import (
    KIND_CODES,
    prepare_surface_bc,
    region_table,
)
from esdg_cns_tpu_torch.ops import modal_volume as mv
from esdg_cns_tpu_torch.ops import surface_viscous as sv
from esdg_cns_tpu_torch.ops.flux_differencing import flux_differencing_xla
from esdg_cns_tpu_torch.physics import pfun, primitive_to_conservative
from esdg_cns_tpu_torch.physics.viscous import (
    viscous_flux_1d,
    viscous_flux_2d,
    viscous_flux_3d,
    viscous_flux_nd,
)
from esdg_cns_tpu_torch.presets import lid_driven_cavity
from esdg_cns_tpu_torch.solvers import (
    make_cns_rhs,
    make_euler_rhs,
    make_viscous_rhs,
)
from esdg_cns_tpu_torch.solvers._shared import (
    adiabatic_mask,
    inviscid_surface,
)
from esdg_cns_tpu_torch.timestepping import lsrk45

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "euler_one_step.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def test_golden_cns_cavity_step():
    """tests/golden/euler_one_step.npz cns_cavity_*: one f64 LSRK45 step
    (dt=1e-3) of the integrated CNS RHS, isothermal cavity N=2 k1d=4,
    both dissipations on; the twin runs the dense tri flux differencing
    as the fixture did."""
    stored = np.load(GOLDEN)
    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4, dtype=F64, device="cpu")
    q0 = q0 + 1e-3 * _t(np.random.default_rng(1).standard_normal(
        tuple(q0.shape))) * _t([1.0, 0.1, 0.1, 1.0])[:, None, None]
    np.testing.assert_allclose(q0.numpy(), stored["cns_cavity_q0"],
                               rtol=1e-12, atol=1e-12)
    rhs = make_cns_rhs(disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                       inviscid_dissipation=True, viscous_dissipation=True)
    qf, aux = lsrk45(rhs, q0, 1e-3, 1)
    np.testing.assert_allclose(qf.numpy(), stored["cns_cavity_qf"],
                               rtol=1e-12, atol=1e-12)
    for key in ("rhstest", "rhstest_visc"):
        np.testing.assert_allclose(aux[key].numpy(),
                                   stored[f"cns_cavity_{key}"],
                                   rtol=1e-12, atol=1e-14)


def test_golden_tri_euler_step():
    """tests/golden/euler_one_step.npz tri_euler_*: one f64 LSRK45 step of
    the periodic tri N=2 Euler RHS with the dense ('xla') flux
    differencing, dissipation on."""
    stored = np.load(GOLDEN)
    vx, vy, etov = uniform_tri_mesh(2)
    disc = build_discretization(ref_tri(2), (vx, vy), etov,
                                periodic_axes=(0, 1), dtype=F64,
                                device="cpu")
    rng = np.random.default_rng(0)
    sh = (disc.np_, disc.num_elements)
    q0 = primitive_to_conservative(_t(2 + 0.1 * rng.random(sh)),
                                   _t(0.3 * rng.standard_normal((2, *sh))),
                                   _t(2 + 0.1 * rng.random(sh)))
    np.testing.assert_allclose(q0.numpy(), stored["tri_euler_q0"],
                               rtol=1e-12, atol=1e-12)
    rhs = make_euler_rhs(disc, dissipation=True, flux_diff_impl="xla",
                         compute_rhstest=True)
    qf, aux = lsrk45(rhs, q0, 1e-3, 1)
    np.testing.assert_allclose(qf.numpy(), stored["tri_euler_qf"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(aux["rhstest"].numpy(),
                               stored["tri_euler_rhstest"], rtol=1e-12)


def _entropy_state(rng, dim, shape):
    """Seeded entropy variables of a physical state (v_last < 0) and
    random gradients."""
    v = rng.standard_normal((dim + 2, *shape))
    v[-1] = -(0.5 + rng.random(shape))
    grads = [rng.standard_normal((dim + 2, *shape)) for _ in range(dim)]
    return v, grads


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("lam", [None, 0.3])
def test_viscous_flux_nd_matches_jax(dim, lam):
    rng = np.random.default_rng(dim)
    v, grads = _entropy_state(rng, dim, (5, 7))
    mu, pr = 0.013, 0.71
    a = viscous_flux_nd(_t(v), [_t(g) for g in grads], mu, lam, pr)
    b = jax_viscous_nd(jnp.asarray(v), [jnp.asarray(g) for g in grads], mu,
                       lam, pr)
    for x in range(dim):
        _close(a[x].numpy(), b[x], 1e-13)


def test_viscous_flux_1d_2d_3d_are_the_nd_form():
    rng = np.random.default_rng(5)
    v2, g2 = _entropy_state(rng, 2, (6,))
    a = viscous_flux_2d(_t(v2), _t(g2[0]), _t(g2[1]), 0.02)
    b = viscous_flux_nd(_t(v2), [_t(g) for g in g2], 0.02)
    for x in range(2):
        _close(a[x].numpy(), b[x].numpy(), 1e-13)
    v3, g3 = _entropy_state(rng, 3, (6,))
    a3 = viscous_flux_3d(_t(v3), *[_t(g) for g in g3], 0.02)
    b3 = viscous_flux_nd(_t(v3), [_t(g) for g in g3], 0.02)
    for x in range(3):
        assert torch.equal(a3[x], b3[x])
    v1 = rng.standard_normal((3, 6))
    v1[-1] = -(0.5 + rng.random(6))
    g1 = rng.standard_normal((3, 6))
    a1 = viscous_flux_1d(_t(v1), _t(g1), 0.02, pr=0.71)
    (b1,) = viscous_flux_nd(_t(v1), [_t(g1)], 0.02, pr=0.71)
    _close(a1.numpy(), b1.numpy(), 1e-13)


def _mixed_bc_pair(seed=4):
    """The same four-kind BC in both packages on the N=2, k1d=3 cavity:
    lid isothermal with an array lid profile and an array theta, bottom
    adiabatic with a moving wall, left slip, right Dirichlet with seeded
    states and a ghost stress; the right wall also overlaps the slip
    region at the corner, so region order matters."""
    jdisc, _, _, _ = jax_cavity(n=2, k1d=3)
    tdisc, _, _, _ = lid_driven_cavity(n=2, k1d=3, dtype=F64, device="cpu")
    rng = np.random.default_rng(seed)
    xf, yf = (np.asarray(c) for c in jdisc.xf)
    bm = np.asarray(jdisc.bmask)
    tol = 1e-10
    sh = bm.shape
    lid = bm & (np.abs(yf - 1) < tol)
    bottom = bm & (np.abs(yf + 1) < tol)
    left = bm & (np.abs(xf + 1) < tol)
    right = bm & (np.abs(xf - 1) < tol)
    prof = 1.0 + 0.1 * rng.standard_normal(sh)
    theta = 2.0 + 0.1 * rng.random(sh)
    qbc = np.stack([1 + 0.1 * rng.random(sh), rng.standard_normal(sh),
                    rng.standard_normal(sh), 1 + 0.1 * rng.random(sh)])
    vbc = rng.standard_normal((4, *sh))
    vbc[-1] = -(0.5 + rng.random(sh))
    sbc = rng.standard_normal((2, 4, *sh))
    specs = [
        dict(kind="isothermal", mask=lid, u_wall=(prof, 0.0), theta=theta),
        dict(kind="adiabatic", mask=bottom, u_wall=(0.3, 0.0), theta=None),
        dict(kind="slip", mask=left, u_wall=(0.0, 0.0), theta=None),
        dict(kind="dirichlet", mask=right, u_wall=(0.0, 0.0), theta=None,
             state=qbc, entropy_state=vbc, stress=sbc),
    ]
    jregions = []
    for s in specs:
        kw = {}
        if s["kind"] == "dirichlet":
            kw = dict(state=lambda t, a=jnp.asarray(qbc): a,
                      entropy_state=lambda t, a=jnp.asarray(vbc): a,
                      stress_state=lambda t, a=jnp.asarray(sbc): a)
        jregions.append(JRegion(
            mask=jnp.asarray(s["mask"]), kind=s["kind"],
            u_wall=tuple(c if isinstance(c, float) else jnp.asarray(c)
                         for c in s["u_wall"]),
            theta=(s["theta"] if s["theta"] is None
                   else jnp.asarray(s["theta"])), **kw))
    jbc = jax_make_wall_bc(jdisc, jregions)
    tbc = interop.wall_bc_from_arrays(
        specs, [np.asarray(n) for n in jbc.nhat], np.asarray(jbc.bmask), 2,
        device="cpu", dtype=F64)
    # the port's Dirichlet stress ghost, which wall_bc_from_arrays leaves
    # natural: give it the same callable
    tbc.regions[3].stress_state = lambda t, a=_t(sbc): a
    return jdisc, tdisc, jbc, tbc, rng


@pytest.mark.parametrize("hook", ["inviscid", "entropy_vars", "stress",
                                  "stress_normal", "penalty_energy_rows"])
def test_wall_bc_hooks_match_jax(hook):
    jdisc, tdisc, jbc, tbc, rng = _mixed_bc_pair()
    sh = (4, tdisc.nfq, tdisc.num_elements)
    a = [1 + 0.2 * rng.random(sh) for _ in range(2)]
    for x in a:
        x[1:3] = rng.standard_normal((2, *sh[1:]))
    qm, qp = a
    vuf, vup = (rng.standard_normal(sh) for _ in range(2))
    vuf[-1] = -(0.5 + rng.random(sh[1:]))
    if hook == "inviscid":
        jo, _ = jbc.inviscid(jdisc, jnp.asarray(qm), jnp.asarray(qp), None,
                             None, 0.0)
        to, _ = tbc.inviscid(tdisc, _t(qm), _t(qp), None, None, 0.0)
        pairs = [(to, jo)]
    elif hook == "entropy_vars":
        pairs = [(tbc.entropy_vars(tdisc, _t(vuf), _t(vup), 0.0),
                  jbc.entropy_vars(jdisc, jnp.asarray(vuf), jnp.asarray(vup),
                                   0.0))]
    elif hook == "stress":
        s_f = rng.standard_normal((2, *sh))
        s_p = rng.standard_normal((2, *sh))
        jo = jbc.stress(jdisc, tuple(jnp.asarray(s) for s in s_f),
                        tuple(jnp.asarray(s) for s in s_p), None, 0.0)
        to = tbc.stress(tdisc, tuple(_t(s) for s in s_f),
                        tuple(_t(s) for s in s_p), None, 0.0)
        pairs = list(zip(to, jo))
    elif hook == "stress_normal":
        t_f, t_ex = rng.standard_normal(sh), rng.standard_normal(sh)
        pairs = [(tbc.stress_normal(tdisc, _t(t_f), _t(t_ex), 0.0),
                  jbc.stress_normal(jdisc, jnp.asarray(t_f),
                                    jnp.asarray(t_ex), 0.0))]
    else:
        dv = vup - vuf
        tau = rng.standard_normal(sh[1:])
        am = np.asarray(jbc.regions[1].mask)
        pairs = [(tbc.penalty_energy_rows(_t(vuf), _t(vup), _t(dv), _t(tau),
                                          torch.as_tensor(np.array(am))),
                  jbc.penalty_energy_rows(jnp.asarray(vuf), jnp.asarray(vup),
                                          jnp.asarray(dv), jnp.asarray(tau),
                                          jnp.asarray(am)))]
    for to, jo in pairs:
        _close(to.numpy(), jo, 1e-13)


@pytest.mark.parametrize("bctype", ["adiabatic", "isothermal", "slip"])
def test_cavity_preset_matches_jax(bctype):
    """Masks, u_wall, theta, state and parameters bit-equal in f64."""
    jd, jq, jbc, jp = jax_cavity(n=3, k1d=3, bctype=bctype)
    td, tq, tbc, tp = lid_driven_cavity(n=3, k1d=3, bctype=bctype,
                                        dtype=F64, device="cpu")
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert tp == jp
    for x in range(2):
        assert np.array_equal(tbc.nhat[x].numpy(), np.asarray(jbc.nhat[x]))
    for jr, tr in zip(jbc.regions, tbc.regions):
        assert jr.kind == tr.kind and jr.theta == tr.theta
        assert np.array_equal(tr.mask.numpy(), np.asarray(jr.mask))
        assert tr.u_wall == jr.u_wall
    am = adiabatic_mask(td, tbc)
    assert bool(am.any()) == (bctype == "adiabatic")


def test_cns_twin_entropy_stable_cavity():
    """Adiabatic walls at rest, both dissipations on: the viscous entropy
    production is nonnegative and the total balance is nonpositive (the
    property of tests/test_cns_fused.py, on the port's twin)."""
    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=4, bctype="adiabatic",
                                        lid_profile=lambda x: 0.0 * x,
                                        dtype=F64, device="cpu")
    rng = np.random.default_rng(1)
    q = q0 + 1e-3 * _t(rng.standard_normal(tuple(q0.shape))) \
        * _t([1.0, 0.1, 0.1, 1.0])[:, None, None]
    _, aux = make_cns_rhs(disc, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                          inviscid_dissipation=True,
                          viscous_dissipation=True)(q, 0.0)
    assert float(aux["rhstest_visc"]) >= 0.0
    assert float(aux["rhstest"]) < 1e-10


@pytest.mark.parametrize("curved", [False, True])
def test_dense_flux_differencing_matches_jax(curved):
    """The tri volume term on random flux variables, with an affine
    [4, 1, K] or a curved [4, Nh, K] metric (pairwise averaged)."""
    disc, _, _, _ = lid_driven_cavity(n=2, k1d=2, dtype=F64, device="cpu")
    rng = np.random.default_rng(9)
    sh = (disc.nh, disc.num_elements)
    qh = np.stack([1 + 0.2 * rng.random(sh), rng.standard_normal(sh),
                   rng.standard_normal(sh), 1 + 0.2 * rng.random(sh)])
    qlog = np.log(qh[[0, 3]])
    geo = rng.standard_normal((4, disc.nh if curved else 1, sh[1]))
    qs = tuple(q.numpy() for q in disc.q_skew)
    a = flux_differencing_xla(_t(qh), _t(qlog), disc.q_skew, _t(geo), 1.4)
    b = jax_fd_xla(jnp.asarray(qh), jnp.asarray(qlog),
                   tuple(jnp.asarray(q) for q in qs), jnp.asarray(geo), 1.4)
    _close(a.numpy(), b, 1e-13)


@pytest.mark.parametrize("bctype", ["isothermal", "adiabatic"])
def test_viscous_rhs_matches_jax(bctype):
    """make_viscous_rhs (BR1 alone, penalty on) against the JAX one."""
    jd, jq0, jbc, p = jax_cavity(n=2, k1d=3, bctype=bctype)
    td, tq0, tbc, _ = lid_driven_cavity(n=2, k1d=3, bctype=bctype,
                                        dtype=F64, device="cpu")
    q = moving_state(_t(np.array(jq0)), np.random.default_rng(2)).numpy()
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], dissipation=True)
    a, aa = make_viscous_rhs(td, bc=tbc, **kw)(_t(q), 0.0)
    b, ab = jax_make_viscous_rhs(jd, bc=jbc, **kw)(jnp.asarray(q), 0.0)
    _close(a.numpy(), b, 1e-12)
    assert abs(float(aa["rhstest_visc"]) - float(ab["rhstest_visc"])) \
        <= 1e-12 * abs(float(ab["rhstest_visc"]))


def test_region_table_encodes_the_recipe():
    """The flat table the CUDA kernel walks: header, then per region the
    kind code, mask row, u_wall rows or scalars, theta, Dirichlet rows."""
    jdisc, tdisc, jbc, tbc, _ = _mixed_bc_pair()
    pool, recipe, evals = prepare_surface_bc(tbc, adiabatic_mask(tdisc, tbc),
                                             2)
    ints, floats = region_table(recipe, torch.device("cpu"))
    ints, floats = ints.tolist(), floats.tolist()
    nhat0, bmask_i, adiab_i, specs, n_static = recipe
    assert ints[:4] == [4, nhat0, bmask_i, adiab_i] and len(evals) == 2
    assert pool.shape[0] == n_static
    for r, (kind, mask_i, uw, theta, qbc_i, vbc_i) in enumerate(specs):
        row = ints[4 + 8 * r:12 + 8 * r]
        assert row[:2] == [KIND_CODES[kind], mask_i]
        assert row[6:] == [qbc_i, vbc_i]
        for d, c in enumerate(uw[:2]):
            if c[0] == "a":
                assert row[2 + d] == c[1]
                assert torch.equal(pool[c[1]], tbc.regions[r].u_wall[d])
            else:
                assert row[2 + d] == -1 and floats[4 * r + d] == c[1]
        if theta is not None and theta[0] == "a":
            assert row[5] == theta[1]
            assert torch.equal(pool[theta[1]], tbc.regions[r].theta)
    # the lid's array profile, the bottom's scalar wall speed, the
    # Dirichlet rows right after the static pool
    assert ints[4 + 2] >= 0 and floats[4 * 1] == 0.3
    assert ints[4 + 8 * 3 + 6:4 + 8 * 3 + 8] == [n_static, n_static + 4]


def test_cns_twin_rhstest_f64_mode():
    """rhstest_mode='f64' sums the same diagnostics in float64: on an f64
    state it equals the native sums."""
    disc, q0, bc, p = lid_driven_cavity(n=2, k1d=3, dtype=F64, device="cpu")
    q = moving_state(q0, np.random.default_rng(4))
    kw = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
              inviscid_dissipation=True, viscous_dissipation=True)
    _, a = make_cns_rhs(disc, **kw)(q)
    _, b = make_cns_rhs(disc, rhstest_mode="f64", **kw)(q)
    for key in ("rhstest", "rhstest_visc", "rhstest_visc_total"):
        assert float(a[key]) == pytest.approx(float(b[key]), rel=1e-12,
                                              abs=1e-16)


@pytest.mark.parametrize("form", ["ghosts+extras", "entropy_extras"])
def test_inviscid_surface_matches_jax(form):
    """The merged exchange + EC surface flux + LF on the mixed BC: with the
    BC's inviscid ghosts and a caller's extra rows riding the exchange,
    and with the rebuilt neighbour entropy variables (the CNS form)."""
    jdisc, tdisc, jbc, tbc, rng = _mixed_bc_pair()
    sh = (tdisc.nfq, tdisc.num_elements)
    qm = np.stack([1 + 0.2 * rng.random(sh), rng.standard_normal(sh),
                   rng.standard_normal(sh), 1 + 0.2 * rng.random(sh)])
    logs = np.log(qm[[0, 3]])
    rho, u1, u2, beta = qm
    uf = np.stack([rho, rho * u1, rho * u2,
                   rho / (2 * beta * 0.4) + 0.5 * rho * (u1 ** 2 + u2 ** 2)])
    extra = rng.standard_normal((3, *sh))
    kw = dict(gamma=1.4, dissipation=True)
    if form == "ghosts+extras":
        jkw = dict(bc_inviscid=jbc.inviscid,
                   extra_parts=(jnp.asarray(extra),))
        tkw = dict(bc_inviscid=tbc.inviscid, extra_parts=(_t(extra),))
    else:
        jkw = tkw = dict(entropy_extras=True)
    jf, jx = jax_inviscid_surface(jdisc, jdisc.gather_traces,
                                  jnp.asarray(qm), jnp.asarray(uf),
                                  jnp.asarray(logs), **kw, **jkw)
    tf, tx = inviscid_surface(tdisc, tdisc.gather_traces, _t(qm), _t(uf),
                              _t(logs), **kw, **tkw)
    _close(tf.numpy(), jf, 1e-13)
    _close(tx.numpy(), jx, 1e-13)


def test_rebuilt_jump_bitwise_antisymmetric():
    """Both sides of every conforming face rebuild the entropy and
    conservative traces from the same exchanged flux-variable payload, so
    the BR1 jump is bitwise antisymmetric across faces (fl(a-b) ==
    -fl(b-a)); checked on a fully periodic tri mesh, where the gather is
    an involutive permutation (the property of tests/test_cns_fused.py on
    the port's rebuilds)."""
    from esdg_cns_tpu_torch.solvers._shared import (
        entropy_vars_from_flux,
        flux_to_conservative,
    )

    vx, vy, etov = uniform_tri_mesh(6)
    disc = build_discretization(ref_tri(2), (vx, vy), etov,
                                periodic_axes=(0, 1), dtype=F64,
                                device="cpu")
    rng = np.random.default_rng(3)
    sh = (disc.nfq, disc.num_elements)
    qm = _t(np.stack([0.5 + rng.random(sh), rng.standard_normal(sh),
                      rng.standard_normal(sh), 0.5 + rng.random(sh)]))
    logs = torch.stack([torch.log(qm[0]), torch.log(qm[-1])])
    gather = disc.gather_traces
    qp, logp = gather(qm), gather(logs)
    assert torch.equal(gather(qp), qm)
    dv = entropy_vars_from_flux(qp, logp, 1.4) \
        - entropy_vars_from_flux(qm, logs, 1.4)
    du = flux_to_conservative(qp, 1.4) - flux_to_conservative(qm, 1.4)
    assert torch.equal(gather(dv), -dv)
    assert torch.equal(gather(du), -du)


@pytest.mark.parametrize("case", CAVITY_BCS)
def test_cavity_cases_move_and_take_the_plain_path_on_cpu(case):
    """The cases the card holds K3 and K4 against: the state moves at
    every node with positive pressure, and on CPU tensors the kernel
    wrappers return their plain versions' outputs without a launch."""
    disc, q, bc, p = cavity_case(case, 2, 3, F64, "cpu")
    assert bool((q[1:3] != 0).all()) and bool((pfun(q) > 0).all())
    k3args = (q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, 1.4)
    args, tail, kw = k4_inputs(disc, q, bc, p)
    counts = (mv.euler_modal_volume.launches, sv.cns_surface_viscous.launches)
    for a, b in zip(mv.euler_modal_volume(*k3args, nq=disc.nq),
                    mv.euler_modal_volume_plain(*k3args, nq=disc.nq)):
        assert torch.equal(a, b)
    for fold in (False, True):
        extra = tail if fold else ()
        kern = sv.cns_surface_viscous(*args, *extra, fold_tail=fold, **kw)
        plain = sv.cns_surface_viscous_plain(*args, *extra, fold_tail=fold,
                                             **kw)
        assert len(kern) == len(plain)
        for a, b in zip(kern, plain):
            assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert counts == (mv.euler_modal_volume.launches,
                      sv.cns_surface_viscous.launches)

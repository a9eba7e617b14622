"""The Becker viscous shock tubes, their exact solution and the
verification helpers, on the port against the JAX package (f64, CPU).

The port's ``becker_shocktube_1d`` / ``_2d`` / ``_3d`` build JAX's initial
state, and their Dirichlet BC's ghost states (the exact wave bisected on
the device, ``BeckerShock.conservative_torch``) equal JAX's
(``conservative_jax``) at a later time; ``make_cns_rhs`` on each preset and
``make_cns_rhs_affine(volume_impl='fused_hex')`` on the 3D one (K1 at
N+1 = 6, then K4 at dim=3 with time-dependent Dirichlet ghosts) equal
JAX's.  Tolerances are 1e-12 of the largest value, for states, ghost
states and whole RHS alike (the packages sum in different orders; the
RHS agree to about 1e-13 here).  The port's twin then passes JAX's
accuracy oracle (``tests/test_cns.py:35-39``): the 1D tube at N=3
converges from 16 to 32 elements.  ``l2_error``, ``dg_div`` and
``isentropic_vortex`` equal JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu import presets as jax_presets
from esdg_cns_tpu.physics import BeckerShock as JaxBeckerShock
from esdg_cns_tpu.physics.exact import isentropic_vortex as jax_vortex
from esdg_cns_tpu.presets import lid_driven_cavity as jax_cavity
from esdg_cns_tpu.solvers import make_cns_rhs as jax_cns_rhs
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_cns_affine
from esdg_cns_tpu.solvers.dg_ops import dg_div as jax_dg_div
from esdg_cns_tpu.solvers.euler import l2_error as jax_l2_error
from esdg_cns_tpu_torch import presets
from esdg_cns_tpu_torch.physics.exact import BeckerShock, isentropic_vortex
from esdg_cns_tpu_torch.presets import lid_driven_cavity
from esdg_cns_tpu_torch.solvers import (l2_error, make_cns_rhs,
                                        make_cns_rhs_affine)
from esdg_cns_tpu_torch.solvers.dg_ops import dg_div
from esdg_cns_tpu_torch.timestepping import ssprk33

F64 = torch.float64
TOL_STATE = 1e-12
TOL_RHS = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# (preset, size, mu of the RHS cases): JAX's own tests take mu = 0.1 on
# the 2D tube at these sizes, where the default mu = 0.01 wave is too
# steep for the tris and the state goes negative (NaN in both packages)
PRESETS = {
    "1d": ("becker_shocktube_1d", dict(n=3, k=8), None),
    "2d": ("becker_shocktube_2d", dict(n=2, k1d=4), 0.1),
    "3d": ("becker_shocktube_3d", dict(n=2, k1d=4), None),
}


@functools.lru_cache(maxsize=8)
def _pair(case, mu=None):
    name, size, _ = PRESETS[case]
    kw = dict(size)
    if mu is not None:
        kw["shock"] = BeckerShock(mu=mu)
    port = getattr(presets, name)(**kw, dtype=F64, device="cpu")
    if mu is not None:
        kw["shock"] = JaxBeckerShock(mu=mu)
    return getattr(jax_presets, name)(**kw), port


@pytest.mark.parametrize("case", list(PRESETS))
def test_preset_state_and_ghosts_match_jax(case):
    (jd, jq0, jbc, jshock), (td, tq0, tbc, tshock) = _pair(case)
    assert tshock == BeckerShock(**vars(jshock))
    assert np.array_equal(tq0.numpy(), np.asarray(jq0))
    assert np.array_equal(td.bmask.numpy(), np.asarray(jd.bmask))
    (jr,), (tr,) = jbc.regions, tbc.regions
    assert tr.kind == jr.kind == "dirichlet"
    assert np.array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    for t in (0.0, 0.037):
        assert _rel(tr.state(t), jr.state(t)) <= TOL_STATE
        assert _rel(tr.entropy_state(t), jr.entropy_state(t)) <= TOL_STATE


@pytest.mark.parametrize("case", list(PRESETS))
def test_cns_rhs_on_preset_matches_jax(case):
    (jd, jq0, jbc, jshock), (td, tq0, tbc, _) = _pair(case, PRESETS[case][2])
    flags = dict(mu=jshock.mu, pr=jshock.pr, inviscid_dissipation=True,
                 viscous_dissipation=True)
    t = 0.037
    ref, jaux = jax_cns_rhs(jd, bc=jbc, **flags)(jq0, t)
    got, taux = make_cns_rhs(td, bc=tbc, **flags)(tq0, t)
    assert _rel(got, ref) <= TOL_RHS
    assert abs(float(taux["rhstest_visc"]) - float(jaux["rhstest_visc"])) \
        <= 1e-9 * abs(float(jaux["rhstest_visc"]))


def test_fused_hex_on_3d_preset_matches_jax():
    """The 3D tube at N=5 through the fused_hex front (K1 at N+1 = 6, the
    packed joint kernel in JAX) and K4 merged_tail, with the Dirichlet
    ghosts at t > 0, against JAX (interpret mode) and the port's twin."""
    jd, jq0, jbc, shock = jax_presets.becker_shocktube_3d(n=5, k1d=4)
    td, tq0, tbc, _ = presets.becker_shocktube_3d(n=5, k1d=4, dtype=F64,
                                                  device="cpu")
    flags = dict(mu=shock.mu, pr=shock.pr, inviscid_dissipation=True,
                 viscous_dissipation=True, compute_rhstest=False)
    t = 0.037
    ref, _ = jax_cns_affine(jd, bc=jbc, volume_impl="fused_hex",
                            interpret=True, **flags)(jq0, t)
    got, aux = make_cns_rhs_affine(td, bc=tbc, volume_impl="fused_hex",
                                   **flags)(tq0, t)
    assert _rel(got, ref) <= TOL_RHS
    assert float(aux["rhstest_visc"]) >= 0.0
    twin, _ = make_cns_rhs(td, bc=tbc, **flags)(tq0, t)
    assert _rel(got, twin) <= 1e-9


def _shocktube_error(n, k, t_end=0.02):
    """tests/test_cns.py's oracle on the port's twin: SSPRK33 to t_end,
    the quadrature L2 error against the exact wave over its norm."""
    disc, q0, bc, shock = presets.becker_shocktube_1d(n=n, k=k, dtype=F64,
                                                      device="cpu")
    rhs = make_cns_rhs(disc, mu=shock.mu, pr=shock.pr, bc=bc,
                       inviscid_dissipation=True, compute_rhstest=False)
    cn = (n + 1) * (n + 2) / 2
    dt = 2.0 / (cn * k * k)
    ns = int(np.ceil(t_end / dt))
    qf, _ = ssprk33(rhs, q0, t_end / ns, ns)
    uex = torch.as_tensor(shock.conservative(disc.xq[0].numpy(), t_end))
    err = float(l2_error(disc, qf, uex))
    norm = float(torch.sqrt(torch.sum(disc.wjq[None] * uex ** 2)))
    return err / norm


def test_becker_shocktube_accuracy_and_convergence():
    e1 = _shocktube_error(3, 16)
    e2 = _shocktube_error(3, 32)
    assert e2 < 0.6 * e1, f"no convergence: {e1:.3e} -> {e2:.3e}"
    assert e2 < 2e-3, f"error too large: {e2:.3e}"


def test_exact_wave_on_device_matches_host_and_jax():
    """The tensor bisection against the NumPy one (f64: to roundoff of the
    endpoints) and against JAX's traceable one; in f32 it stays inside
    the bracket."""
    shock = BeckerShock(mu=0.01)
    jshock = JaxBeckerShock(mu=0.01)
    x = np.linspace(-2.0, 2.0, 257)
    host = shock.conservative(x, 0.05)
    dev = shock.conservative_torch(torch.as_tensor(x), 0.05)
    ref = jshock.conservative_jax(jnp.asarray(x), 0.05)
    assert _rel(dev, host) <= TOL_STATE
    assert _rel(dev, ref) <= TOL_STATE
    v32 = shock.velocity_torch(torch.as_tensor(x, dtype=torch.float32))
    assert v32.dtype == torch.float32
    assert bool(((v32 > shock.v_1) & (v32 < shock.v_0)).all())


def test_l2_error_and_dg_div_match_jax():
    jd, jq0, _, _ = jax_cavity(n=2, k1d=3)
    td, tq0, _, _ = lid_driven_cavity(n=2, k1d=3, dtype=F64, device="cpu")
    rng = np.random.default_rng(7)
    nf, nq, k = 4, td.nq, td.num_elements
    exact = rng.standard_normal((nf, nq, k))
    q = tq0.numpy() + 0.1 * rng.standard_normal(tuple(tq0.shape))
    e_ref = jax_l2_error(jd, jnp.asarray(q), jnp.asarray(exact))
    e_got = l2_error(td, torch.as_tensor(q), torch.as_tensor(exact))
    assert abs(float(e_got) - float(e_ref)) <= TOL_STATE * float(e_ref)
    vols = [rng.standard_normal((nf, td.np_, k)) for _ in range(2)]
    fs = [rng.standard_normal((nf, td.nfq, k)) for _ in range(2)]
    ps = [rng.standard_normal((nf, td.nfq, k)) for _ in range(2)]
    as_j = lambda xs: tuple(jnp.asarray(a) for a in xs)
    as_t = lambda xs: tuple(torch.as_tensor(a) for a in xs)
    ref = jax_dg_div(jd, as_j(vols), as_j(fs), as_j(ps))
    got = dg_div(td, as_t(vols), as_t(fs), as_t(ps))
    assert _rel(got, ref) <= TOL_STATE


def test_isentropic_vortex_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 20.0, (64, 8))
    y = rng.uniform(-5.0, 5.0, (64, 8))
    ref = jax_vortex(x, y, 0.3)
    for got in (isentropic_vortex(x, y, 0.3),
                isentropic_vortex(torch.as_tensor(x), torch.as_tensor(y),
                                  0.3)):
        for a, b in zip(got, ref):
            assert _rel(a, b) <= TOL_STATE
    assert all(isinstance(a, np.ndarray)
               for a in isentropic_vortex(x, y, 0.3))
    jax.block_until_ready(ref)

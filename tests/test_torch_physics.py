"""The port's Euler physics against the JAX package (f64, CPU), and the
flux property suite of tests/test_euler_fluxes.py on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.physics import euler as jphys
from esdg_cns_tpu_torch.physics import euler as tphys

RTOL = 1e-14


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prim(dim, shape=(16,), seed=0):
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.5 * rng.random(shape)
    vel = rng.normal(size=(dim, *shape)) * 0.5
    p = 1.0 + 0.5 * rng.random(shape)
    return rho, vel, p


def states(dim, shape=(16,), seed=0):
    """The same conservative state in both packages."""
    rho, vel, p = _prim(dim, shape, seed)
    t = tphys.primitive_to_conservative(*(torch.as_tensor(a)
                                          for a in (rho, vel, p)))
    j = jphys.primitive_to_conservative(*(jnp.asarray(a)
                                          for a in (rho, vel, p)))
    return t, j


def close(t, j, rtol=RTOL, atol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


# ------------------------------------------------ against the JAX package

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_constitutive_maps_match_jax(dim):
    tu, ju = states(dim, seed=dim)
    close(tu, ju)
    for name in ("pfun", "betafun", "sfun", "entropy_fun", "v_ufun",
                 "conservative_to_primitive_beta", "psi_fun"):
        close(getattr(tphys, name)(tu), getattr(jphys, name)(ju))
    close(tphys.u_vfun(tphys.v_ufun(tu)), jphys.u_vfun(jphys.v_ufun(ju)))
    for a, b in zip(tphys.euler_flux(tu), jphys.euler_flux(ju)):
        close(a, b)
    close(tphys.wavespeed(tu[0], tu[1], tu[-1]),
          jphys.wavespeed(ju[0], ju[1], ju[-1]))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_ec_flux_matches_jax(dim):
    tl, jl = states(dim, seed=10 + dim)
    tr, jr = states(dim, seed=20 + dim)
    tql, tqr = (tphys.conservative_to_primitive_beta(u) for u in (tl, tr))
    jql, jqr = (jphys.conservative_to_primitive_beta(u) for u in (jl, jr))
    # pair each left state with itself too: the series branch at aL == aR
    tqr[:, :4] = tql[:, :4]
    jqr = jqr.at[:, :4].set(jql[:, :4])
    for a, b in zip(tphys.ec_flux(tql, tqr), jphys.ec_flux(jql, jqr)):
        close(a, b)
    # per-direction emission (the axis-aligned kernels' dirs=(d,))
    tlog = lambda q: (torch.log(q[0]), torch.log(q[-1]))
    jlog = lambda q: (jnp.log(q[0]), jnp.log(q[-1]))
    for d in range(dim):
        (ft,) = tphys.ec_flux_fields(tuple(tql), tuple(tqr), tlog(tql),
                                     tlog(tqr), dirs=(d,))
        (fj,) = jphys.ec_flux_fields(tuple(jql), tuple(jqr), jlog(jql),
                                     jlog(jqr), dirs=(d,))
        for a, b in zip(ft, fj):
            close(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_logmean_matches_jax_across_the_switch(dtype):
    """Exactly equal arguments, and ratios straddling the dtype's series
    switch (1e-2 in f64, 1e-1 in f32)."""
    a = np.full(9, 1.3, dtype)
    delta = np.array([0.0, 1e-9, 1e-4, 3e-3, 8e-3, 1.2e-2, 5e-2, 0.09, 0.2])
    b = (a * (1 + delta)).astype(dtype)
    t = tphys.logmean(torch.as_tensor(a), torch.as_tensor(b))
    j = jphys.logmean(jnp.asarray(a), jnp.asarray(b))
    assert t.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    tol = RTOL if dtype == np.float64 else 1e-6
    close(t, j, rtol=tol, atol=0)
    assert np.all(np.isfinite(t.numpy()))


# --------------------------------------------- properties, on the port

def test_logmean_symmetry_consistency():
    a = torch.tensor([1.0, 2.5, 0.3], dtype=torch.float64)
    b = torch.tensor([3.0, 2.5000001, 0.31], dtype=torch.float64)
    np.testing.assert_allclose(tphys.logmean(a, b), tphys.logmean(b, a),
                               rtol=1e-14)
    np.testing.assert_allclose(tphys.logmean(a, a), a, rtol=1e-14)


def test_logmean_series_matches_exact_and_grad_finite():
    a = torch.tensor(1.0, dtype=torch.float64)
    for delta in [3e-3, 8e-3, 1.2e-2, 5e-2]:
        b = a * (1 + delta)
        exact = float(b - a) / (np.log(float(b)) - np.log(float(a)))
        np.testing.assert_allclose(float(tphys.logmean(a, b)), exact,
                                   rtol=1e-14)
    g = torch.func.grad(lambda x: tphys.logmean(x, torch.ones_like(x)))(a)
    assert np.isfinite(float(g)) and abs(float(g) - 0.5) < 1e-12


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_entropy_variables_are_gradient(dim):
    u, _ = states(dim, shape=(5,))
    grad = torch.func.vmap(
        torch.func.grad(lambda w: tphys.entropy_fun(w[:, None])[0]),
        in_dims=1, out_dims=1)(u)
    np.testing.assert_allclose(tphys.v_ufun(u).numpy(), grad.numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_involution_and_pressure(dim):
    u, _ = states(dim)
    np.testing.assert_allclose(tphys.u_vfun(tphys.v_ufun(u)).numpy(),
                               u.numpy(), rtol=1e-12)
    p = tphys.pfun(u)
    np.testing.assert_allclose(tphys.betafun(u).numpy(),
                               (u[0] / (2 * p)).numpy())
    assert bool((p > 0).all())


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_flux_symmetry_consistency_tadmor(dim):
    ul, _ = states(dim, seed=4)
    ur, _ = states(dim, seed=5)
    ql, qr = (tphys.conservative_to_primitive_beta(u) for u in (ul, ur))
    for a, b in zip(tphys.ec_flux(ql, qr), tphys.ec_flux(qr, ql)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    for a, b in zip(tphys.ec_flux(ql, ql), tphys.euler_flux(ul)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-11)
    # (vL - vR) . F_d(UL,UR) = psi_d(UL) - psi_d(UR)
    vl, vr = tphys.v_ufun(ul), tphys.v_ufun(ur)
    psi_l, psi_r = tphys.psi_fun(ul), tphys.psi_fun(ur)
    for d, f in enumerate(tphys.ec_flux(ql, qr)):
        np.testing.assert_allclose(torch.sum((vl - vr) * f, dim=0).numpy(),
                                   (psi_l[d] - psi_r[d]).numpy(), rtol=1e-10)
    # precomputed logs change nothing
    logs = lambda q: torch.stack([torch.log(q[0]), torch.log(q[-1])])
    for a, b in zip(tphys.ec_flux(ql, qr),
                    tphys.ec_flux(ql, qr, logs(ql), logs(qr))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13)


def test_wavespeed():
    u, _ = states(1, seed=8)
    c = torch.sqrt(tphys.GAMMA * tphys.pfun(u) / u[0])
    np.testing.assert_allclose(
        tphys.wavespeed(u[0], u[1], u[2]).numpy(),
        (torch.abs(u[1] / u[0]) + c).numpy(), rtol=1e-12)

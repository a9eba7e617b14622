"""The port's RHS paths and steppers against the JAX package (f64, CPU).

The fused path runs its kernels' plain versions here (CPU tensors); the
JAX fused path runs its Pallas kernels in interpret mode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu.solvers import make_euler_rhs as jax_make_euler_rhs
from esdg_cns_tpu.solvers.euler_fused import (
    make_euler_rhs_fused as jax_make_euler_rhs_fused,
)
from esdg_cns_tpu.timestepping import ssprk33 as jax_ssprk33
from esdg_cns_tpu_torch.physics import primitive_to_conservative
from esdg_cns_tpu_torch.presets import euler_hex_3d
from esdg_cns_tpu_torch.solvers import make_euler_rhs, make_euler_rhs_fused
from esdg_cns_tpu_torch.timestepping import lsrk45, ssprk33

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "euler_one_step.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _random_state(disc, seed):
    rng = np.random.default_rng(seed)
    sh = (disc.np_, disc.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=F64)
    return primitive_to_conservative(
        f(2 + 0.1 * rng.random(sh)), f(0.3 * rng.standard_normal((3, *sh))),
        f(2 + 0.1 * rng.random(sh)))


def test_fused_and_twin_match_jax():
    """(d) port fused (plain kernels) vs JAX fused (interpret) and the
    port twin vs JAX make_euler_rhs('lines'); N=3, k1d=2."""
    jd, jq = jax_preset(n=3, k1d=2)
    td, tq = euler_hex_3d(n=3, k1d=2, dtype=F64, device="cpu")
    j_twin, _ = jax_make_euler_rhs(jd, dissipation=True,
                                   flux_diff_impl="lines",
                                   compute_rhstest=False)(jq)
    j_fused, _ = jax_make_euler_rhs_fused(jd, dissipation=True,
                                          interpret=True)(jq)
    t_twin, _ = make_euler_rhs(td, flux_diff_impl="lines", dissipation=True,
                               compute_rhstest=False)(tq)
    t_fused, _ = make_euler_rhs_fused(td, dissipation=True)(tq)
    assert _rel(t_twin.numpy(), j_twin) <= 1e-11
    assert _rel(t_fused.numpy(), j_fused) <= 1e-11
    # and the port keeps the JAX package's fused == lines equality
    assert _rel(t_fused.numpy(), t_twin.numpy()) <= 1e-11
    g, _ = make_euler_rhs_fused(td, dissipation=True, axis_aligned=False)(tq)
    assert _rel(g.numpy(), t_fused.numpy()) <= 1e-13


def test_golden_hex_step_without_jax():
    """(e) tests/golden/euler_one_step.npz hex keys: one f64 LSRK45 step,
    dt=1e-3, dissipation on.  The fixture came from the dense 'xla' fd,
    the port takes the line-sparse one: another summation order."""
    stored = np.load(GOLDEN)
    disc, q0 = euler_hex_3d(n=2, k1d=2, dtype=F64, device="cpu")
    np.testing.assert_allclose(q0.numpy(), stored["hex_euler_q0"],
                               rtol=1e-12, atol=1e-12)
    rhs = make_euler_rhs(disc, flux_diff_impl="lines", dissipation=True,
                         compute_rhstest=True)
    qf, aux = lsrk45(rhs, q0, 1e-3, 1)
    np.testing.assert_allclose(qf.numpy(), stored["hex_euler_qf"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(aux["rhstest"].numpy(),
                               stored["hex_euler_rhstest"],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,k1d", [(3, 2), (2, 3)])
def test_entropy_conservation_without_dissipation(n, k1d):
    """(f) f64 rhstest <= 1e-12 with dissipation off, twin and fused."""
    disc, _ = euler_hex_3d(n=n, k1d=k1d, dtype=F64, device="cpu")
    q = _random_state(disc, seed=3)
    _, aux = make_euler_rhs(disc, flux_diff_impl="lines", dissipation=False)(q)
    assert abs(float(aux["rhstest"])) <= 1e-12
    for mode in ("native", "f64"):
        _, aux = make_euler_rhs_fused(disc, dissipation=False,
                                      compute_rhstest=True,
                                      rhstest_mode=mode)(q)
        assert abs(float(aux["rhstest"])) <= 1e-12
    # with dissipation the balance is a strict entropy decrease
    _, aux = make_euler_rhs(disc, flux_diff_impl="lines", dissipation=True)(q)
    assert float(aux["rhstest"]) < 0


def test_free_stream_preserved_on_curved_hex():
    """A constant state is a steady solution on a curved mesh (the
    curl-form metrics satisfy the GCL); the fused path takes its plain
    kernels on the CPU, which cover curved geometry."""
    disc, _ = euler_hex_3d(n=2, k1d=2, curved=True, dtype=F64, device="cpu")
    assert disc.geo.shape[1] != 1
    sh = (disc.np_, disc.num_elements)
    full = lambda v: torch.full(sh, v, dtype=F64)
    q = primitive_to_conservative(
        full(1.3), torch.stack([full(0.2), full(-0.1), full(0.4)]), full(0.9))
    for rhs in (make_euler_rhs(disc, flux_diff_impl="lines",
                               compute_rhstest=False),
                make_euler_rhs_fused(disc)):
        dq, _ = rhs(q)
        assert float(dq.abs().max()) < 1e-11


def test_curved_twin_and_fused_match_jax():
    """Curved N=3, k1d=2 mesh (metric at every hybridized point, all nine
    terms nonzero) on a random state: the port's twin vs JAX
    make_euler_rhs('lines'), and the fused path (plain kernels) vs JAX
    fused (interpret)."""
    jd, _ = jax_preset(n=3, k1d=2, curved=True)
    td, _ = euler_hex_3d(n=3, k1d=2, curved=True, dtype=F64, device="cpu")
    assert td.geo.shape[1] == td.nh
    tq = _random_state(td, seed=5)
    jq = jnp.asarray(tq.numpy())
    j_twin, _ = jax_make_euler_rhs(jd, dissipation=True,
                                   flux_diff_impl="lines",
                                   compute_rhstest=False)(jq)
    j_fused, _ = jax_make_euler_rhs_fused(jd, dissipation=True,
                                          interpret=True)(jq)
    t_twin, _ = make_euler_rhs(td, flux_diff_impl="lines", dissipation=True,
                               compute_rhstest=False)(tq)
    t_fused, _ = make_euler_rhs_fused(td, dissipation=True)(tq)
    assert _rel(t_twin.numpy(), j_twin) <= 1e-11
    assert _rel(t_fused.numpy(), j_fused) <= 1e-11


def test_ssprk33_matches_jax():
    jd, jq = jax_preset(n=2, k1d=2)
    td, tq = euler_hex_3d(n=2, k1d=2, dtype=F64, device="cpu")
    jrhs = jax_make_euler_rhs(jd, dissipation=True, flux_diff_impl="lines")
    jqf, jaux = jax.jit(lambda q: jax_ssprk33(jrhs, q, 1e-3, 2))(jq)
    tqf, taux = ssprk33(make_euler_rhs(td, flux_diff_impl="lines",
                                       dissipation=True), tq, 1e-3, 2)
    assert _rel(tqf.numpy(), jqf) <= 1e-12
    assert taux["rhstest"].shape == (2,)
    np.testing.assert_allclose(taux["rhstest"].numpy(),
                               np.asarray(jaux["rhstest"]), rtol=1e-10,
                               atol=1e-13)


def test_f32_state_stays_f32():
    disc, q0 = euler_hex_3d(n=2, k1d=2, dtype=torch.float32, device="cpu")
    for rhs in (make_euler_rhs(disc, flux_diff_impl="lines",
                               compute_rhstest=False),
                make_euler_rhs_fused(disc)):
        dq, _ = rhs(q0)
        assert dq.dtype == torch.float32
        qf, _ = lsrk45(rhs, q0, 1e-3, 1)
        assert qf.dtype == torch.float32 and bool(torch.isfinite(qf).all())
    # the f64 twin agrees with the f32 one to f32 roundoff
    d64, q64 = euler_hex_3d(n=2, k1d=2, dtype=F64, device="cpu")
    a, _ = make_euler_rhs_fused(d64)(q64)
    b, _ = make_euler_rhs_fused(disc)(q0)
    assert _rel(b.double().numpy(), a.numpy()) <= 1e-4

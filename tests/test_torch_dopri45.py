"""The port's adaptive DOPRI45 (``timestepping.dopri45``) against the JAX
package's (f64, CPU).

Both integrate the same right-hand sides from the same state: the twin
CNS RHS on the 1D Becker tube (the two presets are bit-equal in f64 and
their RHS agree to about 1e-13), a right-hand side that turns the state
into NaN, and a linear ODE with a known solution.  The controller's
decisions must coincide (the counts of accepted and rejected steps, the
bail-out) and the final states agree to 1e-11 of their size.  The
error estimate sum_i e_i k_i cancels to about 1e-8 of its terms, so it
carries about 1e-8 relative roundoff that depends on the summation order
(XLA fuses and contracts the sum; the port sums term by term): the
recorded err column agrees to 1e-6, and the step sizes, which take err to
the power 0.067 and 0.05, and the times they sum to, to 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu import presets as jax_presets
from esdg_cns_tpu.solvers import make_cns_rhs as jax_cns_rhs
from esdg_cns_tpu.timestepping import dopri45 as jax_dopri45
from esdg_cns_tpu_torch import presets
from esdg_cns_tpu_torch.solvers import make_cns_rhs
from esdg_cns_tpu_torch.timestepping import dopri45
from esdg_cns_tpu_torch.verification import becker_dt0

F64 = torch.float64
STATS = {"t", "dt", "n_accepted", "n_rejected", "stalled"}
TOL_STEP = 1e-8
TOL_ERR = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _becker_pair(n=2, k=16):
    jd, jq0, jbc, shock = jax_presets.becker_shocktube_1d(n=n, k=k)
    td, tq0, tbc, _ = presets.becker_shocktube_1d(n=n, k=k, dtype=F64,
                                                  device="cpu")
    flags = dict(mu=shock.mu, pr=shock.pr, inviscid_dissipation=True,
                 compute_rhstest=False)
    return (jax_cns_rhs(jd, bc=jbc, **flags), jq0,
            make_cns_rhs(td, bc=tbc, **flags), tq0)


def _same_decisions(stats, jstats):
    for key in ("n_accepted", "n_rejected"):
        assert stats[key] == int(jstats[key]), key
    assert stats["stalled"] == bool(jstats["stalled"])
    assert abs(stats["t"] - float(jstats["t"])) <= 1e-14
    assert abs(stats["dt"] - float(jstats["dt"])) <= TOL_STEP * float(
        jstats["dt"])


def test_becker_tube_matches_jax():
    """becker_shocktube_1d(n=2, k=16) to t=0.01 at err_tol=1e-9."""
    jrhs, jq0, rhs, q0 = _becker_pair()
    kw = dict(err_tol=1e-9)
    dt0 = becker_dt0(2, 16)
    jq, jstats = jax.jit(lambda q: jax_dopri45(jrhs, q, 0.01, dt0, **kw))(
        jq0)
    q, stats = dopri45(rhs, q0, 0.01, dt0, **kw)
    assert set(stats) == set(jstats)
    assert STATS <= set(stats)
    _same_decisions(stats, jstats)
    assert stats["n_accepted"] > 5 and not stats["stalled"]
    assert _rel(q, jq) <= 1e-11
    assert abs(float(stats["rhstest_visc"]) - float(jstats["rhstest_visc"])
               ) <= 1e-9 * abs(float(jstats["rhstest_visc"]))


def test_history_matches_jax():
    """max_records / record_every: every second accepted step recorded
    into 4 slots, with the aux scalars beside t, dt and err; recording
    stops when the buffer is full."""
    jrhs, jq0, rhs, q0 = _becker_pair()
    kw = dict(err_tol=1e-9, max_records=4, record_every=2)
    dt0 = becker_dt0(2, 16)
    _, jstats = jax.jit(lambda q: jax_dopri45(jrhs, q, 0.01, dt0, **kw))(
        jq0)
    _, stats = dopri45(rhs, q0, 0.01, dt0, **kw)
    assert set(stats) == set(jstats)
    assert stats["n_records"] == int(jstats["n_records"]) == 4
    hist, jhist = stats["history"], jstats["history"]
    assert set(hist) == set(jhist) == {"t", "dt", "err", "rhstest_visc"}
    for key in hist:
        a, b = hist[key].numpy(), np.asarray(jhist[key])
        assert a.shape == b.shape == (4,)
        tol = TOL_ERR if key == "err" else TOL_STEP
        assert np.allclose(a, b, rtol=tol, atol=0.0), key
    # a larger buffer keeps its unused tail NaN
    kw["max_records"] = 64
    _, stats = dopri45(rhs, q0, 0.01, dt0, **kw)
    n = stats["n_records"]
    assert n == (stats["n_accepted"] + 1) // 2
    assert bool(torch.isnan(stats["history"]["t"][n:]).all())
    assert not bool(torch.isnan(stats["history"]["t"][:n]).any())


def test_nan_rhs_stalls_as_jax_does():
    """A right-hand side that is NaN from t > 0 on: every step is rejected
    (the non-finite error counts as 1e6), dt falls to dt_min, and after
    max_stuck rejections there the loop bails out with the initial
    state."""
    q0 = np.array([1.0, 2.0, 3.0])

    def jrhs(q, t):
        return jnp.where(t > 0, jnp.nan, -q), {"m": jnp.sum(q)}

    def rhs(q, t):
        dq = torch.full_like(q, float("nan")) if t > 0 else -q
        return dq, {"m": torch.sum(q)}

    kw = dict(err_tol=1e-6, dt_min=1e-4, max_stuck=5)
    jq, jstats = jax.jit(lambda q: jax_dopri45(jrhs, q, 1.0, 0.1, **kw))(
        jnp.asarray(q0))
    q, stats = dopri45(rhs, torch.tensor(q0), 1.0, 0.1, **kw)
    assert stats["stalled"] and bool(jstats["stalled"])
    _same_decisions(stats, jstats)
    assert stats["n_accepted"] == 0
    assert np.array_equal(q.numpy(), q0) and np.array_equal(
        np.asarray(jq), q0)


def test_linear_ode_matches_exact_solution():
    """q' = lam q to t = 1: the exact exp(lam t), within the error the
    tolerance allows, and JAX's step for step."""
    lam = np.array([-1.0, -2.0, 0.5])
    q0 = np.array([1.0, 0.5, 2.0])
    kw = dict(err_tol=1e-10)
    q, stats = dopri45(lambda q, t: (torch.tensor(lam) * q, {}),
                       torch.tensor(q0), 1.0, 0.01, **kw)
    jq, jstats = jax.jit(lambda q: jax_dopri45(
        lambda q, t: (jnp.asarray(lam) * q, {}), q, 1.0, 0.01, **kw))(
        jnp.asarray(q0))
    exact = q0 * np.exp(lam)
    assert _rel(q, exact) <= 1e-8
    assert _rel(q, jq) <= 1e-13
    _same_decisions(stats, jstats)
    assert stats["t"] == 1.0

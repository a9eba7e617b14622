"""K1 (the fused hex volume stage) at N+1 = 6, 7, 8 on the paths that
select it, on the port against the JAX package (f64, CPU).

JAX's ``make_euler_rhs_fused`` takes its joint kernel (K1's math, the
Pallas ``_volume_kernel`` in interpret mode here) at N = 5 under 'auto'
(``joint_packed``: 8 % 6 != 0), at N = 6 under ``force_fused``, on the
curved mesh at every order (N = 7 under ``force_fused``) and wherever
``volume_mode='joint'`` is named; the 3D cavity's ``fused_hex`` front
takes it at N = 5.  The port must take K1 on each (``euler_volume``: its
plain version on these CPU tensors, its CUDA kernel on the card, built
for N+1 <= 8) and agree with JAX to 1e-12 of max |dq|.  Both packages
get the same operators (the port's presets build JAX's bits, tested in
``test_torch_split_volume.py``) and the same seeded moving state.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu.presets import lid_driven_cavity_3d as jax_cavity_3d
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_cns_affine
from esdg_cns_tpu.solvers.euler_fused import (
    make_euler_rhs_fused as jax_euler_fused,
)
from esdg_cns_tpu_torch.cavity_cases import moving_state
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.physics import primitive_to_conservative
from esdg_cns_tpu_torch.presets import euler_hex_3d, lid_driven_cavity_3d
from esdg_cns_tpu_torch.solvers import euler_fused, make_cns_rhs_affine
from esdg_cns_tpu_torch.solvers import make_euler_rhs_fused

F64 = torch.float64
# one whole RHS, relative to max |dq|: the packages sum in other orders
TOL = 1e-12


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


@functools.lru_cache(maxsize=4)
def _euler_pair(n, curved):
    """(JAX disc, port disc, JAX state, port state) at k1d=2: a seeded
    state whose three velocity components are all nonzero."""
    jd, _ = jax_preset(n=n, k1d=2, curved=curved)
    td, _ = euler_hex_3d(n=n, k1d=2, curved=curved, dtype=F64, device="cpu")
    rng = np.random.default_rng(n)
    sh = (td.np_, td.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=F64)
    tq = primitive_to_conservative(f(2 + 0.1 * rng.random(sh)),
                                   f(0.3 * rng.standard_normal((3, *sh))),
                                   f(2 + 0.1 * rng.random(sh)))
    return jd, td, jnp.asarray(tq.numpy()), tq


def _counting(monkeypatch, module, names):
    """Count the calls of module.<name> for each name (the volume stages
    the RHS constructors bind at construction)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(module, name)

        def wrapped(*args, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("n,curved,kw,mode", [
    (5, False, {}, "joint_packed"),
    (6, False, dict(force_fused=True), "joint_packed"),
    (7, True, dict(force_fused=True), "joint"),
    (7, False, dict(force_fused=True, volume_mode="joint"), "joint"),
], ids=["n5-auto", "n6-force_fused", "n7-curved", "n7-joint"])
def test_euler_fused_takes_k1_and_matches_jax(monkeypatch, n, curved, kw,
                                              mode):
    jd, td, jq, tq = _euler_pair(n, curved)
    assert euler_fused.resolve_volume_mode(
        td, kw.get("volume_mode", "auto")) == mode
    calls = _counting(monkeypatch, euler_fused,
                      ("euler_volume", "euler_volume_split_parts"))
    got, _ = make_euler_rhs_fused(td, dissipation=True, **kw)(tq)
    assert calls == {"euler_volume": 1, "euler_volume_split_parts": 0}
    ref, _ = jax_euler_fused(jd, dissipation=True, interpret=True, **kw)(jq)
    assert _rel(got, ref) <= TOL


def test_fused_hex_front_at_n5_takes_k1_and_matches_jax(monkeypatch):
    """The 3D cavity's fused_hex front at N = 5 (JAX's packed joint
    kernel, cns_fused.py:314-318) through K4 merged_tail, as the bench
    runs it."""
    jd, _, jbc, p = jax_cavity_3d(n=5, k1d=2)
    td, tq0, tbc, _ = lid_driven_cavity_3d(n=5, k1d=2, dtype=F64,
                                           device="cpu")
    q = moving_state(tq0, np.random.default_rng(5))
    calls = _counting(monkeypatch, fv, ("euler_volume", "euler_volume_split"))
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True,
                 volume_impl="fused_hex", compute_rhstest=False)
    got, _ = make_cns_rhs_affine(td, bc=tbc, **flags)(q, 0.0)
    assert calls == {"euler_volume": 1, "euler_volume_split": 0}
    ref, _ = jax_cns_affine(jd, bc=jbc, interpret=True, **flags)(
        jnp.asarray(q.numpy()), 0.0)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n,k1d", [(5, 20), (6, 16)])
def test_bench_meshes_detected_axis_aligned(n, k1d):
    """The snap gate at the sizes the card runs K1 at N = 5 and 6 (8.64M
    and 7.0M DOF): K1 and K2 take their diagonal forms there."""
    disc, _ = euler_hex_3d(n=n, k1d=k1d, dtype=torch.float32, device="cpu")
    assert disc.num_elements == k1d ** 3
    assert fv.detect_axis_aligned(disc)
    assert euler_fused.resolve_volume_mode(disc) == "joint_packed"

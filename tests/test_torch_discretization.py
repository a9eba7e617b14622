"""The port's discretization against the JAX package's (f64, CPU).

Both run the same NumPy host setup, so every array must agree BITWISE;
the axis-aligned detection must agree at the bench-scale meshes, where
the curl-form noise once defeated a tighter snap gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.core import build_discretization as jax_build
from esdg_cns_tpu.core import ref_hex as jax_ref_hex
from esdg_cns_tpu.core import ref_tri as jax_ref_tri
from esdg_cns_tpu.mesh import uniform_hex_mesh, uniform_tri_mesh
from esdg_cns_tpu.ops.pallas_volume import detect_axis_aligned as jax_detect
from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.core import build_discretization, ref_hex, ref_tri
from esdg_cns_tpu_torch.core.discretization import (
    ARRAY_FIELDS,
    META_FIELDS,
    TUPLE_FIELDS,
)
from esdg_cns_tpu_torch.ops.fused_volume import detect_axis_aligned
from esdg_cns_tpu_torch.presets import euler_hex_3d

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy(disc, name):
    v = getattr(disc, name)
    if name in TUPLE_FIELDS:
        return np.stack([t.numpy() for t in v])
    return v.numpy()


def jax_arrays(jd):
    """The JAX Discretization's leaves and static fields, as numpy."""
    arrays = {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(jd, f) for f in META_FIELDS}
    return arrays, meta


def _assert_same(td, jd):
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jd, f)), _numpy(td, f)
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f"{f} differs"
    for f in META_FIELDS:
        if f == "line_ops":
            lo_j, lo_t = jd.line_ops, td.line_ops
            assert (lo_j is None) == (lo_t is None)
            if lo_j is not None:
                for k in ("n1d", "s1", "e_minus", "e_plus", "w1"):
                    assert getattr(lo_j, k) == getattr(lo_t, k), k
        else:
            assert getattr(jd, f) == getattr(td, f), f


@pytest.mark.parametrize("n,curved", [(2, False), (3, False), (2, True)])
def test_discretization_bitwise_equal(n, curved):
    jd, jq = jax_preset(n=n, k1d=2, curved=curved)
    td, tq = euler_hex_3d(n=n, k1d=2, curved=curved, dtype=F64, device="cpu")
    _assert_same(td, jd)
    # the preset's seeded state: the same IEEE ops on the same draws
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-15,
                               atol=0)
    # and the interop route carries the JAX leaves over unchanged
    arrays, meta = jax_arrays(jd)
    _assert_same(interop.discretization_from_arrays(
        arrays, meta, device="cpu", dtype=F64), jd)


def test_non_periodic_mesh_bitwise_equal():
    """Boundary faces self-map (bmask) and the map_p gather path."""
    vx, vy, vz, etov = uniform_hex_mesh(2, 1, 2)
    jd = jax_build(jax_ref_hex(2), (vx, vy, vz), etov, periodic_axes=(0,),
                   dtype=jnp.float64)
    td = build_discretization(ref_hex(2), (vx, vy, vz), etov,
                              periodic_axes=(0,), dtype=F64, device="cpu")
    _assert_same(td, jd)
    assert bool(td.bmask.any())


@pytest.mark.parametrize("n", [2, 3])
def test_tri_discretization_bitwise_equal(n):
    """The modal (non-collocated) element: every operator differs from
    the hex case (Vq, Pq dense, no line_ops)."""
    vx, vy, etov = uniform_tri_mesh(2)
    jd = jax_build(jax_ref_tri(n), (vx, vy), etov, periodic_axes=(0, 1),
                   dtype=jnp.float64)
    td = build_discretization(ref_tri(n), (vx, vy), etov,
                              periodic_axes=(0, 1), dtype=F64, device="cpu")
    _assert_same(td, jd)
    assert td.line_ops is None


def test_gather_traces_matches_jax():
    """Roll exchange (grid_shape) and map_p gather against JAX's, and
    against each other: pure data movement, so bitwise."""
    jd, _ = jax_preset(n=2, k1d=3)
    td, _ = euler_hex_3d(n=2, k1d=3, dtype=F64, device="cpu")
    uf = np.random.default_rng(0).standard_normal((7, td.nfq, td.num_elements))
    ref = np.asarray(jd.gather_traces(jnp.asarray(uf)))
    rolled = td.gather_traces(torch.as_tensor(uf))
    assert np.array_equal(rolled.numpy(), ref)
    arrays, meta = jax_arrays(jd)
    meta["grid_shape"] = None        # force the map_p gather
    tg = interop.discretization_from_arrays(arrays, meta, device="cpu",
                                            dtype=F64)
    assert np.array_equal(tg.gather_traces(torch.as_tensor(uf)).numpy(), ref)


def test_detect_axis_aligned_agrees():
    # small meshes: both packages, uniform and curved
    for curved in (False, True):
        jd, _ = jax_preset(n=3, k1d=2, curved=curved)
        td, _ = euler_hex_3d(n=3, k1d=2, curved=curved, dtype=F64,
                             device="cpu")
        assert detect_axis_aligned(td) == jax_detect(jd) == (not curved)
    # the bench-scale meshes (JAX: tests/test_flux_differencing.py pins
    # these True with the same 1e-9 gate)
    for n, k1d in ((3, 32), (4, 24)):
        td, _ = euler_hex_3d(n=n, k1d=k1d, dtype=torch.float32,
                             device="cpu")
        assert detect_axis_aligned(td), (n, k1d)
        del td

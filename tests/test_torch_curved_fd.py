"""The flux-differencing choices and the curved kernels' plain versions
against the JAX package (f64, CPU).

Covers the port's ``make_cns_rhs(flux_diff_impl=...)`` and
``make_euler_rhs``'s default (both as the JAX package has them), the
'pallas' (K5, ``ops.dense_fd``) and 'lines_pallas' (row 10,
``ops.tensor_product_fd.flux_differencing_lines_fused``) choices of
``resolve_flux_diff``, and the curved branch of K3 on a tri mesh curved
by ``presets.square_warp``.  The JAX Pallas kernels run in interpret
mode.  Inputs are seeded NumPy draws of moving states, handed to both
packages.  The whole file takes about two minutes on one core, most of
it XLA compiling the unrolled Pallas bodies of the interpret runs (the
curved hex N=1 case of K5 alone about 30 s).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.core import build_discretization as jax_build
from esdg_cns_tpu.core import ref_hex as jax_ref_hex
from esdg_cns_tpu.core import ref_tri as jax_ref_tri
from esdg_cns_tpu.mesh import uniform_hex_mesh, uniform_tri_mesh
from esdg_cns_tpu.ops.pallas_fd import flux_differencing_pallas
from esdg_cns_tpu.ops.pallas_modal_volume import euler_modal_volume_pallas
from esdg_cns_tpu.ops.tensor_product_fd import flux_differencing_lines_pallas
from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu.presets import lid_driven_cavity as jax_cavity
from esdg_cns_tpu.solvers import make_cns_rhs as jax_make_cns_rhs
from esdg_cns_tpu.solvers import make_euler_rhs as jax_make_euler_rhs
from esdg_cns_tpu.solvers._shared import (
    resolve_flux_diff as jax_resolve_flux_diff,
)
from esdg_cns_tpu_torch.cavity_cases import fd_inputs, moving_state
from esdg_cns_tpu_torch.core import build_discretization, ref_hex, ref_tri
from esdg_cns_tpu_torch.core.discretization import (
    ARRAY_FIELDS,
    META_FIELDS,
    TUPLE_FIELDS,
)
from esdg_cns_tpu_torch.ops.dense_fd import (
    flux_differencing_dense,
    flux_differencing_dense_plain,
)
from esdg_cns_tpu_torch.ops.modal_volume import euler_modal_volume_plain
from esdg_cns_tpu_torch.ops.tensor_product_fd import (
    flux_differencing_lines,
    flux_differencing_lines_fused,
)
from esdg_cns_tpu_torch.physics import primitive_to_conservative
from esdg_cns_tpu_torch.presets import (
    euler_hex_3d,
    lid_driven_cavity,
    square_warp,
)
from esdg_cns_tpu_torch.solvers import make_cns_rhs, make_euler_rhs
from esdg_cns_tpu_torch.solvers._shared import resolve_flux_diff

F64 = torch.float64
GAMMA = 1.4
TOL = 1e-12


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
    return np.abs(a - b).max() / np.abs(b).max()


def _random_state(disc, seed):
    """Seeded moving state: every velocity component O(0.3)."""
    rng = np.random.default_rng(seed)
    sh = (disc.np_, disc.num_elements)
    return primitive_to_conservative(
        _t(2 + 0.1 * rng.random(sh)),
        _t(0.3 * rng.standard_normal((disc.dim, *sh))),
        _t(2 + 0.1 * rng.random(sh)))


def _hex_n1(curved):
    """Hex N=1 (Nh=32) on a 3 x 3 x 2 mesh (K=18, ragged against
    block_k=8), optionally warped as tests/test_flux_differencing.py
    warps it; the same NumPy setup in both packages."""
    vx, vy, vz, etov = uniform_hex_mesh(3, 3, 2)
    warp = None
    if curved:
        def warp(x, y, z):
            return x + 0.08 * (x - 1) * (x + 1) * (y - 1) * (y + 1), y, z
    return (jax_build(jax_ref_hex(1), (vx, vy, vz), etov, curved_map=warp),
            build_discretization(ref_hex(1), (vx, vy, vz), etov,
                                 curved_map=warp, dtype=F64, device="cpu"))


def _tri_n3(curved, k1d=3):
    """Tri N=3 on [-1, 1]^2 (K=2 k1d^2 = 18, ragged against block_k=8),
    curved by the port's square_warp or affine."""
    vx, vy, etov = uniform_tri_mesh(k1d)
    warp = square_warp if curved else None
    return (jax_build(jax_ref_tri(3), (vx, vy), etov, curved_map=warp),
            build_discretization(ref_tri(3), (vx, vy), etov,
                                 curved_map=warp, dtype=F64, device="cpu"))


# ---- the two repairs: make_cns_rhs(flux_diff_impl=...), and
# make_euler_rhs's default ----

@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_make_cns_rhs_takes_flux_diff_impl_as_jax_does(impl):
    jd, jq0, jbc, jp = jax_cavity(n=2, k1d=4)
    td, tq0, tbc, tp = lid_driven_cavity(n=2, k1d=4, dtype=F64,
                                         device="cpu")
    q = moving_state(tq0, np.random.default_rng(11))
    flags = dict(mu=tp["mu"], pr=tp["pr"], re=tp["re"],
                 inviscid_dissipation=True, viscous_dissipation=True,
                 flux_diff_impl=impl)
    dq, aux = make_cns_rhs(td, bc=tbc, **flags)(q)
    jdq, jaux = jax_make_cns_rhs(jd, bc=jbc, **flags)(jnp.asarray(q.numpy()))
    assert _rel(dq.numpy(), jdq) <= 1e-11
    assert _rel(aux["rhstest_visc"].numpy(), jaux["rhstest_visc"]) <= 1e-11


def test_make_euler_rhs_default_is_jax_default():
    """Both packages' make_euler_rhs default to the same flux
    differencing ('xla', the dense sum), and give the same RHS with it."""
    param = lambda f: inspect.signature(f).parameters["flux_diff_impl"]
    assert param(make_euler_rhs).default == param(jax_make_euler_rhs).default
    assert param(make_cns_rhs).default == param(jax_make_cns_rhs).default
    jd, td = _hex_n1(curved=False)
    q = _random_state(td, seed=2)
    a, _ = make_euler_rhs(td, compute_rhstest=False)(q)
    b, _ = make_euler_rhs(td, flux_diff_impl="xla", compute_rhstest=False)(q)
    j, _ = jax_make_euler_rhs(jd, compute_rhstest=False)(
        jnp.asarray(q.numpy()))
    assert torch.equal(a, b)
    assert _rel(a.numpy(), j) <= 1e-11


def test_resolve_flux_diff_names():
    """'pallas' and 'lines_pallas' resolve; the errors are JAX's."""
    _, td = _tri_n3(curved=False)
    jd, _ = _tri_n3(curved=False)
    for impl in ("auto", "xla", "pallas"):
        assert callable(resolve_flux_diff(td, impl))
    for impl in ("lines", "lines_pallas"):
        with pytest.raises(ValueError) as port_err:
            resolve_flux_diff(td, impl)
        with pytest.raises(ValueError) as jax_err:
            jax_resolve_flux_diff(jd, impl)
        assert str(port_err.value) == str(jax_err.value)
    for impl in ("dense", "PALLAS"):
        with pytest.raises(ValueError):
            resolve_flux_diff(td, impl)
        with pytest.raises(ValueError):
            jax_resolve_flux_diff(jd, impl)
    _, hd = _hex_n1(curved=False)
    for impl in ("lines", "lines_pallas"):
        assert callable(resolve_flux_diff(hd, impl))
    with pytest.raises(ValueError):
        flux_differencing_dense(*fd_inputs(hd, _random_state(hd, 1)),
                                hd.q_skew, hd.geo, GAMMA, nq=hd.nq,
                                fd_mode="packed")


# ---- K5: the dense sum against JAX's _fd_kernel (interpret) ----

@pytest.mark.parametrize("mesh", ["hex1", "tri3"])
@pytest.mark.parametrize("curved", [False, True])
def test_dense_fd_plain_matches_pallas(mesh, curved):
    jd, td = _hex_n1(curved) if mesh == "hex1" else _tri_n3(curved)
    assert (td.geo.shape[1] == td.nh) == curved
    qh, qlog = fd_inputs(td, _random_state(td, seed=4))
    j = flux_differencing_pallas(
        jnp.asarray(qh.numpy()), jnp.asarray(qlog.numpy()), jd.q_skew,
        jd.geo, GAMMA, nq=jd.nq, block_k=8, interpret=True)
    p = flux_differencing_dense_plain(qh, qlog, td.q_skew, td.geo, GAMMA,
                                      nq=td.nq)
    assert _rel(p.numpy(), j) <= TOL
    # the wrapper takes the plain version on CPU tensors, in every layout
    for mode in ("tri", "tri8", "full"):
        w = flux_differencing_dense(qh, qlog, torch.stack(td.q_skew),
                                    td.geo, GAMMA, nq=td.nq, fd_mode=mode)
        assert torch.equal(w, p)


# ---- row 10: the line-sparse sum against JAX's _hex_lines_kernel ----

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("curved", [False, True])
def test_hex_lines_plain_matches_pallas(n, curved):
    jd, _ = jax_preset(n=n, k1d=2, curved=curved)
    td, _ = euler_hex_3d(n=n, k1d=2, curved=curved, dtype=F64, device="cpu")
    qh, qlog = fd_inputs(td, _random_state(td, seed=n))
    kw = dict(elem_type="hex", line_ops=td.line_ops, nq=td.nq)
    j = flux_differencing_lines_pallas(
        jnp.asarray(qh.numpy()), jnp.asarray(qlog.numpy()), jd.geo, GAMMA,
        elem_type="hex", line_ops=jd.line_ops, nq=jd.nq, interpret=True)
    p = flux_differencing_lines(qh, qlog, td.geo, GAMMA, **kw)
    assert _rel(p.numpy(), j) <= TOL
    assert torch.equal(
        flux_differencing_lines_fused(qh, qlog, td.geo, GAMMA, **kw), p)


# ---- K3c: the modal volume stage on a curved tri mesh ----

def test_warped_tri_discretization_bitwise_equal():
    jd, td = _tri_n3(curved=True)
    assert not td.affine and td.geo.shape == (4, td.nh, td.num_elements)
    for f in ARRAY_FIELDS:
        a = np.asarray(getattr(jd, f))
        v = getattr(td, f)
        b = (np.stack([x.numpy() for x in v]) if f in TUPLE_FIELDS
             else v.numpy())
        assert a.shape == b.shape and np.array_equal(a, b), f
    for f in META_FIELDS:
        if f != "line_ops":
            assert getattr(jd, f) == getattr(td, f), f


def test_modal_volume_plain_matches_pallas_on_warped_tris():
    jd, td = _tri_n3(curved=True)
    q = _random_state(td, seed=6)
    j = euler_modal_volume_pallas(jnp.asarray(q.numpy()), jd.geo, jd.q_skew,
                                  jd.vq, jd.vhp, jd.ph, GAMMA, nq=jd.nq,
                                  interpret=True)
    p = euler_modal_volume_plain(q, td.geo, td.q_skew, td.vq, td.vhp, td.ph,
                                 GAMMA, nq=td.nq)
    for a, b in zip(p, j):
        assert _rel(a.numpy(), b) <= TOL


# ---- the twins with the kernel choices, on the curved hex ----

@pytest.mark.parametrize("impl", ["pallas", "lines_pallas"])
def test_curved_twin_with_kernel_choice_matches_jax(impl):
    jd, _ = jax_preset(n=3, k1d=2, curved=True)
    td, _ = euler_hex_3d(n=3, k1d=2, curved=True, dtype=F64, device="cpu")
    q = _random_state(td, seed=5)
    j, _ = jax_make_euler_rhs(jd, dissipation=True, flux_diff_impl="lines",
                              compute_rhstest=False)(jnp.asarray(q.numpy()))
    p, _ = make_euler_rhs(td, dissipation=True, flux_diff_impl=impl,
                          compute_rhstest=False)(q)
    assert _rel(p.numpy(), j) <= 1e-11

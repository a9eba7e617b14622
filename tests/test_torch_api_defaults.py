"""The RHS constructors' defaults and hooks, on the port against the JAX
package (f64, CPU).

``make_cns_rhs_affine`` defaults to the plain 'xla' volume front and
sends any other ``volume_impl`` name there, as JAX's does
(``esdg_cns_tpu/solvers/cns_fused.py:57,347-349``; its TGV example passes
'auto'); both must equal the port's 'xla' RHS bit for bit.
``make_euler_rhs(bc_fun=)`` applies an inviscid ghost-state hook, as JAX's
does (``euler.py:66,113``): on a closed slip-wall box it equals JAX's RHS
to 1e-11 of max |dq| and keeps its properties
(``tests/test_euler_rhs.py:196-220``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.presets import lid_driven_cavity as jax_cavity
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_cns_affine
from esdg_cns_tpu.solvers import make_euler_rhs as jax_euler_rhs
from esdg_cns_tpu_torch.cavity_cases import moving_state
from esdg_cns_tpu_torch.presets import lid_driven_cavity, lid_driven_cavity_3d
from esdg_cns_tpu_torch.solvers import make_cns_rhs_affine, make_euler_rhs

F64 = torch.float64


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _cavity(dim, k1d):
    preset = lid_driven_cavity if dim == 2 else lid_driven_cavity_3d
    disc, q0, bc, p = preset(n=2, k1d=k1d, dtype=F64, device="cpu")
    q = moving_state(q0, np.random.default_rng(0))
    return disc, q, dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc)


def _same(a, b):
    """Two (dq, aux) results equal bit for bit."""
    assert torch.equal(a[0], b[0])
    assert set(a[1]) == set(b[1])
    for key in a[1]:
        assert torch.equal(a[1][key], b[1][key]), key


@pytest.mark.parametrize("dim,k1d", [(2, 4), (3, 2)])
def test_cns_rhs_affine_defaults_to_the_xla_front(dim, k1d):
    """The default volume_impl is JAX's 'xla' (it was 'fused', K3, which
    refuses the 3D cavity's five fields on the card)."""
    disc, q, flags = _cavity(dim, k1d)
    default = make_cns_rhs_affine(disc, **flags)(q, 0.0)
    xla = make_cns_rhs_affine(disc, volume_impl="xla", **flags)(q, 0.0)
    _same(default, xla)


def test_cns_rhs_affine_other_volume_names_take_the_xla_front():
    """'auto' (the TGV example's) and any other unknown name run the 'xla'
    front, as in JAX, where they raised ValueError; JAX's 'auto' RHS
    agrees."""
    disc, q, flags = _cavity(2, 3)
    xla = make_cns_rhs_affine(disc, volume_impl="xla", **flags)(q, 0.0)
    for name in ("auto", "joint"):
        _same(make_cns_rhs_affine(disc, volume_impl=name, **flags)(q, 0.0),
              xla)
    jd, _, jbc, p = jax_cavity(n=2, k1d=3)
    ref, _ = jax_cns_affine(jd, bc=jbc, mu=p["mu"], pr=p["pr"], re=p["re"],
                            volume_impl="auto")(jnp.asarray(q.numpy()), 0.0)
    assert _rel(xla[0], ref) <= 1e-11


def test_euler_bc_fun_slip_wall_box():
    """make_euler_rhs(bc_fun=bc.inviscid) on the slip-walled cavity box:
    dq equals JAX's to 1e-11; the mirror ghost zeroes the wall mass flux,
    so total mass is conserved (|d/dt sum wJq rho| < 1e-13), and with LF
    dissipation the scheme is entropy-stable (rhstest <= 1e-12)."""
    disc, q0, bc, _ = lid_driven_cavity(n=2, k1d=3, bctype="slip",
                                        dtype=F64, device="cpu")
    jd, jq0, jbc, _ = jax_cavity(n=2, k1d=3, bctype="slip")
    rng = np.random.default_rng(5)
    noise = (1e-3 * rng.standard_normal(tuple(q0.shape))
             * np.array([1.0, 0.1, 0.1, 1.0])[:, None, None])
    q = q0 + torch.as_tensor(noise)
    jq = jq0 + jnp.asarray(noise)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    for dissp in (False, True):
        dq, aux = make_euler_rhs(disc, dissipation=dissp, bc_fun=bc.inviscid,
                                 compute_rhstest=True)(q, 0.0)
        ref, _ = jax.jit(jax_euler_rhs(jd, dissipation=dissp,
                                       bc_fun=jbc.inviscid,
                                       compute_rhstest=True))(jq, 0.0)
        assert _rel(dq, ref) <= 1e-11
        assert bool(torch.isfinite(dq).all())
        dmass = float(torch.sum(disc.wjq * (disc.vq @ dq[0])))
        assert abs(dmass) < 1e-13
        if dissp:
            assert float(aux["rhstest"]) <= 1e-12
    # without the hook the self-mapped wall faces see their own state: a
    # different RHS (the hook is applied, not dropped)
    plain, _ = make_euler_rhs(disc, dissipation=True)(q, 0.0)
    assert not torch.equal(plain, dq)


@functools.lru_cache(maxsize=1)
def _fd_mode_case():
    """(port disc, bc, state, flags, JAX's default RHS on that state) on
    tests/test_cns_fused.py:277's cavity."""
    jd, _, jbc, p = jax_cavity(n=3, k1d=4)
    disc, q0, bc, _ = lid_driven_cavity(n=3, k1d=4, dtype=F64, device="cpu")
    rng = np.random.default_rng(3)
    noise = 5e-4 * rng.standard_normal(tuple(q0.shape)) \
        * np.array([1.0, 0.1, 0.1, 1.0])[:, None, None]
    q = q0 + torch.as_tensor(noise)
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True,
                 volume_impl="fused")
    ref, _ = jax.jit(jax_cns_affine(jd, bc=jbc, **flags, interpret=True))(
        jnp.asarray(q.numpy()), 0.0)
    return disc, bc, q, flags, np.asarray(ref)


@pytest.mark.parametrize("fd_mode", ["tri", "tri8", "full"])
def test_cns_rhs_affine_takes_jax_fd_modes(fd_mode):
    """Repair: make_cns_rhs_affine takes JAX's fd_mode (cns_fused.py:67),
    whose layouts are one sum: tests/test_cns_fused.py:277-297 on the
    port, held against JAX's default RHS at its 1e-11 of max |dq|; an
    unknown mode raises as ops/dense_fd's wrappers do."""
    disc, bc, q, flags, ref = _fd_mode_case()
    got, _ = make_cns_rhs_affine(disc, bc=bc, **flags, fd_mode=fd_mode)(q)
    assert _rel(got, ref) < 1e-11
    with pytest.raises(ValueError, match="unknown fd_mode"):
        make_cns_rhs_affine(disc, bc=bc, **flags, fd_mode="tri4")

"""K2 with the neighbour read and the split combine inside it, on the port
against the JAX package (f64, CPU).

On fully periodic uniform hex grids K2 finds each face point's neighbour
itself (``csrc/hex_surface.cuh``, GRID), and after the split volume front
it takes the three direction parts in place of ph_qf (SPLIT).  Here:
``fv.surface_neighbour_index``, the Python mirror of the kernel's rule, is
held equal to the mesh's own ``map_p`` at every wrap; the plain versions
of the two new forms (the roll exchange ``grid_neighbours`` then the old
surface stage; ``split_combine`` then the same), which the wrapper runs on
CPU tensors and the card holds the kernel against, are held against
``euler_surface_pallas(traces, jd.gather_traces(traces), ...)`` and
``euler_volume_split_pallas`` in interpret mode, to 1e-12 of max |ref|.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.pallas_volume import euler_surface_pallas as jax_k2
from esdg_cns_tpu.ops.pallas_volume import (
    euler_volume_split_pallas as jax_split,
)
from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.core import build_discretization, ref_hex
from esdg_cns_tpu_torch.core.discretization import (
    ARRAY_FIELDS,
    META_FIELDS,
    grid_neighbours,
)
from esdg_cns_tpu_torch.mesh.generators import uniform_hex_mesh
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.physics import primitive_to_conservative

F64 = torch.float64
GAMMA = 1.4
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


def _grid_disc(n, kx, ky, kz):
    vx, vy, vz, etov = uniform_hex_mesh(kx, ky, kz)
    return build_discretization(ref_hex(n), (vx, vy, vz), etov,
                                periodic_axes=(0, 1, 2), dtype=F64,
                                device="cpu", grid_shape=(kz, ky, kx))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 2), (3, 3, 3),
                                   (2, 3, 4)])
def test_kernel_neighbour_rule_is_map_p(shape):
    """K2's in-kernel neighbour (face 2d+1 of k - s_d, face 2d of k + s_d,
    wrapped) is the mesh's own connectivity at k1d = 1, 2, 3 (every wrap;
    at 1 and 2 an element meets itself or one neighbour twice) and on a
    grid whose three periods differ; the roll exchange gathers the same."""
    disc = _grid_disc(2, *shape)
    nfp = disc.nfq // 6
    idx = fv.surface_neighbour_index(disc.grid_shape, nfp)
    assert np.array_equal(idx, disc.map_p.numpy().astype(np.int64))
    tr = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (7, disc.nfq, disc.num_elements)))
    flat = tr.reshape(7, -1)
    assert torch.equal(grid_neighbours(tr, disc.grid_shape),
                       flat[:, torch.as_tensor(idx.reshape(-1))]
                       .reshape(tr.shape))


@functools.lru_cache(maxsize=4)
def _case(n, metric):
    """The JAX discretization, its port, and seeded inputs on both: the
    state, the affine metric of the split fd (the mesh's, or a random
    non-diagonal one) and K2's normal, sj, 1/sj and 1/J (the mesh's compact
    ones with diag, random ones in the general form)."""
    jd, _ = jax_preset(n=n, k1d=2)
    td = interop.discretization_from_arrays(
        {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS},
        {f: getattr(jd, f) for f in META_FIELDS}, device="cpu", dtype=F64)
    rng = np.random.default_rng(10 + n)
    k = td.num_elements
    sh = (td.np_, k)
    f = lambda a: torch.as_tensor(a, dtype=F64)
    q = primitive_to_conservative(f(2 + 0.1 * rng.random(sh)),
                                  f(0.3 * rng.standard_normal((3, *sh))),
                                  f(2 + 0.1 * rng.random(sh))).numpy()
    if metric == "diag":
        geo = np.array(jd.geo)
        nxj = np.array(sum(jd.nxj))[None]
        sj, inv_sj = np.array(jd.sj), np.array(jd.inv_sj)
        inv_jac = np.array(jd.inv_jac)[:1]
    else:
        geo = (rng.uniform(0.5, 1.5, (9, 1, k))
               * rng.choice([-1.0, 1.0], (9, 1, k)))
        nxj = rng.standard_normal((3, td.nfq, k))
        sj = np.sqrt((nxj ** 2).sum(axis=0))
        inv_sj = 1.0 / sj
        inv_jac = rng.uniform(0.5, 2.0, (td.nq, k))
    return jd, td, q, geo, (nxj, sj, inv_sj, inv_jac)


@pytest.mark.parametrize("metric", ["diag", "general"])
@pytest.mark.parametrize("n", [3, 7])
def test_grid_and_split_forms_match_jax(n, metric):
    """The grid form (neighbours read on the grid) and the split form
    (three parts for ph_qf, on the grid too) of the surface stage, plain,
    against JAX's split volume stage, exchange and surface kernel."""
    jd, td, q, geo, geom = _case(n, metric)
    diag = metric == "diag"
    nq = jd.nq
    j_phqf, j_tr = jax_split(jnp.asarray(q), jnp.asarray(geo), jd.vhp[nq:],
                             jd.lift, GAMMA, nq=nq, line_ops=jd.line_ops,
                             block_k=8, interpret=True, diag=diag)
    j_geom = [jnp.asarray(a) for a in geom]
    ref = jax_k2(j_tr, jd.gather_traces(j_tr), *j_geom, jd.lift, j_phqf,
                 GAMMA, dissipation=True, block_k=8, interpret=True,
                 diag=diag)
    t_geom = [torch.as_tensor(a) for a in geom]
    tr = torch.as_tensor(np.array(j_tr))
    grid_form = fv.euler_surface_plain(
        tr, None, *t_geom, td.lift, torch.as_tensor(np.array(j_phqf)),
        GAMMA, dissipation=True, diag=diag, grid=td.grid_shape)
    assert _rel(grid_form, ref) <= TOL
    tq = torch.as_tensor(q)
    parts, t_tr = fv.euler_volume_split_parts(
        tq, torch.as_tensor(geo), td.vhp[nq:], GAMMA, line_ops=td.line_ops,
        diag=diag)
    assert _rel(t_tr, j_tr) <= TOL
    for grid in (None, td.grid_shape):
        nbr = None if grid else td.gather_traces(t_tr)
        split_form = fv.euler_surface_plain(
            t_tr, nbr, *t_geom, td.lift, None, GAMMA, dissipation=True,
            diag=diag, grid=grid, parts=parts, line_ops=td.line_ops)
        assert _rel(split_form, ref) <= TOL
    # the wrapper takes the same plain code for CPU tensors
    before = fv.euler_surface.launches
    got = fv.euler_surface(t_tr, None, *t_geom, td.lift, None, GAMMA,
                           dissipation=True, diag=diag, grid=td.grid_shape,
                           parts=parts, line_ops=td.line_ops)
    assert torch.equal(got, split_form)
    assert fv.euler_surface.launches == before


def test_surface_forms_refuse_ambiguous_inputs():
    """One neighbour source and one volume term, named: the gathered
    traces or the grid, ph_qf or the three parts (with line_ops)."""
    _, td, q, _, _ = _case(3, "diag")
    tr = torch.zeros((7, td.nfq, td.num_elements), dtype=F64)
    ph_qf = torch.zeros((5, td.nq, td.num_elements), dtype=F64)
    geom = (torch.stack(td.nxj), td.sj, td.inv_sj, td.inv_jac)
    for fn in (fv.euler_surface, fv.euler_surface_plain):
        with pytest.raises(ValueError, match="not both"):
            fn(tr, tr, *geom, td.lift, ph_qf, GAMMA, grid=td.grid_shape)
        with pytest.raises(ValueError, match="not both"):
            fn(tr, None, *geom, td.lift, ph_qf, GAMMA)
        with pytest.raises(ValueError, match="not both"):
            fn(tr, tr, *geom, td.lift, ph_qf, GAMMA, parts=[ph_qf] * 3,
               line_ops=td.line_ops)
        with pytest.raises(ValueError, match="three parts and line_ops"):
            fn(tr, tr, *geom, td.lift, None, GAMMA, parts=[ph_qf] * 3)

"""CUDA kernels of the port against their plain PyTorch versions.

These tests need an NVIDIA GPU (marker ``gpu``) and skip elsewhere; the
decision is taken inside the ``cuda`` fixture.  The file imports no JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are max |kernel - plain| / max |plain|: the kernels sum in
another order than the plain version and contract multiply-adds into
FMAs, and libdevice's transcendentals differ by an ulp or two.
"""

import json
import os

import numpy as np
import pytest
import torch

from esdg_cns_tpu_torch.cavity_cases import (
    CAVITY_BCS,
    becker_case,
    cavity_case,
    fd_inputs,
    k4_inputs,
    k7_inputs,
    k8_inputs,
    tail_inputs,
    warped_tri_case,
)
from esdg_cns_tpu_torch.core import build_discretization, ref_hex
from esdg_cns_tpu_torch.mesh.generators import uniform_hex_mesh
from esdg_cns_tpu_torch.ops import cns_surface as cs
from esdg_cns_tpu_torch.ops import cns_tail as ct
from esdg_cns_tpu_torch.ops import dense_fd as df
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.ops.lsrk45_update import lsrk45_update
from esdg_cns_tpu_torch.ops import modal_volume as mv
from esdg_cns_tpu_torch.ops import surface_viscous as sv
from esdg_cns_tpu_torch.ops import tensor_product_fd as tp
from esdg_cns_tpu_torch.physics import primitive_to_conservative
from esdg_cns_tpu_torch.solvers.boundary import Region, make_wall_bc
from esdg_cns_tpu_torch.presets import (
    becker_shocktube_1d,
    becker_shocktube_3d,
    euler_hex_3d,
    lid_driven_cavity,
    lid_driven_cavity_3d,
)
from esdg_cns_tpu_torch.solvers import (
    make_cns_rhs,
    make_cns_rhs_affine,
    make_euler_rhs,
    make_euler_rhs_fused,
)
from esdg_cns_tpu_torch.timestepping import dopri45, lsrk45
from esdg_cns_tpu_torch.timestepping.explicit import (
    LSRK45_A,
    LSRK45_B,
    LSRK45_C,
)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
GAMMA = 1.4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _random_state(disc, dtype, device, seed=0):
    """Seeded state with all three velocity components nonzero."""
    rng = np.random.default_rng(seed)
    sh = (disc.np_, disc.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return primitive_to_conservative(
        f(2 + 0.1 * rng.random(sh)), f(0.3 * rng.standard_normal((3, *sh))),
        f(2 + 0.1 * rng.random(sh)))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _surface_inputs(disc, diag):
    if diag:
        return (disc.nxj[0] + disc.nxj[1] + disc.nxj[2])[None], disc.inv_jac[:1]
    return torch.stack(disc.nxj), disc.inv_jac


# k1d=3 gives K=27: a ragged last tile for both kernels.  N=3 k1d=32 in
# f32 is the main path's own launch (K=32768, many waves of blocks), where
# a fault that needs many blocks shows: a race between blocks, a grid
# limit, index arithmetic at large K
_K12_CASES = [(dtype, n, k1d) for dtype in (torch.float32, torch.float64)
              for n, k1d in ((1, 3), (2, 3), (3, 3), (4, 2))] + [
                  (torch.float32, 3, 32)]
_K12_IDS = [f"{str(d)[6:]}-n{n}-k1d{k}" for d, n, k in _K12_CASES]


def _check_surface(disc, tr, ph_qf, nxj, sj, inv_sj, inv_jac, diag, dtype):
    """K2 against its plain version, with and without dissipation, in the
    gathered form (the neighbour traces given) and the grid form the
    paths run (the kernel reads them itself)."""
    nbr = disc.gather_traces(tr)
    for dissipation in (True, False):
        for nb, grid in ((nbr, None), (None, disc.grid_shape)):
            sargs = (tr, nb, nxj, sj, inv_sj, inv_jac, disc.lift, ph_qf,
                     GAMMA)
            skw = dict(dissipation=dissipation, diag=diag, grid=grid)
            p_s = fv.euler_surface_plain(*sargs, **skw)
            k_s = fv.euler_surface(*sargs, **skw)
            torch.cuda.synchronize()
            assert _rel(k_s, p_s) <= TOL[dtype], (dissipation, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,k1d", _K12_CASES, ids=_K12_IDS)
@pytest.mark.parametrize("diag", [True, False])
def test_kernels_match_plain(cuda, dtype, n, k1d, diag):
    disc, _ = euler_hex_3d(n=n, k1d=k1d, dtype=dtype, device=cuda)
    q = _random_state(disc, dtype, cuda)
    ef = disc.vhp[disc.nq:]
    vargs = (q, disc.geo, ef, disc.lift, GAMMA)
    vkw = dict(line_ops=disc.line_ops, diag=diag)
    before = fv.euler_volume.launches
    p_out, p_tr = fv.euler_volume_plain(*vargs, **vkw)
    k_out, k_tr = fv.euler_volume(*vargs, **vkw)
    torch.cuda.synchronize()
    assert fv.euler_volume.launches == before + 1
    assert _rel(k_out, p_out) <= TOL[dtype]
    assert _rel(k_tr, p_tr) <= TOL[dtype]
    nxj, inv_jac = _surface_inputs(disc, diag)
    _check_surface(disc, p_tr, p_out, nxj, disc.sj, disc.inv_sj, inv_jac,
                   diag, dtype)


def _random_affine(disc, dtype, device, seed=11):
    """Seeded non-diagonal affine geometry: geo [9, 1, K] with all nine
    entries O(1), nxj [3, Nfq, K] with sj = |nxj| and inv_sj = 1/sj, and
    inv_jac [Nq, K] varying per node.  Unlike the uniform mesh, no cross
    term is an exact zero."""
    rng = np.random.default_rng(seed)
    k = disc.num_elements
    geo = rng.uniform(0.5, 1.5, (9, 1, k)) * rng.choice([-1.0, 1.0], (9, 1, k))
    nxj = rng.standard_normal((3, disc.nfq, k))
    sj = np.sqrt((nxj ** 2).sum(axis=0))
    inv_jac = rng.uniform(0.5, 2.0, (disc.nq, k))
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return f(geo), f(nxj), f(sj), f(1.0 / sj), f(inv_jac)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,k1d", _K12_CASES, ids=_K12_IDS)
def test_general_kernels_on_random_affine_metric(cuda, dtype, n, k1d):
    disc, _ = euler_hex_3d(n=n, k1d=k1d, dtype=dtype, device=cuda)
    q = _random_state(disc, dtype, cuda)
    geo, nxj, sj, inv_sj, inv_jac = _random_affine(disc, dtype, cuda)
    vargs = (q, geo, disc.vhp[disc.nq:], disc.lift, GAMMA)
    vkw = dict(line_ops=disc.line_ops, diag=False)
    p_out, p_tr = fv.euler_volume_plain(*vargs, **vkw)
    k_out, k_tr = fv.euler_volume(*vargs, **vkw)
    torch.cuda.synchronize()
    assert _rel(k_out, p_out) <= TOL[dtype]
    assert _rel(k_tr, p_tr) <= TOL[dtype]
    _check_surface(disc, p_tr, p_out, nxj, sj, inv_sj, inv_jac, False,
                   dtype)


@pytest.mark.gpu
def test_fused_rhs_matches_twin_and_conserves_entropy(cuda):
    disc, _ = euler_hex_3d(n=3, k1d=3, dtype=torch.float64, device=cuda)
    q = _random_state(disc, torch.float64, cuda, seed=1)
    a, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)(q)
    b, _ = make_euler_rhs_fused(disc, dissipation=True)(q)
    assert _rel(b, a) <= 1e-11
    _, aux = make_euler_rhs_fused(disc, dissipation=False,
                                  compute_rhstest=True)(q)
    assert abs(float(aux["rhstest"])) <= 1e-12


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_cover(cuda):
    disc, q = euler_hex_3d(n=2, k1d=2, dtype=torch.float32, device=cuda)
    ef = disc.vhp[disc.nq:]
    with pytest.raises(TypeError):
        fv.euler_volume(q, disc.geo.double(), ef, disc.lift, GAMMA,
                        line_ops=disc.line_ops)
    with pytest.raises(ValueError):
        fv.euler_volume(q[:, :, ::2], disc.geo[:, :, ::2], ef, disc.lift,
                        GAMMA, line_ops=disc.line_ops)
    # a curved metric must hold every hybridized point
    with pytest.raises(ValueError):
        fv.euler_volume(q, disc.geo.expand(9, 2, -1).contiguous(), ef,
                        disc.lift, GAMMA, line_ops=disc.line_ops)
    qh, qlog = fd_inputs(disc, q)
    with pytest.raises(ValueError):
        tp.flux_differencing_lines_fused(
            qh, qlog[:, :-1].contiguous(), disc.geo, GAMMA, elem_type="hex",
            line_ops=disc.line_ops, nq=disc.nq)
    with pytest.raises(TypeError):
        df.flux_differencing_dense(qh, qlog.double(), disc.q_skew, disc.geo,
                                   GAMMA, nq=disc.nq)
    with pytest.raises(ValueError):
        df.flux_differencing_dense(qh, qlog, disc.q_skew, disc.geo, GAMMA,
                                   nq=disc.nq, fd_mode="packed")
    # K3 on five fields (a 3D state) with a 2D disc's metric and
    # operators: the shape check refuses them; K7's contract=False (its
    # default) runs on the card and matches its plain version
    cdisc, cq, bc, p = cavity_case("isothermal", 2, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="shape"):
        mv.euler_modal_volume(torch.cat([cq, cq[:1]]), cdisc.geo,
                              cdisc.q_skew, cdisc.vq, cdisc.vhp, cdisc.ph,
                              GAMMA, nq=cdisc.nq)
    args7, kw7 = k7_inputs(cdisc, cq, bc, p)
    kw7 = dict(kw7, contract=False)
    _match(sv.cns_viscous(*args7, **kw7), sv.cns_viscous_plain(*args7,
                                                               **kw7),
           torch.float32, "contract=False")
    # K1 keeps its whole tile in shared memory and is built for N <= 7
    d8, q8 = euler_hex_3d(n=8, k1d=1, dtype=torch.float32, device=cuda)
    with pytest.raises(NotImplementedError, match="N = 1..7"):
        fv.euler_volume(q8, d8.geo, d8.vhp[d8.nq:], d8.lift, GAMMA,
                        line_ops=d8.line_ops)
    # the split path is affine-only and has no padded dense form
    curved = disc.geo.expand(9, disc.nh, -1).contiguous()
    with pytest.raises(ValueError, match="affine-only"):
        fv.euler_volume_split(q, curved, ef, disc.lift, GAMMA,
                              line_ops=disc.line_ops)
    with pytest.raises(ValueError, match="pad_x"):
        fv.euler_volume_split(q, disc.geo, ef, disc.lift, GAMMA,
                              line_ops=disc.line_ops, dense=True, pad_x=True)
    qh, qlog, _ = fv.hex_project(q, ef, GAMMA)
    with pytest.raises(ValueError, match="affine-only"):
        fv.hex_fd_dir(qh, qlog, curved, GAMMA, line_ops=disc.line_ops, d=0)
    with pytest.raises(ValueError):
        fv.hex_fd_dir_dense(qh, qlog, disc.geo, GAMMA,
                            line_ops=disc.line_ops, d=3)
    with pytest.raises(TypeError):
        fv.hex_project(q.double(), ef, GAMMA)


def _launch_counts():
    """Every kernel wrapper's launches so far, by name."""
    return {"euler_volume": fv.euler_volume.launches,
            "euler_surface": fv.euler_surface.launches,
            "euler_modal_volume": mv.euler_modal_volume.launches,
            "cns_surface_viscous": sv.cns_surface_viscous.launches,
            "cns_surface": cs.cns_surface.launches,
            "cns_viscous": sv.cns_viscous.launches,
            "flux_differencing_lines_fused":
                tp.flux_differencing_lines_fused.launches,
            "flux_differencing_dense": df.flux_differencing_dense.launches,
            "hex_project": fv.hex_project.launches,
            "hex_fd_dir": fv.hex_fd_dir.launches,
            "hex_fd_dir_dense": fv.hex_fd_dir_dense.launches,
            "lsrk45_update": lsrk45_update.launches,
            "cns_traction_tail": ct.cns_traction_tail.launches}


def _launched(before):
    """The launches since ``before`` (a ``_launch_counts()``) of each
    wrapper that launched."""
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


def _plain_work():
    """The calls of the plain stage work K2 takes in on periodic grids:
    the roll exchange and the split combine."""
    from esdg_cns_tpu_torch.core.discretization import grid_neighbours
    return grid_neighbours.calls, fv.split_combine.calls


# ---- the split volume path (rows 3, 4a, 4b) and K2 at N = 5..7 ----

# k1d=3 gives K=27: a ragged last tile of every kernel
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k1d", [(1, 3), (2, 2), (4, 3), (7, 3)])
def test_split_volume_kernels_match_plain(cuda, dtype, n, k1d):
    disc, _ = euler_hex_3d(n=n, k1d=k1d, dtype=dtype, device=cuda)
    q = _random_state(disc, dtype, cuda)
    ef = disc.vhp[disc.nq:]
    tol = TOL[dtype]
    before = _launch_counts()
    got = fv.hex_project(q, ef, GAMMA)
    want = fv.hex_project_plain(q, ef, GAMMA)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _rel(a, b) <= tol
    qh, qlog, _ = want
    random_geo = _random_affine(disc, dtype, cuda)[0]
    lo = disc.line_ops
    for d in range(3):
        for geo, diag in ((disc.geo, True), (disc.geo, False),
                          (random_geo, False)):
            a = fv.hex_fd_dir(qh, qlog, geo, GAMMA, line_ops=lo, d=d,
                              diag=diag)
            b = fv.hex_fd_dir_plain(qh, qlog, geo, GAMMA, line_ops=lo, d=d,
                                    diag=diag)
            torch.cuda.synchronize()
            assert _rel(a, b) <= tol, (d, diag)
        for geo in (disc.geo, random_geo):
            a = fv.hex_fd_dir_dense(qh, qlog, geo, GAMMA, line_ops=lo, d=d)
            b = fv.hex_fd_dir_dense_plain(qh, qlog, geo, GAMMA, line_ops=lo,
                                          d=d)
            torch.cuda.synchronize()
            assert _rel(a, b) <= tol, d
    assert _launched(before) == dict(hex_project=1, hex_fd_dir=9,
                                     hex_fd_dir_dense=6)
    for dense in (False, True):
        a = fv.euler_volume_split(q, disc.geo, ef, disc.lift, GAMMA,
                                  line_ops=lo, dense=dense, diag=not dense)
        b = fv.euler_volume_split_plain(q, disc.geo, ef, disc.lift, GAMMA,
                                        line_ops=lo, dense=dense,
                                        diag=not dense)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert _rel(x, y) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7])
def test_split_fd_every_order_moving_and_at_rest(cuda, dtype, n):
    """Rows 4a and 4b at every N+1 = 2..8 on K=27 (a ragged last tile), on
    a moving state and at rest (uniform density and pressure: every pair
    of equal states), diag and general on the mesh's metric, general and
    dense on a random affine one."""
    disc, _ = euler_hex_3d(n=n, k1d=3, dtype=dtype, device=cuda)
    sh = (disc.np_, disc.num_elements)
    full = lambda v, *lead: torch.full((*lead, *sh), v, dtype=dtype,
                                       device=cuda)
    rest = primitive_to_conservative(full(1.2), full(0.0, 3), full(1.5))
    random_geo = _random_affine(disc, dtype, cuda)[0]
    lo = disc.line_ops
    for q in (_random_state(disc, dtype, cuda, seed=n), rest):
        qh, qlog, _ = fv.hex_project_plain(q, disc.vhp[disc.nq:], GAMMA)
        for d in range(3):
            for geo, diag in ((disc.geo, True), (disc.geo, False),
                              (random_geo, False)):
                a = fv.hex_fd_dir(qh, qlog, geo, GAMMA, line_ops=lo, d=d,
                                  diag=diag)
                b = fv.hex_fd_dir_plain(qh, qlog, geo, GAMMA, line_ops=lo,
                                        d=d, diag=diag)
                torch.cuda.synchronize()
                assert _rel(a, b) <= TOL[dtype], (d, diag)
            for geo in (disc.geo, random_geo):
                a = fv.hex_fd_dir_dense(qh, qlog, geo, GAMMA, line_ops=lo,
                                        d=d)
                b = fv.hex_fd_dir_dense_plain(qh, qlog, geo, GAMMA,
                                              line_ops=lo, d=d)
                torch.cuda.synchronize()
                assert _rel(a, b) <= TOL[dtype], d


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", [2, 3, 4, 5, 6, 7, 8])
def test_split_fd_launch_shape(cuda, dtype, n1):
    """The split fd's tile fits the card in both forms: at least one
    resident block, its threads a multiple of its elements, and at N+1 = 8
    in f32 at least 16 warps an SM and no local memory (the old tile held
    8 warps)."""
    for diag in (True, False):
        blocks, threads, smem, _, local, te, _ = fv.hex_fd_dir_shape(
            dtype, n1, diag=diag)
        assert blocks >= 1 and threads % te == 0 and smem <= 232448
        if dtype == torch.float32 and n1 == 8:
            assert blocks * threads // 32 >= 16 and local == 0, diag


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 6, 7])
@pytest.mark.parametrize("diag", [True, False])
def test_surface_kernel_at_high_order(cuda, dtype, n, diag):
    """K2 at N+1 = 6..8, on gathered traces and ph_qf, at the tile it
    takes there (k1d=3: K=27, a ragged last tile)."""
    disc, _ = euler_hex_3d(n=n, k1d=3, dtype=dtype, device=cuda)
    q = _random_state(disc, dtype, cuda)
    ph_qf, tr = fv.euler_volume_split_plain(
        q, disc.geo, disc.vhp[disc.nq:], disc.lift, GAMMA,
        line_ops=disc.line_ops, diag=True)
    if diag:
        nxj, inv_jac = _surface_inputs(disc, diag)
        sj, inv_sj = disc.sj, disc.inv_sj
    else:   # a non-diagonal normal: every cross term of the flux counts
        _, nxj, sj, inv_sj, inv_jac = _random_affine(disc, dtype, cuda)
    nbr = disc.gather_traces(tr)
    for dissipation in (True, False):
        args = (tr, nbr, nxj, sj, inv_sj, inv_jac, disc.lift, ph_qf, GAMMA)
        kw = dict(dissipation=dissipation, diag=diag)
        a = fv.euler_surface(*args, **kw)
        b = fv.euler_surface_plain(*args, **kw)
        torch.cuda.synchronize()
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.gpu
def test_n7_split_rhs_matches_twin_and_conserves_entropy(cuda):
    """The N=7 path as 'auto' picks it with force_fused: the projection,
    one fd launch per direction and K2, no K1; equal to the lines twin."""
    disc, _ = euler_hex_3d(n=7, k1d=3, dtype=torch.float64, device=cuda)
    q = _random_state(disc, torch.float64, cuda, seed=2)
    before = _launch_counts()
    b, _ = make_euler_rhs_fused(disc, dissipation=True, force_fused=True)(q)
    assert _launched(before) == dict(hex_project=1, hex_fd_dir=3,
                                     euler_surface=1)
    a, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)(q)
    assert _rel(b, a) <= 1e-11
    _, aux = make_euler_rhs_fused(disc, dissipation=False, force_fused=True,
                                  compute_rhstest=True)(q)
    assert abs(float(aux["rhstest"])) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_n4_split_modes_match_auto(cuda, dtype):
    disc, _ = euler_hex_3d(n=4, k1d=3, dtype=dtype, device=cuda)
    q = _random_state(disc, dtype, cuda, seed=3)
    ref, _ = make_euler_rhs_fused(disc)(q)          # 'auto': K1
    for mode, fd in (("split", "hex_fd_dir"), ("split_pad8", "hex_fd_dir"),
                     ("split_dense", "hex_fd_dir_dense")):
        before = _launch_counts()
        got, _ = make_euler_rhs_fused(disc, volume_mode=mode)(q)
        assert _launched(before) == {"hex_project": 1, fd: 3,
                                     "euler_surface": 1}, mode
        assert _rel(got, ref) <= TOL[dtype], mode


@pytest.mark.gpu
def test_fused_hex_front_at_n7_takes_the_split_path(cuda):
    disc, q0, bc, p = lid_driven_cavity_3d(n=7, k1d=2, dtype=torch.float64,
                                           device=cuda)
    rng = np.random.default_rng(1)
    q = q0 + 5e-4 * torch.as_tensor(
        rng.standard_normal(tuple(q0.shape)), device=cuda) * torch.tensor(
        [1.0, 0.1, 0.1, 0.1, 1.0], dtype=torch.float64,
        device=cuda)[:, None, None]
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                 inviscid_dissipation=True, viscous_dissipation=True)
    before = _launch_counts()
    a, _ = make_cns_rhs_affine(disc, volume_impl="fused_hex", **flags)(q)
    ran = _launched(before)
    assert [ran.get(k, 0) for k in ("hex_project", "hex_fd_dir",
                                    "hex_fd_dir_dense", "euler_volume")] == [
        1, 3, 0, 0]
    b, _ = make_cns_rhs(disc, **flags)(q)
    assert _rel(a, b) <= 1e-9


# ---- K1 at N+1 = 6, 7, 8 (tiles of 8, 4 and 2 elements) ----

# k1d=3 gives K=27: a ragged last tile at every tile size
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 6, 7])
@pytest.mark.parametrize("form", ["diag", "general", "random", "curved"])
def test_volume_kernel_at_high_order(cuda, dtype, n, form):
    """K1 against its plain version in each metric form: the mesh's own
    metric (diag and the general contraction of its exact zeros), a seeded
    random non-diagonal affine metric, and the warped mesh's per-point
    metric."""
    disc, _ = euler_hex_3d(n=n, k1d=3, curved=form == "curved", dtype=dtype,
                           device=cuda)
    q = _random_state(disc, dtype, cuda, seed=n)
    geo = _random_affine(disc, dtype, cuda)[0] if form == "random" \
        else disc.geo
    vargs = (q, geo, disc.vhp[disc.nq:], disc.lift, GAMMA)
    vkw = dict(line_ops=disc.line_ops, diag=form == "diag")
    before = fv.euler_volume.launches
    p_out, p_tr = fv.euler_volume_plain(*vargs, **vkw)
    k_out, k_tr = fv.euler_volume(*vargs, **vkw)
    torch.cuda.synchronize()
    assert fv.euler_volume.launches == before + 1
    assert _rel(k_out, p_out) <= TOL[dtype]
    assert _rel(k_tr, p_tr) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("n,curved,kw", [
    (5, False, {}), (5, True, {}), (6, False, dict(force_fused=True)),
    (7, True, dict(force_fused=True)),
    (7, False, dict(force_fused=True, volume_mode="joint"))])
def test_k1_rhs_at_high_order_matches_twin(cuda, n, curved, kw):
    """The RHS that JAX runs on its joint kernel at these orders takes K1
    once, no split kernel and no exchange or combine, equals the lines
    twin and conserves entropy with dissipation off."""
    disc, _ = euler_hex_3d(n=n, k1d=3, curved=curved, dtype=torch.float64,
                           device=cuda)
    q = _random_state(disc, torch.float64, cuda, seed=4)
    before, plain = _launch_counts(), _plain_work()
    b, _ = make_euler_rhs_fused(disc, dissipation=True, **kw)(q)
    assert _launched(before) == dict(euler_volume=1, euler_surface=1)
    assert _plain_work() == plain
    a, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)(q)
    assert _rel(b, a) <= 1e-11
    _, aux = make_euler_rhs_fused(disc, dissipation=False,
                                  compute_rhstest=True, **kw)(q)
    assert abs(float(aux["rhstest"])) <= 1e-12


@pytest.mark.gpu
def test_becker_3d_fused_hex_at_n5_takes_k1(cuda):
    """The 3D Becker tube at N=5 through fused_hex: K1 at N+1 = 6 and K4
    at dim=3 with the Dirichlet ghosts, equal to the twin make_cns_rhs."""
    disc, q0, bc, shock = becker_shocktube_3d(n=5, k1d=4,
                                              dtype=torch.float64,
                                              device=cuda)
    flags = dict(mu=shock.mu, pr=shock.pr, bc=bc, inviscid_dissipation=True,
                 viscous_dissipation=True, compute_rhstest=False)
    before = (fv.euler_volume.launches, sv.cns_surface_viscous.launches)
    a, aux = make_cns_rhs_affine(disc, volume_impl="fused_hex",
                                 **flags)(q0, 0.037)
    assert (fv.euler_volume.launches, sv.cns_surface_viscous.launches) == (
        before[0] + 1, before[1] + 1)
    b, _ = make_cns_rhs(disc, **flags)(q0, 0.037)
    assert _rel(a, b) <= 1e-9
    assert float(aux["rhstest_visc"]) >= 0.0


# ---- the curved Euler kernels (K1 on curved metrics, K2 on curved
# normals) and the flux-differencing kernels K5 and row 10 ----

# k1d=3 gives K=27: a ragged last tile
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k1d", [(2, 2), (3, 3), (4, 2)])
def test_curved_kernels_match_plain(cuda, dtype, n, k1d):
    disc, _ = euler_hex_3d(n=n, k1d=k1d, curved=True, dtype=dtype,
                           device=cuda)
    assert disc.geo.shape[1] == disc.nh
    q = _random_state(disc, dtype, cuda)
    vargs = (q, disc.geo, disc.vhp[disc.nq:], disc.lift, GAMMA)
    before = fv.euler_volume.launches
    p_out, p_tr = fv.euler_volume_plain(*vargs, line_ops=disc.line_ops)
    # diag is ignored on a curved metric
    k_out, k_tr = fv.euler_volume(*vargs, line_ops=disc.line_ops, diag=True)
    torch.cuda.synchronize()
    assert fv.euler_volume.launches == before + 1
    assert _rel(k_out, p_out) <= TOL[dtype]
    assert _rel(k_tr, p_tr) <= TOL[dtype]
    nbr = disc.gather_traces(p_tr)
    for dissipation in (True, False):
        sargs = (p_tr, nbr, torch.stack(disc.nxj), disc.sj, disc.inv_sj,
                 disc.inv_jac, disc.lift, p_out, GAMMA)
        p_s = fv.euler_surface_plain(*sargs, dissipation=dissipation)
        k_s = fv.euler_surface(*sargs, dissipation=dissipation)
        torch.cuda.synchronize()
        assert _rel(k_s, p_s) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k1d", [(2, 3), (3, 5)])
def test_modal_volume_kernel_on_warped_tris(cuda, dtype, n, k1d):
    disc, q = warped_tri_case(n, k1d, dtype, cuda)
    assert disc.geo.shape[1] == disc.nh
    args = (q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA)
    before = mv.euler_modal_volume.launches
    plain = mv.euler_modal_volume_plain(*args, nq=disc.nq)
    kern = mv.euler_modal_volume(*args, nq=disc.nq)
    torch.cuda.synchronize()
    assert mv.euler_modal_volume.launches == before + 1
    for a, b in zip(kern, plain):
        assert _rel(a, b) <= TOL[dtype]


def _curved_hex_n1(dtype, device):
    """Hex N=1 (Nh=32) on a warped, non-periodic 3^3 mesh."""
    vx, vy, vz, etov = uniform_hex_mesh(3)
    warp = lambda x, y, z: (x + 0.08 * (x - 1) * (x + 1) * (y - 1) * (y + 1),
                            y, z)
    return build_discretization(ref_hex(1), (vx, vy, vz), etov,
                                curved_map=warp, dtype=dtype, device=device)


_FD_CASES = ("tri3", "tri3_warped", "hex1", "hex1_curved", "hex3_curved")


def _fd_case(case, dtype, device):
    """(disc, q) of a flux-differencing case; K = 50 or 27 (ragged)."""
    if case == "tri3":
        disc, q, _, _ = cavity_case("isothermal", 3, 5, dtype, device)
        return disc, q
    if case == "tri3_warped":
        return warped_tri_case(3, 5, dtype, device)
    if case == "hex1_curved":
        disc = _curved_hex_n1(dtype, device)
    else:
        disc, _ = euler_hex_3d(n=int(case[3]), k1d=3,
                               curved=case.endswith("curved"), dtype=dtype,
                               device=device)
    return disc, _random_state(disc, dtype, device, seed=4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", _FD_CASES)
def test_dense_fd_kernel_matches_plain(cuda, dtype, case):
    disc, q = _fd_case(case, dtype, cuda)
    qh, qlog = fd_inputs(disc, q)
    args = (qh, qlog, disc.q_skew, disc.geo, GAMMA)
    before = df.flux_differencing_dense.launches
    plain = df.flux_differencing_dense_plain(*args, nq=disc.nq)
    kern = df.flux_differencing_dense(*args, nq=disc.nq)
    torch.cuda.synchronize()
    assert df.flux_differencing_dense.launches == before + 1
    assert _rel(kern, plain) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k1d", [(2, 3), (3, 3), (4, 2)])
@pytest.mark.parametrize("curved", [False, True])
def test_hex_lines_kernel_matches_plain(cuda, dtype, n, k1d, curved):
    disc, _ = euler_hex_3d(n=n, k1d=k1d, curved=curved, dtype=dtype,
                           device=cuda)
    qh, qlog = fd_inputs(disc, _random_state(disc, dtype, cuda, seed=2))
    kw = dict(elem_type="hex", line_ops=disc.line_ops, nq=disc.nq)
    before = tp.flux_differencing_lines_fused.launches
    plain = tp.flux_differencing_lines(qh, qlog, disc.geo, GAMMA, **kw)
    kern = tp.flux_differencing_lines_fused(qh, qlog, disc.geo, GAMMA, **kw)
    torch.cuda.synchronize()
    assert tp.flux_differencing_lines_fused.launches == before + 1
    assert _rel(kern, plain) <= TOL[dtype]


@pytest.mark.gpu
def test_curved_fused_rhs_matches_twins_and_conserves_entropy(cuda):
    disc, _ = euler_hex_3d(n=3, k1d=3, curved=True, dtype=torch.float64,
                           device=cuda)
    q = _random_state(disc, torch.float64, cuda, seed=1)
    a, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)(q)
    b, _ = make_euler_rhs_fused(disc, dissipation=True)(q)
    assert _rel(b, a) <= 1e-11
    for impl in ("pallas", "lines_pallas"):
        c, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl=impl,
                              compute_rhstest=False)(q)
        assert _rel(c, a) <= 1e-11, impl
    _, aux = make_euler_rhs_fused(disc, dissipation=False,
                                  compute_rhstest=True)(q)
    assert abs(float(aux["rhstest"])) <= 1e-12


@pytest.mark.gpu
def test_cns_rhs_with_the_dense_kernel_matches_xla(cuda):
    disc, q, bc, p = cavity_case("isothermal", 3, 5, torch.float64, cuda)
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                 inviscid_dissipation=True, viscous_dissipation=True)
    before = df.flux_differencing_dense.launches
    a, _ = make_cns_rhs(disc, flux_diff_impl="xla", **flags)(q)
    b, _ = make_cns_rhs(disc, flux_diff_impl="pallas", **flags)(q)
    assert df.flux_differencing_dense.launches == before + 1
    assert _rel(b, a) <= 1e-11


# ---- the 2D CNS cavity kernels: K3 (modal volume) and K4 (merged
# surface + viscous) ----

# k1d=3 gives K=18 and k1d=5 K=50: ragged last tiles
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k1d", [(2, 3), (3, 5), (3, 8)])
def test_modal_volume_kernel_matches_plain(cuda, dtype, n, k1d):
    disc, q, _, _ = cavity_case("isothermal", n, k1d, dtype, cuda)
    args = (q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA)
    before = mv.euler_modal_volume.launches
    plain = mv.euler_modal_volume_plain(*args, nq=disc.nq)
    kern = mv.euler_modal_volume(*args, nq=disc.nq)
    torch.cuda.synchronize()
    assert mv.euler_modal_volume.launches == before + 1
    for a, b in zip(kern, plain):
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CAVITY_BCS)
@pytest.mark.parametrize("fold_tail", [False, True])
def test_surface_viscous_kernel_matches_plain(cuda, dtype, case, fold_tail):
    disc, q, bc, p = cavity_case(case, 3, 5, dtype, cuda)
    args, tail, kw = k4_inputs(disc, q, bc, p)
    tail = tail if fold_tail else ()
    before = sv.cns_surface_viscous.launches
    plain = sv.cns_surface_viscous_plain(*args, *tail, fold_tail=fold_tail,
                                         **kw)
    kern = sv.cns_surface_viscous(*args, *tail, fold_tail=fold_tail, **kw)
    torch.cuda.synchronize()
    assert sv.cns_surface_viscous.launches == before + 1
    assert len(kern) == len(plain)
    for a, b in zip(kern, plain):
        if b.abs().max() > 0:
            assert _rel(a, b) <= TOL[dtype], case
        else:
            assert a.abs().max() == 0


@pytest.mark.gpu
def test_fused_cavity_rhs_matches_twin_and_is_entropy_stable(cuda):
    disc, q, bc, p = cavity_case("isothermal", 3, 5, torch.float64, cuda)
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                 inviscid_dissipation=True, viscous_dissipation=True)
    a, _ = make_cns_rhs(disc, **flags)(q)
    b, _ = make_cns_rhs_affine(disc, volume_impl="fused",
                               compute_rhstest=False, **flags)(q)
    assert _rel(b, a) <= 1e-11
    disc, q0, bc, p = lid_driven_cavity(n=3, k1d=4, bctype="adiabatic",
                                        lid_profile=lambda x: 0.0 * x,
                                        dtype=torch.float64, device=cuda)
    rng = np.random.default_rng(1)
    q = q0 + 1e-3 * torch.as_tensor(
        rng.standard_normal(tuple(q0.shape)), device=cuda) * torch.tensor(
        [1.0, 0.1, 0.1, 1.0], dtype=torch.float64, device=cuda)[:, None, None]
    _, aux = make_cns_rhs_affine(disc, mu=p["mu"], pr=p["pr"], re=p["re"],
                                 bc=bc, inviscid_dissipation=True,
                                 viscous_dissipation=True,
                                 volume_impl="fused")(q)
    assert float(aux["rhstest_visc"]) >= 0.0
    assert float(aux["rhstest"]) < 1e-10


def _match(kern, plain, dtype, case):
    assert len(kern) == len(plain)
    for a, b in zip(kern, plain):
        if b is None:
            assert a is None
        elif b.abs().max() > 0:
            assert _rel(a, b) <= TOL[dtype], case
        else:
            assert a.abs().max() == 0


# ---- the split CNS stages, K8 (surface) and K7 (viscous), in 2D and 3D,
# and K4 at dim=3; k1d=3 gives K=27 on hexes, a ragged last tile ----
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CAVITY_BCS)
@pytest.mark.parametrize("dim", [2, 3])
def test_split_kernels_match_plain(cuda, dtype, case, dim):
    disc, q, bc, p = cavity_case(case, 3, 5 if dim == 2 else 3, dtype, cuda,
                                 dim=dim)
    args, kw = k8_inputs(disc, q, bc, p)
    before = cs.cns_surface.launches
    plain = cs.cns_surface_plain(*args, **kw)
    kern = cs.cns_surface(*args, **kw)
    torch.cuda.synchronize()
    assert cs.cns_surface.launches == before + 1
    _match(kern, plain, dtype, case)
    args, kw = k7_inputs(disc, q, bc, p)
    before = sv.cns_viscous.launches
    plain = sv.cns_viscous_plain(*args, **kw)
    kern = sv.cns_viscous(*args, **kw)
    torch.cuda.synchronize()
    assert sv.cns_viscous.launches == before + 1
    _match(kern, plain, dtype, case)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CAVITY_BCS)
@pytest.mark.parametrize("fold_tail", [False, True])
def test_surface_viscous_3d_kernel_matches_plain(cuda, dtype, case,
                                                 fold_tail):
    disc, q, bc, p = cavity_case(case, 3, 3, dtype, cuda, dim=3)
    args, tail, kw = k4_inputs(disc, q, bc, p)
    assert not kw["proj"]
    tail = tail if fold_tail else ()
    before = sv.cns_surface_viscous.launches
    plain = sv.cns_surface_viscous_plain(*args, *tail, fold_tail=fold_tail,
                                         **kw)
    kern = sv.cns_surface_viscous(*args, *tail, fold_tail=fold_tail, **kw)
    torch.cuda.synchronize()
    assert sv.cns_surface_viscous.launches == before + 1
    _match(kern, plain, dtype, case)


# ---- the tail after K4's fold_tail form (ops.cns_tail) ----
def _tail_case(case, n, k1d, dtype, device):
    """The 3D cavity with isothermal walls, adiabatic ones under a moving
    lid, or 'arrays': the isothermal lid and the adiabatic floor of
    'mixed' with array wall speeds, then adiabatic side walls with scalar
    ones over their shared edges."""
    disc, q, bc, p = cavity_case("mixed" if case == "arrays" else case, n,
                                 k1d, dtype, device, dim=3)
    if case == "arrays":
        top, bottom, low, high = bc.regions
        bc = make_wall_bc(disc, [top, bottom, Region(
            mask=low.mask | high.mask, kind="adiabatic",
            u_wall=(0.2, -0.1, 0.3))])
    return disc, q, bc, p


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["isothermal", "adiabatic", "arrays"])
@pytest.mark.parametrize("n,k1d", [(3, 4), (3, 6), (7, 2)])
def test_tail_kernel_matches_the_plain_tail(cuda, dtype, case, n, k1d):
    """The tail kernel on K4's outputs against the plain tail: the
    exchange, WallBC.stress_normal, the jump's LIFT and 1/J."""
    disc, q, bc, p = _tail_case(case, n, k1d, dtype, cuda)
    (dq_part, t_f, lift, inv_j), t_pn = tail_inputs(disc, q, bc, p)
    plain = ct.cns_traction_tail_plain(dq_part, t_f, lift, inv_j, t_pn=t_pn)
    rule = ct.traction_rule(disc, bc)
    assert (rule.wall.shape[0] > 0) == (case != "isothermal")
    before = ct.cns_traction_tail.launches
    kern = ct.cns_traction_tail(dq_part.clone(), t_f, lift, inv_j, rule=rule)
    torch.cuda.synchronize()
    assert ct.cns_traction_tail.launches == before + 1
    assert _rel(kern, plain) <= TOL[dtype], case


def _cavity_rhs(disc, bc, p, **kw):
    return make_cns_rhs_affine(disc, mu=p["mu"], pr=p["pr"], re=p["re"],
                               bc=bc, inviscid_dissipation=True,
                               viscous_dissipation=True,
                               volume_impl="fused_hex", compute_rhstest=False,
                               **kw)


def _tail_forms(before):
    return {k: v - before[k] for k, v in ct.cns_traction_tail.forms.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["isothermal", "adiabatic", "arrays"])
def test_rhs_on_the_tail_kernel_matches_the_plain_tail(cuda, monkeypatch,
                                                       dtype, case):
    """The whole fold_tail RHS on the tail kernel against the same RHS
    with the plain tail (no rule), on the same state."""
    disc, q, bc, p = _tail_case(case, 3, 4, dtype, cuda)
    forms = dict(ct.cns_traction_tail.forms)
    a, _ = _cavity_rhs(disc, bc, p)(q)
    assert _tail_forms(forms) == {"kernel": 1, "plain": 0}
    monkeypatch.setattr(ct, "traction_rule", lambda disc, bc: None)
    forms = dict(ct.cns_traction_tail.forms)
    b, _ = _cavity_rhs(disc, bc, p)(q)
    torch.cuda.synchronize()
    assert _tail_forms(forms) == {"kernel": 0, "plain": 1}
    assert _rel(a, b) <= TOL[dtype], case


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["slip", "mixed", "stress_state"])
def test_tail_without_a_rule_takes_the_plain_lines(cuda, case):
    """A slip region, or Dirichlet ghost stresses, have no code in the
    rule: the RHS runs the plain tail and launches no tail kernel."""
    disc, q, bc, p = cavity_case("isothermal" if case == "stress_state"
                                 else case, 3, 3, torch.float64, cuda, dim=3)
    if case == "stress_state":
        # the ghost at rest (rho = beta = 1) over the lid, no ghost stress
        ghost = torch.ones((5, disc.nfq, disc.num_elements),
                           dtype=torch.float64, device=cuda)
        ghost[1:4] = 0.0
        stress = torch.zeros((3, *ghost.shape), dtype=torch.float64,
                             device=cuda)
        bc = make_wall_bc(disc, list(bc.regions) + [Region(
            mask=bc.regions[0].mask, kind="dirichlet",
            state=lambda t: ghost, stress_state=lambda t: stress)])
    forms = dict(ct.cns_traction_tail.forms)
    launches = ct.cns_traction_tail.launches
    dq, _ = _cavity_rhs(disc, bc, p)(q)
    torch.cuda.synchronize()
    assert _tail_forms(forms) == {"kernel": 0, "plain": 1}
    assert ct.cns_traction_tail.launches == launches
    assert bool(torch.isfinite(dq).all())


@pytest.mark.gpu
def test_fused_cavity_3d_rhs_matches_twin_and_is_entropy_stable(cuda):
    disc, q, bc, p = cavity_case("isothermal", 3, 3, torch.float64, cuda,
                                 dim=3)
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                 inviscid_dissipation=True, viscous_dissipation=True)
    a, _ = make_cns_rhs(disc, **flags)(q)
    for surface in ("merged_tail", "fused"):
        b, _ = make_cns_rhs_affine(disc, volume_impl="fused_hex",
                                   surface_impl=surface,
                                   compute_rhstest=False, **flags)(q)
        assert _rel(b, a) <= 1e-11, surface
    disc, q0, bc, p = lid_driven_cavity_3d(n=3, k1d=3, bctype="adiabatic",
                                           dtype=torch.float64, device=cuda)
    bc.regions[0].u_wall = (0.0, 0.0, 0.0)      # the lid at rest
    rng = np.random.default_rng(1)
    q = q0 + 1e-3 * torch.as_tensor(
        rng.standard_normal(tuple(q0.shape)), device=cuda) * torch.tensor(
        [1.0, 0.1, 0.1, 0.1, 1.0], dtype=torch.float64,
        device=cuda)[:, None, None]
    _, aux = make_cns_rhs_affine(disc, mu=p["mu"], pr=p["pr"], re=p["re"],
                                 bc=bc, inviscid_dissipation=True,
                                 viscous_dissipation=True,
                                 volume_impl="fused_hex",
                                 surface_impl="merged")(q)
    assert float(aux["rhstest_visc"]) >= 0.0
    assert float(aux["rhstest"]) < 1e-10


@pytest.mark.gpu
def test_cavity_kernel_wrappers_refuse_what_they_do_not_cover(cuda):
    disc, q, bc, p = cavity_case("isothermal", 2, 3, torch.float32, cuda)
    with pytest.raises(TypeError):
        mv.euler_modal_volume(q, disc.geo.double(), disc.q_skew, disc.vq,
                              disc.vhp, disc.ph, GAMMA, nq=disc.nq)
    # a curved metric must hold every hybridized point
    with pytest.raises(ValueError):
        mv.euler_modal_volume(q, disc.geo.expand(4, 2, -1).contiguous(),
                              disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA,
                              nq=disc.nq)
    args, _, kw = k4_inputs(disc, q, bc, p)
    # a pool short of the rows its recipe reads
    with pytest.raises(ValueError):
        sv.cns_surface_viscous(*args[:7], args[7][:-1], *args[8:], **kw)
    # the tri form without the projection block is no path's
    with pytest.raises(NotImplementedError):
        sv.cns_surface_viscous(*args[:11], args[11][disc.nq:], *args[12:],
                               **dict(kw, proj=False))
    args7, kw7 = k7_inputs(disc, q, bc, p)
    # contract=False, the public default, runs on the card
    kw_c = dict(kw7, contract=False)
    kern = sv.cns_viscous(*args7, **kw_c)
    assert kern[0].shape == (2 * 4, disc.nfq, disc.num_elements)
    _match(kern, sv.cns_viscous_plain(*args7, **kw_c), torch.float32,
           "contract=False")
    with pytest.raises(TypeError):
        sv.cns_viscous(args7[0].double(), *args7[1:], **kw7)
    args8, kw8 = k8_inputs(disc, q, bc, p)
    with pytest.raises(ValueError):
        cs.cns_surface(*args8[:5], args8[5][:1], *args8[6:], **kw8)


# ---- the dim-generic forms that make_cns_rhs_affine(volume_impl='fused')
# reaches on lines and hexes: K3 at dim 1 and 3, K4 and K7 with the
# projected front at dim 1 and 3, K7 contract=False at every form, K8 at
# dim 1; the Becker tubes' Dirichlet pools and wall recipes, ragged K ----
_FORM_CASES = {
    "line_becker": lambda dt, dev: becker_case(1, 4, 37, dt, dev),
    "line_wall": lambda dt, dev: becker_case(1, 3, 5, dt, dev, wall=True),
    "hex_becker": lambda dt, dev: becker_case(3, 2, 12, dt, dev),
    "hex_n3_becker": lambda dt, dev: becker_case(3, 3, 12, dt, dev),
    "hex_wall": lambda dt, dev: cavity_case("mixed", 2, 3, dt, dev, dim=3),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(_FORM_CASES))
def test_projected_forms_match_plain(cuda, dtype, case):
    disc, q, bc, p = _FORM_CASES[case](dtype, cuda)
    t = 0.003
    a = (q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA)
    before = mv.euler_modal_volume.launches
    kern = mv.euler_modal_volume(*a, nq=disc.nq)
    plain = mv.euler_modal_volume_plain(*a, nq=disc.nq)
    torch.cuda.synchronize()
    assert mv.euler_modal_volume.launches == before + 1
    _match(kern, plain, dtype, (case, "K3"))
    args, tail, kw = k4_inputs(disc, q, bc, p, t=t, proj=True)
    for fold in (False, True):
        extra = tail if fold else ()
        kern = sv.cns_surface_viscous(*args, *extra, fold_tail=fold, **kw)
        plain = sv.cns_surface_viscous_plain(*args, *extra, fold_tail=fold,
                                             **kw)
        torch.cuda.synchronize()
        _match(kern, plain, dtype, (case, "K4", fold))
    args, kw = k7_inputs(disc, q, bc, p, t=t, proj=True)
    for contract in (True, False):
        k = dict(kw, contract=contract)
        _match(sv.cns_viscous(*args, **k), sv.cns_viscous_plain(*args, **k),
               dtype, (case, "K7", contract))
    args, kw = k8_inputs(disc, q, bc, p, t=t, proj=True)
    _match(cs.cns_surface(*args, **kw), cs.cns_surface_plain(*args, **kw),
           dtype, (case, "K8"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_uncontracted_traces_match_plain(cuda, dtype, dim):
    """K7 contract=False at (2, True) and (3, False), the cavities' forms."""
    disc, q, bc, p = cavity_case("mixed", 3, 5 if dim == 2 else 3, dtype,
                                 cuda, dim=dim)
    args, kw = k7_inputs(disc, q, bc, p)
    kw["contract"] = False
    kern = sv.cns_viscous(*args, **kw)
    assert kern[0].shape == (dim * (dim + 2), disc.nfq, disc.num_elements)
    _match(kern, sv.cns_viscous_plain(*args, **kw), dtype, dim)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_becker_bisection_kernel_matches_eager(cuda, dtype):
    """The bisection kernel repeats the eager loop's arithmetic: bitwise
    equal at the 1D tube's face points and over the wave; within an ulp at
    the 3D tube's (N=5, k1d=32), where libdevice's log, an ulp from
    PyTorch's, may flip a comparison near the root."""
    from esdg_cns_tpu_torch.ops import becker_bisect as bb

    disc, _, _, shock = becker_shocktube_1d(n=4, k=32, dtype=dtype,
                                            device=cuda)
    for xi in (disc.xf[0] - 0.2 * 0.037,
               torch.linspace(-3.0, 3.0, 4097, dtype=dtype, device=cuda)):
        before = bb.becker_bisect.launches
        u = shock.velocity_torch(xi)
        assert bb.becker_bisect.launches == before + 1
        ref = bb.becker_bisect_plain(xi, **shock.bisection(dtype))
        assert torch.equal(u, ref)
    disc, _, _, shock = becker_shocktube_3d(n=5, k1d=32, dtype=dtype,
                                            device=cuda)
    xi = disc.xf[0] - float(shock.v_inf) * 0.037
    kw = shock.bisection(dtype)
    got, ref = bb.becker_bisect(xi, **kw), bb.becker_bisect_plain(xi, **kw)
    ulp = torch.finfo(dtype).eps * ref.abs()
    assert float(((got - ref).abs() / ulp).max()) <= 1.0


# dopri45 on the 1D Becker tube: (K, t_end, first step, err_tol, how many
# accepted steps the kernel path may differ from the twin by).  At K=32
# and err_tol 1e-9 the two take the same steps.  K=128 and err_tol 1e-11
# are the paper anchor's finest run: there the error estimate lies a few
# digits above the two RHS's difference (about 2e-11 of max |dq|), so
# their step sizes part and the last step before t_end can fall either
# side of it; the states may not part
_DOPRI_CASES = [(32, 2e-3, 1e-4, 1e-9, 0), (128, 5e-3, None, 1e-11, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,t_end,dt0,err_tol,slack", _DOPRI_CASES,
                         ids=["k32", "k128_anchor"])
def test_fused_rhs_on_line_and_hex_matches_twin(cuda, k, t_end, dt0,
                                                err_tol, slack):
    """make_cns_rhs_affine(volume_impl='fused') agrees with the twin on the
    1D tube at N=4 and K elements and on the 3D tube; dopri45 on the
    kernel path launches K3 and K4 once an RHS and matches the twin's
    state and step count (without dt0, the anchor driver's first step)."""
    from esdg_cns_tpu_torch.verification import becker_dt0

    for make, size in ((becker_shocktube_1d, dict(n=4, k=k)),
                       (becker_shocktube_3d, dict(n=2, k1d=4))):
        disc, q0, bc, shock = make(**size, dtype=torch.float64, device=cuda)
        flags = dict(mu=shock.mu, pr=shock.pr, bc=bc,
                     inviscid_dissipation=True)
        twin, _ = make_cns_rhs(disc, **flags)(q0, 0.01)
        for kw in (dict(), dict(compute_rhstest=False),
                   dict(surface_impl="fused")):
            got, _ = make_cns_rhs_affine(disc, volume_impl="fused",
                                         **kw, **flags)(q0, 0.01)
            assert _rel(got, twin) <= 1e-10, (make.__name__, kw)
    disc, q0, bc, shock = becker_shocktube_1d(n=4, k=k, dtype=torch.float64,
                                              device=cuda)
    flags = dict(mu=shock.mu, pr=shock.pr, bc=bc, inviscid_dissipation=True,
                 compute_rhstest=False)
    dt0 = dt0 or becker_dt0(4, k)
    before = _launch_counts()
    qk, sk = dopri45(make_cns_rhs_affine(disc, volume_impl="fused", **flags),
                     q0, t_end, dt0, err_tol=err_tol)
    n_rhs = 1 + 6 * (sk["n_accepted"] + sk["n_rejected"])
    assert _launched(before) == {"euler_modal_volume": n_rhs,
                                 "cns_surface_viscous": n_rhs}
    qt, st = dopri45(make_cns_rhs(disc, **flags), q0, t_end, dt0,
                     err_tol=err_tol)
    assert abs(sk["n_accepted"] - st["n_accepted"]) <= slack
    assert _rel(qk, qt) <= 1e-10


# -----------------------------------------------------------------------------
# The probes (rows 11-13) and the flux-differencing section (row 14)
# -----------------------------------------------------------------------------

PROBE_ITERS = 64


def _probe_input(cuda, rows=256):
    rng = np.random.default_rng(5)
    return torch.as_tensor(1.0 + 0.5 * rng.random((rows, 1024)),
                           dtype=torch.float32, device=cuda)


@pytest.mark.gpu
def test_fma_peak_kernel_matches_plain(cuda):
    """Row 11: the kernel's fmaf rounds once where the plain multiply and
    add round twice, and the map's factor 0.999998 keeps those roundings:
    iters 2^-24 of max |plain|."""
    from esdg_cns_tpu_torch.probes import peak

    x = _probe_input(cuda)
    got = peak.fma_peak(x, PROBE_ITERS)
    torch.cuda.synchronize()
    assert _rel(got, peak.fma_peak_plain(x, PROBE_ITERS)) <= (
        PROBE_ITERS * 2.0 ** -24)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fma", "mul", "add", "div", "log", "exp",
                                  "rsqrt", "sqrt"])
def test_chain_kernels_match_plain(cuda, kind):
    """Rows 12, 13: every kind's chains against the plain version."""
    from esdg_cns_tpu_torch.probes import divide, transcendental

    x = _probe_input(cuda)
    plain = transcendental.chain_plain(x, kind, PROBE_ITERS)
    got = transcendental.chain(x, kind, PROBE_ITERS)
    torch.cuda.synchronize()
    assert _rel(got, plain) <= TOL[torch.float32], kind
    if kind in divide.DIVIDE_KINDS:
        assert _rel(divide.chain(x, kind, PROBE_ITERS), plain) <= TOL[
            torch.float32], kind


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", [5, 6, 7])
@pytest.mark.parametrize("diag", [True, False])
def test_fd_section_kernels_match_plain(cuda, dtype, n1, diag):
    """Row 14: the joint body (K1's line body) and the split body (three
    hex_fd_dir launches with the study's tables) against the plain
    version on the study's non-skew inputs, at a ragged K."""
    from esdg_cns_tpu_torch.probes import fd_section as fs

    npdt = np.float32 if dtype == torch.float32 else np.float64
    args = fs.as_tensors(fs.study_inputs(n1, 37, diag, dtype=npdt), cuda)
    kw = dict(n1=n1, diag=diag)
    plain = fs.fd_section_plain(*args, GAMMA, **kw)
    n0 = fs.fd_section.launches
    joint = fs.fd_section(*args, GAMMA, **kw)
    split = fs.fd_section_split(*args, GAMMA, **kw)
    torch.cuda.synchronize()
    assert fs.fd_section.launches == n0 + 1
    assert _rel(joint, plain) <= TOL[dtype]
    assert _rel(split, plain) <= TOL[dtype]


@pytest.mark.gpu
def test_probe_wrappers_refuse_what_they_do_not_cover(cuda):
    from esdg_cns_tpu_torch.probes import divide, peak, transcendental
    from esdg_cns_tpu_torch.probes import fd_section as fs

    x = _probe_input(cuda, 8)
    with pytest.raises(TypeError):
        peak.fma_peak(x.double(), 8)
    with pytest.raises(ValueError):
        divide.chain(x, "log", 8)
    with pytest.raises(ValueError):
        transcendental.chain(x, "tanh", 8)
    args = fs.as_tensors(fs.study_inputs(4, 8, True), cuda)
    with pytest.raises(NotImplementedError, match="5, 6, 7"):
        fs.fd_section(*args, GAMMA, n1=4, diag=True)
    args = fs.as_tensors(fs.study_inputs(5, 8, True), cuda)
    with pytest.raises(ValueError):
        fs.fd_section(args[0][:, :-1].contiguous(), *args[1:], GAMMA, n1=5,
                      diag=True)


# ---- K1 in every form at every line length, and K3 on its operator
# lists, on ragged tiles ----

def _k1_case(n, form, dtype, device):
    """(disc, q, geo) at N = n on k1d=3 (K=27): the mesh's own metric
    (diag, general), a seeded random affine metric, or the warped mesh's
    per-point metric (at N=1 the warped non-periodic mesh)."""
    if form == "curved" and n == 1:
        disc = _curved_hex_n1(dtype, device)
    else:
        disc, _ = euler_hex_3d(n=n, k1d=3, curved=form == "curved",
                               dtype=dtype, device=device)
    q = _random_state(disc, dtype, device, seed=n)
    geo = (_random_affine(disc, dtype, device)[0] if form == "random"
           else disc.geo)
    return disc, q, geo


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("form", ["diag", "general", "random", "curved"])
@pytest.mark.parametrize("k", [27, 1])
def test_volume_kernel_every_order_form_and_tile(cuda, dtype, n, form, k):
    """K1 (one thread per element, direction and line) against its plain
    version at N+1 = 2..8: K=27 is not a multiple of any tile of more than
    one element, K=1 is smaller than every such tile."""
    disc, q, geo = _k1_case(n, form, dtype, cuda)
    q, geo = q[:, :, :k].contiguous(), geo[:, :, :k].contiguous()
    vargs = (q, geo, disc.vhp[disc.nq:], disc.lift, GAMMA)
    vkw = dict(line_ops=disc.line_ops, diag=form == "diag")
    before = fv.euler_volume.launches
    p_out, p_tr = fv.euler_volume_plain(*vargs, **vkw)
    k_out, k_tr = fv.euler_volume(*vargs, **vkw)
    torch.cuda.synchronize()
    assert fv.euler_volume.launches == before + 1
    assert _rel(k_out, p_out) <= TOL[dtype]
    assert _rel(k_tr, p_tr) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", [2, 4, 5, 6, 7, 8])
def test_volume_launch_shape(cuda, dtype, n1):
    """K1's tile fits the card: the occupancy query reports at least one
    resident block of 3 (N+1)^2 threads per element, and in f32 the warps
    this design is for (32 an SM up to N+1 = 4, 16 at N+1 = 5..7)."""
    for form in ("diag", "general", "curved"):
        blocks, threads, smem, *_ , te, _ = fv.euler_volume_shape(
            dtype, n1, diag=form == "diag", curved=form == "curved")
        assert threads == te * 3 * n1 * n1 and smem <= 232448
        warps = blocks * ((threads + 31) // 32)
        assert blocks >= 1
        if dtype == torch.float32 and n1 <= 7:
            assert warps >= (32 if n1 <= 4 else 16), (form, warps)


def _rest(disc, dtype, device):
    """A fluid at rest: rho = 1, u = 0, p = 1 / (gamma Ma^2) at Ma = 0.3."""
    sh = (disc.np_, disc.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return primitive_to_conservative(
        f(np.ones(sh)), f(np.zeros((disc.dim, *sh))),
        f(np.full(sh, 1.0 / (0.3 * 0.3 * GAMMA))))


def _k3_cases(dtype, device):
    """{label: (disc, rest state, moving state)} at ragged K: the cavities'
    meshes at rest and made a moving fluid (hex N=3 k1d=3, K=27; tri N=3
    k1d=5, K=50), the 1D Becker tube (line N=4, K=37: its own state, a
    moving shock) and a fluid at rest on it, the warped tri k1d=5."""
    from esdg_cns_tpu_torch.cavity_cases import moving_state
    rng = np.random.default_rng(17)
    out = {}
    for label, (disc, q0, *_) in (
            ("hex", lid_driven_cavity_3d(3, 3, dtype=dtype, device=device)),
            ("tri", lid_driven_cavity(3, 5, dtype=dtype, device=device))):
        out[label] = (disc, q0, moving_state(q0, rng))
    disc, q0, *_ = becker_shocktube_1d(4, 37, dtype=dtype, device=device)
    out["line"] = (disc, _rest(disc, dtype, device), q0)
    disc, q = warped_tri_case(3, 5, dtype, device)
    out["curved tri"] = (disc, _rest(disc, dtype, device), q)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["hex", "tri", "line", "curved tri"])
@pytest.mark.parametrize("state", ["rest", "moving"])
def test_modal_volume_kernel_on_its_lists(cuda, dtype, case, state):
    """K3 over its operator lists against the dense plain version, at dims
    1, 2, 3 and on curved tris, on a state at rest and a moving one; the
    lists given (as make_cns_rhs_affine gives them) or built by the
    wrapper give one result."""
    disc, rest, moving = _k3_cases(dtype, cuda)[case]
    q = rest if state == "rest" else moving
    args = (q, disc.geo, disc.q_skew, disc.vq, disc.vhp, disc.ph, GAMMA)
    lists = mv.modal_lists(torch.stack(disc.q_skew), disc.vq, disc.vhp,
                           disc.ph, disc.nq)
    before = mv.euler_modal_volume.launches
    plain = mv.euler_modal_volume_plain(*args, nq=disc.nq)
    kern = mv.euler_modal_volume(*args, nq=disc.nq, lists=lists)
    built = mv.euler_modal_volume(*args, nq=disc.nq)
    torch.cuda.synchronize()
    assert mv.euler_modal_volume.launches == before + 2
    for a, b, c in zip(kern, plain, built):
        assert _rel(a, b) <= TOL[dtype]
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_curved_cell_path_launches_the_curved_forms(cuda):
    """A step of the curved benchmark cell's path (the warped preset,
    'auto', f32): five curved K1s and five general grid K2s, no diag
    launch and no exchange, each launch inside its span once; the affine
    preset takes the diag forms; spans off record nothing."""
    from esdg_cns_tpu_torch import tracing
    from esdg_cns_tpu_torch.solvers.euler_fused import resolve_volume_mode

    spans = ("ops.fused_volume.euler_volume",
             "ops.fused_volume.euler_surface")
    for curved, k1, k2 in ((True, "curved", "general.grid"),
                           (False, "diag", "diag.grid")):
        disc, q0 = euler_hex_3d(n=3, k1d=4, curved=curved,
                                dtype=torch.float32, device=cuda)
        assert resolve_volume_mode(disc) == ("joint" if curved
                                             else "joint_packed")
        assert fv.detect_axis_aligned(disc) is not curved
        rhs = make_euler_rhs_fused(disc, dissipation=True)
        v0, s0 = dict(fv.euler_volume.forms), dict(fv.euler_surface.forms)
        tracing.reset()
        tracing.enable(True)
        try:
            qf, _ = lsrk45(rhs, q0, 1e-3, 1)
            summary = tracing.summary()
        finally:
            tracing.enable(False)
        assert bool(torch.isfinite(qf).all())
        assert {k: fv.euler_volume.forms[k] - v for k, v in v0.items()} == {
            **dict.fromkeys(v0, 0), k1: 5}
        assert {k: fv.euler_surface.forms[k] - v
                for k, v in s0.items()} == {**dict.fromkeys(s0, 0), k2: 5}
        for name in spans:
            assert summary[name]["calls"] == 5
            assert summary[name]["device_calls"] == 5
            assert summary[name]["device_ms"] > 0
        assert "core.discretization.gather_traces" not in summary
        tracing.reset()
        lsrk45(rhs, q0, 1e-3, 1)
        assert tracing.records() == []


# ---- K4 and K7 at dim 3 on their operator lists (visc_lists), every
# form, against the dense plain versions: a moving state and the state at
# rest, every wall kind of the 3D cavity; k1d=3 gives K=27, a ragged last
# tile.  At rest behind walls that move nothing (slip, no BC) the viscous
# outputs vanish but for roundoff; an output whose max |plain| at rest is
# below the tolerance of its max on the moving state is held to that
# moving max instead (the error of a zero, on the output's scale) ----
def _match_at_scale(kern, plain, moving_plain, dtype, case):
    assert len(kern) == len(plain)
    for a, b, m in zip(kern, plain, moving_plain):
        if b is None:
            assert a is None
            continue
        scale = float(b.abs().max())
        if scale < TOL[dtype] * float(m.abs().max()):
            scale = float(m.abs().max())
        assert float((a - b).abs().max()) <= TOL[dtype] * scale, case


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", CAVITY_BCS)
def test_viscous_kernels_on_lists_match_dense_plain(cuda, dtype, case):
    disc, q, bc, p = cavity_case(case, 3, 3, dtype, cuda, dim=3)
    rest = lid_driven_cavity_3d(3, 3, dtype=dtype, device=cuda)[1]
    for proj in (True, False):
        lists = None
        moving = {}
        for state, qs in (("moving", q), ("rest", rest)):
            args, tail, kw = k4_inputs(disc, qs, bc, p, proj=proj)
            if lists is None:
                lists = sv.visc_lists(*args[11:15], tail[1], nq=disc.nq,
                                      proj=proj)
            for fold in (False, True):
                extra = tail if fold else ()
                before = sv.cns_surface_viscous.launches
                kern = sv.cns_surface_viscous(*args, *extra, fold_tail=fold,
                                              lists=lists, **kw)
                built = sv.cns_surface_viscous(*args, *extra,
                                               fold_tail=fold, **kw)
                plain = sv.cns_surface_viscous_plain(*args, *extra,
                                                     fold_tail=fold, **kw)
                torch.cuda.synchronize()
                assert sv.cns_surface_viscous.launches == before + 2
                key = ("K4", fold)
                moving.setdefault(key, plain)
                _match_at_scale(kern, plain, moving[key], dtype,
                                (case, state, "K4", proj, fold))
                for a, b in zip(kern, built):
                    assert (a is None) == (b is None)
                    assert a is None or torch.equal(a, b)
            a7, kw7 = k7_inputs(disc, qs, bc, p, proj=proj)
            for contract in (True, False):
                k = dict(kw7, contract=contract)
                before = sv.cns_viscous.launches
                kern = sv.cns_viscous(*a7, lists=lists, **k)
                plain = sv.cns_viscous_plain(*a7, **k)
                torch.cuda.synchronize()
                assert sv.cns_viscous.launches == before + 1
                key = ("K7", contract)
                moving.setdefault(key, plain)
                _match_at_scale(kern, plain, moving[key], dtype,
                                (case, state, "K7", proj, contract))


@pytest.mark.gpu
def test_viscous_kernels_refuse_lists_that_do_not_fit(cuda):
    disc, q, bc, p = cavity_case("mixed", 3, 3, torch.float32, cuda, dim=3)
    args, tail, kw = k4_inputs(disc, q, bc, p, proj=False)
    ops = args[11:15]
    good = sv.visc_lists(*ops, tail[1], nq=disc.nq, proj=False)
    a7, kw7 = k7_inputs(disc, q, bc, p, proj=False)
    bad = {
        # the projection block's list with proj=False operators
        "proj": sv.visc_lists(*k4_inputs(disc, q, bc, p, proj=True)[0][11:15],
                              tail[1], nq=disc.nq, proj=True),
        "short": sv.ViscLists(good.vals[:-1], good.cols[:-1], good.widths,
                              good.entries),
        "widths": sv.ViscLists(good.vals, good.cols, good.widths[:5],
                               good.entries),
        "cpu": sv.ViscLists(good.vals.cpu(), good.cols, good.widths,
                            good.entries),
        "cols on cpu": sv.ViscLists(good.vals, good.cols.cpu(), good.widths,
                                    good.entries),
        "int32 cols": sv.ViscLists(good.vals, good.cols.int(), good.widths,
                                   good.entries),
    }
    for name, lists in bad.items():
        with pytest.raises(ValueError):
            sv.cns_surface_viscous(*args, lists=lists, **kw)
        with pytest.raises(ValueError):
            sv.cns_viscous(*a7, lists=lists, **kw7)
    # fold_tail reads LIFT's list
    no_lift = sv.visc_lists(*ops, nq=disc.nq, proj=False)
    with pytest.raises(ValueError):
        sv.cns_surface_viscous(*args, *tail, fold_tail=True, lists=no_lift,
                               **kw)
    with pytest.raises(TypeError):
        sv.cns_viscous(*a7, lists=sv.ViscLists(
            good.vals.double(), good.cols, good.widths, good.entries), **kw7)


@pytest.mark.gpu
def test_rhs_builds_the_viscous_lists_once(cuda):
    """make_cns_rhs_affine builds the lists with the RHS on hexes, for
    both fronts, and its K4 and K7 read them; on tris none."""
    disc, q, bc, p = cavity_case("isothermal", 3, 3, torch.float64, cuda,
                                 dim=3)
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                 inviscid_dissipation=True, viscous_dissipation=True,
                 compute_rhstest=False)
    for impl, proj in (("fused", True), ("fused_hex", False)):
        for surface in ("merged_tail", "fused"):
            rhs = make_cns_rhs_affine(disc, volume_impl=impl,
                                      surface_impl=surface, **flags)
            assert rhs.visc_lists is not None
            assert (rhs.visc_lists.widths[0] > 0) == proj
            assert rhs.visc_lists.widths[5] > 0
            ref = make_cns_rhs(disc, **flags)(q)[0]
            before = (sv.cns_surface_viscous.launches,
                      sv.cns_viscous.launches)
            dq, _ = rhs(q)
            torch.cuda.synchronize()
            after = (sv.cns_surface_viscous.launches,
                     sv.cns_viscous.launches)
            assert after[0] - before[0] == (surface == "merged_tail")
            assert after[1] - before[1] == (surface == "fused")
            assert _rel(dq, ref) <= 1e-9, (impl, surface)
    disc2, _, bc2, p2 = cavity_case("isothermal", 3, 3, torch.float32, cuda)
    rhs = make_cns_rhs_affine(disc2, volume_impl="fused", mu=p2["mu"],
                              pr=p2["pr"], re=p2["re"], bc=bc2)
    assert rhs.visc_lists is None


# ---- K2's grid and split forms and the projection's tile ----
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,shape", [(3, (4, 4, 4)), (3, (3, 3, 3)),
                                     (7, (2, 2, 2)), (4, (2, 3, 4)),
                                     (1, (5, 1, 3))])
@pytest.mark.parametrize("diag", [True, False])
def test_surface_kernel_grid_and_split_forms_match_plain(cuda, dtype, n,
                                                         shape, diag):
    """K2 reading the neighbours on the periodic grid (periods that differ
    per axis; K=27 and 15 ragged), and taking the split path's three parts
    in place of ph_qf, each against its plain version (the roll exchange,
    the split combine, then the plain surface stage); no exchange or
    combine runs on the card."""
    from esdg_cns_tpu_torch.core.discretization import grid_neighbours
    kx, ky, kz = shape
    vx, vy, vz, etov = uniform_hex_mesh(kx, ky, kz)
    disc = build_discretization(ref_hex(n), (vx, vy, vz), etov,
                                periodic_axes=(0, 1, 2), dtype=dtype,
                                device=cuda, grid_shape=(kz, ky, kx))
    q = _random_state(disc, dtype, cuda, seed=n)
    lo = disc.line_ops
    ph_qf, tr = fv.euler_volume_split_plain(
        q, disc.geo, disc.vhp[disc.nq:], disc.lift, GAMMA, line_ops=lo,
        diag=True)
    parts = [fv.hex_fd_dir_plain(*fv.hex_project_plain(
        q, disc.vhp[disc.nq:], GAMMA)[:2], disc.geo, GAMMA, line_ops=lo,
        d=d, diag=True) for d in range(3)]
    if diag:
        nxj, inv_jac = _surface_inputs(disc, diag)
        sj, inv_sj = disc.sj, disc.inv_sj
    else:
        _, nxj, sj, inv_sj, inv_jac = _random_affine(disc, dtype, cuda)
    nbr = disc.gather_traces(tr)
    for grid in (None, disc.grid_shape):
        for split in (False, True):
            args = (tr, None if grid else nbr, nxj, sj, inv_sj, inv_jac,
                    disc.lift, None if split else ph_qf, GAMMA)
            kw = dict(dissipation=True, diag=diag, grid=grid,
                      parts=parts if split else None, line_ops=lo)
            b = fv.euler_surface_plain(*args, **kw)
            before = (fv.euler_surface.launches, grid_neighbours.calls,
                      fv.split_combine.calls)
            a = fv.euler_surface(*args, **kw)
            torch.cuda.synchronize()
            assert (fv.euler_surface.launches, grid_neighbours.calls,
                    fv.split_combine.calls) == (before[0] + 1, *before[1:])
            assert _rel(a, b) <= TOL[dtype], (grid, split)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n1", [2, 3, 4, 5, 6, 7, 8])
def test_surface_and_projection_launch_shapes(cuda, dtype, n1):
    """K2's tile (every grid form) and the projection's fit the card: at
    least one resident block, its threads a multiple of its elements, and
    at N+1 = 8 in f32 at least 16 warps an SM (the old tiles held 8)."""
    for diag in (True, False):
        for split in (True, False):
            occ = fv.euler_surface_shape(dtype, n1, diag=diag, grid=True,
                                         split=split)
            blocks, threads, smem, _, _, te, _ = occ
            assert blocks >= 1 and threads % te == 0 and smem <= 232448
            if dtype == torch.float32 and n1 == 8:
                assert blocks * threads // 32 >= 16, (diag, split)
    blocks, threads, smem, _, _, te, _ = fv.hex_project_shape(dtype, n1)
    assert blocks >= 1 and threads % te == 0 and smem <= 232448
    if dtype == torch.float32 and n1 == 8:
        assert blocks * threads // 32 >= 16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cavity_kernels_launch_shapes(cuda, dtype):
    """The tail kernel's tile at N+1 = 2..8, K3's at each dim (and curved
    tris) on the paths' operator lists, and K4's (both fold_tail forms) and
    K7's at dim 3 on theirs (hex N=3 with either front, N=5 without) fit
    the card: at least one resident block, within an SM's shared memory."""
    from esdg_cns_tpu_torch.solvers.cns_fused import composed_operators

    for n1 in range(2, 9):
        blocks, threads, smem, _, _, te, _ = ct.cns_traction_tail_shape(
            dtype, n1)
        assert blocks >= 1 and threads % te == 0 and smem <= 232448, n1
    for disc in (lid_driven_cavity_3d(3, 2, dtype=dtype, device=cuda)[0],
                 lid_driven_cavity(3, 2, dtype=dtype, device=cuda)[0],
                 becker_shocktube_1d(4, 8, dtype=dtype, device=cuda)[0],
                 warped_tri_case(3, 2, dtype, cuda)[0]):
        lists = mv.modal_lists(torch.stack(disc.q_skew), disc.vq, disc.vhp,
                               disc.ph, disc.nq)
        occ, _ = mv.euler_modal_volume_shape(
            dtype, disc.dim, disc.geo.shape[1] != 1, disc.np_, disc.nq,
            disc.nh, lists)
        assert occ[0] >= 1 and occ[2] <= 232448, disc.dim
    for n, proj in ((3, True), (3, False), (5, False)):
        disc = lid_driven_cavity_3d(n, 2, dtype=dtype, device=cuda)[0]
        front, vqlift, drpq = composed_operators(disc, proj=proj)
        lists = sv.visc_lists(front, vqlift, disc.vhp[disc.nq:], drpq,
                              disc.lift, nq=disc.nq, proj=proj)
        shapes = sv.viscous_shapes(dtype, 3, proj, disc.np_, disc.nq,
                                   disc.nfq, lists)
        for key, (occ, _) in shapes.items():
            assert occ[0] >= 1 and occ[2] <= 232448, (key, n, proj)


@pytest.mark.gpu
@pytest.mark.parametrize("n,kw", [(3, {}), (7, dict(force_fused=True)),
                                  (4, dict(volume_mode="split_dense")),
                                  (3, dict(axis_aligned=False)),
                                  (5, dict(volume_mode="split")),
                                  (6, dict(force_fused=True,
                                           volume_mode="split"))])
def test_grid_stages_run_no_exchange_or_combine(cuda, n, kw):
    """On the periodic grid the fused Euler RHS launches K1 or the split
    front, then K2, and runs no roll exchange and no split combine; it
    equals the lines twin (so at N = 5 and 6, where 'auto' runs K1,
    'split' equals K1)."""
    from esdg_cns_tpu_torch.core.discretization import grid_neighbours
    disc, _ = euler_hex_3d(n=n, k1d=3, dtype=torch.float64, device=cuda)
    q = _random_state(disc, torch.float64, cuda, seed=3)
    rhs = make_euler_rhs_fused(disc, dissipation=True, **kw)
    before = (fv.euler_surface.launches, grid_neighbours.calls,
              fv.split_combine.calls)
    got, _ = rhs(q)
    torch.cuda.synchronize()
    assert (fv.euler_surface.launches, grid_neighbours.calls,
            fv.split_combine.calls) == (before[0] + 1, *before[1:])
    want, _ = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                             compute_rhstest=False)(q)
    assert _rel(got, want) <= 1e-11


# ---- LSRK45's update kernel against the plain two lines, bit for bit ----
def _plain_update(q, res, dq, a, b, dt):
    res = a * res + dt * dq
    return q + b * res, res


def _same_bits(a, b):
    """torch.equal on the values and on their bits (which tell -0 from
    +0)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.dtype == b.dtype and torch.equal(a, b)
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def _state_dt(dtype):
    return torch.tensor(2.5e-4, dtype=dtype).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(5, 64, 1000), (5, 7, 13), (3,)])
def test_lsrk45_update_kernel_matches_plain(cuda, dtype, shape):
    """At each of the five stages from random q, res and dq: the kernel
    launches, updates res in place, makes a new q, and both equal the two
    plain lines bit for bit; at the first stage res holds NaN and is not
    read.  (5, 7, 13) and (3,) leave a tail of the 16-byte vector."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, res, dq = (torch.randn(shape, dtype=dtype, device=cuda, generator=g)
                  for _ in range(3))
    dt = _state_dt(dtype)
    for s in range(5):
        a, b = float(LSRK45_A[s]), float(LSRK45_B[s])
        want_q, want_res = _plain_update(
            q, res if s else torch.zeros_like(q), dq, a, b, dt)
        res_in = res.clone() if s else torch.full_like(q, float("nan"))
        before = lsrk45_update.launches
        got_q, got_res = lsrk45_update(q, res_in, dq, a, b, dt, s == 0)
        torch.cuda.synchronize()
        assert lsrk45_update.launches == before + 1
        assert got_res.data_ptr() == res_in.data_ptr()
        assert got_q.data_ptr() != q.data_ptr()
        assert _same_bits(got_res, want_res), s
        assert _same_bits(got_q, want_q), s


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_lsrk45_update_kernel_takes_unaligned_views(cuda, dtype, offset):
    """Views whose storage offset breaks 16-byte alignment (q, res and dq
    each off by another amount) launch the kernel's one-value-a-thread
    form and equal the plain lines bit for bit at every stage."""
    g = torch.Generator(device=cuda).manual_seed(6)
    n = 5 * 7 * 13
    base = torch.randn(3 * n + 16, dtype=dtype, device=cuda, generator=g)
    q, res, dq = (base[at:at + n].view(5, 7, 13)
                  for at in (offset, n + 4 + 2 * offset, 2 * n + 12 + offset))
    assert any(t.data_ptr() % 16 for t in (q, res, dq))
    dt = _state_dt(dtype)
    for s in range(5):
        a, b = float(LSRK45_A[s]), float(LSRK45_B[s])
        want_q, want_res = _plain_update(
            q, res if s else torch.zeros_like(q), dq, a, b, dt)
        res_in = res.clone() if s else torch.full_like(q, float("nan"))
        before = lsrk45_update.launches
        got_q, got_res = lsrk45_update(q, res_in, dq, a, b, dt, s == 0)
        torch.cuda.synchronize()
        assert lsrk45_update.launches == before + 1
        assert _same_bits(got_res, want_res), s
        assert _same_bits(got_q, want_q), s


@pytest.mark.gpu
def test_lsrk45_update_raises_on_inputs_the_kernel_does_not_take(cuda):
    """On the card there is no plain fallback: a non-contiguous tensor,
    mixed dtypes, another shape or a dtype the kernel is not built for
    raise and launch nothing."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, res, dq = (torch.randn(5, 7, 13, device=cuda, generator=g)
                  for _ in range(3))
    strided = torch.randn(5, 14, 13, device=cuda, generator=g)[:, ::2]
    cases = [((strided, res, dq), ValueError),
             ((q, strided, dq), ValueError),
             ((q, res, dq.double()), TypeError),
             ((q, res, dq[:3]), ValueError),
             ((q.half(), res.half(), dq.half()), TypeError)]
    before = lsrk45_update.launches
    for args, err in cases:
        with pytest.raises(err):
            lsrk45_update(*args, 0.5, 0.25, 1e-3, False)
    assert lsrk45_update.launches == before


def _strided(x):
    """x's values in a non-contiguous layout."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("strided", [False, True])
def test_lsrk45_steps_match_plain_loop_and_keep_stage_inputs(cuda, dtype,
                                                             strided):
    """Two whole lsrk45 steps against a loop of the plain lines written
    here: bit for bit, 10 launches; q0 and every stage's input q_s are
    unchanged after the steps (held by reference, as the benchmark's
    recorder holds them) and each stage's q is a distinct tensor.  With
    strided, q0 and every dq are non-contiguous (as the plain twins' dq
    is): the stepper hands the kernel contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q0 = torch.randn(5, 64, 125, dtype=dtype, device=cuda, generator=g)
    w = torch.randn(5, 64, 125, dtype=dtype, device=cuda, generator=g)
    if strided:
        q0 = _strided(q0)
    seen = []

    def rhs(q, t):
        seen.append((q, q.clone()))
        dq = -torch.sin(q) * w * (1.0 + t)
        return (_strided(dq) if strided else dq), {}

    dt = _state_dt(dtype)
    q0_copy = q0.clone()
    before = lsrk45_update.launches
    got, _ = lsrk45(rhs, q0, dt, 2)
    torch.cuda.synchronize()
    assert lsrk45_update.launches == before + 10
    assert _same_bits(q0, q0_copy)
    assert len(seen) == 10
    assert len({q.data_ptr() for q, _ in seen} | {got.data_ptr()}) == 11
    for q, copy in seen:
        assert _same_bits(q, copy)
    q, res = q0, torch.zeros_like(q0)
    for i in range(2):
        for s in range(5):
            dq, _ = rhs(q, i * dt + float(LSRK45_C[s]) * dt)
            q, res = _plain_update(q, res, dq, float(LSRK45_A[s]),
                                   float(LSRK45_B[s]), dt)
    assert _same_bits(got, q)


# ---- whole runs: 20 LSRK45 steps (100 stages) of each path, every kernel
# launch counted, against the path's plain twin stepped from the same
# state.  Each path runs at its own full width (K in the thousands, many
# waves of blocks), where a fault that needs many blocks shows: a race
# between blocks, a grid limit, index arithmetic at large K.  The limits
# below were set on readings at these widths ----

_STEPS = 20
# max |path - twin| / max |twin| after the 100 stages: in f32 the per-stage
# RHS differences of ~1e-6 relative, times dt, over 100 stages; in f64 one
# RHS agrees to ~1e-13 of max |dq|, and the stages add dt times that
_TWIN_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
# |change of sum(wJq q_f)| over the run / sum(wJq rho), f32 state updates:
# the f32 updates' roundoff reads <= 1.9e-10 at full width on an H100; the
# limit leaves a factor 50 and fails a leak of 1e-10 a stage
_CONSERVATION_TOL_F32 = 1e-8
# the cavities' mass, |change of sum(wJq rho)| / sum(wJq rho): the walls
# carry no mass flux and rho+ = rho- on them, so in f64 the drift stays at
# roundoff.  In f32 the state starts at rest and most nodes get increments
# below half an ulp of rho, which round away coherently (4.3e-8 on the 2D
# cavity at k1d=128 on an H100): the limit lies between that reading and
# the coherent worst case of 100 stages x 2^-24
_MASS_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def _becker_dt(n, k1d):
    """The time step of esdg_cns_tpu/config.py's estimate_dt for a CNS run
    on hexes: 0.5 h / C_N with C_N = 3 (N+1)(N+2)/2 and h = 2 / k1d (CFL
    0.5), capped by the parabolic limit 2 / (C_N k1d^2)."""
    cn = 3.0 * (n + 1) * (n + 2) / 2
    return min(0.5 * (2.0 / k1d) / cn, 2.0 / (cn * k1d * k1d))


def _euler_run(n, k1d, dt, curved=False, impl=None, **kw):
    """The periodic Euler path (the fused RHS; with impl, the twin with
    that flux_diff_impl) and its 'lines' twin."""
    def build(dtype, device):
        disc, q0 = euler_hex_3d(n=n, k1d=k1d, curved=curved, dtype=dtype,
                                device=device)
        twin = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                              compute_rhstest=False)
        rhs = (make_euler_rhs(disc, dissipation=True, flux_diff_impl=impl,
                              compute_rhstest=False) if impl else
               make_euler_rhs_fused(disc, dissipation=True, **kw))
        return disc, q0, rhs, twin, dt
    return build


def _cavity_run(dim, k1d, impl=None, **kw):
    """The lid-driven cavity through make_cns_rhs_affine(**kw) (with impl,
    the twin with that flux_diff_impl) and the twin make_cns_rhs, at the
    benchmark's flags and time step."""
    def build(dtype, device):
        make = lid_driven_cavity if dim == 2 else lid_driven_cavity_3d
        disc, q0, bc, p = make(3, k1d, dtype=dtype, device=device)
        flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                     inviscid_dissipation=True, viscous_dissipation=True,
                     compute_rhstest=False)
        rhs = (make_cns_rhs(disc, flux_diff_impl=impl, **flags) if impl
               else make_cns_rhs_affine(disc, **kw, **flags))
        return disc, q0, rhs, make_cns_rhs(disc, **flags), 1e-4
    return build


def _becker_run(n, k1d):
    """The 3D Becker tube through fused_hex (K1, then K4 with the exact
    wave's time-dependent Dirichlet ghosts) and its twin."""
    def build(dtype, device):
        disc, q0, bc, shock = becker_shocktube_3d(n=n, k1d=k1d, dtype=dtype,
                                                  device=device)
        flags = dict(mu=shock.mu, pr=shock.pr, bc=bc,
                     inviscid_dissipation=True, compute_rhstest=False)
        return (disc, q0,
                make_cns_rhs_affine(disc, volume_impl="fused_hex", **flags),
                make_cns_rhs(disc, **flags), _becker_dt(n, k1d))
    return build


_K1 = dict(euler_volume=1, euler_surface=1)
_SPLIT = dict(hex_project=1, hex_fd_dir=3, euler_surface=1)
# name: (build, launches a stage besides the update's, what is conserved:
# "fields" sum(wJq q) per field in f32, "mass" the cavity's, else None)
_RUNS = {
    "euler_n3": (_euler_run(3, 32, 1e-3), _K1, "fields"),
    "euler_n3_curved": (_euler_run(3, 32, 1e-3, curved=True), _K1,
                        "fields"),
    "euler_n3_curved_lines_pallas": (
        _euler_run(3, 32, 1e-3, curved=True, impl="lines_pallas"),
        dict(flux_differencing_lines_fused=1), None),
    "euler_n4": (_euler_run(4, 24, 1e-3), _K1, None),
    "euler_n4_split": (_euler_run(4, 24, 1e-3, volume_mode="split"), _SPLIT,
                       None),
    "euler_n4_split_pad8": (
        _euler_run(4, 24, 1e-3, volume_mode="split_pad8"), _SPLIT, None),
    "euler_n4_split_dense": (
        _euler_run(4, 24, 1e-3, volume_mode="split_dense"),
        dict(hex_project=1, hex_fd_dir_dense=3, euler_surface=1), None),
    "euler_n5": (_euler_run(5, 20, 5e-4), _K1, "fields"),
    "euler_n6": (_euler_run(6, 16, 4e-4, force_fused=True), _K1, "fields"),
    "euler_n7": (_euler_run(7, 16, 2.5e-4, force_fused=True), _SPLIT,
                 "fields"),
    "cavity_2d": (_cavity_run(2, 128, volume_impl="fused"),
                  dict(euler_modal_volume=1, cns_surface_viscous=1), "mass"),
    "cavity_2d_split": (
        _cavity_run(2, 128, volume_impl="fused", surface_impl="fused"),
        dict(euler_modal_volume=1, cns_surface=1, cns_viscous=1), None),
    "cavity_2d_pallas": (_cavity_run(2, 128, impl="pallas"),
                         dict(flux_differencing_dense=1), None),
    "cavity_3d": (_cavity_run(3, 16, volume_impl="fused_hex"),
                  dict(euler_volume=1, cns_surface_viscous=1,
                       cns_traction_tail=1), "mass"),
    "cavity_3d_split": (
        _cavity_run(3, 16, volume_impl="fused_hex", surface_impl="fused"),
        dict(euler_volume=1, cns_surface=1, cns_viscous=1), None),
    "cavity_3d_modal": (_cavity_run(3, 16, volume_impl="fused"),
                        dict(euler_modal_volume=1, cns_surface_viscous=1,
                             cns_traction_tail=1), "mass"),
    "becker_3d": (_becker_run(5, 32), dict(euler_volume=1,
                                           cns_surface_viscous=1,
                                           cns_traction_tail=1), None),
}
# f32, the paths' type; f64 where the mass is held to roundoff and the
# Becker tube; the 3D cavity's f32 mass is not held (its drift is the f32
# updates' rounding, which the 2D cavity's limit was set on)
_RUN_CASES = ([(name, torch.float32) for name in _RUNS]
              + [(name, torch.float64) for name in (
                  "cavity_2d", "cavity_3d", "cavity_3d_modal", "becker_3d")])


def _mass(disc, q):
    return float((disc.wjq.double()
                  * (disc.vq.double() @ q[0].double())).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", _RUN_CASES, ids=[
    f"{name}-{str(dtype)[6:]}" for name, dtype in _RUN_CASES])
def test_run_launches_each_kernel_once_a_stage_and_matches_its_twin(
        cuda, name, dtype):
    """20 steps of the path: each of its kernels and the update launched
    once a stage and no other kernel; where K2 runs (the periodic grids)
    no roll exchange or split combine; where the tail kernel runs, no call
    of the plain tail; a finite state of the path's type
    within _TWIN_TOL of the twin's; what the path conserves, conserved; on
    the Becker tube rhstest_visc >= 0 at the end."""
    build, stage, conserved = _RUNS[name]
    disc, q0, rhs, twin, dt = build(dtype, cuda)
    before, plain = _launch_counts(), _plain_work()
    forms = dict(ct.cns_traction_tail.forms)
    qf, _ = lsrk45(rhs, q0, dt, _STEPS)
    torch.cuda.synchronize()
    assert _launched(before) == {k: 5 * _STEPS * n for k, n in dict(
        stage, lsrk45_update=1).items()}
    if "cns_traction_tail" in stage:
        assert _tail_forms(forms) == {"kernel": 5 * _STEPS, "plain": 0}
    if "euler_surface" in stage:
        assert _plain_work() == plain
    assert qf.dtype == dtype and bool(torch.isfinite(qf).all())
    qt, _ = lsrk45(twin, q0, dt, _STEPS)
    assert _rel(qf, qt) <= _TWIN_TOL[dtype]
    if conserved == "fields":
        w = disc.wjq.double()[None]
        drift = ((w * qf.double()).sum(dim=(1, 2))
                 - (w * q0.double()).sum(dim=(1, 2))).abs()
        mass = float((w * q0.double()).sum(dim=(1, 2))[0])
        assert float(drift.max()) / mass <= _CONSERVATION_TOL_F32
    if conserved == "mass" and (dtype == torch.float64 or disc.dim == 2):
        m0 = _mass(disc, q0)
        assert abs(_mass(disc, qf) - m0) / m0 <= _MASS_TOL[dtype]
    if name == "becker_3d":
        _, aux = rhs(qf, _STEPS * dt)
        assert float(aux["rhstest_visc"]) >= 0.0


# the free stream on the warped hex mesh, f64: max |dq| of a constant
# state, every term of which cancels through the curl-form metric identity.
# The residual grows like 1/h and with N (the plain RHS reads 2.5e-12 at
# N=3 k1d=8, 4.3e-11 at N=5 k1d=8 and 1.66e-10 at N=5 k1d=16 on the CPU, as
# the JAX package's does): held to 1e-10 where that floor is under it, and
# to twice the plain twin's residual on the same mesh where it is not
_FREE_STREAM_TOL = 1e-10
_FREE_STREAM_TWIN_FACTOR = 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,k1d", [(3, 8), (5, 8), (5, 16)])
def test_curved_fused_rhs_keeps_the_free_stream(cuda, n, k1d):
    disc, _ = euler_hex_3d(n=n, k1d=k1d, curved=True, dtype=torch.float64,
                           device=cuda)
    sh = (disc.np_, disc.num_elements)
    full = lambda v: torch.full(sh, v, dtype=torch.float64, device=cuda)
    q = primitive_to_conservative(
        full(1.3), torch.stack([full(0.2), full(-0.1), full(0.4)]), full(0.9))
    before = fv.euler_volume.launches
    got = float(make_euler_rhs_fused(disc, dissipation=True)(q)[0]
                .abs().max())
    assert fv.euler_volume.launches == before + 1
    if k1d == 8:
        assert got <= _FREE_STREAM_TOL
    else:
        twin = float(make_euler_rhs(disc, dissipation=True,
                                    flux_diff_impl="lines",
                                    compute_rhstest=False)(q)[0].abs().max())
        assert got <= _FREE_STREAM_TWIN_FACTOR * twin


@pytest.mark.gpu
def test_becker_3d_error_falls_with_the_mesh(cuda):
    """The 3D Becker tube at N=5 through fused_hex in f64: the L2 error
    against the exact wave at one time falls from k1d=16 to k1d=32.  The
    wave is the JAX package's accuracy tests' (mu = 0.1,
    tests/test_viscous.py:151), which both meshes resolve; the default
    mu = 0.01 shock, about 0.02 wide, is under-resolved at 0.125 an
    element and its error does not fall."""
    from esdg_cns_tpu_torch.physics.exact import BeckerShock
    from esdg_cns_tpu_torch.solvers import l2_error

    t_end = _STEPS * _becker_dt(5, 16)
    errs = []
    for k1d in (16, 32):
        disc, q0, bc, shock = becker_shocktube_3d(
            n=5, k1d=k1d, dtype=torch.float64, device=cuda,
            shock=BeckerShock(mu=0.1))
        rhs = make_cns_rhs_affine(disc, volume_impl="fused_hex", mu=shock.mu,
                                  pr=shock.pr, bc=bc,
                                  inviscid_dissipation=True,
                                  compute_rhstest=False)
        steps = int(np.ceil(t_end / _becker_dt(5, k1d)))
        qf, _ = lsrk45(rhs, q0, t_end / steps, steps)
        u = shock.conservative(disc.xq[0].cpu().numpy(), t_end)
        z = np.zeros_like(u[0])
        exact = torch.as_tensor(np.stack([u[0], u[1], z, z, u[2]]),
                                device=cuda)
        errs.append(float(l2_error(disc, qf, exact)))
    assert errs[1] < errs[0], errs


# the paper anchor (results/paper_anchor_r05.json: the Mach-3 tube of the
# reference's dg1D_CNS_modalESDG.jl, T=0.1, err_tol 1e-11, f64): each of
# l1, l2, linf within 1% of the artifact's row, and the L2 rates above 4.5,
# as tests/test_paper_anchor.py requires of the artifact
_ANCHOR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "results", "paper_anchor_r05.json")
_ANCHOR_REL, _ANCHOR_MIN_RATE = 0.01, 4.5


def _anchor_row_within(got, row):
    for key in ("l1", "l2", "linf"):
        assert abs(got[key] - row[key]) <= _ANCHOR_REL * row[key], (
            row["n"], row["k"], key)


@pytest.mark.gpu
def test_paper_anchor_on_the_card(cuda):
    """The N=4 rows (K = 32, 64, 128) through volume_impl='fused' (K3 at
    dim 1, K4 at (1, True), no other kernel) and, through the twin as the
    JAX package runs it, the N=2 K=32 row."""
    from esdg_cns_tpu_torch.verification import becker_shocktube_errors

    with open(_ANCHOR) as fh:
        art = {(r["n"], r["k"]): r for r in json.load(fh)["rows"]}
    l2 = []
    for k in (32, 64, 128):
        before = _launch_counts()
        got = becker_shocktube_errors(4, k, 0.1, 1e-11, dtype=torch.float64,
                                      device=cuda, volume_impl="fused")
        assert set(_launched(before)) == {"euler_modal_volume",
                                          "cns_surface_viscous"}
        _anchor_row_within(got, art[4, k])
        l2.append(got["l2"])
    assert min(np.log2(a / b) for a, b in zip(l2, l2[1:])) > _ANCHOR_MIN_RATE
    _anchor_row_within(becker_shocktube_errors(2, 32, 0.1, 1e-11,
                                               dtype=torch.float64,
                                               device=cuda), art[2, 32])


# the split path (K8 then K7) against the merged kernel (K4) on one RHS,
# max |split - merged| / max |merged|: the same arithmetic in two kernels
_SPLIT_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the cavities' k1d: in f32 the paths' full widths (tri K=32768, hex
# K=4096), in f64 small meshes with ragged last tiles (K=50, K=27)
_CAVITY_K1D = {("tri", torch.float32): 128, ("hex", torch.float32): 16,
               ("tri", torch.float64): 5, ("hex", torch.float64): 3}


@pytest.mark.gpu
@pytest.mark.parametrize("case,front,dtype", [
    ("tri", "fused", torch.float32), ("tri", "fused", torch.float64),
    ("hex", "fused_hex", torch.float32), ("hex", "fused_hex", torch.float64),
    ("hex", "fused", torch.float32), ("line", "fused", torch.float64)],
    ids=["tri-f32", "tri-f64", "hex-f32", "hex-f64", "hex_modal-f32",
         "line-f64"])
def test_split_surface_matches_merged_tail(cuda, case, front, dtype):
    """surface_impl='fused' (K8 once, K7 once, no K4) against
    'merged_tail' on one RHS: both cavities on moving states, the 1D
    Becker tube (K=32) at t > 0."""
    if case == "line":
        disc, q, bc, shock = becker_shocktube_1d(4, 32, dtype=dtype,
                                                 device=cuda)
        flags = dict(mu=shock.mu, pr=shock.pr, bc=bc,
                     inviscid_dissipation=True)
        t = 0.01
    else:
        disc, q, bc, p = cavity_case("isothermal", 3,
                                     _CAVITY_K1D[case, dtype], dtype, cuda,
                                     dim=2 if case == "tri" else 3)
        flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                     inviscid_dissipation=True, viscous_dissipation=True)
        t = 0.0
    merged, _ = make_cns_rhs_affine(disc, volume_impl=front,
                                    surface_impl="merged_tail",
                                    compute_rhstest=False, **flags)(q, t)
    before = _launch_counts()
    split, _ = make_cns_rhs_affine(disc, volume_impl=front,
                                   surface_impl="fused",
                                   compute_rhstest=False, **flags)(q, t)
    ran = _launched(before)
    assert (ran.get("cns_surface"), ran.get("cns_viscous")) == (1, 1)
    assert "cns_surface_viscous" not in ran
    assert _rel(split, merged) <= _SPLIT_TOL[dtype]


# the modal front ('fused': K3) against fused_hex (K1) on one RHS: in f32
# the kernels' roundoff, at the 3D cavity's full width (k1d=16); in f64,
# at k1d=4, the JAX package's own limit between these fronts
# (tests/test_cns_fused.py:48-67: Vq Pq = I only up to roundoff)
_FRONT_TOL = {torch.float32: 1e-5, torch.float64: 1e-9}


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", [("cavity", torch.float32),
                                        ("cavity", torch.float64),
                                        ("becker", torch.float64)],
                         ids=["cavity-f32", "cavity-f64", "becker-f64"])
def test_modal_front_matches_fused_hex(cuda, case, dtype):
    """The 3D cavity on a moving state, and the 3D Becker tube (N=2,
    k1d=8) at t > 0, whose 'fused' RHS also agrees with the twin to
    1e-10."""
    if case == "cavity":
        disc, q, bc, p = cavity_case("isothermal", 3,
                                     16 if dtype == torch.float32 else 4,
                                     dtype, cuda, dim=3)
        flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
                     inviscid_dissipation=True, viscous_dissipation=True,
                     compute_rhstest=False)
        t = 0.0
    else:
        disc, q, bc, shock = becker_shocktube_3d(2, 8, dtype=dtype,
                                                 device=cuda)
        flags = dict(mu=shock.mu, pr=shock.pr, bc=bc,
                     inviscid_dissipation=True, compute_rhstest=False)
        t = 0.01
    a, _ = make_cns_rhs_affine(disc, volume_impl="fused", **flags)(q, t)
    b, _ = make_cns_rhs_affine(disc, volume_impl="fused_hex", **flags)(q, t)
    assert _rel(a, b) <= _FRONT_TOL[dtype]
    if case == "becker":
        assert _rel(a, make_cns_rhs(disc, **flags)(q, t)[0]) <= 1e-10


# the FMA probe at the TPU probes' defaults (examples/vpu_peak.py: ITERS
# 512, BLOCKS 64, REPS 3, INNER_LO 4, INNER_HI 24) reads between these
# shares of the data sheet's 67 TFLOP/s: under half it measures latency,
# not throughput; above the data sheet it measures nothing real
_FMA_SHARE = (0.50, 1.05)


@pytest.mark.gpu
def test_fma_probe_reads_within_the_data_sheet(cuda):
    from esdg_cns_tpu_torch.probes import peak

    before = peak.fma_peak.launches
    share = float(np.median(peak.rates(512, 64, 3, 4, 24, cuda))) / (
        peak.FP32_PEAK)
    assert peak.fma_peak.launches > before
    assert _FMA_SHARE[0] <= share <= _FMA_SHARE[1], share

"""The split volume path (projection, one fd launch per direction, plain
combine) and the volume-mode choices of the fused solvers, on the port
against the JAX package (f64, CPU).

The plain versions of ``hex_project``, ``hex_fd_dir`` and
``hex_fd_dir_dense`` (what the CUDA wrappers take on CPU tensors and what
the card holds the kernels against) go through ``euler_volume_split_plain``
and are held against ``euler_volume_split_pallas`` in interpret mode;
``make_euler_rhs_fused`` in each ``volume_mode`` against JAX's same mode;
N >= 6 and the 3D cavity's ``fused_hex`` front choose their volume stage as
JAX's do.  Both packages get the same operators
(``interop.discretization_from_arrays``) and the same seeded moving state.
Tolerances are relative to max |out|: 1e-12 for one volume stage, 1e-11
for a whole RHS (the two packages sum in different orders).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.pallas_volume import _entropy_project_hex
from esdg_cns_tpu.ops.pallas_volume import (
    euler_volume_split_pallas as jax_split,
)
from esdg_cns_tpu.presets import euler_hex_3d as jax_preset
from esdg_cns_tpu.presets import lid_driven_cavity_3d as jax_cavity_3d
from esdg_cns_tpu.solvers import make_cns_rhs_affine as jax_cns_affine
from esdg_cns_tpu.solvers.euler_fused import (
    make_euler_rhs_fused as jax_euler_fused,
)
from esdg_cns_tpu_torch import interop
from esdg_cns_tpu_torch.cavity_cases import moving_state
from esdg_cns_tpu_torch.core.discretization import (
    ARRAY_FIELDS,
    META_FIELDS,
    TUPLE_FIELDS,
)
from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.physics import primitive_to_conservative
from esdg_cns_tpu_torch.presets import euler_hex_3d, lid_driven_cavity_3d
from esdg_cns_tpu_torch.solvers import euler_fused, make_cns_rhs_affine
from esdg_cns_tpu_torch.solvers import make_euler_rhs, make_euler_rhs_fused

F64 = torch.float64
GAMMA = 1.4
TOL_STAGE = 1e-12
TOL_RHS = 1e-11
MODES = ("joint", "split", "split_dense", "split_pad8", "joint_pad8",
         "joint_packed")


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
def _pair(n, k1d=2):
    """(JAX disc, port disc carried across, JAX state, port state): a
    seeded state whose three velocity components are all nonzero."""
    jd, _ = jax_preset(n=n, k1d=k1d)
    td = interop.discretization_from_arrays(
        {f: np.asarray(getattr(jd, f)) for f in ARRAY_FIELDS},
        {f: getattr(jd, f) for f in META_FIELDS}, device="cpu", dtype=F64)
    rng = np.random.default_rng(n)
    sh = (td.np_, td.num_elements)
    f = lambda a: torch.as_tensor(a, dtype=F64)
    tq = primitive_to_conservative(f(2 + 0.1 * rng.random(sh)),
                                   f(0.3 * rng.standard_normal((3, *sh))),
                                   f(2 + 0.1 * rng.random(sh)))
    return jd, td, jnp.asarray(tq.numpy()), tq


def _random_geo(k, seed=11):
    """Non-diagonal affine metric, numpy-seeded: all nine entries O(1),
    so no cross term is an exact zero."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, (9, 1, k))
            * rng.choice([-1.0, 1.0], (9, 1, k)))


# the mesh's own metric in the other forms is covered through the whole
# RHS by test_fused_rhs_modes_match_jax ('split', 'split_pad8',
# 'split_dense', each with axis_aligned True and False)
@pytest.mark.parametrize("dense,pad_x,diag,metric", [
    (False, False, True, "mesh"),
    (False, False, False, "random"),
    (False, True, False, "random"),
    (True, False, False, "random"),
])
def test_split_volume_plain_matches_pallas(dense, pad_x, diag, metric):
    """The split stage, ph_qf and traces, on the axis-aligned mesh (diag)
    and on a random non-diagonal affine metric (triangular, pad_x,
    dense)."""
    jd, td, jq, tq = _pair(4)
    nq = jd.nq
    geo = (np.asarray(jd.geo) if metric == "mesh"
           else _random_geo(jd.num_elements))
    j_out, j_tr = jax_split(jq, jnp.asarray(geo), jd.vhp[nq:], jd.lift,
                            GAMMA, nq=nq, line_ops=jd.line_ops, block_k=8,
                            interpret=True, dense=dense, diag=diag,
                            pad_x=pad_x)
    t_out, t_tr = fv.euler_volume_split_plain(
        tq, torch.as_tensor(geo), td.vhp[nq:], td.lift, GAMMA,
        line_ops=td.line_ops, dense=dense, diag=diag, pad_x=pad_x)
    assert _rel(t_out, j_out) <= TOL_STAGE
    assert _rel(t_tr, j_tr) <= TOL_STAGE
    # the wrapper takes the same plain code for CPU tensors, launching
    # nothing
    before = (fv.hex_project.launches, fv.hex_fd_dir.launches,
              fv.hex_fd_dir_dense.launches)
    w_out, w_tr = fv.euler_volume_split(
        tq, torch.as_tensor(geo), td.vhp[nq:], td.lift, GAMMA,
        line_ops=td.line_ops, dense=dense, diag=diag, pad_x=pad_x)
    assert torch.equal(w_out, t_out) and torch.equal(w_tr, t_tr)
    assert (fv.hex_project.launches, fv.hex_fd_dir.launches,
            fv.hex_fd_dir_dense.launches) == before


def test_projection_plain_matches_jax():
    """hex_project_plain against the TPU kernels' shared projection
    (_entropy_project_hex, plain jnp): flux variables and logs at all Nh
    points, and the traces (their face rows)."""
    jd, td, jq, tq = _pair(4)
    nq = jd.nq
    j_qh, j_log = _entropy_project_hex(jq, jd.vhp[nq:], GAMMA)
    qh, qlog, traces = fv.hex_project_plain(tq, td.vhp[nq:], GAMMA)
    assert _rel(qh, jnp.stack(j_qh)) <= TOL_STAGE
    assert _rel(qlog, jnp.stack(j_log)) <= TOL_STAGE
    assert torch.equal(traces, torch.cat([qh[:, nq:], qlog[:, nq:]]))


@pytest.mark.parametrize("axis_aligned", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_fused_rhs_modes_match_jax(mode, axis_aligned):
    """Every volume_mode of make_euler_rhs_fused at N=4 against JAX's same
    mode (interpret mode), as tests/test_flux_differencing.py holds JAX's
    modes against its lines path."""
    jd, td, jq, tq = _pair(4)
    ref, _ = jax_euler_fused(jd, dissipation=True, force_fused=True,
                             interpret=True, volume_mode=mode,
                             axis_aligned=axis_aligned)(jq)
    got, _ = make_euler_rhs_fused(td, dissipation=True, force_fused=True,
                                  volume_mode=mode,
                                  axis_aligned=axis_aligned)(tq)
    assert _rel(got, ref) <= TOL_RHS


def test_volume_modes_resolve_as_in_jax(monkeypatch):
    """'auto' picks the joint kernel at N=4 and the split path at N=7
    (8 % (N+1) == 0, N+1 != 4); the split modes reach the split stage."""
    split_calls = []
    real = euler_fused.euler_volume_split_parts

    def counting(*args, **kw):
        split_calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(euler_fused, "euler_volume_split_parts", counting)
    for n, mode, want in ((4, "auto", "joint_packed"), (7, "auto", "split"),
                          (2, "auto", "joint_packed"), (1, "auto", "joint"),
                          (4, "split_pad8", "split_pad8")):
        td, _ = euler_hex_3d(n=n, k1d=2, dtype=F64, device="cpu")
        assert euler_fused.resolve_volume_mode(td, mode) == want, (n, mode)
    _, td, _, tq = _pair(4)
    for mode, dense in (("split", False), ("split_pad8", False),
                        ("split_dense", True), ("joint", None)):
        split_calls.clear()
        make_euler_rhs_fused(td, force_fused=True, volume_mode=mode)(tq)
        assert len(split_calls) == (0 if dense is None else 1), mode
        if dense is not None:
            assert split_calls[0].get("dense", False) == dense


def test_n7_force_fused_takes_the_split_path_and_matches_jax(monkeypatch):
    """Repair: at N=7 force_fused=True resolves to the split path (with
    the diag form on this axis-aligned mesh) and equals JAX's at 1e-11."""
    jd, td, jq, tq = _pair(7)
    calls = []
    real = euler_fused.euler_volume_split_parts

    def counting(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(euler_fused, "euler_volume_split_parts", counting)
    got, _ = make_euler_rhs_fused(td, dissipation=True, force_fused=True)(tq)
    assert len(calls) == 1 and calls[0]["diag"] is True
    ref, _ = jax_euler_fused(jd, dissipation=True, force_fused=True,
                             interpret=True)(jq)
    assert _rel(got, ref) <= TOL_RHS


def test_n6_without_force_fused_is_the_lines_path():
    """Repair: N >= 6 without force_fused is JAX's lines fallback, and the
    flags that fallback would ignore raise the same ValueError."""
    jd, td, jq, tq = _pair(6)
    ref, _ = jax_euler_fused(jd, dissipation=True)(jq)   # JAX's lines path
    got, _ = make_euler_rhs_fused(td, dissipation=True)(tq)
    assert _rel(got, ref) <= TOL_RHS
    twin, _ = make_euler_rhs(td, dissipation=True, flux_diff_impl="lines",
                             compute_rhstest=False)(tq)
    assert torch.equal(got, twin)
    for kw in (dict(axis_aligned=True), dict(volume_mode="split"),
               dict(axis_aligned=False, volume_mode="joint")):
        with pytest.raises(ValueError) as jerr:
            jax_euler_fused(jd, **kw)
        with pytest.raises(ValueError) as terr:
            make_euler_rhs_fused(td, **kw)
        assert str(terr.value) == str(jerr.value)


def test_split_wrappers_refuse_what_jax_refuses():
    _, td, _, tq = _pair(4)
    ef = td.vhp[td.nq:]
    curved = td.geo.expand(9, td.nh, -1).contiguous()
    for fn in (fv.euler_volume_split, fv.euler_volume_split_plain):
        with pytest.raises(ValueError, match="affine-only"):
            fn(tq, curved, ef, td.lift, GAMMA, line_ops=td.line_ops)
        with pytest.raises(ValueError, match="pad_x is only implemented"):
            fn(tq, td.geo, ef, td.lift, GAMMA, line_ops=td.line_ops,
               dense=True, pad_x=True)


@functools.lru_cache(maxsize=2)
def _cavity_pair(n):
    jd, jq0, jbc, p = jax_cavity_3d(n=n, k1d=2)
    td, tq0, tbc, _ = lid_driven_cavity_3d(n=n, k1d=2, dtype=F64,
                                           device="cpu")
    q = moving_state(tq0, np.random.default_rng(n))
    return jd, jbc, td, tbc, p, q


@pytest.mark.parametrize("n,split", [(7, True), (4, False)])
def test_fused_hex_front_choice(monkeypatch, n, split):
    """Repair: the 3D cavity's fused_hex front takes the split path at
    N=7, as JAX's does (cns_fused.py:314-318), and K1 at N=4; at N=7 it
    equals JAX's 'xla' path at 1e-9, the tolerance and reason of
    tests/test_cns_fused.py:45-75 (v(U) raw against (Vq Pq) v(U))."""
    jd, jbc, td, tbc, p, q = _cavity_pair(n)
    calls = {"split": 0, "joint": 0}
    real_split, real_joint = fv.euler_volume_split, fv.euler_volume

    def count(key, real):
        def wrapped(*args, **kw):
            calls[key] += 1
            return real(*args, **kw)
        return wrapped

    monkeypatch.setattr(fv, "euler_volume_split", count("split", real_split))
    monkeypatch.setattr(fv, "euler_volume", count("joint", real_joint))
    flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"],
                 inviscid_dissipation=True, viscous_dissipation=True)
    got, _ = make_cns_rhs_affine(td, bc=tbc, volume_impl="fused_hex",
                                 **flags)(q)
    assert calls == ({"split": 1, "joint": 0} if split
                     else {"split": 0, "joint": 1})
    if split:
        ref, _ = jax_cns_affine(jd, bc=jbc, **flags)(
            jnp.asarray(q.numpy()), 0.0)
        assert _rel(got, ref) <= 1e-9


@pytest.mark.parametrize("n", [4, 7])
def test_discretization_carried_across_bitwise(n):
    """interop carries the JAX hex discretization over unchanged at the
    split path's orders, and the port's preset builds the same bits."""
    jd, td, _, _ = _pair(n)
    own, _ = euler_hex_3d(n=n, k1d=2, dtype=F64, device="cpu")
    for f in ARRAY_FIELDS:
        ref = np.asarray(getattr(jd, f))
        for disc in (td, own):
            v = getattr(disc, f)
            got = (np.stack([t.numpy() for t in v]) if f in TUPLE_FIELDS
                   else v.numpy())
            assert np.array_equal(got, ref), f
    assert td.line_ops == own.line_ops
    assert td.line_ops.n1d == n + 1


def test_n7_path_mesh_is_detected_axis_aligned():
    """The snap gate at the N=7 path's own size (k1d=16): the split fd and
    K2 take their diagonal forms on the card."""
    disc, q0 = euler_hex_3d(n=7, k1d=16, dtype=torch.float32, device="cpu")
    assert disc.num_elements == 4096 and disc.nh == 896
    assert tuple(q0.shape) == (5, 512, 4096)
    assert fv.detect_axis_aligned(disc)
    assert euler_fused.resolve_volume_mode(disc) == "split"


def _line_nodes(n1, d, line):
    """The volume nodes of node line `line` of direction d, in the
    numbering of the CUDA kernels (common.cuh's line_base/line_stride)."""
    base = (n1 * line if d == 0 else
            line % n1 + n1 * n1 * (line // n1) if d == 1 else line)
    return [base + a * n1 ** d for a in range(n1)]


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_face_operators_touch_one_line_per_face_point(n):
    """The CUDA kernels form Ef v and LIFT x over the N+1 nodes of each
    face point's line (common.cuh's ef_line, lift_lines): hold every entry
    of Ef and LIFT off those lines below 1e-14 of the largest, and every
    entry on them above it, on the hex Euler and 3D cavity operators."""
    n1 = n + 1
    nfp = n1 * n1
    for disc in (euler_hex_3d(n=n, k1d=2, dtype=F64, device="cpu")[0],
                 lid_driven_cavity_3d(n=n, k1d=2, dtype=F64,
                                      device="cpu")[0]):
        ef = disc.vhp[disc.nq:].numpy()
        lift_t = disc.lift.numpy().T
        for op in (ef, lift_t):
            on = np.zeros(op.shape, dtype=bool)
            for fp in range(6 * nfp):
                on[fp, _line_nodes(n1, fp // (2 * nfp), fp % nfp)] = True
            scale = np.abs(op).max()
            assert np.abs(op[~on]).max(initial=0.0) <= 1e-14 * scale
            assert np.abs(op[on]).min() > 1e-14 * scale

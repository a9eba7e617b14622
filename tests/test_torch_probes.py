"""The port's throughput probes and flux-differencing section (rows 11-14
of the TPU kernel table) against the TPU study kernels, and the by-kind
operation counts of chip_smoke.py against the totals they replace.

On the CPU the wrappers take their plain versions.  Rows 12 and 13 run the
TPU probes' own kernels (``examples/vpu_divide.make_pallas``,
``examples/vpu_transcendental.make_pallas``) in Pallas' TPU interpret
mode, row 14 the study's ``make_fd_call`` around the TPU body
``_fd_pad8`` in interpret mode, each on the same f32 input made from a
NumPy seed.  Row 11's kernel is a closure inside ``examples/vpu_peak.py``'s
``main`` and cannot be imported, so its plain version is held to a NumPy
f32 copy of that closure's recurrence.  The kernels themselves run on the
card (``tests/test_torch_gpu.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_probes.py -q
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from esdg_cns_tpu_torch.core import build_discretization  # noqa: E402
from esdg_cns_tpu_torch.core import ref_hex, ref_line, ref_tri  # noqa: E402
from esdg_cns_tpu_torch.mesh.generators import (  # noqa: E402
    uniform_hex_mesh, uniform_line_mesh, uniform_tri_mesh)
from esdg_cns_tpu_torch.ops.fused_volume import hex_fd_dir_plain  # noqa: E402
from esdg_cns_tpu_torch.ops.tensor_product_fd import (  # noqa: E402
    LineOps, _hex_line_coeffs)
from esdg_cns_tpu_torch.probes import divide, peak  # noqa: E402
from esdg_cns_tpu_torch.probes import fd_section as fs  # noqa: E402
from esdg_cns_tpu_torch.probes import transcendental  # noqa: E402
from esdg_cns_tpu_torch.solvers.cns_fused import (  # noqa: E402
    composed_operators)

GAMMA = 1.4
# the TPU probes at a CPU size: iters=8, one block
ITERS = 8
# plain version vs the TPU kernel, max |a - b| / max |TPU|: the same f32
# operations in one order, libm's log/exp/sqrt against XLA's by an ulp
PROBE_TOL = 1e-6
# row 14 in f32: the same pairs summed in another order
FD_TOL_F32 = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def examples():
    """The TPU study modules.  Importing them points JAX's compilation
    cache at the repository's .jax_cache and puts examples/ on sys.path;
    both are restored."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import r5_packed_fd_study
        import vpu_divide
        import vpu_transcendental
    finally:
        sys.path[:] = path
        for k, v in saved.items():
            jax.config.update(k, v)
    return types.SimpleNamespace(divide=vpu_divide,
                                 transcendental=vpu_transcendental,
                                 fd=r5_packed_fd_study)


def _probe_x(rows):
    rng = np.random.default_rng(11)
    return (1.0 + 0.5 * rng.random((rows, 1024))).astype(np.float32)


def _tpu_peak_recurrence(x, iters):
    """examples/vpu_peak.py:62-72, the kernel closure of its main(), in
    NumPy f32: every operation rounded to f32 as the TPU kernel's are."""
    f = np.float32
    a = x
    b = x * f(0.5) + f(1.0)
    for _ in range(iters // 2):
        a = a * f(0.999998) + x
        b = b * f(0.999999) + x
    return (a + b) * f(1e-3)


@pytest.mark.parametrize("iters", [8, 64])
def test_peak_plain_matches_the_tpu_recurrence(iters):
    x = _probe_x(64)
    ref = _tpu_peak_recurrence(x, iters)
    got = peak.fma_peak_plain(torch.from_numpy(x), iters)
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= PROBE_TOL
    n0 = peak.fma_peak.launches
    assert torch.equal(peak.fma_peak(torch.from_numpy(x), iters), got)
    assert peak.fma_peak.launches == n0   # the CPU takes the plain version


@pytest.mark.parametrize("kind", divide.DIVIDE_KINDS)
def test_divide_plain_matches_the_tpu_kernel(examples, kind):
    x = _probe_x(examples.divide.BS[0])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(examples.divide.make_pallas(kind, ITERS, 1)(
            jnp.asarray(x)))
    got = divide.chain_plain(torch.from_numpy(x), kind, ITERS)
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert _rel(got, ref) <= PROBE_TOL, kind
    n0 = divide.chain.launches
    assert torch.equal(divide.chain(torch.from_numpy(x), kind, ITERS), got)
    assert divide.chain.launches == n0


@pytest.mark.parametrize("kind", transcendental.KINDS)
def test_transcendental_plain_matches_the_tpu_kernel(examples, kind):
    assert tuple(examples.transcendental._STEPS) == transcendental.KINDS
    x = _probe_x(examples.transcendental.BS[0])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(examples.transcendental.make_pallas(
            kind, ITERS, 1)(jnp.asarray(x)))
    got = transcendental.chain_plain(torch.from_numpy(x), kind, ITERS)
    assert _rel(got, ref) <= PROBE_TOL, kind
    n0 = transcendental.chain.launches
    assert torch.equal(transcendental.chain(torch.from_numpy(x), kind,
                                            ITERS), got)
    assert transcendental.chain.launches == n0


def test_probe_wrappers_refuse_unknown_kinds():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        divide.chain(x, "log", ITERS)
    with pytest.raises(ValueError):
        transcendental.chain(x, "tanh", ITERS)
    with pytest.raises(ValueError):
        transcendental.rates(kinds=("div",))


@pytest.mark.parametrize("diag", [True, False])
def test_fd_section_plain_matches_the_study_kernel(examples, diag):
    """Row 14 on the study's own random, non-skew tables: only the pair
    bookkeeping of _fd_pad8 (one coefficient per pair, at the lower
    node) reproduces it."""
    n1, k = 4, 128
    inp = fs.study_inputs(n1, k, diag)
    ref = np.asarray(examples.fd.make_fd_call(
        examples.fd._fd_pad8,
        *(jnp.asarray(inp[key]) for key in ("qh", "qlog", "geo", "cvol",
                                            "cface")),
        n1=n1, gamma=GAMMA, diag=diag, block_k=128, interpret=True))
    args = fs.as_tensors(inp, "cpu")
    got = fs.fd_section_plain(*args, GAMMA, n1=n1, diag=diag)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= FD_TOL_F32
    n0 = fs.fd_section.launches
    assert torch.equal(fs.fd_section(*args, GAMMA, n1=n1, diag=diag), got)
    assert fs.fd_section.launches == n0
    assert torch.equal(fs.fd_section_split(*args, GAMMA, n1=n1, diag=diag),
                       got)


@pytest.mark.parametrize("n1", [2, 4, 5])
@pytest.mark.parametrize("diag", [True, False])
def test_fd_section_plain_is_the_split_directions_summed(n1, diag):
    """f64, the real line operators' tables: the volume rows are the sum
    of the three directions' of hex_fd_dir_plain, face fid's rows are
    direction fid // 2's side fid % 2."""
    nq, nfp = n1 ** 3, n1 * n1
    inp = fs.study_inputs(n1, 6, diag, dtype=np.float64)
    qh, qlog, geo, _, _ = fs.as_tensors(inp, "cpu")
    line_ops = LineOps.make(n1 - 1)
    cvol, cface = (torch.as_tensor(a)[..., None]
                   for a in _hex_line_coeffs(line_ops))
    got = fs.fd_section_plain(qh, qlog, geo, cvol, cface, GAMMA, n1=n1,
                              diag=diag)
    parts = [hex_fd_dir_plain(qh, qlog, geo, GAMMA, line_ops=line_ops, d=d,
                              diag=diag) for d in range(3)]
    assert _rel(got[:, :nq], sum(p[:, :nq] for p in parts)) <= 1e-12
    for fid in range(6):
        side = nq + (fid % 2) * nfp
        want = parts[fid // 2][:, side:side + nfp]
        assert _rel(got[:, nq + fid * nfp:nq + (fid + 1) * nfp],
                    want) <= 1e-12, fid


# -----------------------------------------------------------------------------
# chip_smoke.py's operation counts by kind
# -----------------------------------------------------------------------------

def _old_counts():
    """chip_smoke.py's hand counts before they were split by kind (FMA two
    operations, every other kind one), verbatim: the totals the data-sheet
    bound keeps."""
    pair_3d = {"diag": 74, "general": 106, "curved": 112}
    pair_modal = {1: 55, 2: 85, 3: pair_3d["general"]}
    entries, line_pairs, tri_pairs = cs.entries, cs.line_pairs, cs.tri_pairs
    needed_pairs = cs.needed_pairs

    def ops_project(n1, ef_entries):
        nq, nfq = n1 ** 3, 6 * n1 * n1
        return 27 * nq + 2 * ef_entries * 5 + 40 * nfq

    def ops_k1(n1, ef_entries, lift_entries, form="diag"):
        nq, nfq = n1 ** 3, 6 * n1 * n1
        return (ops_project(n1, ef_entries) + pair_3d[form] * line_pairs(n1)
                + 5 * nfq + 2 * lift_entries * 5 + 15 * nq)

    def ops_k2(n1, lift_entries, diag=True):
        nq, nfq = n1 ** 3, 6 * n1 * n1
        return (120 if diag else 160) * nfq + 2 * lift_entries * 5 + 15 * nq

    def ops_lines(n1, curved):
        nh = n1 ** 3 + 6 * n1 * n1
        return (pair_3d["curved" if curved else "general"] * line_pairs(n1)
                + 5 * nh)

    def ops_k3(dim, vq, vhp, ph, q_skew, nq, curved=False):
        nf, nh = dim + 2, vhp.shape[0]
        np_ = ph.shape[0]
        pair = 93 if curved else pair_modal[dim]
        return (2 * nf * (entries(vq) + entries(vhp) + entries(ph))
                + (10 + 5 * dim) * nq + (30 + 5 * dim) * nh
                + pair * needed_pairs(q_skew, nq) + nf * np_)

    def ops_dense_2d(nq, nh, curved):
        return (93 if curved else 85) * tri_pairs(nq, nh) + 4 * nh

    def ops_face(dim, rebuild_local):
        nf = dim + 2
        cons, evars = 3 * dim + 4, 3 * dim + 7
        rebuild = cons + evars + (cons + evars if rebuild_local else 0)
        ghosts = 4 * dim + 2 + 3 * dim
        pair = 34 + 4 * dim + dim * (2 * dim + 2 + 2 * nf)
        lf = 4 * dim + 19 + 3 * nf
        return rebuild + ghosts + pair + lf + nf + 4 * dim + 6 + nf

    def ops_visc(dim, nq, nfq, front, vqlift, ef, drpq):
        nf = dim + 2
        sigma = {1: 20, 2: 83, 3: 190}[dim]
        front = 2 * entries(front) * nf
        surface = 2 * dim * entries(vqlift) * nf + nfq * nf * (1 + dim)
        node = nf * dim * (2 * dim + 1) + sigma + 3 * dim * nf
        traction = 2 * dim * nf * entries(ef) + nfq * 2 * dim * nf
        div = dim * nq * nf * (2 * dim - 1) + 2 * entries(drpq) * nf
        return front + surface + nq * node + traction + div

    def ops_k4(dim, np_, nq, nfq, k4args, lift):
        fold = 4 * (dim + 2) * entries(lift) + 6 * (dim + 2) * np_
        return (nfq * ops_face(dim, True)
                + ops_visc(dim, nq, nfq, *k4args[-4:]) + fold)

    return types.SimpleNamespace(**{k: v for k, v in locals().items()
                                    if k.startswith(("ops_", "pair_"))})


@pytest.mark.parametrize("n1", [2, 3, 4, 5, 6, 7, 8])
def test_counts_by_kind_keep_the_old_totals(n1):
    """The collocated-hex counts at N+1 = 2..8, weighed the old way, equal
    the old totals, so the data-sheet bound_ms does not move."""
    old = _old_counts()
    nfq = 6 * n1 * n1
    ef, lift = nfq * n1, nfq * n1   # one node line per face point
    for form in ("diag", "general", "curved"):
        assert cs.PAIR_3D[form].flops() == old.pair_3d[form]
        assert (cs.ops_k1(n1, ef, lift, form).flops()
                == old.ops_k1(n1, ef, lift, form))
    assert cs.ops_project(n1, ef).flops() == old.ops_project(n1, ef)
    for diag in (True, False):
        assert cs.ops_k2(n1, lift, diag).flops() == old.ops_k2(n1, lift,
                                                               diag)
    for curved in (True, False):
        assert cs.ops_lines(n1, curved).flops() == old.ops_lines(n1, curved)
    # the split fd's per-direction counts
    for form in ("diag", "general"):
        assert ((cs.PAIR_3D[form] * (cs.line_pairs(n1) // 3 * 5)).flops()
                == old.pair_3d[form] * cs.line_pairs(n1) // 3 * 5)


_PAIRS = {"3d " + k: v for k, v in cs.PAIR_3D.items()}
_PAIRS.update({f"modal dim {k}": v for k, v in cs.PAIR_MODAL.items()},
              tri_curved=cs.PAIR_TRI_CURVED)


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_pair_counts_take_five_divisions(name):
    """Every EC pair count takes the five divisions ec_pair_n performs
    (csrc/common.cuh: the two logarithmic means' v, rho's mean, beta's
    reciprocal mean, the pressure average; the two series terms v / 448
    are multiplies by 1/448), and keeps its old total."""
    old = _old_counts()
    totals = {"3d " + k: v for k, v in old.pair_3d.items()}
    totals.update({f"modal dim {k}": v for k, v in old.pair_modal.items()},
                  tri_curved=93)
    assert _PAIRS[name]["div"] == 5
    assert _PAIRS[name].flops() == totals[name]


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_face_counts_take_the_pairs_five_divisions(dim):
    """The CNS face node: one division to rebuild each conservative trace
    (the neighbour's, and with rebuild_local the local one), the pair's
    five, two wave speeds' four and the penalty rows' two; K2's face node
    the pair's five, both sides' conservative states, both wave speeds'
    six and, diag, 1/sj."""
    for local, rebuilt in ((True, 2), (False, 1)):
        assert cs.ops_face(dim, local)["div"] == rebuilt + 5 + 4 + 2
    nfq = 6 * 4 * 4
    assert cs.ops_k2(4, 0, diag=True)["div"] == (5 + 2 + 6 + 1) * nfq
    assert cs.ops_k2(4, 0, diag=False)["div"] == (5 + 2 + 6) * nfq


def _disc(kind, n):
    """A two-element-a-side discretization: its operators are the
    reference element's."""
    ref, mesh = {"line": (ref_line, uniform_line_mesh),
                 "tri": (ref_tri, uniform_tri_mesh),
                 "hex": (ref_hex, uniform_hex_mesh)}[kind]
    *verts, etov = mesh(2)
    return build_discretization(ref(n), tuple(verts), etov,
                                dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("kind,n", [("line", 4), ("tri", 3), ("hex", 3)])
def test_counts_by_kind_keep_the_old_totals_on_the_paths_operators(kind, n):
    """K3, K4, K7, K8 and K5 on the operators the paths use (line N=4,
    tri N=3, hex N=3, each front the paths take): the by-kind counts,
    weighed the old way, equal the old totals."""
    old = _old_counts()
    disc = _disc(kind, n)
    dim = disc.dim
    q_skew = torch.stack(disc.q_skew)
    new = cs.ops_k3(dim, disc.vq, disc.vhp, disc.ph, q_skew, disc.nq)
    assert new.flops() == old.ops_k3(dim, disc.vq, disc.vhp, disc.ph, q_skew,
                                     disc.nq)
    for proj in ((True, False) if dim == 3 else (True,)):
        front, vqlift, drpq = composed_operators(disc, proj=proj)
        ops = (front, vqlift, disc.vhp[disc.nq:].contiguous(), drpq)
        assert (cs.ops_visc(dim, disc.nq, disc.nfq, *ops).flops()
                == old.ops_visc(dim, disc.nq, disc.nfq, *ops))
        assert (cs.ops_k4(dim, disc.np_, disc.nq, disc.nfq, ops,
                          disc.lift).flops()
                == old.ops_k4(dim, disc.np_, disc.nq, disc.nfq, ops,
                              disc.lift))
    for local in (True, False):
        assert cs.ops_face(dim, local).flops() == old.ops_face(dim, local)
    if kind == "tri":
        assert cs.PAIR_TRI_CURVED.flops() == 93
        for curved in (True, False):
            assert (cs.ops_k3(dim, disc.vq, disc.vhp, disc.ph, q_skew,
                              disc.nq, curved=curved).flops()
                    == old.ops_k3(dim, disc.vq, disc.vhp, disc.ph, q_skew,
                                  disc.nq, curved=curved))
            assert (cs.ops_dense_2d(disc.nq, disc.nh, curved).flops()
                    == old.ops_dense_2d(disc.nq, disc.nh, curved))
    for d in (1, 2, 3):
        assert cs.PAIR_MODAL[d].flops() == old.pair_modal[d]


def test_priced_time_is_the_hand_sum():
    ops = cs.Ops(fma=3, mul=5, add=7, div=2, log=1, exp=4, sqrt=1, rsqrt=6,
                 pow=2)
    slots = {"mul": 1.5, "add": 1.25, "div": 9.0, "log": 20.0, "exp": 7.0,
             "sqrt": 11.0, "rsqrt": 8.0}
    rate = 2.0e12   # FMA/s
    pow_slots = slots["log"] + slots["exp"] + slots["mul"]
    hand = (3 * 1.0 + 5 * 1.5 + 7 * 1.25 + 2 * 9.0 + 1 * 20.0 + 4 * 7.0
            + 1 * 11.0 + 6 * 8.0 + 2 * pow_slots)
    assert cs.priced_ms(ops, slots, rate) == pytest.approx(
        hand / rate * 1e3, rel=1e-15)
    assert ops.flops() == 2 * 3 + 5 + 7 + 2 + 1 + 4 + 1 + 6 + 2
    # the data-sheet bound divides by the dtype's peak; the priced bound
    # is f32's alone and never below the bytes leg
    n_bytes = 1e6
    b32, b64 = (cs.bound(n_bytes, ops * 10 ** 9, dt)
                for dt in ("float32", torch.float64))
    assert b32.ms == pytest.approx(ops.flops() * 1e9 / 67e12 * 1e3)
    assert b64.ms == pytest.approx(ops.flops() * 1e9 / 34e12 * 1e3)
    assert b32.by == b64.by == "operations"
    assert cs.priced_bound(b64, slots, rate) is None
    assert cs.priced_bound(b32, slots, rate) == pytest.approx(
        hand * 1e9 / rate * 1e3)
    small = cs.bound(n_bytes, ops, "float32")
    assert small.by == "bytes"
    assert cs.priced_bound(small, slots, rate) == pytest.approx(
        n_bytes / 3.35e12 * 1e3)
    with pytest.raises(ValueError):
        cs.split(10, fma=4, div=3)
    with pytest.raises(ValueError):
        cs.Ops(tanh=1)

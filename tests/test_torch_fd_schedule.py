"""What the split fd kernel (``csrc/hex_split.cuh``) relies on, on the CPU.

The kernel spreads each line's pairs over its nodes' threads in a fixed
schedule (``fused_volume.fd_pair_schedule``) and runs the dense form
(row 4b) as the general form with every pair once.  Both rest on cvol's
line blocks being skew with a zero diagonal (the flux is symmetric).
These tests hold that structure in f64 at N+1 = 2..8, the dense plain
version to the triangular one, the schedule's coverage, and sums formed
in the schedule's order on the plain pair to ``hex_fd_dir_plain``.
"""

import itertools

import numpy as np
import pytest
import torch

from esdg_cns_tpu_torch.ops import fused_volume as fv
from esdg_cns_tpu_torch.ops.tensor_product_fd import _hex_line_coeffs
from esdg_cns_tpu_torch.physics import primitive_to_conservative
from esdg_cns_tpu_torch.physics.euler import ec_flux_fields
from esdg_cns_tpu_torch.presets import euler_hex_3d

GAMMA = 1.4
ORDERS = [2, 3, 4, 5, 6, 7, 8]


def _line(n1, d, line):
    """(base, stride) of line `line` of direction d (common.cuh)."""
    stride = (1, n1, n1 * n1)[d]
    base = (n1 * line, line % n1 + n1 * n1 * (line // n1), line)[d]
    return base, stride


def _case(n1, seed):
    """f64 disc at N+1 = n1 (K = 8), the plain projection of a moving
    state, and a random affine metric."""
    disc, _ = euler_hex_3d(n=n1 - 1, k1d=2, dtype=torch.float64,
                           device="cpu")
    rng = np.random.default_rng(seed)
    sh = (disc.np_, disc.num_elements)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    q = primitive_to_conservative(t(2 + 0.1 * rng.random(sh)),
                                  t(0.3 * rng.standard_normal((3, *sh))),
                                  t(2 + 0.1 * rng.random(sh)))
    qh, qlog, _ = fv.hex_project_plain(q, disc.vhp[disc.nq:], GAMMA)
    geo = t(rng.standard_normal((9, 1, disc.num_elements)))
    return disc, qh, qlog, geo


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("n1", ORDERS)
def test_cvol_line_blocks_are_skew_with_zero_diagonal(n1):
    disc, _ = euler_hex_3d(n=n1 - 1, k1d=1, dtype=torch.float64,
                           device="cpu")
    cvol, _ = _hex_line_coeffs(disc.line_ops)
    scale = np.abs(cvol).max()
    for d, line in itertools.product(range(3), range(n1 * n1)):
        base, stride = _line(n1, d, line)
        # block[a, ap] = c(a, ap), the coefficient node a takes from ap
        block = np.array([[cvol[d * n1 + ap, base + a * stride]
                           for ap in range(n1)] for a in range(n1)])
        assert np.abs(block + block.T).max() <= 1e-12 * scale, (d, line)
        assert np.abs(np.diag(block)).max() <= 1e-12 * scale, (d, line)


@pytest.mark.parametrize("n1", ORDERS)
def test_dense_plain_is_the_general_triangular_form(n1):
    disc, qh, qlog, geo = _case(n1, n1)
    lo = disc.line_ops
    for d in range(3):
        dense = fv.hex_fd_dir_dense_plain(qh, qlog, geo, GAMMA, line_ops=lo,
                                          d=d)
        tri = fv.hex_fd_dir_plain(qh, qlog, geo, GAMMA, line_ops=lo, d=d,
                                  diag=False)
        assert _rel(dense, tri) <= 1e-12, d


@pytest.mark.parametrize("n1", ORDERS)
def test_schedule_covers_every_pair_once(n1):
    rounds = fv.fd_pair_schedule(n1)
    pairs = [p for r in rounds for p in r]
    vol = sorted(tuple(sorted(p)) for p in pairs if p[1] < n1)
    assert vol == list(itertools.combinations(range(n1), 2))
    face = sorted(p for p in pairs if p[1] >= n1)
    assert face == [(a, n1 + side) for a in range(n1) for side in (0, 1)]
    for r in rounds:   # a thread evaluates at most one pair a round
        assert len({a for a, _ in r}) == len(r)
    assert len(rounds) == n1 // 2 + 2


def _scheduled(qh, qlog, geo, line_ops, d, diag, coeffs):
    """One direction's output formed as the kernel forms it: every line of
    every element at once, the rounds of fd_pair_schedule in order, the
    plain pair (ec_flux_fields), the tables coeffs = (cvol, cface)."""
    n1 = line_ops.n1d
    nq, nfp, k = n1 ** 3, n1 * n1, qh.shape[2]
    cvol, cface = coeffs
    lines = [_line(n1, d, line) for line in range(nfp)]
    nodes = torch.tensor([[b + a * s for a in range(n1)] for b, s in lines])
    fpts = torch.tensor([[nq + (2 * d + side) * nfp + line
                          for side in (0, 1)] for line in range(nfp)])
    pts = torch.cat([nodes, fpts], dim=1)          # [nfp, n1 + 2]
    xs = (d,) if diag else (0, 1, 2)
    g = [geo[d * 3 + x, 0] for x in xs]             # [K] each

    def point(p):      # the flux variables at point p of every line
        return ([qh[f][pts[:, p]] for f in range(5)],
                [qlog[f][pts[:, p]] for f in range(2)])

    def contracted(a, p, coeff):
        (ql, ll), (qr, lr) = point(a), point(p)
        fl = ec_flux_fields(ql, qr, ll, lr, GAMMA,
                            dirs=(d,) if diag else None)
        return [sum(gx * coeff * fx[f] for gx, fx in zip(g, fl))
                for f in range(5)]

    acc = [[torch.zeros(nfp, k, dtype=qh.dtype) for _ in range(5)]
           for _ in range(n1)]
    face = [[[] for _ in range(5)] for _ in range(2)]
    for rnd in fv.fd_pair_schedule(n1):
        handed = []
        for a, p in rnd:
            if p < n1:     # the triangular coefficient, signed
                lo, hi = min(a, p), max(a, p)
                sign = 1.0 if a < p else -1.0
                coeff = sign * cvol[d * n1 + hi][nodes[:, lo]][:, None]
            else:
                coeff = cface[2 * d + p - n1][nodes[:, a]][:, None]
            fr = contracted(a, p, coeff)
            for f in range(5):
                acc[a][f] = acc[a][f] + fr[f]
            handed.append((a, p, [-x for x in fr]))
        for a, p, neg in handed:        # after the round's barrier
            for f in range(5):
                if p < n1:
                    acc[p][f] = acc[p][f] + neg[f]
                else:
                    face[p - n1][f].append((a, neg[f]))
    out = torch.empty(5, nq + 2 * nfp, k, dtype=qh.dtype)
    for f in range(5):
        for a in range(n1):
            out[f, nodes[:, a]] = acc[a][f]
        for side in (0, 1):
            parts = [x for _, x in sorted(face[side][f], key=lambda t: t[0])]
            out[f, nq + side * nfp:nq + (side + 1) * nfp] = sum(
                parts[1:], parts[0])
    return out


@pytest.mark.parametrize("n1", ORDERS)
def test_sums_in_the_schedules_order_equal_the_plain_version(n1):
    """On the line tables and on random ones that are not skew (the fd
    section's study inputs are such): the kernel's order gives the
    triangular form's function either way."""
    disc, qh, qlog, geo = _case(n1, 100 + n1)
    lo = disc.line_ops
    diag_geo = geo * torch.eye(3, dtype=geo.dtype).reshape(9, 1, 1)
    rng = np.random.default_rng(n1)
    tables = (tuple(torch.as_tensor(c) for c in _hex_line_coeffs(lo)),
              (torch.as_tensor(rng.standard_normal((3 * n1, n1 ** 3))),
               torch.as_tensor(rng.standard_normal((6, n1 ** 3)))))
    for d in range(3):
        for diag, g in ((True, diag_geo), (False, geo)):
            for coeffs in tables:
                got = _scheduled(qh, qlog, g, lo, d, diag, coeffs)
                want = fv.hex_fd_dir_plain(qh, qlog, g, GAMMA, line_ops=lo,
                                           d=d, diag=diag, coeffs=coeffs)
                assert _rel(got, want) <= 1e-12, (d, diag)


def test_fd_shape_refuses_bad_arguments():
    """The shape query's argument checks run before the library loads."""
    with pytest.raises(TypeError):
        fv.hex_fd_dir_shape(torch.float16, 8)
    with pytest.raises(ValueError, match="direction"):
        fv.hex_fd_dir_shape(torch.float32, 8, d=3)
    for n1 in (1, 9):
        with pytest.raises(NotImplementedError, match="N = 1..7"):
            fv.hex_fd_dir_shape(torch.float32, n1)

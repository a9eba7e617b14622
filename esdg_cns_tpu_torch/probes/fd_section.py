"""K1's flux-differencing section alone, in two bodies (row 14:
examples/r5_packed_fd_study.py).

``fd_section`` (CUDA ``csrc/fd_section.cuh``, entry ``esdg_fd_section``
in ``fd_section5.cu``) runs K1's joint line body, the three directions in
one block on K1's shared-memory tile, on given flux variables:

    qh [5, Nh, K] = (rho, u1, u2, u3, beta), qlog [2, Nh, K] =
    (log rho, log beta), geo [9, 1, K] (affine), cvol [3 N1, Nq, 1],
    cface [6, Nq, 1]  ->  [5, Nh, K]

the volume sums on rows 0..Nq-1, then the six face rows (the negated
vol-face sums), face fid at Nq + fid Nfp; no 1/w scaling, no LIFT, no
factor 2.  ``fd_section_split`` is the card's second body: the split
path's three per-direction launches of ``ops.fused_volume.hex_fd_dir``,
assembled (the volume rows summed over the directions, the face rows of
faces 2d and 2d+1 placed).  ``fd_section_plain`` is the plain version, the
sum of the split path's plain directions.  The TPU study's two bodies
(``_fd_pad8``, ``_fd_packed``) are two TPU layouts of this one function.

``study_inputs`` makes the study's inputs with NumPy from a seed
(random, non-skew coefficient tables: see ``csrc/fd_section.cuh`` on the
pair bookkeeping they pin down); ``study`` prints each body's max
difference from the plain version and its device time.

    python -m esdg_cns_tpu_torch.probes.fd_section   [N1=5 K=13824 DIAG=1]
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.fused_volume import (_DTYPE_CODE, _check_cuda, _check_shape,
                                _fd_dir_plain, _raise_on, hex_fd_dir)
from ..ops.tensor_product_fd import LineOps
from .timing import card_label, device_ms, env_int, require_cuda

GAMMA = 1.4
BUILT_N1 = (5, 6, 7)   # the line lengths the CUDA kernel is built for
_BUILT = "no kernel for this line length (N+1 = 5, 6, 7 are built)"


def study_inputs(n1, k, diag, seed=0, dtype=np.float32):
    """The study's inputs (r5_packed_fd_study.py:104-122), NumPy arrays of
    dtype: qh with rho, beta = exp(0.2 N(0,1)) and u = 0.2 N(0,1); qlog
    their logs, taken in dtype; geo [9, 1, K] with the diagonal
    0.25 + 0.01 U(0,1) and, unless diag, the entries (d, d+1 mod 3)
    0.03 U(0,1); cvol [3 n1, Nq, 1] and cface [6, Nq, 1] 0.1 N(0,1)."""
    nq, nfp = n1 ** 3, n1 * n1
    nh = nq + 6 * nfp
    rng = np.random.default_rng(seed)
    rho = np.exp(0.2 * rng.standard_normal((nh, k)))
    u = 0.2 * rng.standard_normal((3, nh, k))
    beta = np.exp(0.2 * rng.standard_normal((nh, k)))
    qh = np.concatenate([rho[None], u, beta[None]]).astype(dtype)
    qlog = np.stack([np.log(qh[0]), np.log(qh[4])])
    geo = np.zeros((9, 1, k))
    for d in range(3):
        geo[d * 3 + d] = 0.25 + 0.01 * rng.random((1, k))
        if not diag:
            geo[d * 3 + (d + 1) % 3] = 0.03 * rng.random((1, k))
    cvol = 0.1 * rng.standard_normal((3 * n1, nq, 1))
    cface = 0.1 * rng.standard_normal((6, nq, 1))
    return dict(qh=qh, qlog=qlog, geo=geo.astype(dtype),
                cvol=cvol.astype(dtype), cface=cface.astype(dtype))


def as_tensors(inputs, device, dtype=None):
    """study_inputs' arrays as tensors (qh, qlog, geo, cvol, cface)."""
    return tuple(torch.as_tensor(inputs[key], dtype=dtype, device=device)
                 for key in ("qh", "qlog", "geo", "cvol", "cface"))


@functools.lru_cache(maxsize=8)
def line_ops(n1):
    """LineOps of line length n1: the split path's wrappers take N+1 from
    it, while the study gives the coefficient tables."""
    return LineOps.make(n1 - 1)


def assemble(parts, nq):
    """Three [5, Nq + 2 Nfp, K] directions -> [5, Nh, K]."""
    vol = parts[0][:, :nq] + parts[1][:, :nq] + parts[2][:, :nq]
    return torch.cat([vol] + [p[:, nq:] for p in parts], dim=1)


def fd_section_plain(qh, qlog, geo, cvol, cface, gamma, *, n1, diag):
    """Plain PyTorch version of ``fd_section``."""
    parts = [_fd_dir_plain(qh, qlog, geo, gamma, line_ops(n1), d, diag,
                           False, (cvol, cface)) for d in range(3)]
    return assemble(parts, n1 ** 3)


def fd_section_split(qh, qlog, geo, cvol, cface, gamma, *, n1, diag):
    """The same function through the split path's three per-direction
    launches (``hex_fd_dir``), assembled with plain tensor code."""
    parts = [hex_fd_dir(qh, qlog, geo, gamma, line_ops=line_ops(n1), d=d,
                        diag=diag, coeffs=(cvol, cface)) for d in range(3)]
    return assemble(parts, n1 ** 3)


def fd_section(qh, qlog, geo, cvol, cface, gamma, *, n1, diag):
    """K1's flux-differencing section on given flux variables; see the
    module docstring for the shapes.  diag: one metric term per
    direction (axis-aligned), else the 3-term affine contraction."""
    if qh.device.type == "cpu":
        return fd_section_plain(qh, qlog, geo, cvol, cface, gamma, n1=n1,
                                diag=diag)
    if qh.device.type != "cuda":
        raise ValueError(f"fd_section: no kernel for device {qh.device}")
    name = "fd_section"
    nq, nfp, k = n1 ** 3, n1 * n1, qh.shape[-1]
    nh = nq + 6 * nfp
    tensors = {"qh": qh, "qlog": qlog, "geo": geo, "cvol": cvol,
               "cface": cface}
    _check_cuda(name, tensors, qh.dtype, qh.device)
    for key, shape in (("qh", (5, nh, k)), ("qlog", (2, nh, k)),
                       ("geo", (9, 1, k)), ("cvol", (3 * n1, nq, 1)),
                       ("cface", (6, nq, 1))):
        _check_shape(name, key, tensors[key], shape)
    out = torch.empty((5, nh, k), dtype=qh.dtype, device=qh.device)
    if k == 0:
        return out
    from ..kernels import library

    lib = library()
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream(qh.device).cuda_stream
        rc = lib.esdg_fd_section(
            _DTYPE_CODE[qh.dtype], n1, int(diag), qh.data_ptr(),
            qlog.data_ptr(), geo.data_ptr(), cvol.data_ptr(),
            cface.data_ptr(), out.data_ptr(), k, float(gamma), stream)
    _raise_on(name, rc, _BUILT)
    fd_section.launches += 1
    return out


fd_section.launches = 0


def study(n1=5, k=13824, diag=True, seed=0, device="cuda"):
    """Both bodies against the plain version on the study's inputs (f32),
    and their device times: returns {'joint', 'split': max |body - plain|
    / max |plain|, 'joint_ms', 'split_ms' (the three launches),
    'assembly_ms'}."""
    dev = require_cuda(device)
    args = as_tensors(study_inputs(n1, k, diag, seed), dev)
    kw = dict(n1=n1, diag=diag)
    plain = fd_section_plain(*args, GAMMA, **kw)
    scale = float(plain.abs().max())
    out = {body: float((fn(*args, GAMMA, **kw) - plain).abs().max()) / scale
           for body, fn in (("joint", fd_section),
                            ("split", fd_section_split))}
    lo = line_ops(n1)
    fd = lambda d: hex_fd_dir(args[0], args[1], args[2], GAMMA, line_ops=lo,
                              d=d, diag=diag, coeffs=args[3:])
    parts = [fd(d) for d in range(3)]
    out["joint_ms"] = device_ms(lambda: fd_section(*args, GAMMA, **kw), 20)
    out["split_ms"] = device_ms(lambda: [fd(d) for d in range(3)], 20)
    out["assembly_ms"] = device_ms(lambda: assemble(parts, n1 ** 3), 20)
    return out


def main():
    n1, k = env_int("N1", 5), env_int("K", 13824)
    diag = env_int("DIAG", 1) == 1
    r = study(n1, k, diag)
    print(card_label())
    print(f"n1={n1} K={k} diag={diag} f32: max |body - plain| / max |plain|"
          f": joint {r['joint']:.2e}, split {r['split']:.2e}")
    split_total = r["split_ms"] + r["assembly_ms"]
    print(f"joint fd (K1's line body): {r['joint_ms']:7.4f} ms")
    print(f"split fd (3 x hex_fd_dir): {r['split_ms']:7.4f} ms + assembly "
          f"{r['assembly_ms']:.4f} ms = {split_total:.4f} ms "
          f"({split_total / r['joint_ms']:.2f}x the joint body)")


if __name__ == "__main__":
    main()

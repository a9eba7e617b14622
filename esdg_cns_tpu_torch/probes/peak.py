"""The f32 FMA peak of the card (row 11: examples/vpu_peak.py).

``fma_peak`` (CUDA ``csrc/probes.cu`` ``esdg_probe_peak``) computes, per
element of x, the TPU probe's two FMA chains a <- a 0.999998 + x and
b <- b 0.999999 + x over iters / 2 steps from a = x, b = 0.5 x + 1, and
returns (a + b) 1e-3; ``fma_peak_plain`` is the same in PyTorch (each
step a multiply and an add, two roundings where the kernel's fmaf rounds
once).  ``measure`` times the kernel by slope and returns f32 FLOP/s (an
FMA is two).

    python -m esdg_cns_tpu_torch.probes.peak   [ITERS=512 BLOCKS=64 REPS=3
                                                INNER_LO=4 INNER_HI=24]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_volume import _raise_on
from .timing import (card_label, env_int, require_cuda, slope_rate,
                     spread)

BS = (512, 1024)   # the TPU probe's block: x is [blocks * 512, 1024]
FP32_PEAK = 67e12  # H100 SXM data sheet, f32 outside the tensor cores


def probe_input(blocks, rows, device):
    """x = 1 of shape [blocks * rows, 1024], float32 (the TPU probes')."""
    return torch.full((blocks * rows, BS[1]), 1.0, dtype=torch.float32,
                      device=device)


def check_probe_input(name, x):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x is {x.dtype}; the probes are float32")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def fma_peak_plain(x, iters):
    """Plain PyTorch version of ``fma_peak``."""
    a = x
    b = x * 0.5 + 1.0
    for _ in range(iters // 2):
        a = a * 0.999998 + x
        b = b * 0.999999 + x
    return (a + b) * 1e-3


def fma_peak(x, iters):
    """The FMA chains of the TPU probe on every element of x (float32, any
    shape): iters FMAs an element."""
    if x.device.type == "cpu":
        return fma_peak_plain(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"fma_peak: no kernel for device {x.device}")
    check_probe_input("fma_peak", x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from ..kernels import library

    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.esdg_probe_peak(x.data_ptr(), out.data_ptr(), x.numel(),
                                 int(iters), stream)
    _raise_on("fma_peak", rc)
    fma_peak.launches += 1
    return out


fma_peak.launches = 0


def rates(iters=512, blocks=64, reps=3, inner_lo=4, inner_hi=24,
          device="cuda"):
    """The `reps` slope readings of ``fma_peak`` in f32 FLOP/s."""
    x = probe_input(blocks, BS[0], require_cuda(device))
    flops = 2.0 * iters * x.numel()
    return slope_rate(lambda: fma_peak(x, iters), flops, reps=reps,
                      inner_lo=inner_lo, inner_hi=inner_hi)


def measure(iters=512, blocks=64, reps=3, inner_lo=4, inner_hi=24,
            device="cuda"):
    """The card's f32 FMA rate in FLOP/s: the median of the slope
    readings."""
    return float(np.median(rates(iters, blocks, reps, inner_lo, inner_hi,
                                 device)))


def main():
    iters, blocks = env_int("ITERS", 512), env_int("BLOCKS", 64)
    reps = env_int("REPS", 3)
    inner_lo, inner_hi = env_int("INNER_LO", 4), env_int("INNER_HI", 24)
    r = rates(iters, blocks, reps, inner_lo, inner_hi)
    med = float(np.median(r))
    print(card_label())
    print(f"blocks={blocks} iters={iters} inner={inner_lo}->{inner_hi} "
          f"block={BS[0] * BS[1] * 4 / 2 ** 20:.0f} MiB")
    print(f"FMA f32: median {med / 1e12:.3f} TFLOP/s  "
          f"(best {r.max() / 1e12:.3f}, spread {100 * spread(r):.1f}%); "
          f"{med / FP32_PEAK:.1%} of the data sheet's "
          f"{FP32_PEAK / 1e12:.0f} TFLOP/s")


if __name__ == "__main__":
    main()

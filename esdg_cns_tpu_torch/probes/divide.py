"""The cost of an f32 IEEE division in FMA issue slots (row 12:
examples/vpu_divide.py), and the four-chain frame the transcendental
probe shares.

``chain`` (CUDA ``csrc/probes.cu`` ``esdg_probe_chain``) runs, per element
of x, four chains a_i = x (0.5 + 0.1 i) + 1 through iters / 4 steps of
one map with c_i = 0.25 + 0.0625 i, and returns (a_0 + a_1 + a_2 + a_3)
0.25.  Here the kinds are the TPU probe's two: `fma`, a <- a 0.97 + c
(one FMA slot a step), and `div`, a <- x / (a + c) (an add and a
division).  ``chain_plain`` is the same in PyTorch for every kind of
``KINDS``.  ``measure`` reports slots(div) = R_fma / R_div - 1 from the
chains' iteration rates R.

    python -m esdg_cns_tpu_torch.probes.divide   [ITERS=512 BLOCKS=64 REPS=3
                                                  INNER_LO=4 INNER_HI=24]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_volume import _raise_on
from .peak import check_probe_input, probe_input
from .timing import (card_label, env_int, require_cuda, slope_rate,
                     spread)

BS = (512, 1024)   # the TPU probe's block: x is [blocks * 512, 1024]
NCHAINS = 4        # independent chains per element
# the kinds of esdg_probe_chain, in the kernel's order
# (examples/vpu_transcendental.py _STEPS)
KINDS = ("fma", "mul", "add", "div", "log", "exp", "rsqrt", "sqrt")
_STEPS = {
    "fma": lambda a, x, c: a * 0.97 + c,
    "mul": lambda a, x, c: a * (0.97 + 0.001 * c),
    "add": lambda a, x, c: a + c,
    "div": lambda a, x, c: x / (a + c),
    "log": lambda a, x, c: torch.log(a) + (2.0 + c * 0.01),
    "exp": lambda a, x, c: torch.exp(-a) + (0.5 + c * 0.01),
    "rsqrt": lambda a, x, c: torch.rsqrt(a + c),
    "sqrt": lambda a, x, c: torch.sqrt(a + 2.0 + c * 0.1),
}
DIVIDE_KINDS = ("fma", "div")


def chain_plain(x, kind, iters):
    """Plain PyTorch version of the chain probe, any kind of KINDS."""
    step = _STEPS[kind]
    cs = [0.25 + 0.0625 * i for i in range(NCHAINS)]
    chains = [x * (0.5 + 0.1 * i) + 1.0 for i in range(NCHAINS)]
    for _ in range(iters // NCHAINS):
        chains = [step(a, x, cs[i]) for i, a in enumerate(chains)]
    acc = chains[0]
    for a in chains[1:]:
        acc = acc + a
    return acc * 0.25


def launch_chain(name, x, kind, iters):
    """Launch the chain kernel of `kind` on a CUDA float32 tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    check_probe_input(name, x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from ..kernels import library

    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.esdg_probe_chain(KINDS.index(kind), x.data_ptr(),
                                  out.data_ptr(), x.numel(), int(iters),
                                  stream)
    _raise_on(name, rc)
    return out


def check_kind(name, kind, kinds):
    if kind not in kinds:
        raise ValueError(f"{name}: kind {kind!r}, expected one of {kinds}")


def chain(x, kind, iters):
    """The divide probe's chains (kind 'fma' or 'div') on every element of
    x (float32, any shape)."""
    check_kind("divide.chain", kind, DIVIDE_KINDS)
    if x.device.type == "cpu":
        return chain_plain(x, kind, iters)
    out = launch_chain("divide.chain", x, kind, iters)
    chain.launches += 1
    return out


chain.launches = 0


def chain_rates(fn, kinds, rows, iters, blocks, reps, inner_lo, inner_hi,
                device):
    """{kind: the slope readings of fn(x, kind, iters) in chain iterations
    per second} on x = 1 of [blocks * rows, 1024]."""
    x = probe_input(blocks, rows, require_cuda(device))
    work = float(iters) * x.numel()
    return {kind: slope_rate(lambda: fn(x, kind, iters), work, reps=reps,
                             inner_lo=inner_lo, inner_hi=inner_hi)
            for kind in kinds}


def slots(rates):
    """{kind: R_fma / R_kind - 1} for every kind but fma: the FMA issue
    slots of the kind's operation (the -1 removes the step's companion
    add, priced at one slot as the FMA)."""
    fma = float(np.median(rates["fma"]))
    return {k: fma / float(np.median(r)) - 1.0 for k, r in rates.items()
            if k != "fma"}


def rates(iters=512, blocks=64, reps=3, inner_lo=4, inner_hi=24,
          device="cuda"):
    """{'fma', 'div': slope readings in chain iterations per second}."""
    return chain_rates(chain, DIVIDE_KINDS, BS[0], iters, blocks, reps,
                       inner_lo, inner_hi, device)


def measure(iters=512, blocks=64, reps=3, inner_lo=4, inner_hi=24,
            device="cuda"):
    """FMA issue slots per f32 division, R_fma / R_div - 1."""
    return slots(rates(iters, blocks, reps, inner_lo, inner_hi,
                       device))["div"]


def main():
    iters, blocks = env_int("ITERS", 512), env_int("BLOCKS", 64)
    reps = env_int("REPS", 3)
    inner_lo, inner_hi = env_int("INNER_LO", 4), env_int("INNER_HI", 24)
    r = rates(iters, blocks, reps, inner_lo, inner_hi)
    fma_med, div_med = (float(np.median(r[k])) for k in DIVIDE_KINDS)
    print(card_label())
    print(f"iters={iters} blocks={blocks} chains={NCHAINS} "
          f"inner={inner_lo}->{inner_hi}")
    print(f"FMA chain:   {fma_med / 1e12:.3f} T iters/s "
          f"(spread {100 * spread(r['fma']):.1f}%)")
    print(f"DIV chain:   {div_med / 1e12:.3f} T iters/s "
          f"(spread {100 * spread(r['div']):.1f}%)")
    print(f"divide cost: {slots(r)['div']:.2f} FMA-issue slots "
          f"(chain iter = 1 add + 1 div vs 1 FMA)")


if __name__ == "__main__":
    main()

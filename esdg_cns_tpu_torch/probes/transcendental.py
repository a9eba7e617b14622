"""The costs of f32 mul, add, division, log, exp, rsqrt and sqrt in FMA
issue slots (row 13: examples/vpu_transcendental.py).

``chain`` runs the divide probe's four-chain frame (``divide.chain_plain``,
CUDA ``csrc/probes.cu`` ``esdg_probe_chain``) with one map per kind:

  fma  : a <- a 0.97 + c          (the baseline, one FMA slot a step)
  mul  : a <- a (0.97 + 0.001 c)  (with add: whether a multiply and an
  add  : a <- a + c                add each take an FMA's slot)
  div  : a <- x / (a + c)
  log  : a <- log(a) + (2 + 0.01 c)
  exp  : a <- exp(-a) + (0.5 + 0.01 c)
  rsqrt: a <- rsqrt(a + c)
  sqrt : a <- sqrt(a + 2 + 0.1 c)

slots(op) = R_fma / R_op - 1 (the -1 removes the companion add, priced at
one slot as the FMA).  The last line of the command is the JSON of the
TPU probe: {"fma_T_iters_per_s": ..., "slots": {...}}.

    python -m esdg_cns_tpu_torch.probes.transcendental
        [ITERS=512 BLOCKS=64 REPS=3 INNER_LO=4 INNER_HI=24 KINDS=fma,div,...]
"""

from __future__ import annotations

import json
import os

import numpy as np

from .divide import (KINDS, chain_plain, chain_rates, check_kind,
                     launch_chain, slots)
from .timing import card_label, env_int, spread

BS = (256, 1024)   # the TPU probe's block: x is [blocks * 256, 1024]

def chain(x, kind, iters):
    """The transcendental probe's chains of `kind` (one of KINDS) on every
    element of x (float32, any shape)."""
    check_kind("transcendental.chain", kind, KINDS)
    if x.device.type == "cpu":
        return chain_plain(x, kind, iters)
    out = launch_chain("transcendental.chain", x, kind, iters)
    chain.launches += 1
    return out


chain.launches = 0


def rates(kinds=KINDS, iters=512, blocks=64, reps=3, inner_lo=4,
          inner_hi=24, device="cuda"):
    """{kind: slope readings in chain iterations per second}; kinds must
    include 'fma', the baseline."""
    if "fma" not in kinds:
        raise ValueError("the kinds must include 'fma', the baseline")
    return chain_rates(chain, kinds, BS[0], iters, blocks, reps, inner_lo,
                       inner_hi, device)


def measure(kinds=KINDS, iters=512, blocks=64, reps=3, inner_lo=4,
            inner_hi=24, device="cuda"):
    """{kind: FMA issue slots} for every kind but fma."""
    return slots(rates(kinds, iters, blocks, reps, inner_lo, inner_hi,
                       device))


def main():
    iters, blocks = env_int("ITERS", 512), env_int("BLOCKS", 64)
    reps = env_int("REPS", 3)
    inner_lo, inner_hi = env_int("INNER_LO", 4), env_int("INNER_HI", 24)
    kinds = tuple(os.environ.get("KINDS", ",".join(KINDS)).split(","))
    print(card_label())
    r = rates(kinds, iters, blocks, reps, inner_lo, inner_hi)
    for kind, rk in r.items():
        print(f"{kind:>5} chain: {float(np.median(rk)) / 1e12:.3f} T iters/s"
              f" (spread {100 * spread(rk):.1f}%)")
    s = slots(r)
    for k, v in s.items():
        print(f"{k:>5} cost: {v:.2f} FMA-issue slots")
    print(json.dumps({"fma_T_iters_per_s": float(np.median(r["fma"])) / 1e12,
                      "slots": {k: round(v, 2) for k, v in s.items()}}))


if __name__ == "__main__":
    main()

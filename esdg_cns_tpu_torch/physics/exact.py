"""Exact solutions used as convergence and verification oracles.

Port of ``esdg_cns_tpu/physics/exact.py``:

  * the 2D isentropic vortex (reference
    examples/EntropyStableEuler/EntropyStableEuler.jl:21-35);
  * Becker's viscous shock, the 1D steady travelling wave of the
    compressible NS equations (reference
    examples/CompressibleNS/dg1D_CNS_modalESDG.jl:88-198), its velocity
    profile solved by bisection of the implicit relation.

``BeckerShock.velocity`` / ``conservative`` are the host (NumPy, f64)
forms, used for initial states; ``velocity_torch`` /
``conservative_torch`` bisect on a tensor's device and dtype, for the
time-dependent Dirichlet states a boundary condition evaluates at every
RHS (the TPU package's ``velocity_jax`` / ``conservative_jax``, a
``fori_loop`` of the same 100 halvings; here one kernel on the card,
``ops.becker_bisect``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GAMMA = 1.4


def isentropic_vortex(x, y, t, gamma=GAMMA):
    """Exact 2D Euler vortex on a domain around [0,20]x[-5,5].

    x, y: NumPy arrays or tensors (of one kind).  Returns primitive
    (rho, u, v, p) of the same kind.
    """
    exp = torch.exp if isinstance(x, torch.Tensor) else np.exp
    x0, y0, beta = 5.0, 0.0, 5.0
    r2 = (x - x0 - t) ** 2 + (y - y0) ** 2
    g = beta * exp(1.0 - r2)
    u = 1.0 - g * (y - y0) / (2 * np.pi)
    v = g * (x - x0 - t) / (2 * np.pi)
    rho = 1.0 - (1.0 / (8 * gamma * np.pi**2)) * (gamma - 1) / 2 * g**2
    rho = rho ** (1.0 / (gamma - 1))
    p = rho**gamma
    return rho, u, v, p


@dataclasses.dataclass(frozen=True)
class BeckerShock:
    """Becker's exact viscous-shock solution parameters.

    Defaults match the reference 1D CNS script
    (dg1D_CNS_modalESDG.jl:89-103): Mach 3, mu=0.1, Pr=3/4 so that the
    closed-form travelling wave exists.
    """

    gamma: float = GAMMA
    mach: float = 3.0
    mu: float = 0.1
    pr: float = 0.75
    v_inf: float = 0.2
    rho_0: float = 1.0
    v_0: float = 1.0

    @property
    def m_0(self):
        return self.rho_0 * self.v_0

    @property
    def v_1(self):
        g = self.gamma
        return (g - 1 + 2.0 / self.mach**2) / (g + 1)

    @property
    def v_01(self):
        return np.sqrt(self.v_0 * self.v_1)

    @property
    def kappa(self):
        cp = self.gamma / (self.gamma - 1)
        return self.mu * cp / self.pr

    def velocity(self, xi):
        """Solve the implicit wave profile for the velocity by bisection.

        xi = x - v_inf t (wave coordinate), NumPy, vectorized.
        """
        cv = 1.0 / (self.gamma - 1)
        lk = self.kappa / self.m_0 / cv
        v0, v1 = self.v_0, self.v_1
        a = v0 / (v0 - v1)
        b = v1 / (v0 - v1)

        def f(v, xi):
            with np.errstate(divide="ignore"):
                return -xi + 2 * lk / (self.gamma + 1) * (
                    a * np.log(v0 - v) - b * np.log(v - v1)
                )

        xi = np.asarray(xi, dtype=np.float64)
        # exact endpoints: f(v1+) = +inf, f(v0-) = -inf keeps the bracket
        # valid even when the root is within machine eps of an endpoint
        lo = np.full_like(xi, v1)
        hi = np.full_like(xi, v0)
        # f is decreasing in v; bisect to machine precision
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            pos = f(mid, xi) > 0
            lo = np.where(pos, mid, lo)
            hi = np.where(pos, hi, mid)
        return 0.5 * (lo + hi)

    def conservative(self, x, t):
        """Exact conservative state (rho, rho u, E) at (x, t), NumPy f64,
        stacked [3, ...]."""
        u = self.velocity(np.asarray(x) - self.v_inf * t)
        rho = self.m_0 / u
        e = 1.0 / (2 * self.gamma) * (
            (self.gamma + 1) / (self.gamma - 1) * self.v_01**2 - u**2
        )
        vel = self.v_inf + u
        return np.stack([rho, rho * vel, rho * (e + 0.5 * vel**2)], axis=0)

    def bisection(self, dtype):
        """The constants of ``velocity_torch``'s bisection in ``dtype``, as
        ``ops.becker_bisect`` takes them: f(v) = -xi + c2 (a log(v0 - v) -
        b log(v - v1)), bracketed 4 ulps inside (v1, v0), so both
        logarithms stay finite in the working type (Python floats: the
        tensor's dtype carries the arithmetic)."""
        cv = 1.0 / (self.gamma - 1)
        lk = float(self.kappa / self.m_0 / cv)
        v0, v1 = float(self.v_0), float(self.v_1)
        eps = torch.finfo(dtype).eps
        return dict(a=v0 / (v0 - v1), b=v1 / (v0 - v1),
                    c2=2 * lk / (self.gamma + 1), v0=v0, v1=v1,
                    lo=v1 * (1 + 4 * eps), hi=v0 * (1 - 4 * eps))

    def velocity_torch(self, xi):
        """``velocity`` on a tensor's device and dtype: 100 halvings of
        ``bisection``'s bracket; one kernel on the card
        (``ops.becker_bisect``), the eager loop on the CPU."""
        from ..ops.becker_bisect import becker_bisect

        return becker_bisect(xi, **self.bisection(xi.dtype))

    def conservative_torch(self, x, t):
        """``conservative`` on a tensor's device and dtype, stacked
        [3, ...]."""
        u = self.velocity_torch(x - float(self.v_inf) * t)
        rho = float(self.m_0) / u
        e = 1.0 / (2 * self.gamma) * (
            (self.gamma + 1) / (self.gamma - 1) * float(self.v_01) ** 2
            - u**2
        )
        vel = float(self.v_inf) + u
        return torch.stack([rho, rho * vel, rho * (e + 0.5 * vel**2)])

"""Compressible Euler constitutive maps and entropy-conservative fluxes.

Port of ``esdg_cns_tpu/physics/euler.py``: the same formulas in the same
evaluation order, on torch tensors.  Dimension-generic (1D/2D/3D
inferred from field count), shape-agnostic functions on stacked field
arrays ``U[f, ...]`` with ``f = dim + 2`` conservative fields
(rho, rho*u_1..d, E).

Chandrashekar-type EC fluxes in (rho, u, beta) variables with
logarithmic means, the entropy-variable maps v(U)/U(v), and the
Lax-Friedrichs wavespeed |u_n| + c.  ``logmean`` uses the exact Taylor
expansion of L = (aR-aL)/(log aR - log aL) near aL ~ aR (coefficients
1/12, 1/80, 1/448 of v = ((aR-aL)/aavg)^2) below a dtype-dependent
switch point.
"""

from __future__ import annotations

import torch

GAMMA = 1.4


def _logmean_parts(a_l, a_r, log_l, log_r):
    """(numerator, denominator) of the stable logarithmic mean.

    Branchless series/exact select with a SINGLE division deferred to
    the caller: L = num/den with num = aavg (series branch, safe at
    aL == aR) or da (exact branch), den = the series polynomial or the
    log difference.  Selecting before the division keeps 0/0 out of the
    untaken branch at aL == aR.
    """
    da = a_r - a_l
    aavg = 0.5 * (a_r + a_l)
    v = (da * da) / (aavg * aavg)
    eps = torch.finfo(torch.promote_types(a_l.dtype, a_r.dtype)).eps
    cutoff = (1e-2 if eps < 1e-10 else 1e-1) ** 2
    use_series = v < cutoff
    # L = aavg / (1 + v/12 + v^2/80 + v^3/448): exact expansion of
    # 2f / log((1+f/2)/(1-f/2)) in v = f^2
    poly = 1.0 + v * (1.0 / 12.0 + v * (1.0 / 80.0 + v / 448.0))
    num = torch.where(use_series, aavg, da)
    den = torch.where(use_series, poly, log_r - log_l)
    return num, den


def logmean(a_l, a_r, log_l=None, log_r=None):
    """Stable logarithmic mean (aR - aL) / (log aR - log aL).

    Series for |aR-aL|/aavg below a dtype-dependent cutoff (1e-2 for
    f64, 1e-1 for f32), exact ratio otherwise, with safe num/den selects
    so no NaN enters the untaken branch (important for autograd).
    """
    if log_l is None:
        log_l = torch.log(a_l)
    if log_r is None:
        log_r = torch.log(a_r)
    num, den = _logmean_parts(a_l, a_r, log_l, log_r)
    return num / den


# -----------------------------------------------------------------------------
# conservative-variable constitutive maps
# -----------------------------------------------------------------------------

def _split(u):
    """U[f,...] -> (rho, mom[d,...], E)."""
    return u[0], u[1:-1], u[u.shape[0] - 1]


def pfun(u, gamma=GAMMA):
    """Pressure p = (gamma-1) (E - |rho u|^2 / (2 rho))."""
    rho, mom, e = _split(u)
    return (gamma - 1.0) * (e - 0.5 * torch.sum(mom * mom, dim=0) / rho)


def betafun(u, gamma=GAMMA):
    """Inverse temperature beta = rho / (2p)."""
    return _split(u)[0] / (2.0 * pfun(u, gamma))


def sfun(u, gamma=GAMMA):
    """Specific physical entropy s = log(p / rho^gamma)."""
    rho = u[0]
    return torch.log(pfun(u, gamma)) - gamma * torch.log(rho)


def entropy_fun(u, gamma=GAMMA):
    """Mathematical entropy S(U) = -rho s."""
    return -u[0] * sfun(u, gamma)


# Optional constant rescaling of the entropy variables (reference
# EntropyStableEuler.jl:18-24); the default 1.0 matches the packaged
# module's shipped value.
ENTROPY_SCALING = 1.0


def v_ufun(u, gamma=GAMMA, scaling=ENTROPY_SCALING):
    """Entropy variables V = scaling * dS/dU, stacked [f, ...]."""
    rho, mom, e = _split(u)
    p = pfun(u, gamma)
    s = sfun(u, gamma)
    v1 = (gamma + 1.0 - s) - (gamma - 1.0) * e / p
    vmom = (gamma - 1.0) * mom / p
    ve = -(gamma - 1.0) * rho / p
    v = torch.cat([v1[None], vmom, ve[None]], dim=0)
    return v if scaling == 1.0 else scaling * v


def u_vfun(v, gamma=GAMMA, scaling=ENTROPY_SCALING):
    """Conservative variables from entropy variables (inverse of v_ufun)."""
    if scaling != 1.0:
        v = v / scaling
    v1, vmom, ve = _split(v)
    vnorm = torch.sum(vmom * vmom, dim=0)
    s = gamma - v1 + vnorm / (2.0 * ve)
    rhoe = ((gamma - 1.0) / (-ve) ** gamma) ** (1.0 / (gamma - 1.0)) \
        * torch.exp(-s / (gamma - 1.0))
    rho = rhoe * (-ve)
    mom = rhoe * vmom
    e = rhoe * (1.0 - vnorm / (2.0 * ve))
    return torch.cat([rho[None], mom, e[None]], dim=0)


def primitive_to_conservative(rho, vel, p, gamma=GAMMA):
    """(rho, vel[d,...], p) -> stacked conservative U[f,...]."""
    mom = rho * vel
    e = p / (gamma - 1.0) + 0.5 * rho * torch.sum(vel * vel, dim=0)
    return torch.cat([rho[None], mom, e[None]], dim=0)


def conservative_to_primitive_beta(u, gamma=GAMMA):
    """U -> stacked flux variables Q = (rho, u_1..d, beta)."""
    rho, mom, _ = _split(u)
    return torch.cat([rho[None], mom / rho, betafun(u, gamma)[None]], dim=0)


def wavespeed(rho, rhou_n, e, gamma=GAMMA):
    """|u_n| + c for Lax-Friedrichs penalties (euler_fluxes_1D.jl:7-12)."""
    un = rhou_n / rho
    p = (gamma - 1.0) * (e - 0.5 * rho * un * un)
    return torch.abs(un) + torch.sqrt(gamma * p / rho)


def euler_flux(u, gamma=GAMMA):
    """Exact flux tuple (F_1, .., F_d), each stacked [f, ...]."""
    rho, mom, e = _split(u)
    p = pfun(u, gamma)
    vel = mom / rho
    dim = mom.shape[0]
    fluxes = []
    for d in range(dim):
        fmom = [mom[j] * vel[d] + (p if j == d else 0.0) for j in range(dim)]
        fe = vel[d] * (e + p)
        fluxes.append(torch.stack([mom[d], *fmom, fe], dim=0))
    return tuple(fluxes)


def psi_fun(u, gamma=GAMMA):
    """Entropy potential psi_d = (gamma-1) rho u_d (Tadmor condition)."""
    _, mom, _ = _split(u)
    return (gamma - 1.0) * mom


# -----------------------------------------------------------------------------
# entropy-conservative two-point fluxes (Chandrashekar)
# -----------------------------------------------------------------------------

def ec_flux_fields(ql_fields, qr_fields, logs_l, logs_r, gamma=GAMMA,
                   dirs=None):
    """EC two-point flux on unstacked field tuples.

    Args:
      ql_fields / qr_fields: tuples (rho, u_1..d, beta) of broadcastable
        tensors; logs_l / logs_r: tuples (log rho, log beta).
      dirs: optional tuple of direction indices to emit (default: all).
        On axis-aligned meshes the metric contraction needs only ONE
        direction per line/face.

    Returns a tuple over the requested directions of per-field tuples
    ((f_rho, f_mom..., f_e), ...).
    """
    rho_l, *vel_l, beta_l = ql_fields
    rho_r, *vel_r, beta_r = qr_fields
    dim = len(vel_l)
    if dirs is None:
        dirs = tuple(range(dim))

    rholog = logmean(rho_l, rho_r, logs_l[0], logs_r[0])
    # beta's logarithmic mean enters only through its RECIPROCAL, so
    # invert the num/den select instead of dividing twice
    bnum, bden = _logmean_parts(beta_l, beta_r, logs_l[1], logs_r[1])
    inv_betalog = bden / bnum

    rhoavg = 0.5 * (rho_l + rho_r)
    velavg = [0.5 * (a + b) for a, b in zip(vel_l, vel_r)]
    vel_dot = sum(a * b for a, b in zip(vel_l, vel_r))
    pa = rhoavg / (beta_l + beta_r)
    e_plus_p = (rholog * inv_betalog) * (0.5 / (gamma - 1.0)) \
        + pa + 0.5 * rholog * vel_dot

    fluxes = []
    for d in dirs:
        f1 = rholog * velavg[d]
        fmom = [f1 * velavg[j] + (pa if j == d else 0.0) for j in range(dim)]
        fe = e_plus_p * velavg[d]
        fluxes.append((f1, *fmom, fe))
    return tuple(fluxes)


def ec_flux(q_l, q_r, qlog_l=None, qlog_r=None, gamma=GAMMA):
    """Entropy-conservative two-point flux.

    Args:
      q_l, q_r: stacked flux variables [f, ...] = (rho, u_1..d, beta).
      qlog_l, qlog_r: optional precomputed (log rho, log beta) pairs,
        stacked [2, ...].

    Returns tuple of d stacked flux arrays (FxS, [FyS, [FzS]]).
    """
    nf = q_l.shape[0]
    ql_fields = tuple(q_l[i] for i in range(nf))
    qr_fields = tuple(q_r[i] for i in range(nf))
    logs_l = (
        (torch.log(q_l[0]), torch.log(q_l[nf - 1])) if qlog_l is None
        else (qlog_l[0], qlog_l[1])
    )
    logs_r = (
        (torch.log(q_r[0]), torch.log(q_r[nf - 1])) if qlog_r is None
        else (qlog_r[0], qlog_r[1])
    )
    fluxes = ec_flux_fields(ql_fields, qr_fields, logs_l, logs_r, gamma)
    return tuple(torch.stack(f, dim=0) for f in fluxes)

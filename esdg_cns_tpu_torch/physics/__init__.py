"""Physics: Euler constitutive maps and EC fluxes, CNS viscous fluxes."""

from .euler import (
    GAMMA,
    betafun,
    conservative_to_primitive_beta,
    ec_flux,
    ec_flux_fields,
    entropy_fun,
    euler_flux,
    logmean,
    pfun,
    primitive_to_conservative,
    psi_fun,
    sfun,
    u_vfun,
    v_ufun,
    wavespeed,
)
from .viscous import (
    viscous_flux_1d,
    viscous_flux_2d,
    viscous_flux_3d,
    viscous_flux_nd,
)

__all__ = [
    "GAMMA",
    "betafun",
    "conservative_to_primitive_beta",
    "ec_flux",
    "ec_flux_fields",
    "entropy_fun",
    "euler_flux",
    "logmean",
    "pfun",
    "primitive_to_conservative",
    "psi_fun",
    "sfun",
    "u_vfun",
    "v_ufun",
    "viscous_flux_1d",
    "viscous_flux_2d",
    "viscous_flux_3d",
    "viscous_flux_nd",
    "wavespeed",
]

"""LSRK45 (Carpenter & Kennedy), one fixed step a call: the port's
``timestepping.explicit.lsrk45`` and the reference's own step."""

from h100_bench import reference

STAGES = 5


def step(rhs, q, dt, t):
    """One step of the program's LSRK45 from (q, t)."""
    from esdg_cns_tpu_torch.timestepping import explicit

    return explicit.lsrk45(rhs, q, dt, 1, t0=t)[0]


def reference_step(rhs, q, dt, t):
    """One step of the reference's LSRK45 from (q, t)."""
    return reference.lsrk45_step(rhs, q, dt, t)

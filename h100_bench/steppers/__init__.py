"""The time steppers a configuration can name (its ``stepper`` key): each
module here holds ``STAGES`` (RHS calls a step), ``step(rhs, q, dt, t)``,
one step of the program's stepper with the port's ``rhs(q, t) -> (dq,
aux)``, and ``reference_step(rhs, q, dt, t)``, the same step in plain
PyTorch with ``rhs(q, t) -> dq``."""

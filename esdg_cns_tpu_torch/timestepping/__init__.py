"""Explicit time integrators."""

from .explicit import lsrk45, ssprk33

__all__ = ["lsrk45", "ssprk33"]

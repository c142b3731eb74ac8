"""MILP repair of the port (host code over scipy's HiGHS)."""

from .engine import LinearRows, SatAttack

__all__ = ["SatAttack", "LinearRows"]

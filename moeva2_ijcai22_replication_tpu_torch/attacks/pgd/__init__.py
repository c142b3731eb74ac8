"""Constrained PGD (port of ``attacks/pgd``; AutoPGD is not ported yet)."""

from .engine import ConstrainedPGD, round_ints_toward_initial

__all__ = ["ConstrainedPGD", "round_ints_toward_initial"]

"""Constrained PGD and AutoPGD (port of ``attacks/pgd``)."""

from .autopgd import AutoPGD
from .engine import ConstrainedPGD, round_ints_toward_initial

__all__ = ["AutoPGD", "ConstrainedPGD", "round_ints_toward_initial"]

"""MoEvA2 of the port."""

from .engine import Moeva2, MoevaResult

__all__ = ["Moeva2", "MoevaResult"]

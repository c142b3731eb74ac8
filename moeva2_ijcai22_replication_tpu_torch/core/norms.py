"""Lp norms: one home for norm-membership dispatch (2 and inf supported).

Port of ``moeva2_ijcai22_replication_tpu/core/norms.py`` (the parts the MoEvA
path uses).
"""

from __future__ import annotations

import numpy as np
import torch

_INF_ALIASES = (np.inf, "inf", "linf")
_L2_ALIASES = (2, "2", 2.0)


def is_inf(norm) -> bool:
    return norm in _INF_ALIASES


def is_l2(norm) -> bool:
    return norm in _L2_ALIASES


def validate_norm(norm):
    if not (is_inf(norm) or is_l2(norm)):
        raise NotImplementedError(f"Unsupported norm: {norm!r} (use 2 or inf)")
    return norm


def lp_distance(diff: torch.Tensor, norm) -> torch.Tensor:
    """Per-row Lp norm over the trailing axis."""
    if is_inf(norm):
        return torch.abs(diff).amax(-1)
    if is_l2(norm):
        return torch.sqrt((diff * diff).sum(-1))
    raise NotImplementedError(f"Unsupported norm: {norm!r}")

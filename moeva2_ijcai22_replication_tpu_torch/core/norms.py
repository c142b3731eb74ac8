"""Lp norms: one home for norm-membership dispatch (2 and inf supported).

Port of ``moeva2_ijcai22_replication_tpu/core/norms.py``. Its sums run left
to right and its square roots are correctly rounded (:func:`sum_last`,
:func:`sqrt_rn`), so that a kernel can reproduce them bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_INF_ALIASES = (np.inf, "inf", "linf")
_L2_ALIASES = (2, "2", 2.0)
_L1_ALIASES = (1, "1", 1.0)


def is_inf(norm) -> bool:
    return norm in _INF_ALIASES


def is_l2(norm) -> bool:
    return norm in _L2_ALIASES


def validate_norm(norm):
    if not (is_inf(norm) or is_l2(norm)):
        raise NotImplementedError(f"Unsupported norm: {norm!r} (use 2 or inf)")
    return norm


def sum_last(t, keepdim=False):
    """Sum over the last axis, left to right, one rounded add at a time. A
    reduction kernel adds in another order on the card than on the CPU, and
    one ulp in a survival direction moves dist by ~1e-5 (dist cancels near a
    direction); this order gives the same bits on both."""
    out = t[..., 0]
    for k in range(1, t.shape[-1]):
        out = out + t[..., k]
    return out[..., None] if keepdim else out


def sqrt_rn(t):
    """Correctly rounded sqrt, the kernel's ``sqrtf``: PyTorch's float32
    sqrt on an AVX-512 CPU is off by one ulp on some arguments, while a
    float64 sqrt rounded once to float32 is correctly rounded."""
    return torch.sqrt(t.double()).to(t.dtype)


def lp_distance(diff: torch.Tensor, norm) -> torch.Tensor:
    """Per-row Lp norm over the trailing axis."""
    if is_inf(norm):
        return torch.abs(diff).amax(-1)
    if is_l2(norm):
        return torch.sqrt((diff * diff).sum(-1))
    raise NotImplementedError(f"Unsupported norm: {norm!r}")


def _scalar(like: torch.Tensor, v) -> torch.Tensor:
    # a 0-d tensor: dividing by it is a true division on the card too
    return torch.full((), v, dtype=like.dtype, device=like.device)


def project_ball(delta: torch.Tensor, eps, norm) -> torch.Tensor:
    """Project perturbations into the ε-ball (ART ``_projection`` parity):
    clip under L∞, ``delta * min(1, ε / (‖delta‖ + 1e-12))`` under L2."""
    if is_inf(norm):
        return torch.clamp(delta, -eps, eps)
    if is_l2(norm):
        nrm = sqrt_rn(sum_last(delta * delta, keepdim=True))
        return delta * torch.minimum(_scalar(delta, 1.0), _scalar(delta, eps) / (nrm + 1e-12))
    raise NotImplementedError(f"Unsupported norm: {norm!r}")


def condition_grad(grad: torch.Tensor, norm) -> torch.Tensor:
    """Norm-condition gradients for the ascent step (``atk.py:239-261``):
    the sign under L∞ (0 for ±0, NaN for NaN), ``grad / (‖grad‖ + 1e-7)``
    under L1 and L2."""
    tol = 1e-7
    if is_inf(norm):
        return torch.where(grad > 0, 1.0, torch.where(grad < 0, -1.0, torch.where(grad == 0, 0.0, grad)))
    if norm in _L1_ALIASES:
        return grad / (sum_last(torch.abs(grad), keepdim=True) + tol)
    if is_l2(norm):
        return grad / (sqrt_rn(sum_last(grad * grad, keepdim=True)) + tol)
    raise NotImplementedError(f"Unsupported norm: {norm!r}")

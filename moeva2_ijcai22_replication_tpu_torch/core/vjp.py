"""Hand-written cotangents of the operations the constraint terms use, with
``jax.grad``'s conventions at their edges.

Constrained PGD differentiates a domain's smooth violations by hand (a
set's ``smooth_vjp``) so that its kernels can repeat the backward one
rounded operation at a time. These are the rules every domain shares;
they were pinned against ``jax.grad`` in float64 on jax 0.9.0.
"""

from __future__ import annotations

import torch


def abs_vjp(v, ct):
    """``jax.grad``'s abs: the cotangent where ``v >= 0`` (so at ±0 and
    +inf), its negation elsewhere (-inf and NaN)."""
    return torch.where(v >= 0, ct, -ct)


def clip_vjp(v, ct):
    """``jnp.clip(v, 0, inf)``'s cotangent as ``jax.grad`` takes it: the
    product of ``ct`` with minimum's balanced factor (0.5 at +inf, 0 at NaN,
    else 1) and then with maximum's (1 above 0, 0.5 at ±0, else 0). A NaN
    or infinite ``ct`` stays NaN where a factor is 0."""
    lo = torch.where(v == torch.inf, 0.5, torch.where(torch.isnan(v), 0.0, 1.0)).to(ct.dtype)
    hi = torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0)).to(ct.dtype)
    return ct * lo * hi


def div_vjp(ct, num, den):
    """(numerator's, denominator's) cotangents of ``num / den`` as JAX's
    rules give them: ``ct / den`` and ``-((ct * (1 / (den * den))) * num)``."""
    one = torch.ones((), dtype=den.dtype, device=den.device)
    return ct / den, -((ct * (one / (den * den))) * num)

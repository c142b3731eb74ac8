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


def neg_vjp(ct):
    """``-a``'s cotangent: ``-ct``."""
    return -ct


def months_vjp(ct):
    """The month count ``floor(f / 100) * 12 + f mod 100``'s cotangent, as
    ``jax.grad`` takes it: ``ct`` through the remainder (whose derivative in
    its dividend is 1) and an exact zero through ``floor`` (a symbolic zero:
    no product is taken, so a NaN ``ct`` is not multiplied by 12). JAX's
    remainder passes ``ct`` through a ``where`` and adds its two branches,
    so a -0 cotangent comes out +0 there: no feature's cotangent can tell,
    as each sums its contributions from +0."""
    return ct


def pow_base_jac(base, t):
    """``d (base ** t) / d base`` as ``jax.lax.pow`` takes it for a float
    exponent, ``t * base ** (t - 1)``, in float64 and rounded once to the
    base's dtype."""
    b64, t64 = base.double(), t.double()
    return (t64 * torch.pow(b64, t64 - 1.0)).to(base.dtype)


def pow_exp_jac(base, t):
    """``d (base ** t) / d t`` as ``jax.lax.pow`` takes it, ``log(base) *
    base ** t`` with a 0 base's log taken at 1, in float64 and rounded once
    to the exponent's dtype."""
    b64, t64 = base.double(), t.double()
    return (torch.log(torch.where(b64 == 0, 1.0, b64)) * torch.pow(b64, t64)).to(t.dtype)


def guarded_div_vjp(ct, num, den, finite: bool):
    """(numerator's, denominator's) cotangents of ``safe_div(num, den, s) =
    where(ok, num / where(ok, den, 1), s)``, ``ok = den != 0`` (and of
    ``finite_div``, which also keeps ``s`` where the quotient is not
    finite): each ``where`` passes the cotangent to the branch it took and
    an exact 0 to the other, so the division gets ``ct`` where ``ok`` (and
    the quotient is finite) and 0 elsewhere, and the denominator the
    division's cotangent where ``ok`` and 0 elsewhere."""
    ok = den != 0
    take = ok & torch.isfinite(num / den) if finite else ok
    c_q = torch.where(take, ct, 0.0)
    c_num, c_den = div_vjp(c_q, num, torch.where(ok, den, 1.0))
    return c_num, torch.where(ok, c_den, 0.0)


def member_vjp(ct, factors):
    """The cotangents of the factors ``f_k = v_k - x`` of the member product
    ``f_0 * f_1 * ... * f_K`` (left-associated) from ``ct``, that of the
    product, in factor order: each partial product ``p_k = p_{k-1} * f_k``
    passes ``ct_k * f_k`` to ``p_{k-1}`` and ``p_{k-1} * ct_k`` to ``f_k``
    (JAX's mul transposes). ``x`` then takes ``-ct_{f_k}`` from each."""
    partial = [factors[0]]
    for f in factors[1:-1]:
        partial.append(partial[-1] * f)
    out = [None] * len(factors)
    for k in range(len(factors) - 1, 0, -1):
        out[k] = partial[k - 1] * ct
        ct = ct * factors[k]
    out[0] = ct
    return out


def literal_term_vjp(ct):
    """A literal-only term ``v + 0.0 * x[..., 0]``'s cotangent of feature 0,
    ``0.0 * ct`` (a NaN or infinite ``ct`` gives NaN there, as under
    ``jax.grad``)."""
    return torch.zeros((), dtype=ct.dtype, device=ct.device) * ct

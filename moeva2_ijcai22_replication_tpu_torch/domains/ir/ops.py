"""Shared numeric operator definitions for the constraint IR.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/ops.py``. Every operator
the constraint language uses more than once is defined here once, with a
numpy/torch dispatch on the input type: numpy for host values (arrays,
numpy scalars, Python numbers), torch for tensors. The spec evaluator, the
hand-written LCLD domain, the synthetic samplers and the plain interpreter
of kernel K9's programs all call these definitions.

The torch forms keep the port's order of operations (kernels K1, K8 and K9
repeat them): a division by a constant is a true division by a 0-d tensor
(PyTorch on CUDA turns ``t / c`` into ``t * (1 / c)``), and ``pow`` runs in
float64 and is rounded once to the rows' dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_host(value) -> bool:
    return isinstance(value, (np.ndarray, np.generic, float, int))


def literal(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` rounded once to ``like``'s dtype, as a 0-d tensor on its device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def months(date_feature):
    """YYYYMM integer-coded date -> month count: floor(f/100)*12 + f mod 100.

    On tensors the divisor is a 0-d 100, so the division is a true one on the
    card too, and the remainder is PyTorch's, as kernel K1's ``lcld_months``
    computes them (``kernels/csrc/kernels.h``)."""
    if _is_host(date_feature):
        return np.floor(date_feature / 100.0) * 12.0 + np.mod(date_feature, 100.0)
    hundred = literal(date_feature, 100.0)
    return torch.floor(date_feature / hundred) * 12.0 + torch.remainder(date_feature, hundred)


def safe_div(num, den, sentinel):
    """Guarded division: ``num / den`` where ``den != 0``, else ``sentinel``:
    one mask, the denominator replaced by 1 under it, so the division
    produces no inf or NaN on the guarded lanes (the botnet ratio guard)."""
    if _is_host(den):
        ok = den != 0
        return np.where(ok, num / np.where(ok, den, 1.0), sentinel)
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), sentinel)


def finite_div(num, den, sentinel):
    """:func:`safe_div`, then any inf or NaN result also mapped to
    ``sentinel`` (LCLD's g10: a 0/0 must not leak a NaN into the term)."""
    if _is_host(den):
        ok = den != 0
        ratio = np.where(ok, num / np.where(ok, den, 1.0), sentinel)
        return np.where(np.isfinite(ratio), ratio, sentinel)
    ok = den != 0
    ratio = torch.where(ok, num / torch.where(ok, den, 1.0), sentinel)
    return torch.where(torch.isfinite(ratio), ratio, sentinel)


def pow_rn(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """``base ** exponent`` in float64, rounded once to ``base``'s dtype.
    Both operands are expanded to the rows' shape, so PyTorch takes its
    elementwise ``pow`` (its scalar-exponent shortcuts square or multiply
    instead) on every device, as kernels K1 and K9 call ``pow``."""
    shape = torch.broadcast_shapes(base.shape, exponent.shape)
    return torch.pow(base.double().expand(shape), exponent.double().expand(shape)).to(base.dtype)

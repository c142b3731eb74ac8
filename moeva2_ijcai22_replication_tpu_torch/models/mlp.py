"""Surrogate classifiers: a dense relu stack with a logit head.

Port of ``models/mlp.py``. Weights use PyTorch's ``nn.Linear`` layout,
``(out, in)``; Flax stores kernels as ``(in, out)``, so
:func:`..io.params_from_numpy` transposes them on the way in.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..core.norms import sum_last


class MLP(nn.Module):
    """Dense relu stack with a linear (logit) head."""

    def __init__(self, n_features: int, hidden: Sequence[int], n_classes: int = 2):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.n_classes = int(n_classes)
        widths = (int(n_features), *self.hidden, self.n_classes)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)

    @torch.no_grad()
    def reset_parameters_seeded(self, seed: int) -> "MLP":
        """Re-draw every weight from ``seed``: truncated-normal kernels with
        variance 1/fan_in (Flax's default ``lecun_normal``) and zero biases."""
        gen = torch.Generator().manual_seed(int(seed))
        for layer in self.layers:
            # stddev of a unit normal truncated to [-2, 2]
            std = 1.0 / math.sqrt(layer.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            nn.init.zeros_(layer.bias)
        return self


def lcld_mlp(n_features: int = 47, seed: int | None = None) -> MLP:
    """The LCLD surrogate topology (64-32-16-2); seeded weights if ``seed``."""
    model = MLP(n_features, hidden=(64, 32, 16))
    return model if seed is None else model.reset_parameters_seeded(seed)


def botnet_mlp(n_features: int = 756, seed: int | None = None) -> MLP:
    """The botnet surrogate topology (64-64-32-2); seeded weights if ``seed``."""
    model = MLP(n_features, hidden=(64, 64, 32))
    return model if seed is None else model.reset_parameters_seeded(seed)


def mlp_forward_plain(layers, x: torch.Tensor, sequential: bool | None = None) -> list:
    """Activations ``[x, h1, ..., logits]`` of the relu stack ``layers``
    (``((weight (out, in), bias (out,)), ...)``) in kernel K1's order: each
    unit starts from its bias and adds ``weight[k] * x[k]`` for k = 0, 1,
    ... one rounded operation at a time; relu keeps a NaN. ``sequential``
    None takes that order in float32 and one matmul a layer in float64,
    which K1 does not compute; True takes it in any dtype (K16's float64
    order)."""
    if sequential is None:
        sequential = x.dtype != torch.float64
    acts = [x]
    a = x
    for i, (w, b) in enumerate(layers):
        if sequential:
            acc = b.expand(*a.shape[:-1], b.shape[0])
            for k in range(w.shape[1]):
                acc = acc + a[..., k, None] * w[:, k]
        else:
            acc = torch.nn.functional.linear(a, w, b)
        a = torch.relu(acc) if i < len(layers) - 1 else acc
        acts.append(a)
    return acts


def exp_rn(t: torch.Tensor) -> torch.Tensor:
    """``exp`` in float64, rounded once to ``t``'s dtype: the same bits on
    the card, on the CPU and in kernel K1."""
    return torch.exp(t.double()).to(t.dtype)


def mlp_proba_plain(layers, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities of the relu stack ``layers``, its logits as
    :func:`mlp_forward_plain` gives them (K1's order in float32); softmax as
    ``exp(l - max)`` over the left-to-right sum, a 1-column (sigmoid) head
    as ``[1 - p, p]``."""
    a = mlp_forward_plain(layers, x)[-1]
    if a.shape[-1] == 1:
        p = 1.0 / (1.0 + exp_rn(-a))
        return torch.cat([1.0 - p, p], dim=-1)
    e = exp_rn(a - a.amax(-1, keepdim=True))
    return e / sum_last(e, keepdim=True)


def proba1_plain(layers, x: torch.Tensor) -> torch.Tensor:
    """The class-1 probabilities (N,) of the relu stack ``layers`` at the
    rows ``x`` (N, D), kernel K16's float64 order in any dtype: the logits
    of :func:`mlp_forward_plain` with ``sequential``, then e1 / (e0 + e1)
    with e = exp(l - max), or 1 / (1 + exp(-l)) for a 1-unit head."""
    a = mlp_forward_plain(layers, x, sequential=True)[-1]
    if a.shape[-1] == 1:
        return 1.0 / (1.0 + torch.exp(-a[..., 0]))
    mx = torch.maximum(a[..., 0], a[..., 1])
    e0, e1 = torch.exp(a[..., 0] - mx), torch.exp(a[..., 1] - mx)
    return e1 / (e0 + e1)


def mlp_input_grad_plain(layers, acts: list, ct: torch.Tensor) -> torch.Tensor:
    """The cotangent of the stack's input from ``ct``, that of its logits,
    and the activations :func:`mlp_forward_plain` gave: a hidden unit passes
    its cotangent where its output is above 0 and 0 elsewhere (``jax.nn.
    relu``'s select: 0 at 0, and a NaN cotangent stops there); in float32
    each input unit k sums ``weight[o, k] * ct[o]`` for o = 0, 1, ... one
    rounded operation at a time (float64 takes one matmul per layer)."""
    for i in range(len(layers) - 1, -1, -1):
        w = layers[i][0]
        if i < len(layers) - 1:
            ct = torch.where(acts[i + 1] > 0, ct, 0.0)
        if ct.dtype == torch.float64:
            ct = ct @ w
        else:
            out = ct[..., 0, None] * w[0]
            for o in range(1, w.shape[0]):
                out = out + ct[..., o, None] * w[o]
            ct = out
    return ct


def predict_proba(model: MLP, x: torch.Tensor) -> torch.Tensor:
    logits = model(x)
    if logits.shape[-1] == 1:  # sigmoid head
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)

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


def predict_proba(model: MLP, x: torch.Tensor) -> torch.Tensor:
    logits = model(x)
    if logits.shape[-1] == 1:  # sigmoid head
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)

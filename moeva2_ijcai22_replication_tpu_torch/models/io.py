"""Surrogate wrapper and the reader of the JAX package's ``.msgpack`` params.

Port of ``models/io.py``. The file format (``io.py::save_params``) is an
``np.save`` int64 topology header (hidden sizes, then n_classes) followed by
Flax's msgpack bytes of ``{"params": {"Dense_i": {"kernel", "bias"}}}``,
where each array is a msgpack ext of type 1 holding ``(shape, dtype name,
C-order bytes)``. It is read here with ``msgpack`` alone, without Flax.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mlp import MLP, predict_proba

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


@dataclass
class Surrogate:
    """A classifier: an :class:`MLP` behind the reference's duck-typed
    ``Classifier`` interface."""

    model: MLP

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        # a sigmoid head's one column expands to two
        probs = predict_proba(self.model, x)
        if probs.shape[-1] == 1:
            probs = torch.cat([1.0 - probs, probs], dim=-1)
        return probs


def params_from_numpy(tree: dict, dtype=torch.float32) -> MLP:
    """An :class:`MLP` carrying the JAX package's params tree
    ``{"params": {"Dense_i": {"kernel" (in, out), "bias" (out,)}}}``;
    kernels are transposed into ``nn.Linear``'s ``(out, in)`` layout."""
    layers = tree["params"]
    names = sorted(layers, key=lambda k: int(k.split("_")[1]))
    kernels = [np.asarray(layers[n]["kernel"]) for n in names]
    biases = [np.asarray(layers[n]["bias"]) for n in names]
    model = MLP(
        kernels[0].shape[0],
        hidden=[k.shape[1] for k in kernels[:-1]],
        n_classes=kernels[-1].shape[1],
    ).to(dtype)
    with torch.no_grad():
        for layer, k, b in zip(model.layers, kernels, biases):
            layer.weight.copy_(torch.as_tensor(k.T.copy(), dtype=dtype))
            layer.bias.copy_(torch.as_tensor(b.copy(), dtype=dtype))
    return model


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def load_params(path: str, dtype=torch.float32) -> Surrogate:
    """Read a ``.msgpack`` written by the JAX package's ``save_params``."""
    import msgpack

    with open(path, "rb") as f:
        meta = np.load(f)
        raw = f.read()
    tree = msgpack.unpackb(raw, ext_hook=_ext_hook, raw=False)
    model = params_from_numpy(tree, dtype=dtype)
    hidden, n_classes = tuple(int(v) for v in meta[:-1]), int(meta[-1])
    if model.hidden != hidden or model.n_classes != n_classes:
        raise ValueError(
            f"{path}: header topology {hidden}+{n_classes} does not match the "
            f"stored layers {model.hidden}+{model.n_classes}"
        )
    return Surrogate(model)

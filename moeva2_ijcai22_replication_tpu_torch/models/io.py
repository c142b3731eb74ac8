"""Surrogate wrapper and the JAX package's ``.msgpack`` params, both ways.

Port of ``models/io.py``; with the carry of optax's Adam state
(``ScaleByAdamState``: ``count``, ``mu``, ``nu`` as numpy param trees) into
the port's flat :class:`..train.AdamState` and back
(:func:`adam_state_from_numpy`, :func:`adam_state_to_numpy`). The file format (``io.py::save_params``) is an
``np.save`` int64 topology header (hidden sizes, then n_classes) followed by
Flax's msgpack bytes of ``{"params": {"Dense_i": {"kernel", "bias"}}}``,
where each array is a msgpack ext of type 1 holding ``(shape, dtype name,
C-order bytes)``. It is read and written here with ``msgpack`` alone,
without Flax, imported inside the functions that use it.
"""

from __future__ import annotations

import os
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


def _ext_pack(x):
    """Flax's ext types: an ndarray as type 1, a numpy scalar as type 3."""
    import msgpack

    for code, kind in ((_EXT_NDARRAY, np.ndarray), (_EXT_NPSCALAR, np.generic)):
        if isinstance(x, kind):
            arr = np.asarray(x)
            return msgpack.ExtType(code, msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C"))))
    raise TypeError(f"cannot pack {type(x).__name__}")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def params_to_numpy(model: MLP) -> dict:
    """The JAX package's params tree of ``model``: ``{"params": {"Dense_i":
    {"kernel" (in, out), "bias"}}}`` in the model's dtype, in the order the
    JAX package's files hold them."""
    return {"params": {
        f"Dense_{i}": {
            "kernel": layer.weight.detach().cpu().numpy().T.copy(),
            "bias": layer.bias.detach().cpu().numpy().copy(),
        }
        for i, layer in enumerate(model.layers)
    }}


def save_params(surrogate: Surrogate, path: str) -> None:
    """Write ``surrogate`` as the JAX package's ``save_params`` does: the
    int64 topology header by ``np.save``, then the msgpack params tree as
    Flax's ``to_bytes`` packs it."""
    import msgpack

    model = surrogate.model
    meta = np.array(list(model.hidden) + [model.n_classes], dtype=np.int64)
    with open(path, "wb") as f:
        np.save(f, meta, allow_pickle=False)
        f.write(msgpack.packb(params_to_numpy(model), default=_ext_pack, strict_types=True))


def load_params(path: str, dtype=torch.float32) -> Surrogate:
    """Read a ``.msgpack`` written by either package's ``save_params``."""
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


def save_classifier(surrogate: Surrogate, path: str) -> None:
    """Save-side counterpart of :func:`load_classifier`, as the JAX
    package's: ``.msgpack`` (and any other suffix but ``.orbax``) by
    :func:`save_params`; orbax checkpoints are not written by the port."""
    if path.rstrip("/").endswith(".orbax"):
        raise NotImplementedError(f"{path}: orbax checkpoints are not written by the port")
    save_params(surrogate, path)


def flat_from_tree(tree: dict) -> torch.Tensor:
    """A params-shaped tree ``{"params": {"Dense_i": {"kernel" (in, out),
    "bias"}}}`` (parameters, or Adam's ``mu`` or ``nu``) as the port's flat
    float32 buffer: each layer's kernel transposed to (out, in) and
    row-major, then its bias (``models.train.flat_params``' layout)."""
    layers = tree["params"]
    names = sorted(layers, key=lambda k: int(k.split("_")[1]))
    return torch.as_tensor(np.concatenate([
        np.concatenate([np.asarray(layers[k]["kernel"], np.float32).T.ravel(),
                        np.asarray(layers[k]["bias"], np.float32).ravel()])
        for k in names
    ]))


def tree_from_flat(widths, flat: torch.Tensor) -> dict:
    """The params-shaped numpy tree of a flat buffer of the stack
    ``widths`` (the inverse of :func:`flat_from_tree`)."""
    flat = flat.detach().float().cpu().numpy()
    out, off = {}, 0
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        kernel = flat[off:off + a * b].reshape(b, a).T.copy()
        off += a * b
        out[f"Dense_{i}"] = {"kernel": kernel, "bias": flat[off:off + b].copy()}
        off += b
    return {"params": out}


def adam_state_from_numpy(count, mu: dict, nu: dict):
    """optax's ``ScaleByAdamState`` (``count`` and the ``mu``/``nu`` param
    trees, numpy) as the port's :class:`..train.AdamState`."""
    from .train import AdamState

    return AdamState(int(count), flat_from_tree(mu), flat_from_tree(nu))


def adam_state_to_numpy(state, widths) -> tuple:
    """``(count int32, mu, nu)`` numpy trees of the port's Adam ``state``
    for the stack ``widths``: the fields of optax's ``ScaleByAdamState``."""
    return np.int32(state.count), tree_from_flat(widths, state.mu), tree_from_flat(widths, state.nu)


def load_classifier(path: str, dtype=torch.float32) -> Surrogate:
    """Dispatch on the artifact's suffix, as the JAX package's
    ``load_classifier``: ``.msgpack`` and ``.flax`` are read; orbax
    checkpoints and Keras SavedModels are not ported yet."""
    if path.rstrip("/").endswith(".orbax"):
        raise NotImplementedError(f"{path}: orbax checkpoints are not read by the port yet")
    if path.endswith(".model") or os.path.isdir(path):
        raise NotImplementedError(f"{path}: Keras SavedModels are not read by the port yet")
    if path.endswith((".msgpack", ".flax")):
        return load_params(path, dtype=dtype)
    raise ValueError(f"Unknown model artifact: {path}")

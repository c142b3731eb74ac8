"""Surrogate training: the Adam step on kernel K11 (port of ``models/train.py``).

The JAX package jits an optax step (``make_train_step``: the MLP forward,
the softmax cross-entropy times the class weight, the sample-weighted mean
``Σwℓ / max(Σw, 1e-12)``, its gradient and ``optax.adam``) and a
validation loss. Here a step is one call of :func:`train_step`: on the card
kernel K11 (``kernels.train_step``), on the CPU its plain version
:func:`train_step_plain`, which repeats the kernel's operations one at a
time in the same order. The validation loss is K11's loss-only
instantiation (:func:`train_loss`, plain version :func:`train_loss_plain`),
and the attribution gradient of the defense pipeline's feature importance
is kernel K12 (:func:`input_grad`, plain version :func:`input_grad_plain`).

Parameters and Adam's moments are flat float32 buffers, layer by layer the
weight (out, in) row-major then the bias (:func:`flat_params`), updated in
place by the step (JAX's arrays are immutable; :func:`fit_mlp` clones the
parameters at each new best). The float type of a step's arithmetic is the
batch's: float32 on the card (the kernels take float32); on the CPU
float64 data gives JAX's x64 mode, in which flax computes a float32
model's forward and backward in float64 and optax keeps float32 gradients,
parameters and moments. Adam's bias corrections ``1 - b**count`` are
computed in float64 on the host and rounded once to float32, as optax under
x64 computes and casts them.

:func:`fit_mlp` keeps JAX's loop: numpy ``default_rng(seed).permutation``
batches, the tail batch padded with index-0 rows of weight 0, early
stopping on the validation loss with ``patience``, ``class_weight``. The
step losses stay on the device and are summed on the host at the end of
each epoch, in the step order, as JAX sums ``float(loss)`` step by step:
the same number, one synchronisation an epoch. JAX's ``mesh`` argument
(data-parallel steps over a device mesh) has no counterpart on one card.
Random draws are inputs: threefry cannot be reproduced, so ``fit_mlp``
takes an initial parameter tree (the JAX package's numpy tree, e.g. a flax
``model.init``) and draws with ``MLP.reset_parameters_seeded(seed)``
without one.

:func:`train_test_split` reproduces ``sklearn.model_selection.
train_test_split(..., stratify=y)`` index for index in numpy (sklearn's
``StratifiedShuffleSplit`` over ``np.random.RandomState``), for machines
without sklearn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from .io import Surrogate, params_from_numpy
from .mlp import MLP, mlp_forward_plain, mlp_input_grad_plain

#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: rows of a K11 or K12 tile (``kTrainTileRows`` in ``kernels/csrc/
#: kernels.h``): the plain versions sum each tile's rows in the kernel's
#: order, then the tiles
TILE_ROWS = 16


# -- flat parameters ---------------------------------------------------------
def mlp_widths(model: MLP) -> tuple:
    """(D, hidden..., classes) of ``model``."""
    return (model.layers[0].in_features, *model.hidden, model.n_classes)


def n_params(widths) -> int:
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def flat_params(model: MLP) -> torch.Tensor:
    """The model's parameters as one float32 CPU buffer: each layer's
    weight (out, in) row-major, then its bias."""
    with torch.no_grad():
        return torch.cat([t.detach().reshape(-1).float().cpu() for layer in model.layers
                          for t in (layer.weight, layer.bias)])


def layer_views(widths, flat: torch.Tensor, dtype=None) -> list:
    """``[(weight (out, in), bias (out,)), ...]`` of the flat buffer
    (views, or copies in ``dtype``)."""
    out, off = [], 0
    for a, b in zip(widths[:-1], widths[1:]):
        w = flat[off:off + a * b].view(b, a)
        off += a * b
        bias = flat[off:off + b]
        off += b
        out.append((w, bias) if dtype is None else (w.to(dtype), bias.to(dtype)))
    return out


def stack_tensors(model: MLP, dtype: torch.dtype, device) -> tuple:
    """``(widths, params, layers)`` of ``model``: its widths, its
    :func:`flat_params` in ``dtype`` copied to ``device`` in one transfer,
    and their :func:`layer_views`."""
    widths = mlp_widths(model)
    params = flat_params(model).to(device=device, dtype=dtype)
    return widths, params, layer_views(widths, params)


def model_from_flat(widths, flat: torch.Tensor) -> MLP:
    """A float32 CPU :class:`MLP` holding a copy of the flat parameters."""
    model = MLP(widths[0], hidden=widths[1:-1], n_classes=widths[-1])
    with torch.no_grad():
        for layer, (w, b) in zip(model.layers, layer_views(widths, flat.detach().float().cpu())):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    return model


@dataclass
class AdamState:
    """optax ``ScaleByAdamState`` of a flat parameter buffer: the step
    count and the float32 moments (``models.io.adam_state_from_numpy``
    carries the JAX package's state in and out)."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor

    @classmethod
    def zeros(cls, params: torch.Tensor) -> "AdamState":
        return cls(0, torch.zeros_like(params), torch.zeros_like(params))


def adam_scalars(count: int, lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS) -> tuple:
    """K11's float32 constants of the step that takes the state from
    ``count`` to ``count + 1``: (1 - b1, b1, 1 - b2, b2, 1 - b1**(count +
    1), 1 - b2**(count + 1), eps, -lr), each computed in float64 and
    rounded once."""
    t = count + 1
    return tuple(float(np.float32(v)) for v in (1 - b1, b1, 1 - b2, b2, 1 - b1 ** t, 1 - b2 ** t, eps, -lr))


def class_weight_vector(class_weight: dict | None, n_classes: int = 2) -> list:
    """Per-class weights as JAX indexes them: ``[class_weight.get(i, 1.0)
    for i < max(class_weight) + 1]``, a label past the end taking the last
    (JAX's gather clamps); all 1.0 without ``class_weight``, which leaves
    every loss and cotangent unchanged (x * 1.0 == x)."""
    if class_weight is None:
        return [1.0] * n_classes
    cw = [float(class_weight.get(i, 1.0)) for i in range(max(class_weight) + 1)]
    return [cw[min(j, len(cw) - 1)] for j in range(n_classes)]


# -- the plain versions --------------------------------------------------------
def _exp_rn(t: torch.Tensor) -> torch.Tensor:
    """exp, in float64 rounded once for float32 (the kernels' exp_rn)."""
    return torch.exp(t.double()).float() if t.dtype == torch.float32 else torch.exp(t)


def _log_rn(t: torch.Tensor) -> torch.Tensor:
    return torch.log(t.double()).float() if t.dtype == torch.float32 else torch.log(t)


def _softmax2(logits: torch.Tensor):
    l0, l1 = logits[:, 0], logits[:, 1]
    mx = torch.maximum(l0, l1)
    e0, e1 = _exp_rn(l0 - mx), _exp_rn(l1 - mx)
    return mx, e0, e1, e0 + e1


def _row_losses(logits, y, cw, w):
    """(terms, cotangent of the logits) in the kernel's order: the loss
    (mx + log(tot)) - l_y, the term (loss * cw[y]) * w, the cotangent
    (cw[y] * w) * (e_j / tot - [j == y])."""
    yc = y.clamp(0, 1)
    mx, e0, e1, tot = _softmax2(logits)
    loss = (mx + _log_rn(tot)) - torch.where(yc == 0, logits[:, 0], logits[:, 1])
    cwy = cw[yc]
    term = (loss * cwy) * w
    c = cwy * w
    one = torch.ones((), dtype=logits.dtype, device=logits.device)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    ct = torch.stack([c * (e0 / tot - torch.where(yc == 0, one, zero)),
                      c * (e1 / tot - torch.where(yc == 1, one, zero))], dim=1)
    return term, ct


def _tile_sums(v: torch.Tensor) -> torch.Tensor:
    """(n_tiles, ...) sums of ``v`` (N, ...) over each tile's rows, the
    tile's first row first, then left to right (the kernels' order)."""
    n = v.shape[0]
    n_tiles = -(-n // TILE_ROWS)
    pad = n_tiles * TILE_ROWS - n
    if pad:
        v = torch.cat([v, torch.zeros((pad, *v.shape[1:]), dtype=v.dtype, device=v.device)])
    v = v.reshape(n_tiles, TILE_ROWS, *v.shape[1:])
    valid = (torch.arange(n_tiles * TILE_ROWS, device=v.device) < n).reshape(n_tiles, TILE_ROWS)
    acc = v[:, 0]
    for r in range(1, TILE_ROWS):
        keep = valid[:, r].reshape(-1, *([1] * (v.dim() - 2)))
        acc = torch.where(keep, acc + v[:, r], acc)
    return acc


def _sum_left(v: torch.Tensor) -> torch.Tensor:
    """v[0] + v[1] + ... over the leading axis, left to right."""
    acc = v[0]
    for t in range(1, v.shape[0]):
        acc = acc + v[t]
    return acc


def _backprop(w: torch.Tensor, ct: torch.Tensor, a_in: torch.Tensor | None) -> torch.Tensor:
    """The cotangent of a layer's inputs: unit k sums ct[o] * w[o, k] for
    o = 0, 1, ... (float64: one matmul), then relu's select on ``a_in``
    (None: the stack's input, no mask)."""
    if ct.dtype == torch.float64:
        out = ct @ w
    else:
        out = ct[:, 0, None] * w[0]
        for o in range(1, w.shape[0]):
            out = out + ct[:, o, None] * w[o]
    return out if a_in is None else torch.where(a_in > 0, out, 0.0)


def train_step_plain(widths, params, mu, nu, x, y, w, cw, adam) -> torch.Tensor:
    """One training step, the semantics of kernel K11 (``kernels.
    train_step``; ``csrc/train_step.cu`` states them), updating the flat
    float32 ``params``, ``mu`` and ``nu`` in place and returning the loss
    (1,). The forward and backward run in ``x``'s float type (float64: JAX's
    x64 mode, the gradient rounded to float32 once), Adam in float32."""
    dt = x.dtype
    layers = layer_views(widths, params, dt)
    acts = mlp_forward_plain(layers, x)
    term, ct = _row_losses(acts[-1], y, cw.to(dt), w.to(dt))
    part_loss = _tile_sums(torch.stack([term, w.to(dt)], dim=1))
    grads = [None] * len(layers)
    for i in range(len(layers) - 1, -1, -1):
        a_in = acts[i]
        gw = _tile_sums(ct[:, :, None] * a_in[:, None, :])
        gb = _tile_sums(ct)
        grads[i] = (gw.reshape(gw.shape[0], -1), gb)
        if i:
            ct = _backprop(layers[i][0], ct, acts[i])
    part_grad = torch.cat([torch.cat(g, dim=1) for g in grads], dim=1)
    lsum, wsum = _sum_left(part_loss).unbind()
    den = torch.maximum(wsum, torch.tensor(1e-12, dtype=dt, device=x.device))
    g = (_sum_left(part_grad) / den).float()
    c1, b1, c2, b2, bc1, bc2, eps, neg_lr = (torch.tensor(v, dtype=torch.float32, device=params.device)
                                              for v in adam)
    m = c1 * g + b1 * mu
    v = c2 * (g * g) + b2 * nu
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    params.copy_(params + neg_lr * u)
    mu.copy_(m)
    nu.copy_(v)
    return (lsum / den).reshape(1)


def train_loss_plain(widths, params, x, y, cw) -> torch.Tensor:
    """Each tile's sum of ``cw[y] * loss`` (K11's loss-only instantiation,
    ``kernels.train_loss``), in ``x``'s float type."""
    acts = mlp_forward_plain(layer_views(widths, params, x.dtype), x)
    term, _ = _row_losses(acts[-1], y, cw.to(x.dtype), torch.ones((), dtype=x.dtype, device=x.device))
    return _tile_sums(term)


def input_grad_plain(widths, params, x) -> torch.Tensor:
    """Per row the gradient of the softmax's class-0 probability with
    respect to the row (kernel K12's semantics, ``csrc/input_grad.cu``):
    p_j = e_j / tot, the logits' cotangent p0 * ([j == 0] - p_j), then the
    backward of ``models.mlp.mlp_input_grad_plain``; in ``x``'s float
    type."""
    layers = layer_views(widths, params, x.dtype)
    acts = mlp_forward_plain(layers, x)
    _, e0, e1, tot = _softmax2(acts[-1])
    p0, p1 = e0 / tot, e1 / tot
    ct = torch.stack([p0 * (1.0 - p0), p0 * (0.0 - p1)], dim=1)
    return mlp_input_grad_plain(layers, acts, ct)


# -- dispatch: the kernel on the card, the plain version on the CPU ---------------
def train_step(widths, params, mu, nu, x, y, w, cw, adam) -> torch.Tensor:
    """K11 on CUDA tensors (float32 only), :func:`train_step_plain` on CPU
    tensors."""
    if params.is_cuda:
        from .. import kernels

        return kernels.train_step(widths, params, mu, nu, x, y, w, cw, adam)
    return train_step_plain(widths, params, mu, nu, x, y, w, cw, adam)


def train_loss(widths, params, x, y, cw) -> torch.Tensor:
    if params.is_cuda:
        from .. import kernels

        return kernels.train_loss(widths, params, x, y, cw)
    return train_loss_plain(widths, params, x, y, cw)


def input_grad(widths, params, x) -> torch.Tensor:
    """K12 on CUDA tensors (float32 only), :func:`input_grad_plain` on CPU
    tensors."""
    if params.is_cuda:
        from .. import kernels

        return kernels.input_grad(widths, params, x)
    return input_grad_plain(widths, params, x)


def mean_loss(part_loss: torch.Tensor, n: int) -> float:
    """The validation loss from :func:`train_loss`'s tile sums: the tiles
    left to right, over the row count, in their float type."""
    return float(_sum_left(part_loss.cpu()) / n)


def ce_loss(model: MLP, x: torch.Tensor, y: torch.Tensor, class_weight=None, sample_weight=None) -> torch.Tensor:
    """Weighted softmax cross-entropy of ``model`` at integer labels, in
    ``x``'s float type (a float32 model computes in float64 on float64 rows,
    as flax does): the mean of ``cw[y] * loss``, or with ``sample_weight``
    the weighted mean ``Σwℓ / max(Σw, 1e-12)``. ``class_weight`` is a
    per-class tensor or list."""
    layers = [(layer.weight.to(x.dtype), layer.bias.to(x.dtype)) for layer in model.layers]
    logits = mlp_forward_plain(layers, x)[-1]
    losses = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]
    if class_weight is not None:
        losses = losses * torch.as_tensor(class_weight, dtype=x.dtype, device=x.device)[y]
    if sample_weight is None:
        return losses.mean()
    sw = torch.as_tensor(sample_weight, dtype=x.dtype, device=x.device)
    return (losses * sw).sum() / torch.clamp(sw.sum(), min=1e-12)


# -- the loop -------------------------------------------------------------------
@dataclass
class FitResult:
    surrogate: Surrogate
    history: list  # [(epoch, train_loss, val_loss)]
    best_val_loss: float


def train_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """The float type a training run computes in: float32 on the card (the
    kernels'), float64 on the CPU (JAX's x64 mode) unless ``dtype`` says."""
    dtype = dtype or (torch.float32 if device.type == "cuda" else torch.float64)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"training on the card runs kernels K11 and K12, which take float32, not {dtype}")
    return dtype


def fit_mlp(
    model: MLP,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray | None = None,
    y_val: np.ndarray | None = None,
    epochs: int = 100,
    batch_size: int = 512,
    learning_rate: float = 1e-3,
    patience: int = 25,
    class_weight: dict | None = None,
    seed: int = 0,
    verbose: bool = False,
    init_params: dict | None = None,
    device="cuda",
    dtype=None,
) -> FitResult:
    """Train ``model``'s topology with early stopping on the validation
    loss (Keras-fit parity, as the JAX package's ``fit_mlp``), from
    ``init_params`` (the JAX package's numpy tree) or, without it, weights
    drawn by ``model.reset_parameters_seeded(seed)``. Each step is
    :func:`train_step` on ``device`` in :func:`train_dtype`'s float type;
    the returned surrogate holds the best epoch's parameters, float32 on
    the CPU."""
    dev = resolve_device(device)
    dt = train_dtype(dev, dtype)
    n, d = x_train.shape
    if init_params is not None:
        tree_model = params_from_numpy(init_params)
        if mlp_widths(tree_model) != mlp_widths(model):
            raise ValueError(f"the initial parameters are a {mlp_widths(tree_model)} stack, the model a "
                             f"{mlp_widths(model)} one")
        model = tree_model
    else:
        model.reset_parameters_seeded(seed)
    widths = mlp_widths(model)
    if widths[0] != d:
        raise ValueError(f"the model takes {widths[0]} features, the data has {d}")
    y_train = np.asarray(y_train, dtype=np.int64)
    if y_train.size and (y_train.min() < 0 or y_train.max() >= widths[-1]):
        raise ValueError(f"labels must lie in [0, {widths[-1]}), got [{y_train.min()}, {y_train.max()}]")
    params = flat_params(model).to(dev)
    state = AdamState.zeros(params)
    cw = torch.tensor(class_weight_vector(class_weight, widths[-1]), dtype=dt, device=dev)
    xt = torch.as_tensor(np.asarray(x_train), dtype=dt, device=dev)
    yt = torch.as_tensor(y_train, device=dev)
    val = None
    if x_val is not None:
        val = (torch.as_tensor(np.asarray(x_val), dtype=dt, device=dev),
               torch.as_tensor(np.asarray(y_val, dtype=np.int64), device=dev))

    rng = np.random.default_rng(seed)
    steps_per_epoch = max(1, -(-n // batch_size))  # include the partial batch
    best_val = math.inf
    best_params = params.clone()
    since_best = 0
    history = []
    for epoch in range(epochs):
        perm = rng.permutation(n)
        # the tail batch padded with index-0 rows of weight 0: every sample
        # counts once an epoch, every batch has batch_size rows
        idx = np.zeros(steps_per_epoch * batch_size, dtype=np.int64)
        idx[:n] = perm
        w = np.zeros(steps_per_epoch * batch_size, dtype=np.float32)
        w[:n] = 1.0
        idx_t = torch.as_tensor(idx, device=dev)
        w_t = torch.as_tensor(w, dtype=dt, device=dev)
        losses = []
        for i in range(steps_per_epoch):
            rows = idx_t[i * batch_size:(i + 1) * batch_size]
            losses.append(train_step(widths, params, state.mu, state.nu, xt.index_select(0, rows),
                                     yt.index_select(0, rows), w_t[i * batch_size:(i + 1) * batch_size], cw,
                                     adam_scalars(state.count, learning_rate)))
            state.count += 1
        epoch_loss = 0.0
        for loss in torch.cat(losses).tolist():
            epoch_loss += loss
        epoch_loss /= steps_per_epoch

        vl = epoch_loss if val is None else mean_loss(train_loss(widths, params, val[0], val[1], cw), len(val[1]))
        history.append((epoch, epoch_loss, vl))
        if verbose:
            print(f"epoch {epoch}: train {epoch_loss:.4f} val {vl:.4f}")
        if vl < best_val:
            # the step updates params in place: keep a copy of the best
            best_val, since_best = vl, 0
            best_params.copy_(params)
        else:
            since_best += 1
            if since_best >= patience:
                break
    return FitResult(surrogate=Surrogate(model_from_flat(widths, best_params)), history=history,
                     best_val_loss=float(best_val))


def auroc(probs_pos: np.ndarray, y: np.ndarray) -> float:
    """AUROC via the rank statistic (the reference prints Keras' AUC)."""
    # midranks for ties
    _, inv, counts = np.unique(probs_pos, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    start = cum - counts
    ranks = ((start + cum + 1) / 2.0)[inv]
    pos = y == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


# -- the stratified split ----------------------------------------------------------
def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: the floored
    proportional share of each class, the remainder added by decreasing
    left-over share, ties drawn from ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y: np.ndarray, test_size: float = 0.1, random_state: int = 42) -> tuple:
    """(train, test) row indices of sklearn's ``StratifiedShuffleSplit``
    (one split) at a float ``test_size``, index for index: ``ceil(test_size
    * n)`` test rows, each class's share by :func:`_approximate_mode`,
    per-class permutations, then both sets permuted, all from
    ``np.random.RandomState(random_state)``."""
    y = np.asarray(y)
    n = y.shape[0]
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    _, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = class_counts.shape[0]
    if class_counts.min() < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few to stratify")
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each be at least the {n_classes} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(x: np.ndarray, y: np.ndarray, test_size: float = 0.1, random_state: int = 42) -> tuple:
    """``(x_train, x_test, y_train, y_test)`` as sklearn's
    ``train_test_split(x, y, test_size=..., random_state=..., stratify=y)``
    returns them."""
    train, test = stratified_split(y, test_size, random_state)
    return x[train], x[test], y[train], y[test]

"""Genetic <-> ML <-> normalised feature transforms on tensors.

Port of ``moeva2_ijcai22_replication_tpu/core/codec.py``. A candidate has
three representations:

- **ML space** ``(D,)``: every feature, as the classifier consumes it;
- **genetic space** ``(L,)``: the mutable non-OHE features in ML order, then
  one categorical gene per mutable one-hot group;
- **normalised space**: MinMax over per-feature bounds (zero-range features
  get scale 1).

Group structure is precomputed into padded index tables, so every transform
is a gather or scatter over the last axis and broadcasts over leading axes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .schema import OHE_PREFIX, SOFTMAX_TYPE, FeatureSchema


@dataclass(frozen=True)
class Codec:
    """Index tables driving the transforms (all shapes fixed at build)."""

    non_ohe_ml_idx: torch.Tensor  # (n1,) int64 — ML index of each non-OHE gene
    group_ml_idx: torch.Tensor  # (G, K) int64 — ML indices per OHE group, padded
    group_pad_mask: torch.Tensor  # (G, K) bool — True on real entries
    group_sizes: torch.Tensor  # (G,) int64
    int_mask_gen: torch.Tensor  # (L,) bool — genes needing integer rounding
    mutable_mask: torch.Tensor  # (D,) bool
    softmax_mask_gen: torch.Tensor  # (L,) bool
    n_features: int
    gen_length: int

    @property
    def n_groups(self) -> int:
        return self.group_ml_idx.shape[0]

    @property
    def n_non_ohe(self) -> int:
        return self.non_ohe_ml_idx.shape[0]

    def to(self, device) -> "Codec":
        """The same tables on ``device``."""
        return replace(
            self,
            **{
                k: getattr(self, k).to(device)
                for k in (
                    "non_ohe_ml_idx", "group_ml_idx", "group_pad_mask",
                    "group_sizes", "int_mask_gen", "mutable_mask",
                    "softmax_mask_gen",
                )
            },
        )


def _pad_group_tables(group_lists: list[list[int]]):
    """Pad ragged index groups into (G, K) tables + validity mask; pad slots
    repeat the group's first member and are masked out by the mask."""
    n_groups = len(group_lists)
    max_k = max((len(g) for g in group_lists), default=1)
    idx = np.zeros((n_groups, max_k), dtype=np.int64)
    mask = np.zeros((n_groups, max_k), dtype=bool)
    sizes = np.zeros((n_groups,), dtype=np.int64)
    for gi, members in enumerate(group_lists):
        idx[gi, : len(members)] = members
        idx[gi, len(members):] = members[0] if members else 0
        mask[gi, : len(members)] = True
        sizes[gi] = len(members)
    return idx, mask, sizes


def make_codec(schema: FeatureSchema) -> Codec:
    """Build the codec from a feature schema (tables on the CPU; use
    :meth:`Codec.to` to move them). Only mutable features are genes."""
    mutable = schema.mutable
    types = [str(t) for t in schema.types]
    groups: dict[str, list[int]] = {}
    non_ohe_ml: list[int] = []
    for i in range(schema.n_features):
        if not mutable[i]:
            continue
        if types[i].startswith(OHE_PREFIX):
            groups.setdefault(types[i], []).append(i)
        else:
            non_ohe_ml.append(i)
    group_lists = list(groups.values())
    n_groups = len(group_lists)
    group_ml_idx, group_pad_mask, group_sizes = _pad_group_tables(group_lists)
    int_mask = np.array(
        [types[i] == "int" for i in non_ohe_ml] + [True] * n_groups, dtype=bool
    )
    softmax_mask = np.array(
        [types[i] == SOFTMAX_TYPE for i in non_ohe_ml] + [False] * n_groups,
        dtype=bool,
    )
    return Codec(
        non_ohe_ml_idx=torch.as_tensor(np.array(non_ohe_ml, dtype=np.int64)),
        group_ml_idx=torch.as_tensor(group_ml_idx),
        group_pad_mask=torch.as_tensor(group_pad_mask),
        group_sizes=torch.as_tensor(group_sizes),
        int_mask_gen=torch.as_tensor(int_mask),
        mutable_mask=torch.as_tensor(np.asarray(mutable, dtype=bool)),
        softmax_mask_gen=torch.as_tensor(softmax_mask),
        n_features=schema.n_features,
        gen_length=len(non_ohe_ml) + n_groups,
    )


def scatter_groups(x, group_idx, pad_mask, group_vals):
    """Scatter per-group value rows ``(..., G, K)`` into the feature slots of
    ``x`` ``(..., D)``; padded entries land in a sentinel column that is
    dropped."""
    d = x.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], group_vals.shape[:-2])
    flat_idx = torch.where(pad_mask, group_idx, d).reshape(-1)
    flat_vals = group_vals.expand(*batch, *group_vals.shape[-2:]).reshape(*batch, -1)
    padded = torch.cat(
        [x.expand(*batch, d), x.new_zeros((*batch, 1))], dim=-1
    )
    padded[..., flat_idx] = flat_vals
    return padded[..., :d]


def genetic_to_ml(codec: Codec, x_gen, x_init_ml):
    """Decode genetic vectors ``(..., L)`` into ML vectors ``(..., D)``:
    immutables from ``x_init_ml`` (broadcastable), mutable non-OHE genes to
    their slots, categorical genes expanded to one-hot groups."""
    n1 = codec.n_non_ohe
    batch = torch.broadcast_shapes(x_gen.shape[:-1], x_init_ml.shape[:-1])
    out = x_init_ml.expand(*batch, codec.n_features).clone()
    out[..., codec.non_ohe_ml_idx] = x_gen[..., :n1].expand(*batch, n1)
    if codec.n_groups:
        cats = torch.round(x_gen[..., n1:])
        k = torch.arange(codec.group_ml_idx.shape[1], device=x_gen.device)
        onehot = (cats[..., None] == k).to(out.dtype)
        out = scatter_groups(out, codec.group_ml_idx, codec.group_pad_mask, onehot)
    return out


def harden_onehot(x, group_idx, pad_mask):
    """Snap every one-hot group in ``x`` to a hard argmax one-hot (first
    index on ties)."""
    if group_idx.shape[0] == 0:
        return x
    vals = torch.where(pad_mask, x[..., group_idx], -torch.inf)
    winner = torch.argmax(vals, dim=-1)
    k = torch.arange(group_idx.shape[1], device=x.device)
    hard = (winner[..., None] == k).to(x.dtype)
    hard = torch.where(pad_mask, hard, 0.0)
    return scatter_groups(x, group_idx, pad_mask, hard)


def ml_to_genetic(codec: Codec, x_ml):
    """Encode ML vectors into the genetic representation; one-hot groups
    collapse to their argmax."""
    parts = [x_ml[..., codec.non_ohe_ml_idx]]
    if codec.n_groups:
        vals = torch.where(codec.group_pad_mask, x_ml[..., codec.group_ml_idx], -torch.inf)
        parts.append(torch.argmax(vals, dim=-1).to(x_ml.dtype))
    return torch.cat(parts, dim=-1)


def genetic_bounds(codec: Codec, xl_ml, xu_ml):
    """Per-gene (xl, xu) from per-feature ML bounds (may carry leading axes);
    categorical genes range over [0, group_size - 1]."""
    batch = xl_ml.shape[:-1]
    cat_lo = xl_ml.new_zeros((*batch, codec.n_groups))
    cat_hi = (codec.group_sizes - 1).to(xu_ml.dtype).expand(*batch, codec.n_groups)
    xl = torch.cat([xl_ml[..., codec.non_ohe_ml_idx], cat_lo], dim=-1)
    xu = torch.cat([xu_ml[..., codec.non_ohe_ml_idx], cat_hi], dim=-1)
    return xl, xu


def minmax_normalize(x, xl, xu):
    """MinMaxScaler semantics: zero-range features use scale 1."""
    rng = xu - xl
    return (x - xl) / torch.where(rng == 0, 1.0, rng)


def minmax_denormalize(x, xl, xu):
    rng = xu - xl
    return x * torch.where(rng == 0, 1.0, rng) + xl


def round_int_genes(codec: Codec, x_gen):
    """Round integer-typed genes (categoricals included), half to even."""
    return torch.where(codec.int_mask_gen, torch.round(x_gen), x_gen)


def clip_genetic(x_gen, xl_gen, xu_gen):
    return torch.minimum(torch.maximum(x_gen, xl_gen), xu_gen)


def all_ohe_groups_distance(groups_idx, pad_mask, x_ml):
    """Sum over the given (G, K) groups of |1 - sum(group members)|."""
    vals = torch.where(pad_mask, x_ml[..., groups_idx], 0.0)
    return torch.abs(1.0 - vals.sum(dim=-1)).sum(dim=-1)


def full_ohe_tables(schema: FeatureSchema):
    """(G, K) padded index table + mask over ALL OHE groups (immutable ones
    included)."""
    groups = [list(g) for g in schema.ohe_groups()]
    if not groups:
        return torch.zeros((0, 1), dtype=torch.int64), torch.zeros((0, 1), dtype=torch.bool)
    idx, mask, _ = _pad_group_tables(groups)
    return torch.as_tensor(idx), torch.as_tensor(mask)

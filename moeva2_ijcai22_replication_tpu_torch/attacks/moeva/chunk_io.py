"""A MoEvA chunk's prepare and decode on the device: kernel K13.

Port of the head of the JAX engine's ``init`` program
(``attacks/moeva/engine.py:503-521``: ``core/codec.py``'s
``genetic_bounds`` and ``minmax_normalize``, then ``tile_init`` or
``lp_ratio_init``, and the survival's normalisation memory at its start)
and of its final ``codec.genetic_to_ml`` of population and archive
(``engine.py:1508``). :func:`chunk_prepare` launches K13a and
:func:`chunk_decode` K13b (``kernels/csrc/chunk_io.cu``) on CUDA tensors; on
CPU tensors they run :func:`chunk_prepare_plain` and
:func:`chunk_decode_plain`, the engine's eager stages gathered into the
wrappers' signatures, which define the kernels' arithmetic one rounded
operation at a time. The host keeps what the JAX package keeps on the host:
the feature bounds (``get_feature_min_max``) and the decode of rows parked
by the early exit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core import codec as codec_lib
from ...core.codec import Codec
from .initialisation import lp_ratio_init, n_perturbed, tile_init
from .survival import NormState


def feature_gene_tables(codec: Codec):
    """``(feat_gene, feat_onehot)`` (D,) int32 numpy arrays: the gene that
    feeds feature d (-1 for an immutable feature) and d's slot in its one-hot
    group (-1 where the feature is the gene itself)."""
    feat_gene = np.full(codec.n_features, -1, dtype=np.int32)
    feat_onehot = np.full(codec.n_features, -1, dtype=np.int32)
    feat_gene[codec.non_ohe_ml_idx.cpu().numpy()] = np.arange(codec.n_non_ohe)
    group_idx = codec.group_ml_idx.cpu().numpy()
    for g, (idx, real) in enumerate(zip(group_idx, codec.group_pad_mask.cpu().numpy())):
        feat_gene[idx[real]] = codec.n_non_ohe + g
        feat_onehot[idx[real]] = np.arange(real.sum())
    return feat_gene, feat_onehot


class ChunkTables(NamedTuple):
    """The codec (for the plain versions) and its tables as K13 reads them,
    on one device."""

    codec: Codec
    gene_feat: torch.Tensor  # (L,) int32: gene j's feature (j < n1) or one-hot group (j >= n1)
    group_idx: torch.Tensor  # (G, K) int32: each group's features, -1 pads last
    int_gene: torch.Tensor  # (L,) bool: genes rounded to integers
    feat_gene: torch.Tensor  # (D,) int32
    feat_onehot: torch.Tensor  # (D,) int32


def make_chunk_tables(codec: Codec, device) -> ChunkTables:
    gene_feat = np.concatenate([codec.non_ohe_ml_idx.cpu().numpy(), np.arange(codec.n_groups)]).astype(np.int32)
    group_idx = np.where(codec.group_pad_mask.cpu().numpy(), codec.group_ml_idx.cpu().numpy(), -1).astype(np.int32)
    if not codec.n_groups:
        group_idx = np.full((0, 1), -1, dtype=np.int32)
    feat_gene, feat_onehot = feature_gene_tables(codec)
    as_t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return ChunkTables(
        codec=codec.to(device), gene_feat=as_t(gene_feat), group_idx=as_t(group_idx),
        int_gene=as_t(codec.int_mask_gen.cpu().numpy()), feat_gene=as_t(feat_gene), feat_onehot=as_t(feat_onehot),
    )


class Prepared(NamedTuple):
    """What one K13a launch writes: the gene bounds, the normalised states,
    and with a population its start (None without)."""

    xl_gen: torch.Tensor  # (S, L)
    xu_gen: torch.Tensor  # (S, L)
    x_mm: torch.Tensor  # (S, D)
    pop_x: torch.Tensor | None  # (S, P, L)
    norm_state: NormState | None


class InitSpec(NamedTuple):
    """The initial population K13a writes: ``n_pop`` rows at the initial
    state ("tile"), or with ``lp_ratio`` the last :func:`n_perturbed` of
    them moved by the ``ball`` draws (``ball_draw_shape``)."""

    n_pop: int
    lp_ratio: bool = False
    ball: torch.Tensor | None = None
    eps: float = 0.1
    ratio: float = 0.5
    norm: object = 2


def chunk_prepare(tables: ChunkTables, x, xl, xu, init: InitSpec | None = None) -> Prepared:
    """A chunk's device inputs from its states ``x`` and feature bounds
    ``xl``, ``xu`` (S, D), and with ``init`` its initial population and
    normalisation memory: kernel K13a on CUDA tensors,
    :func:`chunk_prepare_plain` on CPU tensors."""
    fn = chunk_prepare_plain
    if x.is_cuda:
        from ...kernels import chunk_prepare as fn
    return fn(tables, x, xl, xu, init)


def chunk_prepare_plain(tables: ChunkTables, x, xl, xu, init: InitSpec | None = None) -> Prepared:
    """:func:`chunk_prepare` in plain PyTorch, the semantics of K13a."""
    codec = tables.codec
    xl_gen, xu_gen = codec_lib.genetic_bounds(codec, xl, xu)
    x_mm = codec_lib.minmax_normalize(x, xl, xu)
    if init is None:
        return Prepared(xl_gen, xu_gen, x_mm, None, None)
    if init.lp_ratio:
        pop = lp_ratio_init(codec, x, init.n_pop, xl_gen, xu_gen, init.ball, eps=init.eps, ratio=init.ratio,
                            norm=init.norm)
    else:
        pop = tile_init(codec, x, init.n_pop)
    return Prepared(xl_gen, xu_gen, x_mm, pop, NormState.init(x.shape[0], 3, x.dtype, x.device))


def init_moves(init: InitSpec | None) -> int:
    """Rows of the initial population that ``init`` moves."""
    return n_perturbed(init.n_pop, init.ratio) if init is not None and init.lp_ratio else 0


def chunk_decode(tables: ChunkTables, pop_x, arch_x, pop_f, arch_f, x_init):
    """The chunk's returned columns, population then archive, and their
    decode to ML space: ``(x_gen (S, P + A, L), f (S, P + A, 3), x_ml (S,
    P + A, D))``; kernel K13b on CUDA tensors, :func:`chunk_decode_plain` on
    CPU tensors."""
    fn = chunk_decode_plain
    if pop_x.is_cuda:
        from ...kernels import chunk_decode as fn
    return fn(tables, pop_x, arch_x, pop_f, arch_f, x_init)


def chunk_decode_plain(tables: ChunkTables, pop_x, arch_x, pop_f, arch_f, x_init):
    """:func:`chunk_decode` in plain PyTorch, the semantics of K13b."""
    x_gen = torch.cat([pop_x, arch_x], dim=1)
    f = torch.cat([pop_f, arch_f], dim=1)
    return x_gen, f, codec_lib.genetic_to_ml(tables.codec, x_gen, x_init[:, None, :])

"""Batched non-dominated sorting (port of ``attacks/moeva/nds.py``).

``nd_ranks`` peels fronts until ``n_stop`` candidates per state are ranked.
On a CUDA tensor it launches kernel K2 (``kernels/csrc/nd_peel.cu``), which
runs the whole peel inside one thread block per state; on a CPU tensor it
runs :func:`nd_ranks_plain`, which defines the semantics. ``nd_ranks_plain``
peels on the host's say-so (one device round trip per front), which is why
the kernel exists.
"""

from __future__ import annotations

import torch

UNRANKED = 2**31 - 1


def domination_matrix(f: torch.Tensor) -> torch.Tensor:
    """``D[..., i, j] = True`` iff candidate i dominates candidate j: no worse
    everywhere and strictly better somewhere (minimisation). A NaN row
    neither dominates nor is dominated."""
    le = (f[..., :, None, :] <= f[..., None, :, :]).all(-1)
    lt = (f[..., :, None, :] < f[..., None, :, :]).any(-1)
    return le & lt


def nd_ranks_plain(f: torch.Tensor, n_stop: int | None = None) -> torch.Tensor:
    """Front index (0 = non-dominated) per candidate of ``f`` (S, M, n_obj),
    int32 (S, M).

    Per state, fronts 0, 1, 2, … are peeled until at least ``n_stop``
    candidates are ranked; the tail keeps :data:`UNRANKED`. If a peel finds
    no front among the remaining candidates (it cannot for a strict partial
    order), all of them take the current rank."""
    n = f.shape[-2]
    if n_stop is None:
        n_stop = n
    dom = domination_matrix(f)
    ranks = torch.full(f.shape[:-1], UNRANKED, dtype=torch.int32, device=f.device)
    r = 0
    while True:
        remaining = ranks == UNRANKED
        active = ((~remaining).sum(-1) < n_stop) & remaining.any(-1)
        if not bool(active.any()):
            return ranks
        front = remaining & ~(remaining[..., :, None] & dom).any(-2)
        front = torch.where(front.any(-1, keepdim=True), front, remaining)
        ranks = torch.where(front & active[..., None], r, ranks)
        r += 1


def nd_ranks(f: torch.Tensor, n_stop: int | None = None, off_f: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`nd_ranks_plain` semantics on the merged objectives [f,
    off_f] (``f`` alone without ``off_f``); kernel K2 on a CUDA tensor,
    which reads the two apart."""
    if f.is_cuda:
        from ...kernels import nd_peel

        m = f.shape[-2] + (0 if off_f is None else off_f.shape[-2])
        return nd_peel(f, m if n_stop is None else n_stop, off_f)
    if off_f is not None:
        f = torch.cat([f, off_f], dim=-2)
    return nd_ranks_plain(f, n_stop)

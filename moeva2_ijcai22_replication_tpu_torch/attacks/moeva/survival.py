"""Aspiration-point (R-NSGA-III) survival over a batch of states.

Port of ``attacks/moeva/survival.py``: persistent ideal/worst points, ASF
extreme points, hyperplane nadir with pymoo's fallbacks, per-generation
re-normalised aspiration directions plus the n_obj axes, perpendicular-
distance niche association, and a closed-form (water-filling) niching fill
of the splitting front. Every function carries a leading states axis S.

A survival round is four stages, each a hand-written CUDA kernel on CUDA
tensors and a plain PyTorch version here that defines its arithmetic: the
front peel (K2, :func:`.nds.nd_ranks`), the normalisation (K4a,
:func:`survive_norm_plain`), niche association (K3, :func:`associate_plain`)
and the niching fill (K4b, :func:`survive_fill_plain`). The niching fill's
two random fields are inputs (:func:`draw_gumbels` makes them from the
port's Philox stream).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.norms import sqrt_rn as _sqrt_rn
from ...core.norms import sum_last as _sum_last
from .nds import UNRANKED, nd_ranks

_BIG = 1e16


class NormState(NamedTuple):
    """Per-state normalisation memory carried across generations."""

    ideal: torch.Tensor  # (S, n_obj)
    worst: torch.Tensor  # (S, n_obj)
    extreme: torch.Tensor  # (S, n_obj, n_obj) — ASF extreme points

    @classmethod
    def init(cls, n_states: int, n_obj: int, dtype=torch.float32, device="cpu") -> "NormState":
        full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=device)  # noqa: E731
        return cls(
            ideal=full((n_states, n_obj), torch.inf),
            worst=full((n_states, n_obj), -torch.inf),
            # sentinel rows with a huge ASF never win the argmin on first use
            extreme=full((n_states, n_obj, n_obj), _BIG),
        )


def _update_extreme_points(f, nd_mask, ideal, extreme, asp_points):
    """ASF-minimising extreme points among [previous extremes, the
    non-dominated front, the aspiration points] (ties to the earlier row);
    weights are eye with 1e6 off-axis; shifts below 1e-3 snap to 0."""
    s, _, n_obj = f.shape
    eye = torch.eye(n_obj, dtype=torch.bool, device=f.device)
    w = torch.where(eye, 1.0, 1e6).to(f.dtype)
    cand = torch.cat(
        [
            extreme,
            torch.where(nd_mask[..., None], f, _BIG),
            asp_points.expand(s, *asp_points.shape),
        ],
        dim=1,
    )  # (S, n_obj + M + A, n_obj)
    shifted = cand - ideal[:, None, :]
    shifted = torch.where(shifted < 1e-3, 0.0, shifted)
    asf = (shifted[:, None, :, :] * w[None, :, None, :]).amax(-1)  # (S, n_obj, C)
    idx = torch.argmin(asf, dim=2)
    return torch.gather(cand, 1, idx[..., None].expand(s, n_obj, n_obj))


def _solve3(m):
    """Solve m @ x = 1 for a batch of 3×3 systems by Cramer's rule; a
    singular system yields inf/nan, which the caller's fallbacks handle."""
    e = lambda i, j: m[..., i, j]  # noqa: E731
    det = (
        e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1))
        - e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0))
        + e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0))
    )
    adj = torch.stack(
        [
            torch.stack([
                e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1),
                e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
                e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1),
            ], -1),
            torch.stack([
                e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2),
                e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
                e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2),
            ], -1),
            torch.stack([
                e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0),
                e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
                e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0),
            ], -1),
        ],
        -2,
    )
    return _sum_last(adj) / det[..., None]


def _nadir_point(extreme, ideal, worst, worst_of_front, worst_of_pop):
    """Hyperplane intercepts with pymoo's fallback chain: a successful solve
    is clamped elementwise to the running worst point; a failed one
    (singular, inconsistent, tiny intercepts) falls back to worst-of-front,
    and a degenerate range per axis to worst-of-population."""
    m = extreme - ideal[:, None, :]
    plane = _solve3(m)
    intercepts = 1.0 / plane
    nadir = torch.minimum(ideal + intercepts, worst)
    residual = _sum_last(m * plane[:, None, :])  # m @ plane
    ok = (
        torch.isfinite(plane).all(-1)
        & (torch.abs(residual - 1.0) <= 1e-8 + 1e-5).all(-1)
        & (intercepts > 1e-6).all(-1)
        & torch.isfinite(nadir).all(-1)
    )
    nadir = torch.where(ok[:, None], nadir, worst_of_front)
    return torch.where((nadir - ideal) <= 1e-6, worst_of_pop, nadir)


def _unit_ref_dirs(asp_points, ideal, nadir):
    """Per-generation survival directions in normalised objective space:
    central projections of the unit-scaled aspiration points onto the simplex
    plane (octant-clipped), then the extreme axes. (S, A + n_obj, n_obj)."""
    s, n_obj = ideal.shape
    denom = nadir - ideal
    denom = torch.where(denom == 0, 1e-12, denom)
    unit = (asp_points[None] - ideal[:, None, :]) / denom[:, None, :]
    tot = _sum_last(unit, keepdim=True)
    proj = unit / torch.where(tot == 0, 1.0, tot)
    needs_clip = (proj <= 0).any(-1, keepdim=True)
    clipped = torch.clamp(proj, min=0.0)
    csum = _sum_last(clipped, keepdim=True)
    clipped = clipped / torch.where(csum == 0, 1.0, csum)
    proj = torch.where(needs_clip, clipped, proj)
    eye = torch.eye(n_obj, dtype=proj.dtype, device=proj.device).expand(s, n_obj, n_obj)
    return torch.cat([proj, eye], dim=1)


def associate_plain(f, dirs, ideal, nadir):
    """Niche association, the semantics of kernel K3.

    ``f`` (S, M, 3), ``dirs`` (S, R, 3), ``ideal``/``nadir`` (S, 3) ->
    ``niche`` (S, M) int64 = first argmax over r of (n·d_r)², and ``dist``
    (S, M) = sqrt(max(|n|² − best, 0)), where n = (f − ideal)/denom with a
    zero denom replaced by 1e-12 and d_r = dirs_r/|dirs_r|. As in
    ``jnp.argmax``, a NaN projection counts as the largest (an inf objective
    gives inf * 0 = NaN on the axis directions): the first NaN wins.

    Dot products are written out as a0*b0 + a1*b1 + a2*b2, one rounded
    operation at a time, which is the kernel's order: dist subtracts two
    nearly equal numbers for candidates close to a direction, so a different
    rounding of |n|² or of the projection shows up magnified by the sqrt."""
    denom = nadir - ideal
    denom = torch.where(denom == 0, 1e-12, denom)
    n = (f - ideal[:, None, :]) / denom[:, None, :]
    nrm = _sqrt_rn(dirs[..., 0] * dirs[..., 0] + dirs[..., 1] * dirs[..., 1] + dirs[..., 2] * dirs[..., 2])
    d = dirs / nrm[..., None]
    n_, d_ = n[:, :, None, :], d[:, None, :, :]
    proj = n_[..., 0] * d_[..., 0] + n_[..., 1] * d_[..., 1] + n_[..., 2] * d_[..., 2]
    p2 = proj * proj
    niche = torch.argmax(p2, dim=2)
    best = torch.gather(p2, 2, niche[..., None])[..., 0]
    dist2 = n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2] - best
    return niche, _sqrt_rn(torch.clamp(dist2, min=0.0))


def associate_batch(f, dirs, ideal, nadir, off_f=None):
    """:func:`associate_plain` semantics on the merged objectives [f,
    off_f] (``f`` alone without ``off_f``); kernel K3 on CUDA tensors,
    which reads the two apart."""
    if f.is_cuda:
        from ...kernels import associate

        return associate(f, dirs, ideal, nadir, off_f)
    return associate_plain(_merge(f, off_f), dirs, ideal, nadir)


def _merge(f, off_f):
    """The merged objectives [f, off_f] the plain versions take: a copy."""
    return f if off_f is None else torch.cat([f, off_f], dim=1)


def _niching_fill(gum_cut, gum_mem, ranks, split_rank, niche, dist, niche_count, n_remaining, n_survive):
    """Closed-form niching fill of the splitting front.

    pymoo's pick loop gives one slot to every niche at the current minimum
    count; that is water-filling of ``n_remaining`` units over niches with
    initial counts ``niche_count`` and capacities = available members. An
    18-step bisection finds the integer water level, the cutoff level's
    partial cohort goes to the niches with the highest ``gum_cut``, and
    members are taken closest first for an empty niche, then by ascending
    ``gum_mem``."""
    s, m = ranks.shape
    r = niche_count.shape[1]
    dev = ranks.device
    member = niche[:, :, None] == torch.arange(r, device=dev)  # (S, M, R)
    avail = ranks == split_rank[:, None]  # (S, M)
    member_avail = member & avail[:, :, None]
    cap = member_avail.sum(1)  # (S, R)
    c0 = niche_count

    def filled(level):
        return torch.minimum(torch.clamp(level[:, None] - c0, min=0), cap).sum(-1)

    # largest integer level whose cumulative fill fits the quota
    lo = torch.zeros(s, dtype=torch.int64, device=dev)
    hi = torch.full((s,), m + n_survive + 1, dtype=torch.int64, device=dev)
    for _ in range(18):
        mid = (lo + hi + 1) // 2
        ok = filled(mid) <= n_remaining
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    level = lo
    quota = torch.minimum(torch.clamp(level[:, None] - c0, min=0), cap)

    # cutoff: niches exactly at the water level with spare members draw the
    # remaining units by gumbel priority
    rem = n_remaining - quota.sum(-1)
    elig = (quota < cap) & ((c0 + quota) == level[:, None])
    pri = torch.where(elig, gum_cut, -torch.inf)
    cut_rank = (pri[:, None, :] > pri[:, :, None]).sum(-1)
    quota = quota + (elig & (cut_rank < rem[:, None]))

    # within-niche order: the closest member first when the niche starts
    # empty, then uniformly random members
    closest = torch.argmin(
        torch.where(member_avail, dist[:, :, None], torch.inf), dim=1
    )  # (S, R)
    first = ((c0 == 0) & (cap > 0)).to(torch.int32)
    is_closest = torch.zeros((s, m), dtype=torch.int32, device=dev).scatter_reduce(
        1, closest, first, reduce="amax"
    ).bool()
    pick_key = torch.where(is_closest & avail, -torch.inf, gum_mem)
    same_niche = niche[:, :, None] == niche[:, None, :]  # (S, M, M)
    rank_in_niche = (
        same_niche & avail[:, None, :] & (pick_key[:, None, :] < pick_key[:, :, None])
    ).sum(-1)
    return avail & (rank_in_niche < torch.gather(quota, 1, niche))


def survive_norm_plain(f, ranks, asp_points, state: NormState):
    """Normalisation update and survival directions, the semantics of kernel
    K4a: the running ideal and worst points, the ASF extreme points, the
    hyperplane nadir and the directions, from the merged objectives ``f``
    (S, M, n_obj) and their front ranks. Returns ``(new_state, nadir,
    dirs)``."""
    ideal = torch.minimum(state.ideal, torch.minimum(f.amin(1), asp_points.amin(0)))
    worst = torch.maximum(state.worst, torch.maximum(f.amax(1), asp_points.amax(0)))
    nd_mask = ranks == 0
    extreme = _update_extreme_points(f, nd_mask, ideal, state.extreme, asp_points)
    worst_of_pop = f.amax(1)
    worst_of_front = torch.where(nd_mask[..., None], f, -torch.inf).amax(1)
    nadir = _nadir_point(extreme, ideal, worst, worst_of_front, worst_of_pop)
    dirs = _unit_ref_dirs(asp_points, ideal, nadir)
    return NormState(ideal=ideal, worst=worst, extreme=extreme), nadir, dirs


def survive_norm(f, ranks, asp_points, state: NormState, off_f=None):
    """:func:`survive_norm_plain` semantics on the merged objectives [f,
    off_f] (``f`` alone without ``off_f``); kernel K4a on CUDA tensors,
    which reads the two apart."""
    if f.is_cuda:
        from ...kernels import survive_norm as kernel

        ideal, worst, extreme, nadir, dirs = kernel(f, ranks, asp_points, state, off_f)
        return NormState(ideal=ideal, worst=worst, extreme=extreme), nadir, dirs
    return survive_norm_plain(_merge(f, off_f), ranks, asp_points, state)


def survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, n_survive: int):
    """The survivor mask (S, M), the semantics of kernel K4b: fronts whose
    cumulative count fits survive whole; the first front that overflows is
    niched by :func:`_niching_fill`."""
    cum_le = (ranks[:, None, :] <= ranks[:, :, None]).sum(-1)
    full_survivor = cum_le <= n_survive
    split_rank = torch.where(full_survivor, UNRANKED, ranks).amin(-1)
    n_remaining = torch.clamp(n_survive - full_survivor.sum(-1), min=0)
    member = niche[:, :, None] == torch.arange(gum_cut.shape[1], device=niche.device)
    niche_count = (member & full_survivor[:, :, None]).sum(1)
    taken = _niching_fill(
        gum_cut, gum_mem, ranks, split_rank, niche, dist, niche_count,
        n_remaining, n_survive,
    )
    return full_survivor | taken


def gumbel_fields(n_states: int, n_dirs: int, m: int) -> list:
    """The Philox fields of the niching fill (``core.philox``): cutoff
    priorities (S, R), then member priorities (S, M), standard Gumbel."""
    from ...core.philox import GUMBEL, Field

    return [Field("gum_cut", GUMBEL, (n_states, n_dirs)), Field("gum_mem", GUMBEL, (n_states, m))]


def draw_gumbels(stream, n_states: int, n_dirs: int, m: int, dtype=torch.float32):
    """The niching fill's two random fields from the Philox ``stream``:
    ``(gum_cut (S, R), gum_mem (S, M))``, one call of
    :func:`gumbel_fields`."""
    out = stream.draw(gumbel_fields(n_states, n_dirs, m), dtype)
    return out["gum_cut"], out["gum_mem"]


def survive_stages(f, asp_points, state: NormState, n_survive: int, off_f=None):
    """The stages of a survival round before the fill: K2, K4a, K3, on the
    merged objectives [f (S, P, 3), off_f (S, O, 3)] (``f`` alone without
    ``off_f``). On the card each kernel reads the two apart (no merged
    copy); on the CPU the plain versions take the concatenation. Returns
    ``(ranks, new_state, niche, dist)``."""
    # fronts beyond the splitting front never survive: peel only that far
    ranks = nd_ranks(f, n_stop=n_survive, off_f=off_f)
    new_state, nadir, dirs = survive_norm(f, ranks, asp_points, state, off_f)
    niche, dist = associate_batch(f, dirs, new_state.ideal, nadir, off_f)
    return ranks, new_state, niche, dist


def survive_batch(f, asp_points, state: NormState, n_survive: int, gum_cut, gum_mem):
    """One survival round for every state.

    ``f`` (S, M, n_obj) merged objectives, ``asp_points`` (A, n_obj),
    ``gum_cut`` (S, A + n_obj) and ``gum_mem`` (S, M) the niching draws.
    Returns ``(mask (S, M) bool — exactly n_survive True per state,
    new_state, ranks)``."""
    ranks, new_state, niche, dist = survive_stages(f, asp_points, state, n_survive)
    if f.is_cuda:
        from ...kernels import survive_fill

        mask = survive_fill(gum_cut, gum_mem, ranks, niche, dist, n_survive).mask
    else:
        mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, n_survive)
    return mask, new_state, ranks

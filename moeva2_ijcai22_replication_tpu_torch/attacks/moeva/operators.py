"""Mixed-variable genetic operators on a batch of states.

Port of ``attacks/moeva/operators.py``: uniform parent selection,
mixed-variable two-point crossover (prob 0.9 per mating, independent cut
points and coin per type sub-vector) and polynomial mutation (eta=20,
per-gene prob 1/n_type, integer genes on ±0.5-extended bounds then rounded).

Random draws are inputs. JAX's threefry and the port's Philox stream cannot
agree, so every operator takes the numbers it consumes as tensors
(:class:`OffspringDraws`) and :func:`draw_offspring` makes them from a
``core.philox.PhiloxStream`` (kernel K0 on the card); the tests feed the JAX
package's own draws instead.
Everything carries a leading states axis ``S``.

:func:`make_offspring` launches kernel K5 (``kernels/csrc/offspring.cu``) on
CUDA tensors; on CPU tensors it runs the plain version below, which defines
the kernel's arithmetic one rounded operation at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core.codec import Codec


class OperatorTables(NamedTuple):
    """Per-gene tables: ``type_id`` 0 = real, 1 = int (categoricals count as
    int), 2 = softmax (rejected: not ported); ``rank_in_type`` is a gene's
    position within its type sub-vector."""

    type_id: torch.Tensor  # (L,) int64
    rank_in_type: torch.Tensor  # (L,) int64
    type_sizes: tuple  # (n_real, n_int, n_softmax) python ints
    mut_prob: torch.Tensor  # (L,) float64 — 1 / n_type
    int_mask: torch.Tensor  # (L,) bool

    def to(self, device) -> "OperatorTables":
        return self._replace(
            type_id=self.type_id.to(device),
            rank_in_type=self.rank_in_type.to(device),
            mut_prob=self.mut_prob.to(device),
            int_mask=self.int_mask.to(device),
        )


def make_operator_tables(codec: Codec) -> OperatorTables:
    int_mask = codec.int_mask_gen.cpu().numpy()
    if bool(codec.softmax_mask_gen.any()):
        raise NotImplementedError("softmax genes are not ported yet")
    type_id = int_mask.astype(np.int64)
    rank = np.zeros(len(type_id), dtype=np.int64)
    counters = [0, 0, 0]
    for i, t in enumerate(type_id):
        rank[i] = counters[t]
        counters[t] += 1
    sizes = np.array(counters, dtype=np.int64)
    return OperatorTables(
        type_id=torch.as_tensor(type_id),
        rank_in_type=torch.as_tensor(rank),
        type_sizes=tuple(int(c) for c in counters),
        mut_prob=torch.as_tensor(1.0 / np.maximum(sizes[type_id], 1)),
        int_mask=torch.as_tensor(int_mask),
    )


class OffspringDraws(NamedTuple):
    """Every random number one mating round consumes, for S states."""

    pairs: torch.Tensor  # (S, n_matings, 2) int — parent indices in [0, P)
    cut_a: torch.Tensor  # (3, S, n_matings) int in [0, 2**30) — first raw cut per type
    cut_b: torch.Tensor  # (3, S, n_matings) int in [0, 2**30) — second raw cut
    coins: torch.Tensor  # (3, S, n_matings) uniform [0, 1) — crossover coin per type
    mut_select: torch.Tensor  # (S, n_offsprings, L) uniform — mutate-this-gene draws
    mut_u: torch.Tensor  # (S, n_offsprings, L) uniform — polynomial-mutation draws


def offspring_fields(n_states: int, pop_size: int, n_offsprings: int, gen_length: int) -> list:
    """The Philox fields of one mating round (``core.philox``), in the
    order of :class:`OffspringDraws`; the two cuts of a type are one field
    (2, 3, S, n_matings)."""
    from ...core.philox import CUT, INTEGER, UNIFORM, Field

    n_mat = (n_offsprings + 1) // 2
    return [
        Field("pairs", INTEGER, (n_states, n_mat, 2), pop_size),
        Field("cuts", CUT, (2, 3, n_states, n_mat)),
        Field("coins", UNIFORM, (3, n_states, n_mat)),
        Field("mut_select", UNIFORM, (n_states, n_offsprings, gen_length)),
        Field("mut_u", UNIFORM, (n_states, n_offsprings, gen_length)),
    ]


def offspring_draws(out: dict) -> OffspringDraws:
    """:class:`OffspringDraws` from a draw call's fields."""
    return OffspringDraws(
        pairs=out["pairs"], cut_a=out["cuts"][0], cut_b=out["cuts"][1], coins=out["coins"],
        mut_select=out["mut_select"], mut_u=out["mut_u"],
    )


def draw_offspring(
    stream,
    n_states: int,
    pop_size: int,
    n_offsprings: int,
    gen_length: int,
    dtype=torch.float32,
) -> OffspringDraws:
    """The draws of one mating round from the Philox ``stream``, on its
    device: one call of :func:`offspring_fields`."""
    return offspring_draws(stream.draw(offspring_fields(n_states, pop_size, n_offsprings, gen_length), dtype))


def two_cuts(a_raw: torch.Tensor, b_raw: torch.Tensor, n: int):
    """Sorted swap segment [lo, hi) from two distinct cut points in [1, n).

    A 2-gene sub-vector (one interior cut) always swaps its second gene; a
    0- or 1-gene sub-vector never swaps (pymoo's ``n_var`` padding)."""
    m = max(n - 1, 1)
    if m == 1:
        fill = (1, n) if n == 2 else (0, 0)
        return torch.full_like(a_raw, fill[0]), torch.full_like(a_raw, fill[1])
    a = a_raw % m
    b = b_raw % max(m - 1, 1)
    b = torch.where(b >= a, b + 1, b)
    return torch.minimum(a, b) + 1, torch.maximum(a, b) + 1


def two_point_crossover(tables: OperatorTables, p1, p2, cut_a, cut_b, coins, prob: float = 0.9):
    """Mixed-variable two-point crossover of parents ``(S, n_matings, L)``."""
    cuts = [two_cuts(cut_a[k], cut_b[k], tables.type_sizes[k]) for k in range(3)]
    lo = torch.stack([c[0] for c in cuts], -1)[..., tables.type_id]
    hi = torch.stack([c[1] for c in cuts], -1)[..., tables.type_id]
    do = (coins < prob).movedim(0, -1)[..., tables.type_id]
    swap = (tables.rank_in_type >= lo) & (tables.rank_in_type < hi) & do
    return torch.where(swap, p2, p1), torch.where(swap, p1, p2)


def _pow_rn(t: torch.Tensor, exponent: float) -> torch.Tensor:
    """``t ** exponent`` in float64, rounded once to ``t``'s dtype. A float32
    ``pow`` rounds differently on the card, on the CPU and in kernel K5; a
    float64 one rounded once gives the same bits on all three. In float64
    this is ``t ** exponent``."""
    return (t.double() ** exponent).to(t.dtype)


def polynomial_mutation(tables: OperatorTables, x, xl, xu, mut_select, mut_u, eta: float = 20.0):
    """Polynomial mutation (Deb & Goyal) of ``x`` (S, N, L) within per-state
    bounds ``xl``/``xu`` broadcastable to it; zero-range genes stay put and
    results are clipped to the true bounds."""
    half = torch.tensor(0.5 - 1e-16, dtype=x.dtype, device=x.device)
    ext = torch.where(tables.int_mask, half, torch.zeros_like(half))
    exl = xl - ext
    exu = xu + ext
    rng = exu - exl
    ok = rng > 0
    safe_rng = torch.where(ok, rng, 1.0)

    u = mut_u
    d1 = (x - exl) / safe_rng
    d2 = (exu - x) / safe_rng
    mut_pow = 1.0 / (eta + 1.0)
    lower = u <= 0.5
    xy = torch.clamp(torch.where(lower, 1.0 - d1, 1.0 - d2), 0.0, 1.0)
    val = torch.where(
        lower,
        2.0 * u + (1.0 - 2.0 * u) * _pow_rn(xy, eta + 1.0),
        2.0 * (1.0 - u) + 2.0 * (u - 0.5) * _pow_rn(xy, eta + 1.0),
    )
    val = torch.clamp(val, min=0.0)
    deltaq = torch.where(lower, _pow_rn(val, mut_pow) - 1.0, 1.0 - _pow_rn(val, mut_pow))

    do = (mut_select < tables.mut_prob.to(x.dtype)) & ok
    y = torch.where(do, x + deltaq * safe_rng, x)
    y = torch.where(tables.int_mask, torch.round(y), y)
    return torch.minimum(torch.maximum(y, xl), xu)


def make_offspring(
    tables: OperatorTables,
    pop_x,  # (S, P, L)
    xl,  # (S, L)
    xu,  # (S, L)
    n_offsprings: int,
    draws: OffspringDraws,
    crossover_prob: float = 0.9,
    eta_mutation: float = 20.0,
):
    """One mating round for every state: selection, crossover, mutation.
    Returns (S, n_offsprings, L). Kernel K5 on CUDA tensors,
    :func:`make_offspring_plain` on CPU tensors."""
    fn = make_offspring_plain
    if pop_x.is_cuda:
        from ...kernels import offspring as fn
    return fn(tables, pop_x, xl, xu, n_offsprings, draws, crossover_prob, eta_mutation)


def make_offspring_plain(
    tables: OperatorTables, pop_x, xl, xu, n_offsprings: int, draws: OffspringDraws,
    crossover_prob: float = 0.9, eta_mutation: float = 20.0,
):
    """:func:`make_offspring` in plain PyTorch, the semantics of kernel K5."""
    rows = torch.arange(pop_x.shape[0], device=pop_x.device)[:, None]
    p1 = pop_x[rows, draws.pairs[..., 0]]
    p2 = pop_x[rows, draws.pairs[..., 1]]
    c1, c2 = two_point_crossover(
        tables, p1, p2, draws.cut_a, draws.cut_b, draws.coins, prob=crossover_prob
    )
    children = torch.cat([c1, c2], dim=1)[:, :n_offsprings]
    return polynomial_mutation(
        tables, children, xl[:, None, :], xu[:, None, :],
        draws.mut_select, draws.mut_u, eta=eta_mutation,
    )

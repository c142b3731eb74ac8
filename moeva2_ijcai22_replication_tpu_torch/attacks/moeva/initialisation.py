"""Initial population (port of ``attacks/moeva/initialisation.py``).

``tile``: every individual starts at the encoded initial state with integer
genes rounded. ``lp_ratio``: the last ``round(ratio * n_pop)`` individuals
are moved inside an Lp ε-ball in the normalised genetic box, clipped to it,
denormalised and integer-rounded; the rest stay at the initial state.

Random draws are inputs: :func:`ball_sample` and :func:`lp_ratio_init` take
the standard normal (L2) or uniform [-1, 1) (L∞) numbers, so a test can
feed them the JAX package's draws. Each operation is one rounded PyTorch
op that gives the same bits on the card and on the CPU: a left-to-right
sum of squares, a correctly rounded sqrt, true divisions.
"""

from __future__ import annotations

import torch

from ...core import codec as codec_lib
from ...core.codec import Codec
from ...core.norms import is_inf, is_l2, sqrt_rn, sum_last


def _scalar(like: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def ball_draw_shape(norm, shape: tuple) -> tuple:
    """The shape of the draws :func:`ball_sample` takes for perturbations of
    ``shape`` (..., d): (..., d + 2) normals under L2, (..., d) uniforms
    under L∞."""
    if is_l2(norm):
        return (*shape[:-1], shape[-1] + 2)
    if is_inf(norm):
        return tuple(shape)
    raise NotImplementedError(f"no ball sampler for norm {norm!r}")


def ball_sample(draws: torch.Tensor, d: int, eps: float, norm) -> torch.Tensor:
    """Uniform perturbations inside the Lp ε-ball, (..., d), from ``draws``:
    under L2 the first d coordinates of a (d + 2)-dimensional standard
    normal vector over its norm (the marginal of a uniform point of the
    ball), under L∞ the uniform [-1, 1) draws themselves; times ``eps``."""
    if is_l2(norm):
        u = draws / sqrt_rn(sum_last(draws * draws, keepdim=True))
        return u[..., :d] * _scalar(u, eps)
    if is_inf(norm):
        return draws * _scalar(draws, eps)
    raise NotImplementedError(f"no ball sampler for norm {norm!r}")


def tile_init(codec: Codec, x_init_ml: torch.Tensor, n_pop: int) -> torch.Tensor:
    """(S, D) initial states -> (S, n_pop, L) genetic population."""
    x0 = codec_lib.round_int_genes(codec, codec_lib.ml_to_genetic(codec, x_init_ml))
    return x0[:, None, :].expand(x0.shape[0], n_pop, codec.gen_length).contiguous()


def n_perturbed(n_pop: int, ratio: float) -> int:
    """Individuals :func:`lp_ratio_init` moves: ``round(ratio * n_pop)``,
    half to even as Python rounds."""
    return int(round(ratio * n_pop))


def lp_ratio_init(
    codec: Codec,
    x_init_ml: torch.Tensor,
    n_pop: int,
    xl_gen: torch.Tensor,
    xu_gen: torch.Tensor,
    draws: torch.Tensor | None,
    eps: float = 0.1,
    ratio: float = 0.5,
    norm=2,
) -> torch.Tensor:
    """Tile, then move the last :func:`n_perturbed` individuals: divide by
    the range (1 where a gene's range is 0, which then stays at its one
    value), add :func:`ball_sample` of ``draws`` (shape
    ``ball_draw_shape(norm, (S, n_pert, L))``), clip to [0, 1], multiply
    by the true range, add the lower bound and round the integer genes."""
    pop = tile_init(codec, x_init_ml, n_pop)
    n_pert = n_perturbed(n_pop, ratio)
    if n_pert == 0:
        return pop
    s, l = x_init_ml.shape[0], codec.gen_length
    want = ball_draw_shape(norm, (s, n_pert, l))
    if draws is None or tuple(draws.shape) != want:
        raise ValueError(f"lp_ratio_init needs draws of shape {want}, got "
                         f"{None if draws is None else tuple(draws.shape)}")
    rng = (xu_gen - xl_gen)[:, None, :]
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    base = (pop[:, -n_pert:, :] - xl_gen[:, None, :]) / safe
    delta = ball_sample(draws, l, eps, norm)
    pert = torch.clamp(base + delta, 0.0, 1.0) * rng + xl_gen[:, None, :]
    pop[:, -n_pert:, :] = codec_lib.round_int_genes(codec, pert)
    return pop

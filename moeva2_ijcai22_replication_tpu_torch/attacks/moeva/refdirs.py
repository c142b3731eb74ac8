"""Reference directions for the many-objective survival.

Port of ``attacks/moeva/refdirs.py``. ``energy_ref_dirs`` minimises the
Riesz s-energy of softmax-parameterised simplex points with Adam on a cosine
schedule, written out by hand to follow optax's ``adam`` +
``cosine_decay_schedule`` step for step, in float64. On the card the whole
descent is one launch of kernel K14 (``kernels/csrc/refdirs.cu``), once per
(n_dim, n_points, seed, n_iter, device) and process; on the CPU it runs
:func:`energy_descent_plain`, the kernel's twin: the analytic gradient in
the kernel's order of operations.
"""

from __future__ import annotations

import math
from functools import lru_cache
from itertools import combinations_with_replacement

import numpy as np
import torch


def das_dennis(n_dim: int, n_points: int) -> np.ndarray:
    """Das-Dennis simplex lattice with the largest partition count whose size
    does not exceed ``n_points`` (n_points=1 -> the centroid)."""
    if n_points <= 1:
        return np.full((1, n_dim), 1.0 / n_dim)
    n_part = 1
    while _dd_size(n_dim, n_part + 1) <= n_points:
        n_part += 1
    pts = [np.array(c, dtype=float) for c in _dd_compositions(n_dim, n_part)]
    return np.array(pts) / n_part


def _dd_size(n_dim: int, n_part: int) -> int:
    return math.comb(n_dim + n_part - 1, n_part)


def _dd_compositions(n_dim: int, n_part: int):
    for bars in combinations_with_replacement(range(n_part + 1), n_dim - 1):
        prev = 0
        comp = []
        for b in bars:
            comp.append(b - prev)
            prev = b
        comp.append(n_part - prev)
        yield comp


#: optax ``adam``'s constants and ``cosine_decay_schedule``'s initial rate
LR0, ADAM_B1, ADAM_B2, ADAM_EPS = 5e-2, 0.9, 0.999, 1e-8


def descent_schedule(n_iter: int) -> torch.Tensor:
    """(n_iter, 3) float64, per step: the cosine-decayed learning rate read
    at the step count before its increment, then Adam's bias corrections
    1 - b1**t and 1 - b2**t at the incremented count t. Computed on the
    host, an input of both the kernel and its twin."""
    rows = [
        (
            LR0 * (0.5 * (1.0 + math.cos(math.pi * min(step, n_iter) / n_iter))),
            1.0 - ADAM_B1 ** (step + 1),
            1.0 - ADAM_B2 ** (step + 1),
        )
        for step in range(n_iter)
    ]
    return torch.tensor(rows, dtype=torch.float64).reshape(n_iter, 3)


def _softmax_rows(theta: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis: e = exp(theta - max), each divided by
    the left-to-right sum of e."""
    ex = torch.exp(theta - theta.amax(-1, keepdim=True))
    tot = ex[:, 0]
    for k in range(1, ex.shape[1]):
        tot = tot + ex[:, k]
    return ex / tot[:, None].expand_as(ex)


def _left_to_right(terms: torch.Tensor) -> torch.Tensor:
    """The sum over axis 1 of ``terms`` (n, m, ...), one rounded addition
    at a time from column 0."""
    acc = terms[:, 0]
    for j in range(1, terms.shape[1]):
        acc = acc + terms[:, j]
    return acc


def energy_descent_plain(theta: torch.Tensor, s: float, sched: torch.Tensor) -> torch.Tensor:
    """Kernel K14's twin: ``softmax(theta)`` after one Adam step per row of
    ``sched`` (:func:`descent_schedule`) on the Riesz s-energy E = sum over
    i != j of d2_ij^(-s/2) of z = softmax(theta), float64 (n, n_dim).

    Each step, in the kernel's order: z = softmax(theta); point i's energy
    gradient -2s * sum_j w_ij (z_i - z_j), with w_ij = pow(d2_ij, -s/2 - 1)
    (0 for j = i), d2_ij summed over the dimensions from 0, the sum over j
    from 0 one rounded addition at a time; the softmax backward z * (g -
    <z, g>), <z, g> from dimension 0; then optax's Adam: mu = (1 - b1) g +
    b1 mu, nu = (1 - b2) g^2 + b2 nu, theta -= lr * (mu / c1) / (sqrt(nu /
    c2) + eps). Vectorised over i, the sums over j and the dimensions one
    column at a time."""
    theta = theta.clone()
    n = theta.shape[0]
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    off = ~torch.eye(n, dtype=torch.bool, device=theta.device)
    expo = torch.full((n, n), -s / 2.0 - 1.0, dtype=theta.dtype, device=theta.device)
    coef = -2.0 * s
    eps = torch.full_like(theta, ADAM_EPS)
    for lr, c1, c2 in sched.tolist():
        z = _softmax_rows(theta)
        diff = z[:, None, :] - z[None, :, :]
        d2 = _left_to_right((diff * diff).transpose(1, 2))
        w = torch.where(off, torch.pow(d2, expo), 0.0)
        g = coef * _left_to_right(w[:, :, None] * diff)
        dot = _left_to_right(z * g)
        g = z * (g - dot[:, None].expand_as(g))
        mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        mu_hat = mu / torch.full_like(mu, c1)
        nu_hat = nu / torch.full_like(nu, c2)
        theta = theta - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return _softmax_rows(theta)


def energy_descent(theta: torch.Tensor, s: float, n_iter: int) -> torch.Tensor:
    """:func:`energy_descent_plain` semantics; kernel K14 on a CUDA
    tensor."""
    if theta.is_cuda:
        from ...kernels import refdirs

        return refdirs(theta, descent_schedule(n_iter).to(theta.device), s)
    return energy_descent_plain(theta, s, descent_schedule(n_iter))


def start_point(n_dim: int, n_points: int, seed: int) -> np.ndarray:
    """The descent's seeded start: the log of a numpy Dirichlet draw,
    clipped at 1e-6, float64 (n_points, n_dim)."""
    init = np.random.default_rng(seed).dirichlet(np.ones(n_dim), n_points)
    return np.log(np.clip(init, 1e-6, 1.0))


def energy_ref_dirs(
    n_dim: int,
    n_points: int,
    seed: int = 1,
    n_iter: int = 3000,
    theta0: np.ndarray | None = None,
) -> np.ndarray:
    """Riesz s-energy reference directions on the unit simplex, s = n_dim + 1,
    from the CPU path (:func:`energy_descent_plain`).

    The start point is :func:`start_point`, or ``theta0`` when given — the
    tests pass the JAX package's own start point there."""
    if theta0 is None:
        return ref_points(n_dim, n_points, seed, n_iter, "cpu").numpy().copy()
    if n_points == 1:
        return np.full((1, n_dim), 1.0 / n_dim)
    theta = torch.as_tensor(np.array(theta0, np.float64))
    return energy_descent(theta, float(n_dim + 1), n_iter).numpy()


def ref_points(n_dim: int, n_points: int, seed: int = 1, n_iter: int = 3000, device="cpu") -> torch.Tensor:
    """:func:`energy_ref_dirs` from the seeded start as a float64 tensor on
    ``device``: one K14 launch on the card, once per (n_dim, n_points,
    seed, n_iter, device) and process. The tensor is shared: callers do not
    write into it."""
    return _ref_points(n_dim, n_points, seed, n_iter, str(torch.device(device)))


@lru_cache(maxsize=32)
def _ref_points(n_dim: int, n_points: int, seed: int, n_iter: int, device: str) -> torch.Tensor:
    if n_points == 1:
        return torch.full((1, n_dim), 1.0 / n_dim, dtype=torch.float64, device=device)
    theta = torch.as_tensor(start_point(n_dim, n_points, seed), device=device)
    return energy_descent(theta, float(n_dim + 1), n_iter)


def aspiration_ref_dirs(
    ref_points: np.ndarray, pop_per_ref_point: int = 1, mu: float = 0.1
) -> np.ndarray:
    """R-NSGA-III survival reference directions from aspiration points: per
    point, a mu-shrunk Das-Dennis cluster re-centred on the point's central
    projection onto the unit-simplex plane (octant-clipped and
    re-normalised), then the n_obj extreme axes."""
    n_obj = ref_points.shape[1]
    shrunk = mu * das_dennis(n_obj, pop_per_ref_point)
    cent = shrunk.mean(axis=0)
    out = []
    for p in ref_points:
        denom = p.sum()
        intercept = p / np.where(denom == 0, 1.0, denom)
        cluster = shrunk + (intercept - cent)
        if (cluster <= 0).any():
            cluster = np.clip(cluster, 0.0, None)
            cluster = cluster / cluster.sum(axis=1, keepdims=True)
        out.append(cluster)
    out.append(np.eye(n_obj))
    return np.concatenate(out, axis=0)


def rnsga3_pop_size(n_obj: int, n_pop: int, pop_per_ref_point: int = 1) -> int:
    """The RNSGA3 population size, n_ref_points * pop_per_ref_point + n_obj,
    without running the descent: the energy method gives n_pop points."""
    return n_pop * das_dennis(n_obj, pop_per_ref_point).shape[0] + n_obj


def rnsga3_geometry(n_obj: int, n_pop: int, pop_per_ref_point: int = 1, mu: float = 0.1, seed: int = 1):
    """(ref_dirs, pop_size): pop_size = n_ref_points * pop_per_ref_point + n_obj."""
    ref = energy_ref_dirs(n_obj, n_pop, seed=seed)
    dirs = aspiration_ref_dirs(ref, pop_per_ref_point, mu)
    return dirs, rnsga3_pop_size(n_obj, n_pop, pop_per_ref_point)

"""Reference directions for the many-objective survival.

Port of ``attacks/moeva/refdirs.py``. ``energy_ref_dirs`` minimises the
Riesz s-energy of softmax-parameterised simplex points with Adam on a cosine
schedule, written out by hand to follow optax's ``adam`` +
``cosine_decay_schedule`` step for step. It runs in float64 on the CPU: it
is set-up work of 3000 steps on an (n_points, n_dim) tensor.
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


def _riesz_energy(z: torch.Tensor, s: float) -> torch.Tensor:
    diff = z[:, None, :] - z[None, :, :]
    d2 = (diff * diff).sum(-1)
    off = ~torch.eye(z.shape[0], dtype=torch.bool)
    d2 = torch.where(off, d2, 1.0)
    return torch.where(off, d2 ** (-s / 2.0), 0.0).sum()


def _energy_descent(theta: torch.Tensor, s: float, n_iter: int) -> torch.Tensor:
    """optax.adam(cosine_decay_schedule(5e-2, n_iter)) on the energy of
    softmax(theta): b1=0.9, b2=0.999, eps=1e-8, bias-corrected moments, the
    learning rate read at the step count before its increment."""
    lr0, b1, b2, eps = 5e-2, 0.9, 0.999, 1e-8
    theta = theta.clone().requires_grad_(True)
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    for step in range(n_iter):
        (g,) = torch.autograd.grad(_riesz_energy(torch.softmax(theta, -1), s), theta)
        mu = b1 * mu + (1.0 - b1) * g
        nu = b2 * nu + (1.0 - b2) * g * g
        t = step + 1
        mu_hat = mu / (1.0 - b1**t)
        nu_hat = nu / (1.0 - b2**t)
        lr = lr0 * (0.5 * (1.0 + math.cos(math.pi * min(step, n_iter) / n_iter)))
        with torch.no_grad():
            theta -= lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return torch.softmax(theta.detach(), -1)


def energy_ref_dirs(
    n_dim: int,
    n_points: int,
    seed: int = 1,
    n_iter: int = 3000,
    theta0: np.ndarray | None = None,
) -> np.ndarray:
    """Riesz s-energy reference directions on the unit simplex, s = n_dim + 1.

    The start point is the log of a seeded numpy Dirichlet draw (clipped at
    1e-6), or ``theta0`` when given — the tests pass the JAX package's own
    start point there."""
    if theta0 is None:
        return _energy_ref_dirs_seeded(n_dim, n_points, seed, n_iter).copy()
    if n_points == 1:
        return np.full((1, n_dim), 1.0 / n_dim)
    theta = torch.as_tensor(np.array(theta0, np.float64))
    return _energy_descent(theta, float(n_dim + 1), n_iter).numpy()


@lru_cache(maxsize=32)
def _energy_ref_dirs_seeded(n_dim: int, n_points: int, seed: int, n_iter: int) -> np.ndarray:
    if n_points == 1:
        return np.full((1, n_dim), 1.0 / n_dim)
    init = np.random.default_rng(seed).dirichlet(np.ones(n_dim), n_points)
    theta = torch.as_tensor(np.log(np.clip(init, 1e-6, 1.0)))
    return _energy_descent(theta, float(n_dim + 1), n_iter).numpy()


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


def rnsga3_geometry(n_obj: int, n_pop: int, pop_per_ref_point: int = 1, mu: float = 0.1, seed: int = 1):
    """(ref_dirs, pop_size): pop_size = n_ref_points * pop_per_ref_point + n_obj."""
    ref_points = energy_ref_dirs(n_obj, n_pop, seed=seed)
    dirs = aspiration_ref_dirs(ref_points, pop_per_ref_point, mu)
    k = das_dennis(n_obj, pop_per_ref_point).shape[0]
    return dirs, ref_points.shape[0] * k + n_obj

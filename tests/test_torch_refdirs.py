"""Port parity of the reference directions: the lattices exactly, and the
energy descent (kernel K14's twin, ``energy_descent_plain``) from the JAX
package's own start point within a tolerance."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import refdirs as jref
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import refdirs as tref

#: |port - JAX| bound for energy_ref_dirs from the same start point, in
#: float64. Measured with the autograd descent: 2.2e-16 at 8 and 40 points,
#: 7.8e-15 at 100; with K14's twin (the analytic gradient): 1.1e-16,
#: 2.8e-16 and 1.0e-14 (3000 Adam steps; the two sides round pow/exp/softmax
#: and the gradient's sums differently). 1e-9 leaves margin without
#: admitting a different optimum.
ENERGY_ATOL = 1e-9


@pytest.mark.parametrize("n_dim,n_points", [(3, 1), (3, 10), (3, 40), (3, 100), (4, 30)])
def test_das_dennis_exact(n_dim, n_points):
    np.testing.assert_array_equal(jref.das_dennis(n_dim, n_points), tref.das_dennis(n_dim, n_points))


@pytest.mark.parametrize("k,mu", [(1, 0.1), (3, 0.1), (6, 0.3)])
def test_aspiration_ref_dirs_exact(k, mu):
    pts = np.random.default_rng(k).dirichlet(np.ones(3), 12)
    pts[0] = [1.0, 0.0, 0.0]  # an octant-clipped cluster
    np.testing.assert_array_equal(
        jref.aspiration_ref_dirs(pts, k, mu), tref.aspiration_ref_dirs(pts, k, mu)
    )


@pytest.mark.parametrize("n_points", [8, 40, 100])
def test_energy_ref_dirs_from_jax_start_point(n_points):
    key = jax.random.PRNGKey(1)
    init = jax.random.dirichlet(key, jnp.ones((3,)), (n_points,))
    theta0 = np.asarray(jnp.log(jnp.clip(init, 1e-6, 1.0)))
    want = jref.energy_ref_dirs(3, n_points, seed=1)
    got = tref.energy_ref_dirs(3, n_points, theta0=theta0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENERGY_ATOL)


def test_seeded_energy_ref_dirs_cover_the_simplex():
    pts = tref.energy_ref_dirs(3, 40, seed=1)
    np.testing.assert_allclose(pts.sum(-1), 1.0, atol=1e-12)
    assert (pts >= 0).all()
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1) + np.eye(40)
    nn = d.min(1)
    assert nn.min() / nn.max() > 0.5  # well spaced, as the JAX docstring states
    assert np.array_equal(pts, tref.energy_ref_dirs(3, 40, seed=1))


def test_rnsga3_geometry_pop_size():
    dirs, pop = tref.rnsga3_geometry(3, 40, seed=1)
    assert pop == 43 and dirs.shape == (43, 3)


def test_rnsga3_pop_size_runs_no_descent(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the population size needs no energy descent")

    monkeypatch.setattr(tref, "energy_descent", refuse)
    monkeypatch.setattr(tref, "energy_descent_plain", refuse)
    for n_pop, k in ((1, 1), (40, 1), (40, 3), (100, 6)):
        assert tref.rnsga3_pop_size(3, n_pop, k) == jref.rnsga3_geometry(3, n_pop, pop_per_ref_point=k)[1]


def test_descent_schedule_is_optax_adam_cosine():
    """The schedule K14 and its twin read: optax's cosine rate at the step
    count before its increment, and Adam's bias corrections at the count
    after it, in float64."""
    n_iter = 50
    sched = tref.descent_schedule(n_iter).numpy()
    rate = optax.cosine_decay_schedule(5e-2, n_iter)
    for step in (0, 1, 17, 49):
        np.testing.assert_allclose(sched[step, 0], float(rate(step)), rtol=1e-15, atol=0)
        assert sched[step, 1] == 1.0 - 0.9 ** (step + 1)
        assert sched[step, 2] == 1.0 - 0.999 ** (step + 1)


def test_ref_points_on_the_cpu_are_the_twins_and_cached():
    got = tref.ref_points(3, 12, seed=3, n_iter=40)
    theta = torch.as_tensor(tref.start_point(3, 12, 3))
    want = tref.energy_descent_plain(theta, 4.0, tref.descent_schedule(40))
    assert torch.equal(got, want)
    assert tref.ref_points(3, 12, seed=3, n_iter=40) is got
    assert torch.equal(tref.ref_points(3, 1), torch.full((1, 3), 1.0 / 3, dtype=torch.float64))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int64), b.view(torch.int64))


def _mirrored_descent(theta: torch.Tensor, s: float, sched: torch.Tensor) -> torch.Tensor:
    """``energy_descent_plain`` with each step's weights computed for the
    pairs i < j only and mirrored: w_ji = w_ij, and the gradient's term
    t_ji = w_ji (z_j - z_i) taken as -t_ij. Checks on the way that d2_ji,
    summed from z_j - z_i, has the bits of d2_ij. The pairs' pows go
    through one call on an (n, n) tensor, each at its (i, j) place and the
    lower triangle a placeholder, as the plain version's call lays them out:
    PyTorch's CPU pow rounds its vectorised body and its scalar tail
    differently (1 ulp on one of 780 weights at 40 points, step 27, when the
    780 pairs are one vector), where the card's pow is one function."""
    theta = theta.clone()
    n, d = theta.shape
    iu, ju = torch.triu_indices(n, n, 1)
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    expo = torch.full((n, n), -s / 2.0 - 1.0, dtype=theta.dtype)
    eps = torch.full_like(theta, tref.ADAM_EPS)
    for lr, c1, c2 in sched.tolist():
        z = tref._softmax_rows(theta)
        diff = z[iu] - z[ju]
        d2 = tref._left_to_right(diff * diff)
        back = z[ju] - z[iu]
        d2_ji = tref._left_to_right(back * back)
        assert _same_bits(d2, d2_ji)
        at = torch.ones((n, n), dtype=theta.dtype)
        at[iu, ju] = d2
        t = torch.pow(at, expo)[iu, ju][:, None] * diff
        terms = torch.zeros((n, n, d), dtype=theta.dtype)
        terms[iu, ju] = t
        terms[ju, iu] = -t
        g = -2.0 * s * tref._left_to_right(terms)
        dot = tref._left_to_right(z * g)
        g = z * (g - dot[:, None].expand_as(g))
        mu = (1.0 - tref.ADAM_B1) * g + tref.ADAM_B1 * mu
        nu = (1.0 - tref.ADAM_B2) * (g * g) + tref.ADAM_B2 * nu
        mu_hat = mu / torch.full_like(mu, c1)
        nu_hat = nu / torch.full_like(nu, c2)
        theta = theta - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return tref._softmax_rows(theta)


@pytest.mark.parametrize("n_points,n_iter", [(8, 300), (40, 300), (100, 200)])
def test_weights_once_a_pair_give_the_plain_descent(n_points, n_iter):
    """Kernel K14's premise: fl(a - b) = -fl(b - a), so d2_ij and d2_ji are
    the same bits, and so are their pows; w_ij (z_j - z_i) = -(w_ij (z_i -
    z_j)) exactly. One weight a pair, mirrored, gives energy_descent_plain
    bit for bit (float64)."""
    theta = torch.as_tensor(tref.start_point(3, n_points, n_points))
    sched = tref.descent_schedule(n_iter)
    got = _mirrored_descent(theta, 4.0, sched)
    assert _same_bits(got, tref.energy_descent_plain(theta, 4.0, sched))

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

"""Port parity of the reference directions: the lattices exactly, and the
energy descent from the JAX package's own start point within a tolerance."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moeva2_ijcai22_replication_tpu.attacks.moeva import refdirs as jref
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import refdirs as tref

#: |port - JAX| bound for energy_ref_dirs from the same start point, in
#: float64. Measured: 2.2e-16 at 8 and 40 points, 7.8e-15 at 100 (3000 Adam
#: steps; the two sides round pow/exp/softmax differently). 1e-9 leaves
#: margin without admitting a different optimum.
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


@pytest.mark.parametrize("n_points", [8, 40])
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

"""The surrogate's forward outside the attacks (kernel K16's twins) against
the JAX package: the PGD runner's labels (JAX ``experiments/pgd.py``'s
``predict_proba(x).argmax(-1)``) exactly, and the pipelines' class-1
probabilities (JAX ``experiments/defense.py`` ``proba1``) in float64 within
``PROBA1_ATOL``. Weights are the JAX package's, carried by
``params_from_numpy``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.experiments import defense as jdefense
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu_torch.experiments import defense as pdefense
from moeva2_ijcai22_replication_tpu_torch.experiments.pgd import surrogate_labels
from moeva2_ijcai22_replication_tpu_torch.models import io as pio
from moeva2_ijcai22_replication_tpu_torch.models.mlp import proba1_plain
from moeva2_ijcai22_replication_tpu_torch.models.train import stack_tensors

#: |port - JAX| bound of the class-1 probabilities in float64: the port sums
#: each unit's inputs one rounded operation at a time, XLA's dot in its own
#: order; both round each sum of a few hundred terms near 1e-16 relative.
#: 1e-12 leaves margin without admitting another forward.
PROBA1_ATOL = 1e-12

#: (widths, rows): LCLD's and botnet's stacks, and a 1-unit sigmoid head
STACKS = (((47, 64, 32, 16, 2), 301), ((756, 64, 64, 32, 2), 67), ((57, 16, 1), 129))


class Affine:
    """A scaler: x * scale + offset, numpy in and out, as both pipelines'
    ``transform`` takes it."""

    def __init__(self, d: int, seed: int):
        rng = np.random.default_rng(seed)
        self.scale, self.offset = rng.uniform(0.5, 2.0, d), rng.uniform(-0.5, 0.5, d)

    def transform(self, x):
        return np.asarray(x) * self.scale + self.offset


class Identity:
    def transform(self, x):
        return np.asarray(x)


def surrogates(widths, seed: int):
    """The JAX surrogate of ``widths`` from its own seeded init, and the
    port's carrying the same weights."""
    model = jmlp.MLP(hidden=widths[1:-1], n_classes=widths[-1])
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, widths[0])))
    return jio.Surrogate(model, params), pio.Surrogate(pio.params_from_numpy(jax.tree.map(np.asarray, params)))


def rows(widths, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 2.0, (n, widths[0]))


@pytest.mark.parametrize("widths,n", STACKS)
def test_labels_equal_jax(widths, n):
    jsur, psur = surrogates(widths, n)
    x = rows(widths, n, n + 1).astype(np.float32)
    want = np.asarray(jsur.predict_proba(jnp.asarray(x, jnp.float32))).argmax(-1)
    got = surrogate_labels(psur, x, "cpu", torch.float32)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n  # both classes occur


@pytest.mark.parametrize("widths,n", STACKS)
def test_proba1_equals_jax(widths, n):
    jsur, psur = surrogates(widths, n + 2)
    scaler = Affine(widths[0], n)
    x = rows(widths, n, n + 3)
    want = jdefense.proba1(jsur, scaler, x)
    got = pdefense.proba1(psur, scaler, x, "cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBA1_ATOL)


def test_proba1_on_the_cpu_is_the_twin():
    _, psur = surrogates(STACKS[0][0], 5)
    x = rows(STACKS[0][0], 40, 6)
    widths, params, layers = stack_tensors(psur.model, torch.float64, "cpu")
    assert widths == STACKS[0][0] and params.dtype == torch.float64
    want = proba1_plain(layers, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(pdefense.proba1(psur, Identity(), x, "cpu"), want)

"""Port parity of the surrogate: the JAX package's params carried across
(``params_from_numpy``) and read from its ``.msgpack`` files."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu_torch.models import io as tio
from moeva2_ijcai22_replication_tpu_torch.models import mlp as tmlp

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


def _jax_surrogate(hidden=(64, 32, 16), n_classes=2, seed=1):
    model = jmlp.MLP(hidden=hidden, n_classes=n_classes)
    return jio.Surrogate(model, jmlp.init_params(model, 47, seed=seed))


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("n_classes", [2, 1])
def test_logits_and_probs_match(n_classes):
    js = _jax_surrogate(n_classes=n_classes)
    ts = tio.Surrogate(tio.params_from_numpy(_numpy_tree(js.params), dtype=torch.float64))
    x = np.random.default_rng(0).uniform(0, 1, (64, 47))
    with torch.no_grad():
        lt = ts.logits(torch.as_tensor(x)).numpy()
        pt = ts.predict_proba(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(np.asarray(js.logits(jnp.asarray(x))), lt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(js.predict_proba(jnp.asarray(x))), pt, rtol=0, atol=1e-12)
    assert pt.shape == (64, 2)


def test_float32_surrogate_within_float32_tolerance():
    js = _jax_surrogate()
    ts = tio.Surrogate(tio.params_from_numpy(_numpy_tree(js.params), dtype=torch.float32))
    x = np.random.default_rng(1).uniform(0, 1, (64, 47))
    with torch.no_grad():
        pt = ts.predict_proba(torch.as_tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(np.asarray(js.predict_proba(jnp.asarray(x))), pt, rtol=0, atol=1e-6)


def test_flax_kernels_are_transposed():
    js = _jax_surrogate()
    model = tio.params_from_numpy(_numpy_tree(js.params))
    k0 = np.asarray(js.params["params"]["Dense_0"]["kernel"])
    assert k0.shape == (47, 64)
    np.testing.assert_array_equal(model.layers[0].weight.detach().numpy(), k0.T.astype(np.float32))
    assert model.hidden == (64, 32, 16) and model.n_classes == 2


def test_msgpack_written_by_jax_loads(tmp_path):
    js = _jax_surrogate(hidden=(64, 64, 32), seed=4)
    path = str(tmp_path / "nn.msgpack")
    jio.save_params(js, path)
    ts = tio.load_params(path, dtype=torch.float64)
    assert ts.model.hidden == (64, 64, 32)
    x = np.random.default_rng(2).uniform(0, 1, (16, 47))
    with torch.no_grad():
        pt = ts.predict_proba(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(np.asarray(js.predict_proba(jnp.asarray(x))), pt, rtol=0, atol=1e-12)


def test_seeded_lcld_mlp_is_deterministic():
    a, b = tmlp.lcld_mlp(seed=3), tmlp.lcld_mlp(seed=3)
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight)
        assert not la.bias.any()
    assert not torch.equal(a.layers[0].weight, tmlp.lcld_mlp(seed=4).layers[0].weight)
    w = a.layers[0].weight.detach()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(47) / 0.8796 + 1e-6

"""The port's training (``models/train.py``) against the JAX package's, on the CPU.

The JAX package runs under x64 here (``tests/conftest.py``): flax computes
a float32 model's forward and backward in float64, optax keeps float32
gradients, parameters and moments. The port's plain step does the same on
float64 rows. Both start from the same flax ``model.init`` tree (random
draws are inputs).

Tolerances, each with its reason:

- the gradient (Adam's first moment after one step): equal bit for bit;
- parameters after one step: within 2 float32 ulps of max(|p|, lr) (the
  step of a parameter near 0 is about lr). XLA's CPU backend fuses the
  jitted Adam update with arithmetic that is not IEEE operation by
  operation (the same update unjitted equals the port's bit for bit, while
  the jitted one differs from it by up to 2 ulps, moments equal);
- parameters after 20 steps: within 1e-5 of max(|p|, lr);
- losses: rtol 1e-6; ``fit_mlp``'s histories: rtol 1e-6, the same epochs
  and the same best epoch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models import train as jtrain
from moeva2_ijcai22_replication_tpu.utils import in_out as jin_out
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.models import io as pio
from moeva2_ijcai22_replication_tpu_torch.models import mlp as pmlp
from moeva2_ijcai22_replication_tpu_torch.models import train as ptrain
from moeva2_ijcai22_replication_tpu_torch.utils import in_out as pin_out

torch.set_num_threads(1)

LR = 1e-3
D = 9
WIDTHS = (D, 64, 32, 16, 2)
STEP_ATOL_REL = 1e-5  # of max(|p|, lr), after 20 steps
LOSS_RTOL = 1e-6


def _blobs(n=256, d=8, seed=0):
    """``tests/test_train.py``'s linearly separable-ish two-class data."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    x = rng.normal(0, 1, (n, d)) + y[:, None] * 2.0
    return x.astype(np.float64), y.astype(np.int64)


def _init(d: int, seed: int):
    """flax's ``model.init`` of the LCLD topology as a numpy tree."""
    return jax.tree.map(np.asarray, jmlp.lcld_mlp().init(jax.random.PRNGKey(seed), jnp.zeros((1, d))))


def _flat(tree) -> np.ndarray:
    return pio.flat_from_tree(jax.tree.map(np.asarray, tree)).numpy()


def _scale(p: np.ndarray) -> np.ndarray:
    return np.maximum(np.abs(p), np.float32(LR))


def _batches(n_steps: int, batch: int, pad: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        x = rng.normal(0, 1, (batch, D))
        y = rng.integers(0, 2, batch)
        w = np.ones(batch, np.float32)
        if pad:
            x[-pad:], y[-pad:], w[-pad:] = x[0], y[0], 0.0  # index-0 rows of weight 0, as fit_mlp pads
        yield x, y, w


CASES = [(None, 0), (None, 7), ({0: 1.0, 1: 3.0}, 0), ({0: 1.0, 1: 3.0}, 7), ({1: 0.5}, 3)]


@pytest.mark.parametrize("class_weight, pad", CASES, ids=[f"cw{bool(c)}-pad{p}" for c, p in CASES])
@pytest.mark.parametrize("n_steps", [1, 20])
def test_steps_match_jax(class_weight, pad, n_steps):
    """``train_step_plain`` against JAX's jitted ``make_train_step`` with
    ``optax.adam``, from the same init and state, batch by batch."""
    model = jmlp.lcld_mlp()
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, D)))
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    cw_j = None
    if class_weight is not None:
        cw_j = jnp.asarray([class_weight.get(i, 1.0) for i in range(max(class_weight) + 1)])
    step = jax.jit(jtrain.make_train_step(model, tx, cw_j))
    flat = pio.flat_from_tree(jax.tree.map(np.asarray, params))
    state = ptrain.AdamState.zeros(flat)
    cw = torch.tensor(ptrain.class_weight_vector(class_weight), dtype=torch.float64)
    for i, (x, y, w) in enumerate(_batches(n_steps, 40, pad, seed=i_seed(class_weight, pad))):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
        got = ptrain.train_step_plain(WIDTHS, flat, state.mu, state.nu, torch.as_tensor(x), torch.as_tensor(y),
                                      torch.as_tensor(w), cw, ptrain.adam_scalars(state.count, LR))
        state.count += 1
        np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_RTOL)
        if i == 0:
            np.testing.assert_array_equal(state.mu.numpy(), _flat(opt_state[0].mu))
    want = _flat(params)
    err = np.abs(flat.numpy() - want)
    if n_steps == 1:
        assert (err <= 2 * np.spacing(_scale(want))).all(), (err / np.spacing(_scale(want))).max()
    else:
        assert (err <= STEP_ATOL_REL * _scale(want)).all(), (err / _scale(want)).max()
    assert state.count == int(opt_state[0].count)


def i_seed(class_weight, pad) -> int:
    return 17 * pad + (0 if class_weight is None else len(class_weight))


def test_validation_loss_matches_jax():
    x, y = _blobs(70, D, seed=4)
    init = _init(D, 2)
    cw = [1.0, 2.5]
    want = float(jtrain.ce_loss(jmlp.lcld_mlp(), init, jnp.asarray(x), jnp.asarray(y), jnp.asarray(cw)))
    flat = pio.flat_from_tree(init)
    part = ptrain.train_loss(WIDTHS, flat, torch.as_tensor(x), torch.as_tensor(y), torch.tensor(cw, dtype=torch.float64))
    assert part.shape == (5,)  # tiles of 16 rows, the last partial
    np.testing.assert_allclose(ptrain.mean_loss(part, len(y)), want, rtol=1e-12)
    with torch.no_grad():
        got = float(ptrain.ce_loss(pio.params_from_numpy(init), torch.as_tensor(x), torch.as_tensor(y), cw))
    np.testing.assert_allclose(got, want, rtol=1e-12)


FITS = {
    "plateau": dict(epochs=200, batch_size=64, patience=3, seed=1),
    "class_weight_tail": dict(epochs=12, batch_size=48, patience=25, seed=2, class_weight={0: 1.0, 1: 3.0}),
}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_mlp_matches_jax(name):
    """``fit_mlp`` on ``tests/test_train.py``'s early-stopping setup (and
    with class weights and a padded tail batch: 128 rows in batches of 48):
    the same history within rtol 1e-6, the same epochs and best epoch, and
    the kept parameters are the best epoch's."""
    kw = FITS[name]
    x, y = _blobs(128)
    rng = np.random.default_rng(3)
    xv = rng.normal(0, 1, (64, x.shape[1]))
    yv = rng.integers(0, 2, 64)
    jfit = jtrain.fit_mlp(jmlp.lcld_mlp(), x, y, x_val=xv, y_val=yv, **kw)
    pfit = ptrain.fit_mlp(pmlp.lcld_mlp(x.shape[1]), x, y, x_val=xv, y_val=yv, init_params=_init(x.shape[1], kw["seed"]),
                          device="cpu", **kw)
    jh, ph = np.array(jfit.history), np.array(pfit.history)
    assert jh.shape == ph.shape
    np.testing.assert_allclose(ph, jh, rtol=1e-6)
    assert int(np.argmin(ph[:, 2])) == int(np.argmin(jh[:, 2]))
    np.testing.assert_allclose(pfit.best_val_loss, jfit.best_val_loss, rtol=1e-6)
    cw = ptrain.class_weight_vector(kw.get("class_weight"))
    with torch.no_grad():
        vl = float(ptrain.ce_loss(pfit.surrogate.model, torch.as_tensor(xv), torch.as_tensor(yv), cw))
    np.testing.assert_allclose(vl, pfit.best_val_loss, rtol=1e-6)
    if name == "plateau":
        assert len(pfit.history) < 200 and pfit.history[-1][0] - int(np.argmin(ph[:, 2])) >= 3


def test_fit_mlp_without_init_draws_from_the_seed_and_learns():
    x, y = _blobs()
    a = ptrain.fit_mlp(pmlp.lcld_mlp(8), x, y, epochs=15, batch_size=64, seed=1, device="cpu")
    b = ptrain.fit_mlp(pmlp.lcld_mlp(8), x, y, epochs=15, batch_size=64, seed=1, device="cpu")
    assert a.history == b.history
    with torch.no_grad():
        preds = a.surrogate.predict_proba(torch.as_tensor(x, dtype=torch.float32)).argmax(-1).numpy()
    assert (preds == y).mean() > 0.9


def test_float32_fit_follows_the_kernels_order():
    """The float32 CPU path (the card's arithmetic) trains too, and agrees
    with the float64 path to float32 precision."""
    x, y = _blobs(96)
    init = _init(8, 5)
    f32 = ptrain.fit_mlp(pmlp.lcld_mlp(8), x, y, epochs=3, batch_size=32, init_params=init, device="cpu",
                         dtype=torch.float32)
    f64 = ptrain.fit_mlp(pmlp.lcld_mlp(8), x, y, epochs=3, batch_size=32, init_params=init, device="cpu")
    np.testing.assert_allclose(np.array(f32.history), np.array(f64.history), rtol=1e-4)


def test_fit_mlp_refuses_the_cpu_without_asking():
    x, y = _blobs(32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.fit_mlp(pmlp.lcld_mlp(8), x, y, epochs=1)
    with pytest.raises(ValueError, match="labels must lie"):
        ptrain.fit_mlp(pmlp.lcld_mlp(8), x, y + 1, epochs=1, device="cpu")


@pytest.mark.parametrize("widths, n", [((D, 64, 32, 16, 2), 40), ((D, 64, 64, 32, 2), 17)])
def test_input_grad_matches_jax(widths, n):
    """The attribution gradient (K12's plain version) against JAX's
    ``vmap(grad(p0))`` (``experiments/defense.py:175``), float64."""
    model = jmlp.MLP(hidden=widths[1:-1])
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, D)))
    sur = jio.Surrogate(model, params)
    x = np.random.default_rng(n).uniform(0, 1, (n, D))
    want = np.asarray(jax.vmap(jax.grad(lambda r: sur.predict_proba(r[None, :])[0, 0]))(jnp.asarray(x)))
    got = ptrain.input_grad(widths, pio.flat_from_tree(jax.tree.map(np.asarray, params)), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_auroc_equal():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 2, 200)
    p = np.round(np.clip(y * 0.3 + rng.random(200) * 0.8, 0, 1), 2)
    assert ptrain.auroc(p, y) == jtrain.auroc(p, y)
    assert np.isnan(ptrain.auroc(np.linspace(0, 1, 5), np.ones(5, np.int64)))


SPLITS = [(100, 0.5, 0.1), (256, 0.3, 0.1), (1000, 0.07, 0.1), (57, 0.5, 0.1), (333, 0.5, 0.25), (9001, 0.5, 0.1)]


@pytest.mark.parametrize("n, share, test_size", SPLITS)
def test_split_equals_sklearn(n, share, test_size):
    sk = pytest.importorskip("sklearn.model_selection")
    rng = np.random.default_rng(n)
    y = (rng.random(n) < share).astype(np.int64)
    x = np.arange(n)[:, None] * np.ones((1, 3))
    want = sk.train_test_split(x, y, test_size=test_size, random_state=42, stratify=y)
    got = ptrain.train_test_split(x, y, test_size=test_size, random_state=42)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_adam_state_carries_both_ways():
    """optax's ``ScaleByAdamState`` after 3 steps into the port's state; the
    next step from it equals JAX's; and back to optax's trees bit for bit."""
    model = jmlp.lcld_mlp()
    params = model.init(jax.random.PRNGKey(9), jnp.zeros((1, D)))
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    step = jax.jit(jtrain.make_train_step(model, tx))
    batches = list(_batches(4, 32, 0, seed=21))
    for x, y, w in batches[:3]:
        params, opt_state, _ = step(params, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    adam = jax.tree.map(np.asarray, opt_state[0])
    state = pio.adam_state_from_numpy(adam.count, adam.mu, adam.nu)
    assert state.count == 3
    count, mu, nu = pio.adam_state_to_numpy(state, WIDTHS)
    assert count == adam.count and count.dtype == np.int32
    for a, b in zip(jax.tree.leaves((mu, nu)), jax.tree.leaves((adam.mu, adam.nu))):
        np.testing.assert_array_equal(a, b)
    flat = pio.flat_from_tree(jax.tree.map(np.asarray, params))
    x, y, w = batches[3]
    params, opt_state, _ = step(params, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    ptrain.train_step_plain(WIDTHS, flat, state.mu, state.nu, torch.as_tensor(x), torch.as_tensor(y),
                            torch.as_tensor(w), torch.ones(2, dtype=torch.float64), ptrain.adam_scalars(state.count, LR))
    want = _flat(params)
    assert (np.abs(flat.numpy() - want) <= STEP_ATOL_REL * _scale(want)).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_msgpack_models_load_in_either_package(tmp_path, writer):
    init = _init(D, 6)
    path = str(tmp_path / "nn.msgpack")
    if writer == "jax":
        jio.save_classifier(jio.Surrogate(jmlp.lcld_mlp(), init), path)
    else:
        pio.save_classifier(pio.Surrogate(pio.params_from_numpy(init)), path)
    x = np.random.default_rng(0).uniform(size=(5, D))
    want = np.asarray(jio.load_classifier(path).predict_proba(jnp.asarray(x, jnp.float32)))
    with torch.no_grad():
        got = pio.load_classifier(path).predict_proba(torch.as_tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(pio.flat_from_tree(jax.tree.map(np.asarray, jio.load_classifier(path).params)),
                                  pio.flat_from_tree(init))


def test_training_kernel_limits_match_the_header():
    import re

    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    header = (build.PACKAGE_DIR / "csrc" / "kernels.h").read_text()
    consts = dict(re.findall(r"constexpr int (kTrain\w+) = (\d+);", header))
    assert int(consts["kTrainTileRows"]) == ptrain.TILE_ROWS
    assert int(consts["kTrainMaxLayers"]) == kernels.TRAIN_MAX_LAYERS


class OneColumn:
    """A classifier with a 1-column (sigmoid-style) probability."""

    def __init__(self, model):
        self.model = model

    def predict_proba(self, x):
        return self.model.predict_proba(x)[:, 1:]


@pytest.mark.parametrize("head", [1, 2])
def test_host_classifier_matches_jax(tmp_path, head):
    """``load_model`` on a ``.joblib`` sklearn model: the host wrapper, with
    a 1-column probability expanded to two, as the JAX package's."""
    pytest.importorskip("sklearn")
    import joblib
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 4))
    y = (x[:, 0] > 0).astype(int)
    model = LogisticRegression().fit(x, y)
    path = str(tmp_path / "model.joblib")
    joblib.dump(model if head == 2 else OneColumn(model), path)
    got, want = pin_out.load_model(path), jin_out.load_model(path)
    assert isinstance(got, pin_out.HostClassifier)
    np.testing.assert_array_equal(got.predict_proba(x[:7]), want.predict_proba(x[:7]))
    assert got.predict_proba(x[:7]).shape == (7, 2)

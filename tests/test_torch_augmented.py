"""Port parity of the augmented LCLD domain (``lcld_augmented``: 47 base
features and 10 XOR pair features of k = 5 important features, 10 + 10
terms) against the JAX package, on the CPU with x64 on.

The artifacts are ``problems.synthetic_lcld_augmented_problem``'s files
(the augmented schema, ``important_features.npy``) read by both packages'
classes, and one 57-input surrogate made by the JAX package's
``init_params``. Tolerances:

- the XOR features, ``augment`` and the consistency terms: equal, edge rows
  included (a feature exactly at its threshold, one ulp below, NaN; an
  augmented column at 0, 1 and 0.5);
- the terms in float64: within 1e-12 relative (the same operations); the
  repair: equal but for the installment, which XLA's and PyTorch's ``pow``
  may round apart in the last ulp (1e-9, as ``test_torch_core.py``);
- the gradient in float64: rtol 1e-12 with a floor of 1e-12 of the largest
  entry, NaN and inf where JAX has them (``test_torch_pgd.py``'s rule);
- PGD runs and both runners' PGD metrics in float64: equal up to that
  rule, o1..o7 exactly; MoEvA's draws differ between the packages, so its
  generation steps are fed the JAX engine's draws (as
  ``test_torch_engine.py``) and its runner is held against the port's own
  engine;
- float32: the port compares a feature with its threshold rounded to
  float32 (the JAX package's rule without x64); away from the thresholds
  the float32 plain path is within ``test_torch_pgd.py``'s and
  ``test_torch_engine.py``'s float32 tolerances of JAX's float64.
"""

from __future__ import annotations

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import _niche_gumbels
from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.domains import augmentation as jaug
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldAugmentedConstraints as JAug
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.experiments import moeva as jmoeva
from moeva2_ijcai22_replication_tpu.experiments import pgd as jpgd
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import GenerationDraws, evaluate_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import grad_and_terms_plain, pgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.domains import augmentation as taug
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldAugmentedConstraints, LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import moeva as pmoeva
from moeva2_ijcai22_replication_tpu_torch.experiments import pgd as ppgd
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import from_sklearn_minmax, save_npz
from moeva2_ijcai22_replication_tpu_torch.problems import (
    LCLD_AUGMENTED_EDGE_ROWS, lcld_augmented_edge_rows, synthetic_lcld_augmented_problem,
)
from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash
from test_torch_engine import _assert_carry_equal
from test_torch_operators import jax_offspring_draws
from test_torch_pgd import _close as close_as_pgd
from test_torch_runners import _run_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RQ2_LOSS = "constraints+flip+adaptive_eps_step+repair"
N_STATES = 24
D = 57


@pytest.fixture(scope="module")
def aug(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("augmented")
    cons, _, scaler, x = synthetic_lcld_augmented_problem(str(tmp), N_STATES)
    paths = {"features": str(tmp / "features_augmented.csv"), "constraints": str(tmp / "constraints_augmented.csv")}
    model = jmlp.lcld_mlp()
    params = jmlp.init_params(model, D, seed=1)
    rng = np.random.default_rng(0)
    # unscaled rows off the data (violated terms, XOR columns off their
    # pairs), then the edge rows
    xs = np.clip(scaler.transform(x) + rng.normal(scale=0.05, size=x.shape), 0.0, 1.0)
    u = (xs - scaler.min_) / scaler.scale
    u[:LCLD_AUGMENTED_EDGE_ROWS] = lcld_augmented_edge_rows(x, cons.important_features, None,
                                                             np.float64)[:LCLD_AUGMENTED_EDGE_ROWS]
    return {
        "dir": tmp, "paths": paths, "cons": cons, "jcons": JAug(paths["features"], paths["constraints"]),
        "x": x, "xs": xs, "u": u, "scaler": scaler, "y": rng.integers(0, 2, N_STATES),
        "jsur": jio.Surrogate(model, params), "tree": jax.tree.map(np.asarray, params),
    }


def _base_paths(aug):
    """The augmented features with the base constraints file (10 rows), as
    ``LcldConstraints`` takes them."""
    return aug["paths"]["features"], str(aug["dir"] / "constraints.csv")


def _close(got, want, what=""):
    """float64 values within rtol 1e-12 and 1e-12 of the largest finite
    entry, NaN and inf where JAX has them (``test_torch_pgd.py``'s rule)."""
    close_as_pgd(got, want, torch.float64, what)


# -- the XOR features and their terms ------------------------------------------


@pytest.mark.parametrize("fn", ["pair_table", "xor_features", "augment", "consistency_terms", "PairTables"])
def test_xor_features_and_terms_equal_jax(aug, fn):
    imp = aug["cons"].important_features
    u = aug["u"]
    assert np.isnan(u[2, imp[:, 0].astype(int)]).all() and (u[3:6, 47:] == [[0.0], [1.0], [0.5]]).all()
    if fn == "pair_table":
        for got, want in zip(taug.pair_table(imp), jaug.pair_table(imp)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        assert taug.n_pairs(imp) == jaug.n_pairs(imp) == 10
        return
    if fn == "PairTables":
        got = taug.PairTables.build(imp).consistency_terms(torch.as_tensor(u)).numpy()
        want = np.asarray(jaug.PairTables.build(imp).consistency_terms(jnp.asarray(u)))
    elif fn == "augment":
        got = getattr(taug, fn)(torch.as_tensor(u[:, :47]), imp).numpy()
        want = np.asarray(getattr(jaug, fn)(jnp.asarray(u[:, :47]), imp))
    else:
        got = getattr(taug, fn)(torch.as_tensor(u), imp).numpy()
        want = np.asarray(getattr(jaug, fn)(jnp.asarray(u), imp))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the edges: at the threshold >= holds, one ulp below and at NaN not
    feats, thr = imp[:, 0].astype(int), imp[:, 1]
    assert (u[0, feats] >= thr).all() and not (u[1, feats] >= thr).any() and not (u[2, feats] >= thr).any()


def test_float32_rows_compare_with_the_threshold_in_float32(aug):
    """In float32 the threshold is rounded once to float32: a feature at
    that rounding is above it, one ulp below is not (the JAX package's
    comparison without x64, where ``jnp.asarray`` rounds the means)."""
    imp = aug["cons"].important_features
    rows = lcld_augmented_edge_rows(aug["x"], imp, None, np.float32)[:2]
    thr32 = imp[:, 1].astype(np.float32)
    above = np.stack([rows[:, int(k)] >= t for k, t in zip(imp[:, 0], thr32)], -1)
    assert above[0].all() and not above[1].any()
    idx, thr = taug.pair_table(imp)
    thr = thr.astype(np.float32)
    want = np.logical_xor(rows[:, idx[:, 0]] >= thr[:, 0], rows[:, idx[:, 1]] >= thr[:, 1]).astype(np.float32)
    got = taug.xor_features(torch.as_tensor(rows), imp)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# -- the constraint set ---------------------------------------------------------


def test_registry_constraints_match_jax_terms(aug):
    cons, jcons, u = aug["cons"], aug["jcons"], aug["u"]
    assert isinstance(cons, LcldAugmentedConstraints) and cons.n_constraints == jcons.n_constraints == 20
    for name in ("evaluate", "evaluate_smooth"):
        got = getattr(cons, name)(torch.as_tensor(u)).numpy()
        want = np.asarray(getattr(jcons, name)(jnp.asarray(u)))
        assert got.shape == want.shape == (N_STATES, 20)
        _close(got, want, name)
        np.testing.assert_array_equal(got[:, 10:], want[:, 10:])
    # what K1 and K7 read: the pairs' features and thresholds in float32
    tables = cons.kernel_tables("cpu")
    idx, thr = taug.pair_table(cons.important_features)
    np.testing.assert_array_equal(tables.idx.numpy(), idx)
    np.testing.assert_array_equal(tables.thr.numpy(), thr.astype(np.float32))
    assert tables.thr.dtype == torch.float32 and tables.idx.dtype == torch.int32


@pytest.mark.parametrize("cls", ["augmented", "base"])
def test_repair_matches_jax(aug, cls):
    u = aug["u"]
    if cls == "augmented":
        cons, jcons = aug["cons"], aug["jcons"]
    else:
        cons, jcons = (cls(*_base_paths(aug)) for cls in (LcldConstraints, JLcld))
        np.testing.assert_array_equal(cons.important_features, jcons.important_features)
    got = cons.repair(torch.as_tensor(u)).numpy()
    want = np.asarray(jcons.repair(jnp.asarray(u)))
    assert got.shape == want.shape == u.shape
    other = np.ones(D, bool)
    other[3] = False
    np.testing.assert_array_equal(got[:, other], want[:, other])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-9)
    # the pairs re-derived from the repaired base: no pair term is violated
    assert not cons.evaluate(torch.as_tensor(got))[:, 10:].any()


def test_missing_important_features_raise_as_jax(aug, tmp_path):
    feats = tmp_path / "features.csv"
    shutil.copy(aug["paths"]["features"], feats)
    base_constraints = _base_paths(aug)[1]
    cons = LcldConstraints(str(feats), base_constraints)
    jcons = JLcld(str(feats), base_constraints)
    assert cons.important_features is None and jcons.important_features is None
    with pytest.raises(FileNotFoundError) as want:
        jcons.repair(jnp.asarray(aug["u"]))
    with pytest.raises(FileNotFoundError) as got:
        cons.repair(torch.as_tensor(aug["u"]))
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError) as want:
        JAug(str(feats), aug["paths"]["constraints"])
    with pytest.raises(FileNotFoundError) as got:
        LcldAugmentedConstraints(str(feats), aug["paths"]["constraints"])
    assert str(got.value) == str(want.value)
    # important features must be base features
    bad = aug["cons"].important_features.copy()
    bad[4, 0] = 50
    np.save(tmp_path / "bad.npy", bad)
    with pytest.raises(ValueError, match="base features in \\[0, 47\\)"):
        LcldAugmentedConstraints(str(feats), aug["paths"]["constraints"], important_features_path=str(tmp_path / "bad.npy"))
    # an explicit path is taken over the one beside the features
    explicit = LcldAugmentedConstraints(str(feats), aug["paths"]["constraints"],
                                        important_features_path=str(aug["dir"] / "important_features.npy"))
    np.testing.assert_array_equal(explicit.important_features, aug["cons"].important_features)


@pytest.mark.parametrize("ctr", [-1, 3, 14])
def test_smooth_vjp_matches_jax_grad(aug, ctr):
    cons, jcons, u = aug["cons"], aug["jcons"], aug["u"]
    ct = np.zeros((N_STATES, 20))
    if ctr < 0:
        ct[:] = -1.0
    else:
        ct[:, ctr] = -1.0
    g, ct_u = cons.smooth_vjp(torch.as_tensor(u), torch.as_tensor(ct))
    want = jax.grad(lambda z: jnp.sum(jnp.asarray(ct) * jcons.evaluate_smooth(z)))(jnp.asarray(u))
    _close(g.numpy(), np.asarray(jcons.evaluate_smooth(jnp.asarray(u))), "g")
    _close(ct_u.numpy(), np.asarray(want), f"ct_u ctr={ctr}")
    if ctr < 0:
        assert (ct_u.numpy()[:, 47:] != 0).any()  # the pairs' cotangents reach their columns


def test_base_smooth_vjp_on_augmented_rows_matches_jax_grad(aug):
    """``LcldConstraints`` (10 terms) on 57-column rows: the base VJP, a
    zero cotangent on the augmented columns."""
    cons, jcons = (cls(*_base_paths(aug)) for cls in (LcldConstraints, JLcld))
    u = aug["u"]
    g, ct_u = cons.smooth_vjp(torch.as_tensor(u), torch.full((N_STATES, 10), -1.0, dtype=torch.float64))
    want = jax.grad(lambda z: -jnp.sum(jcons.evaluate_smooth(z)))(jnp.asarray(u))
    _close(ct_u.numpy(), np.asarray(want), "ct_u")
    assert not ct_u[:, 47:].any()


# -- MoEvA: objectives and generations ------------------------------------------


def _moeva_pair(aug, dtype, **knobs):
    cons, scaler = aug["cons"], aug["scaler"]
    jeng = JMoeva2(classifier=aug["jsur"], constraints=aug["jcons"], ml_scaler=JMinMax(scaler.scale, scaler.min_),
                   dtype=jnp.float64, **knobs)
    teng = Moeva2(Surrogate(params_from_numpy(aug["tree"], dtype=dtype)), cons, ml_scaler=scaler, dtype=dtype,
                  device="cpu", **knobs)
    return jeng, teng


def _candidates(teng, aug, seed):
    """(S, 12, L) genes around the states, the edge rows' genes first."""
    x = aug["x"]
    rng = np.random.default_rng(seed)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in aug["cons"].get_feature_min_max(x))
    codec = teng.codec
    xlg, xug = (a.numpy() for a in codec_lib.genetic_bounds(codec, torch.as_tensor(np.array(xl)),
                                                            torch.as_tensor(np.array(xu))))
    g0 = codec_lib.ml_to_genetic(codec, torch.as_tensor(x)).numpy()[:, None, :]
    cand = np.clip(g0 + rng.normal(size=(len(x), 12, codec.gen_length)) * (xug - xlg)[:, None] * 0.1,
                   xlg[:, None], xug[:, None])
    cand = np.where(codec.int_mask_gen.numpy(), np.round(cand), cand)
    edges = lcld_augmented_edge_rows(x, aug["cons"].important_features, None, np.float64)
    cand[:, 1:1 + LCLD_AUGMENTED_EDGE_ROWS] = codec_lib.ml_to_genetic(
        codec, torch.as_tensor(edges[:LCLD_AUGMENTED_EDGE_ROWS])).numpy()
    return cand, xl, xu


@pytest.mark.parametrize("norm", [2, "inf"])
def test_evaluate_plain_matches_jax_evaluate(aug, norm):
    jeng, teng = _moeva_pair(aug, torch.float64, norm=norm, n_gen=2, n_pop=12, n_offsprings=10)
    cand, xl, xu = _candidates(teng, aug, seed=3)
    x, mc = aug["x"], np.arange(N_STATES) % 2
    x_mm = (x - xl) / np.where(xu - xl == 0, 1.0, xu - xl)
    want, _ = jeng._evaluate(aug["jsur"].params, *(jnp.asarray(a) for a in (cand, x, x_mm, xl, xu)),
                             jnp.asarray(mc))
    got = evaluate_plain(teng._objective, teng.codec, teng.prepare(x, mc), torch.as_tensor(cand), teng.constraints)
    # XLA's pow and PyTorch's differ in the last ulp and g1 cancels (the
    # tolerance of test_torch_engine.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    pairs = teng.constraints.evaluate(codec_lib.genetic_to_ml(teng.codec, torch.as_tensor(cand),
                                                              teng.prepare(x, mc).x_init_ml[:, None]))[..., 10:]
    assert pairs.any()  # the pair terms count


def test_evaluate_plain_float32_within_tolerance(aug):
    jeng, teng = _moeva_pair(aug, torch.float32, norm=2, n_gen=2, n_pop=12, n_offsprings=10)
    cand, xl, xu = _candidates(teng, aug, seed=4)
    x, mc = aug["x"], np.arange(N_STATES) % 2
    x_mm = (x - xl) / np.where(xu - xl == 0, 1.0, xu - xl)
    want, _ = jeng._evaluate(aug["jsur"].params, *(jnp.asarray(a) for a in (cand, x, x_mm, xl, xu)),
                             jnp.asarray(mc))
    away = slice(LCLD_AUGMENTED_EDGE_ROWS + 1, None)  # the candidates away from the thresholds
    want = np.asarray(want)[:, away]
    got = evaluate_plain(teng._objective, teng.codec, teng.prepare(x, mc),
                         torch.as_tensor(cand, dtype=torch.float32), teng.constraints).numpy()[:, away]
    # test_torch_engine.py's float32 tolerances
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-4, atol=2e-3)


def test_init_and_three_generations_match_jax(aug):
    """The init round and 3 generation steps fed the JAX engine's draws
    (``test_torch_engine.py``'s comparison at 57 features)."""
    s, n_pop, n_off, arch, seed = 5, 12, 10, 6, 2
    x = aug["x"][:s]
    jeng, teng = _moeva_pair(aug, torch.float64, norm=2, n_gen=2, n_pop=n_pop, n_offsprings=n_off,
                             archive_size=arch, seed=seed)
    teng.asp_points = torch.as_tensor(np.array(jeng.asp_points))
    mc = np.ones(s, dtype=np.int64)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in aug["cons"].get_feature_min_max(x))
    key = jax.random.PRNGKey(seed)
    jargs = (aug["jsur"].params, jnp.asarray(x), jnp.asarray(mc, jnp.int32), jnp.asarray(xl), jnp.asarray(xu))
    jcarry, _ = jax.jit(jeng._build_init())(*jargs, key)
    run = teng.prepare(x, mc)
    _, _, k0 = jax.random.split(key, 3)
    carry = teng.init_carry(run, *(torch.as_tensor(np.array(g))
                                   for g in _niche_gumbels(k0, (s,), teng.n_dirs, teng.pop_size)))
    _assert_carry_equal(jcarry, carry, "init")
    segment = jax.jit(jeng._build_segment(), static_argnames="length")
    for step in range(3):
        jnext, _ = segment(*jargs, jcarry, length=1)
        _, k_mate, k_surv = jax.random.split(jcarry[5], 3)
        offspring = jax_offspring_draws(jax.random.split(k_mate, s), n_off, teng.codec.gen_length, teng.pop_size)
        gum_cut, gum_mem = _niche_gumbels(k_surv, (s,), teng.n_dirs, teng.pop_size + n_off)
        carry = teng.gen_step(run, carry, GenerationDraws(offspring, torch.as_tensor(np.array(gum_cut)),
                                                          torch.as_tensor(np.array(gum_mem))))
        _assert_carry_equal(jnext, carry, f"step {step}")
        jcarry = jnext


# -- constrained PGD --------------------------------------------------------------


def _pgd_pair(aug, dtype=torch.float64, **kw):
    scaler = aug["scaler"]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ja = JPGD(classifier=aug["jsur"], constraints=aug["jcons"], scaler=JMinMax(scaler.scale, scaler.min_), dtype=jdt,
              **kw)
    ta = ConstrainedPGD(Surrogate(params_from_numpy(aug["tree"], dtype)), aug["cons"], scaler, dtype=dtype,
                        device="cpu", **kw)
    return ja, ta


@pytest.mark.parametrize("norm", [2, np.inf])
def test_pgd_run_matches_jax_one_run(aug, norm):
    t = 20
    ja, ta = _pgd_pair(aug, loss_evaluation=RQ2_LOSS, norm=norm, record_loss="full", record_grad_norm=True, eps=0.2,
                       eps_step=0.1, max_iter=t)
    xs, y = aug["xs"], aug["y"]
    start = ja._random_start(jax.random.PRNGKey(3), jnp.asarray(xs), jnp.asarray(0.2, jnp.float64))
    want_x, want_h = jax.jit(ja._one_run, static_argnums=6)(
        aug["jsur"].params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), start, jnp.asarray(0.2), jnp.asarray(0.1), t)
    got_x, pred, got_h = pgd_run_plain(
        ta.tables, ta.constraints, ta.schedule(0.2, 0.1, t), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(np.array(start)), 0.2, ta.clip, norm, True, False, ta.history_layout(),
    )
    _close(got_x.numpy(), want_x, "x_adv")
    assert ta.hist_column_names() == ja.hist_column_names() and len(ta.hist_column_names()) == 4 + 20
    want_h = np.asarray(want_h)
    assert got_h.shape == want_h.shape == (t, N_STATES, 24)
    for c in range(want_h.shape[-1]):  # test_torch_pgd.py's rule for the history
        w, g = want_h[..., c], got_h[..., c].numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=1e-9 * max(np.abs(w[fin]).max(), 1.0))
    probs = np.asarray(ja.classifier.predict_proba(want_x))
    np.testing.assert_array_equal(pred.numpy(), probs.argmax(-1))


@pytest.mark.parametrize("optim,ctr_id", [("sum", 0), ("alt_constraints", 0), ("single_constraints", 14)])
def test_pgd_gradient_matches_jax(aug, optim, ctr_id):
    t = 20
    ja, ta = _pgd_pair(aug, loss_evaluation=RQ2_LOSS, constraints_optim=optim, ctr_id=ctr_id, eps=0.2, eps_step=0.1,
                       max_iter=t)
    xs, y = aug["xs"], aug["y"]
    for i in (0, 11, 15):
        want = ja._grad_and_terms(aug["jsur"].params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), jnp.asarray(i), t)
        sched = ta.schedule(0.2, 0.1, t)
        got = grad_and_terms_plain(ta.tables, ta.constraints, torch.as_tensor(xs), torch.as_tensor(y),
                                   sched.w_class[i], sched.w_cons[i], int(sched.ctr[i]), False)
        for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
            _close(g.numpy(), w, f"{optim} i={i} {name}")


def test_pgd_gradient_float32_within_tolerance(aug):
    """float32 against JAX's float64 on the same float32 rows: rtol 1e-3
    with a floor of 1e-4 of the largest entry (``test_torch_pgd.py``), on
    the rows away from the thresholds (each row's gradient is its own)."""
    t = 20
    ja, _ = _pgd_pair(aug, loss_evaluation=RQ2_LOSS, eps=0.2, eps_step=0.1, max_iter=t)
    _, ta = _pgd_pair(aug, torch.float32, loss_evaluation=RQ2_LOSS, eps=0.2, eps_step=0.1, max_iter=t)
    xs, y = aug["xs"].astype(np.float32), aug["y"]
    want = ja._grad_and_terms(aug["jsur"].params, jnp.asarray(xs, jnp.float64), jnp.asarray(y, jnp.int32),
                              jnp.asarray(0), t)
    sched = ta.schedule(0.2, 0.1, t)
    got = grad_and_terms_plain(ta.tables, ta.constraints, torch.as_tensor(xs), torch.as_tensor(y), sched.w_class[0],
                               sched.w_cons[0], -1, False)
    rows = slice(LCLD_AUGMENTED_EDGE_ROWS, None)
    for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
        assert g.dtype == torch.float32
        w, g = np.asarray(w, np.float64)[rows], g.double().numpy()[rows]
        top = np.abs(w[np.isfinite(w)]).max()
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * top, equal_nan=True, err_msg=name)


# -- the runners on rq2.lcld ----------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(aug, tmp_path_factory):
    tmp = aug["dir"]
    np.save(tmp / "x_candidates_common_augmented.npy", aug["x"])
    jio.save_params(aug["jsur"], str(tmp / "nn_augmented.msgpack"))
    import joblib
    from sklearn.preprocessing import MinMaxScaler

    x = aug["x"]
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in aug["cons"].get_feature_min_max(x))
    scaler = MinMaxScaler().fit(np.vstack([x, xl, xu]))
    joblib.dump(scaler, tmp / "scaler_augmented.joblib")
    save_npz(from_sklearn_minmax(scaler), str(tmp / "scaler_augmented.npz"))
    return tmp


@pytest.fixture(scope="module")
def jax_runners():
    """The JAX runners with ``test_torch_runners.py``'s patches (the
    judgement with ``precise=False``, float64 PGD), for the module's runner
    tests: their engines are cached from one test to the next, as a grid
    caches them."""

    class Float64PGD(JPGD):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dtype=jnp.float64, **kwargs)

    precise_off = functools.partial(JObjective, precise=False)
    patch = pytest.MonkeyPatch()
    patch.setattr(jmoeva, "ObjectiveCalculator", precise_off)
    patch.setattr(jpgd, "ObjectiveCalculator", precise_off)
    patch.setattr(jpgd, "ConstrainedPGD", Float64PGD)
    jcommon.ENGINES.clear()
    jcommon.ARTIFACTS.clear()
    common.ARTIFACTS.clear()
    yield
    patch.undo()
    jcommon.ENGINES.clear()


def _rq2_config(artifacts, out_dir, attack: str, budget: int, reconstruction: bool) -> dict:
    """rq2.lcld's grid point composed from ``config/`` (the attack's yaml,
    ``rq2.lcld.static``, seed and budget, the scenario, ε and the loss) over
    the test's artifacts."""
    cfg = {}
    for name in (attack, "rq2.lcld.static"):
        with open(os.path.join(REPO, "config", f"{name}.yaml")) as f:
            cfg.update(yaml.safe_load(f))
    with open(os.path.join(REPO, "config", "rq2.lcld.yaml")) as f:
        (scenario,) = yaml.safe_load(f)["scenari"]
    cfg.update(seed=42, budget=budget, project_name=scenario["project_name"], reconstruction=reconstruction,
               n_initial_state=-1)
    cfg["paths"] = {
        "model": str(artifacts / "nn_augmented.msgpack"),
        "x_candidates": str(artifacts / "x_candidates_common_augmented.npy"),
        "min_max_scaler": str(artifacts / "scaler_augmented.joblib"),
        "ml_scaler": str(artifacts / "scaler_augmented.joblib"),
        "features": str(artifacts / "features_augmented.csv"),
        "constraints": str(artifacts / "constraints_augmented.csv"),
    }
    cfg["evaluation"] = {"project_name": scenario["evaluation"]["project_name"],
                         "constraints": str(artifacts / "constraints_augmented.csv")}
    cfg["dirs"] = {"results": str(out_dir)}
    cfg["system"] = {"n_jobs": 1, "verbose": 0, "mesh_devices": 0, "jax_cache_dir": ""}
    if attack == "moeva":
        cfg.update(eps_list=[0.2], n_pop=16, n_offsprings=8, archive_size=4, max_states_per_call=16)
    else:
        cfg.update(eps=0.2, loss_evaluation=RQ2_LOSS)
    return cfg


@pytest.mark.parametrize("reconstruction", [False, True])
@pytest.mark.parametrize("attack", ["pgd", "moeva"])
def test_runners_on_rq2_match_jax(aug, artifacts, jax_runners, tmp_path, attack, reconstruction):
    out = tmp_path / "out"
    cfg = _rq2_config(artifacts, out, attack, 20 if attack == "pgd" else 4, reconstruction)
    dtype = torch.float64 if attack == "pgd" else torch.float32
    runners = (jpgd.run, ppgd.run) if attack == "pgd" else (jmoeva.run, pmoeva.run)
    jm, jfiles, pm, pfiles, jdir = _run_both(*runners, cfg, out, dtype)
    mid_fix = f"pgd_{RQ2_LOSS}" if attack == "pgd" else "moeva"
    h = get_dict_hash(cfg)
    assert pm["config_hash"] == jm["config_hash"] == h
    assert common.metrics_path_for(cfg, mid_fix) == jcommon.metrics_path_for(cfg, mid_fix)
    assert pfiles == jfiles
    assert set(pm) == set(jm) - {"telemetry"}
    assert pm["config"] == jm["config"] == cfg
    name = f"x_attacks_{mid_fix}_{h}.npy"
    got = np.load(out / name)
    if attack == "pgd":
        assert pm["objectives"] == jm["objectives"]
        np.testing.assert_allclose(got, np.load(jdir / name), rtol=1e-9, atol=0)
    else:
        # the port's runner against the port's engine and judgement
        cons = aug["cons"]
        sur = Surrogate(params_from_numpy(aug["tree"]))
        scaler = common.load_scaler_file(cfg["paths"]["ml_scaler"])
        res = Moeva2(sur, cons, ml_scaler=scaler, norm=2, n_gen=4, n_pop=16, n_offsprings=8, seed=42, archive_size=4,
                     max_states_per_call=16, device="cpu").generate(aug["x"], 1)
        want = res.x_ml
        if reconstruction:
            want = taug.augment(torch.as_tensor(want[..., :47]), cons.important_features).numpy()
        np.testing.assert_array_equal(got, want)
        calc = ObjectiveCalculator(sur, cons, {"f1": 0.25, "f2": 0.2}, scaler, minimize_class=1, norm=2,
                                   ml_scaler=scaler)
        assert pm["objectives_list"] == [calc.success_rate_3d_record(aug["x"], want)]
    if reconstruction:
        # the saved rows carry the XOR of their own base features
        rebuilt = taug.augment(torch.as_tensor(got[..., :47]), aug["cons"].important_features).numpy()
        np.testing.assert_array_equal(got, rebuilt)

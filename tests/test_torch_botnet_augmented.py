"""Port parity of the augmented botnet domain (``botnet_augmented``: 756 base
features and C(19, 2) = 171 XOR pair features of k = 19 important features,
360 + 171 = 531 terms) against the JAX package, on the CPU with x64 on.

The artifacts are ``problems.synthetic_botnet_augmented_problem``'s files
(the augmented schema, ``feat_idx.pickle``, ``important_features_19.npy``)
read by both packages' classes, and one 927-input surrogate made by the JAX
package's ``init_params``. Tolerances:

- the terms in float64: within 1e-12 relative (JAX sums a flow equality in
  its own order, the port left to right, as ``test_torch_botnet.py``), the
  same terms counted, the pair terms equal, edge rows included (a feature
  exactly at its threshold, one ulp below, NaN; an augmented column at 0, 1
  and 0.5; the base terms' edges of ``botnet_hard_candidates``);
- float32: each base term within 1e-5 of its scale (``test_torch_botnet.
  py``); the pair terms compare a feature with its threshold rounded once
  to float32 (the JAX package's rule without x64), so they equal a numpy
  float32 reference everywhere and JAX's float64 terms away from the
  thresholds;
- the gradient in float64: rtol 1e-12 with a floor of 1e-12 of the largest
  entry, NaN and inf where JAX has them (``test_torch_pgd.py``'s rule);
- the objectives in float64: rtol and atol 1e-12 (``test_torch_botnet.py``);
- the runner: its metrics equal the objectives recomputed from its saved
  ``x_attacks``, and the JAX judgement of those rows gives the same o1..o7
  exactly.
"""

from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.domains import get_constraints_class as jget
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetAugmentedConstraints as JBotAug
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import card_refusal, grad_and_terms_plain
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.domains import augmentation as taug
from moeva2_ijcai22_replication_tpu_torch.domains import get_constraints_class
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetAugmentedConstraints, BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import moeva as pmoeva
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import save_npz
from moeva2_ijcai22_replication_tpu_torch.problems import (
    BOTNET_AUGMENTED_EDGE_ROWS, BOTNET_IMPORTANT_GATHERED, botnet_augmented_edge_rows,
    synthetic_botnet_augmented_problem,
)
from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash
from test_torch_botnet import _edge_rows, _term_scale
from test_torch_pgd import _close as close_as_pgd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STATES = 12
D = 927
K = 531


@pytest.fixture(scope="module")
def baug(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("botnet_augmented")
    cons, _, scaler, x = synthetic_botnet_augmented_problem(str(tmp), N_STATES)
    paths = {"features": str(tmp / "features_augmented.csv"), "constraints": str(tmp / "constraints_augmented.csv")}
    model = jmlp.botnet_mlp()
    params = jmlp.init_params(model, D, seed=1)
    rng = np.random.default_rng(0)
    # rows off the data (violated base terms, XOR columns off their pairs),
    # with the base terms' edges on every ninth row from row 1 to 8, then
    # the pair terms' edge rows
    pert = x * (1.0 + 0.05 * rng.standard_normal(x.shape))
    pert[:, 756:] = rng.integers(0, 2, (N_STATES, 171))
    pairs = botnet_augmented_edge_rows(x, cons.important_features, np.float64)[:BOTNET_AUGMENTED_EDGE_ROWS]
    u = np.concatenate([_edge_rows(cons, pert), pairs])
    return {
        "dir": tmp, "paths": paths, "cons": cons, "jcons": JBotAug(paths["features"], paths["constraints"]),
        "x": x, "u": u, "scaler": scaler, "jsur": jio.Surrogate(model, params),
        "tree": jax.tree.map(np.asarray, params),
    }


# -- the synthetic problem and the classes ----------------------------------------


def test_synthetic_problem_is_what_both_packages_read(baug):
    cons, jcons, x = baug["cons"], baug["jcons"], baug["x"]
    imp = cons.important_features
    assert x.shape == (N_STATES, D) and cons.schema.n_features == jcons.schema.n_features == D
    assert imp.shape == (19, 2) and imp.dtype == np.float64
    np.testing.assert_array_equal(imp, jcons.important_features)
    feats = imp[:, 0].astype(int)
    assert len(set(feats)) == 19 and (feats < 756).all() and cons.schema.mutable[feats].all()
    ratio = np.concatenate(cons.segments()[4:6])
    assert np.isin(feats, ratio).sum() >= BOTNET_IMPORTANT_GATHERED
    np.testing.assert_array_equal(imp[:, 1], x[:, feats].mean(0))
    assert cons.n_constraints == jcons.n_constraints == K
    # feasible by construction, in both packages
    cons.check_constraints_error(x)
    jcons.check_constraints_error(x)
    # the augmented columns are int genes at [0, 1], mutable
    assert cons.schema.mutable[756:].all()
    assert (cons.schema.types[756:] == "int").all()


def test_important_features_path_as_jax(baug, tmp_path):
    base = (baug["paths"]["features"], str(baug["dir"] / "constraints.csv"))
    # by default the file beside the features, in both packages
    for cls in (BotnetConstraints, JBotnet):
        np.testing.assert_array_equal(cls(*base).important_features, baug["cons"].important_features)
    # an explicit path is taken over it
    other = baug["cons"].important_features[:5].copy()
    np.save(tmp_path / "five.npy", other)
    for cls in (BotnetConstraints, JBotnet):
        np.testing.assert_array_equal(cls(*base, important_features_path=str(tmp_path / "five.npy")).important_features,
                                      other)
    # none beside the features: None, and the augmented class raises JAX's error
    for name in ("features_augmented.csv", "feat_idx.pickle"):
        shutil.copy(baug["dir"] / name, tmp_path / name)
    feats = str(tmp_path / "features_augmented.csv")
    assert BotnetConstraints(feats, base[1]).important_features is None
    with pytest.raises(FileNotFoundError) as want:
        JBotAug(feats, baug["paths"]["constraints"])
    with pytest.raises(FileNotFoundError) as got:
        BotnetAugmentedConstraints(feats, baug["paths"]["constraints"])
    assert str(got.value) == str(want.value)
    # important features must be base features
    bad = baug["cons"].important_features.copy()
    bad[3, 0] = 800
    np.save(tmp_path / "bad.npy", bad)
    with pytest.raises(ValueError, match="base features in \\[0, 756\\)"):
        BotnetAugmentedConstraints(feats, baug["paths"]["constraints"], important_features_path=str(tmp_path / "bad.npy"))


def test_registry(baug):
    """The domains compiled from the constraint IR, which this test once
    held refused, resolve since the IR is ported: to spec sets with JAX's
    origin and spec hash."""
    from moeva2_ijcai22_replication_tpu.domains import domain_origin as jorigin
    from moeva2_ijcai22_replication_tpu_torch.domains import domain_origin
    from moeva2_ijcai22_replication_tpu_torch.domains.ir import SpecConstraintSet

    assert get_constraints_class("botnet_augmented") is BotnetAugmentedConstraints
    assert jget("botnet_augmented") is JBotAug
    for name in ("lcld_spec", "botnet_spec", "phishing", "family7"):
        assert issubclass(get_constraints_class(name), SpecConstraintSet)
        assert domain_origin(name) == jorigin(name)


def test_repair_raises_in_both(baug):
    u = baug["u"]
    with pytest.raises(NotImplementedError) as want:
        baug["jcons"].repair(jnp.asarray(u))
    with pytest.raises(NotImplementedError) as got:
        baug["cons"].repair(torch.as_tensor(u))
    assert str(got.value) == str(want.value)


def test_kernel_tables(baug):
    cons = baug["cons"]
    tables = cons.kernel_tables("cpu")
    base = BotnetConstraints(baug["paths"]["features"], str(baug["dir"] / "constraints.csv")).kernel_tables("cpu")
    assert tables.counts == base.counts
    np.testing.assert_array_equal(tables.index.numpy(), base.index.numpy())
    idx, thr = taug.pair_table(cons.important_features)
    assert tables.pair_idx.dtype == torch.int32 and tables.pair_thr.dtype == torch.float32
    assert tables.pair_idx.shape == tables.pair_thr.shape == (171, 2)
    np.testing.assert_array_equal(tables.pair_idx.numpy(), idx)
    np.testing.assert_array_equal(tables.pair_thr.numpy(), thr.astype(np.float32))
    assert base.pair_idx is None and base.pair_thr is None


# -- the terms and their backward -------------------------------------------------


@pytest.mark.parametrize("name", ["_raw", "evaluate", "evaluate_smooth"])
def test_terms_match_jax(baug, name):
    cons, jcons, u = baug["cons"], baug["jcons"], baug["u"]
    got = getattr(cons, name)(torch.as_tensor(u)).numpy()
    want = np.asarray(getattr(jcons, name)(jnp.asarray(u)))
    assert got.shape == want.shape == (len(u), K)
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got[:, 360:], want[:, 360:])
    if name == "_raw":
        assert (got[-BOTNET_AUGMENTED_EDGE_ROWS:, 360:] > 0).any() and np.isnan(got[:, :360]).any()
        # the edges: at the threshold >= holds, one ulp below and at NaN not
        imp = cons.important_features
        feats, thr = imp[:, 0].astype(int), imp[:, 1]
        first = len(u) - BOTNET_AUGMENTED_EDGE_ROWS
        assert (u[first, feats] >= thr).all() and not (u[first + 1, feats] >= thr).any()
        assert np.isnan(u[first + 2, feats]).all()


def test_terms_float32(baug):
    """Base terms within 1e-5 of their scale of JAX's float64; the pair
    terms with float32 thresholds, as numpy computes them, and equal to
    JAX's away from the thresholds."""
    cons, jcons = baug["cons"], baug["jcons"]
    rows = np.concatenate([baug["u"][:-BOTNET_AUGMENTED_EDGE_ROWS],
                           botnet_augmented_edge_rows(baug["x"], cons.important_features, np.float32)[:3]])
    rows32 = rows.astype(np.float32)
    got = cons._raw(torch.as_tensor(rows32)).double().numpy()
    want = np.asarray(jcons._raw(jnp.asarray(rows32, jnp.float64)))
    fin = np.isfinite(want[:, :360])
    assert np.array_equal(np.isfinite(got[:, :360]), fin)
    scale = _term_scale(cons, rows32.astype(np.float64))
    assert (np.abs(got[:, :360][fin] - want[:, :360][fin]) <= 1e-5 * scale[fin]).all()
    idx, thr = taug.pair_table(cons.important_features)
    thr = thr.astype(np.float32)
    xor = np.logical_xor(rows32[:, idx[:, 0]] >= thr[:, 0], rows32[:, idx[:, 1]] >= thr[:, 1]).astype(np.float32)
    np.testing.assert_array_equal(got[:, 360:], np.abs(rows32[:, 756:] - xor))
    away = slice(None, -3)  # the last three rows sit at and one ulp below the float32 thresholds, and at NaN
    np.testing.assert_array_equal(got[away, 360:], want[away, 360:])
    assert (got[-3] != want[-3])[360:].any() or (got[-2] != want[-2])[360:].any()


@pytest.mark.parametrize("ctr", [-1, 3, 360 + 17])
def test_smooth_vjp_matches_jax_grad(baug, ctr):
    cons, jcons, u = baug["cons"], baug["jcons"], baug["u"]
    ct = np.zeros((len(u), K))
    if ctr < 0:
        ct[:] = -1.0
    else:
        ct[:, ctr] = -1.0
    g, ct_u = cons.smooth_vjp(torch.as_tensor(u), torch.as_tensor(ct))
    want = jax.grad(lambda z: jnp.sum(jnp.asarray(ct) * jcons.evaluate_smooth(z)))(jnp.asarray(u))
    close_as_pgd(g.numpy(), np.asarray(jcons.evaluate_smooth(jnp.asarray(u))), torch.float64, "g")
    close_as_pgd(ct_u.numpy(), np.asarray(want), torch.float64, f"ct_u ctr={ctr}")
    if ctr != 3:
        assert (ct_u.numpy()[:, 756:] != 0).any()  # the pairs' cotangents reach their columns


def test_pgd_gradient_matches_jax_and_the_card_refuses(baug, monkeypatch):
    """``grad_and_terms_plain`` over the augmented set against JAX's
    ``jax.grad`` path in float64; the card no longer refuses constrained
    PGD on the set: K7b's augmented instantiation takes it, as the base
    domain's K7b takes botnet."""
    cons, scaler = baug["cons"], baug["scaler"]
    t = 10
    ja = JPGD(classifier=baug["jsur"], constraints=baug["jcons"], scaler=JMinMax(scaler.scale, scaler.min_),
              dtype=jnp.float64, loss_evaluation="constraints+flip", eps=4.0, eps_step=0.1, max_iter=t)
    sur = Surrogate(params_from_numpy(baug["tree"], torch.float64))
    ta = ConstrainedPGD(sur, cons, scaler, dtype=torch.float64, device="cpu", loss_evaluation="constraints+flip",
                        eps=4.0, eps_step=0.1, max_iter=t)
    xs = np.clip(scaler.transform(baug["x"]) + np.random.default_rng(1).normal(scale=0.05, size=baug["x"].shape), 0, 1)
    y = np.arange(N_STATES) % 2
    want = ja._grad_and_terms(baug["jsur"].params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), jnp.asarray(0), t)
    sched = ta.schedule(4.0, 0.1, t)
    got = grad_and_terms_plain(ta.tables, cons, torch.as_tensor(xs), torch.as_tensor(y), sched.w_class[0],
                               sched.w_cons[0], -1, False)
    for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
        close_as_pgd(g.numpy(), w, torch.float64, name)
    # no refusal on either domain: both have K7b, the augmented set its
    # 927-feature instantiation with the pairs' tables
    assert card_refusal(cons) is None and card_refusal(BotnetConstraints(
        baug["paths"]["features"], str(baug["dir"] / "constraints.csv"))) is None
    assert cons.pgd_kernel == "botnet" and not hasattr(cons, "no_pgd_kernel")
    tables = ta.tables.cons
    assert tables.pair_idx.shape == (171, 2) and tables.pair_idx.dtype == torch.int32
    assert tables.pair_thr.dtype == torch.float32 and tables.inverse.shape[0] == D
    # the inverse table gives the pair columns no entry
    assert (tables.inverse[756:] == -1).all()


# -- MoEvA: the objectives and the runner -----------------------------------------


def test_evaluate_plain_matches_jax_evaluate(baug):
    cons, scaler, x = baug["cons"], baug["scaler"], baug["x"][:4]
    knobs = dict(norm=2, n_gen=2, n_pop=12, n_offsprings=10)
    jeng = JMoeva2(classifier=baug["jsur"], constraints=baug["jcons"], ml_scaler=JMinMax(scaler.scale, scaler.min_),
                   dtype=jnp.float64, **knobs)
    teng = Moeva2(Surrogate(params_from_numpy(baug["tree"], dtype=torch.float64)), cons, ml_scaler=scaler,
                  dtype=torch.float64, device="cpu", **knobs)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    mc = np.arange(len(x)) % 2
    rng = np.random.default_rng(3)
    rows = x[:, None, :] * (1.0 + 0.05 * rng.standard_normal((len(x), 18, D)))
    rows[..., 756:] = rng.integers(0, 2, rows[..., 756:].shape)
    rows = np.stack([_edge_rows(cons, r) for r in rows])
    rows[:, 9:9 + BOTNET_AUGMENTED_EDGE_ROWS] = botnet_augmented_edge_rows(
        baug["x"], cons.important_features, np.float64)[:BOTNET_AUGMENTED_EDGE_ROWS]
    cand = codec_lib.ml_to_genetic(teng.codec, torch.as_tensor(rows)).numpy()
    x_mm = (x - xl) / np.where(xu - xl == 0, 1.0, xu - xl)
    want, _ = jeng._evaluate(baug["jsur"].params, *(jnp.asarray(a) for a in (cand, x, x_mm, xl, xu)), jnp.asarray(mc))
    want = np.asarray(want)
    run = teng.prepare(x, mc)
    got = evaluate_plain(teng._objective, teng.codec, run, torch.as_tensor(cand), cons).numpy()
    assert not np.isfinite(want).all()  # the base edges show
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    pairs = cons.evaluate(codec_lib.genetic_to_ml(teng.codec, torch.as_tensor(cand), run.x_init_ml[:, None]))[..., 360:]
    assert (pairs > 0).any()  # the pair terms count


def _rq2_botnet_config(artifacts, out_dir, budget: int) -> dict:
    """rq2.botnet's grid point composed from ``config/`` (``moeva.yaml``,
    ``rq2.botnet.static``, seed and budget, the scenario, ε) over the test's
    artifacts, at a small population."""
    cfg = {}
    for name in ("moeva", "rq2.botnet.static"):
        with open(os.path.join(REPO, "config", f"{name}.yaml")) as f:
            cfg.update(yaml.safe_load(f))
    with open(os.path.join(REPO, "config", "rq2.botnet.yaml")) as f:
        grid = yaml.safe_load(f)
    (scenario,) = grid["scenari"]
    cfg.update(seed=grid["seeds"][0], budget=budget, project_name=scenario["project_name"],
               reconstruction=scenario["reconstruction"], eps_list=grid["eps_list"])
    cfg["paths"] = {
        "model": str(artifacts / "nn_augmented_19.msgpack"),
        "x_candidates": str(artifacts / "x_candidates_common_augmented.npy"),
        "min_max_scaler": str(artifacts / "scaler_augmented_19.npz"),
        "ml_scaler": str(artifacts / "scaler_augmented_19.npz"),
        "features": str(artifacts / "features_augmented.csv"),
        "constraints": str(artifacts / "constraints_augmented.csv"),
        "important_features": str(artifacts / "important_features_19.npy"),
    }
    cfg["evaluation"] = {"project_name": scenario["evaluation"]["project_name"],
                         "constraints": str(artifacts / "constraints_augmented.csv")}
    cfg["dirs"] = {"results": str(out_dir)}
    cfg["system"] = {"n_jobs": 1, "verbose": 0, "mesh_devices": 0}
    cfg.update(n_pop=16, n_offsprings=8, archive_size=4, max_states_per_call=4)
    return cfg


def test_runner_on_rq2_botnet_matches_the_jax_judgement(baug, tmp_path):
    art = baug["dir"]
    np.save(art / "x_candidates_common_augmented.npy", baug["x"][:6])
    jio.save_params(baug["jsur"], str(art / "nn_augmented_19.msgpack"))
    save_npz(baug["scaler"], str(art / "scaler_augmented_19.npz"))
    common.ARTIFACTS.clear()
    out = tmp_path / "out"
    cfg = _rq2_botnet_config(art, out, budget=3)
    assert cfg["project_name"] == "botnet_augmented" and cfg["eps_list"] == [4] and cfg["norm"] == 2
    pm = pmoeva.run(dict(cfg), device="cpu", dtype=torch.float32)
    h = get_dict_hash(cfg)
    assert pm["config_hash"] == h
    x_init = baug["x"][:6]
    x_att = np.load(out / f"x_attacks_moeva_{h}.npy")
    assert x_att.shape == (6, 16 + 3 + 4, D)  # population (pop 16 -> 19 with the 3 axis directions) + archive
    scaler = baug["scaler"]
    cons = BotnetAugmentedConstraints(cfg["paths"]["features"], cfg["evaluation"]["constraints"])
    calc = ObjectiveCalculator(Surrogate(params_from_numpy(baug["tree"])), cons, {"f1": 0.5, "f2": 4}, scaler,
                               minimize_class=1, norm=2, ml_scaler=scaler)
    assert pm["objectives_list"] == [calc.success_rate_3d_record(x_init, x_att)]
    jcalc = JObjective(classifier=baug["jsur"], constraints=baug["jcons"], thresholds={"f1": 0.5, "f2": 4},
                       min_max_scaler=JMinMax(scaler.scale, scaler.min_), minimize_class=1, norm=2,
                       ml_scaler=JMinMax(scaler.scale, scaler.min_), precise=False)
    np.testing.assert_array_equal(np.asarray(list(pm["objectives_list"][0].values())),
                                  jcalc.success_rate_3d(x_init, x_att))
    # skip-if-done
    assert pmoeva.run(dict(cfg), device="cpu", dtype=torch.float32) is None

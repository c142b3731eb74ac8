"""MoEvA on domains compiled from a constraint spec: the objectives
(``evaluate_plain``, the semantics of kernel K9) against the JAX engine's
``_evaluate``, whole runs on the CPU (phishing against the fixture's
``oracle_ga`` rates; ``lcld_spec`` and ``botnet_spec`` against their
hand-written twins, bit for bit), the runner with a ``spec:`` key, and PGD,
AutoPGD and ``flip+sat`` running on a spec domain (their parity is
``tests/test_torch_spec_pgd.py``'s and ``tests/test_torch_spec_sat.py``'s). Kernel K9 itself is
held against its plain versions on the card by ``tests/test_torch_kernels.py
-m cuda -k spec`` and ``chip_smoke.py`` phase 17."""

from __future__ import annotations

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu import domains as jdomains
from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch import domains, kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_hist_plain, evaluate_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import moeva as pmoeva
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy, save_params
from moeva2_ijcai22_replication_tpu_torch.models.mlp import lcld_mlp
from moeva2_ijcai22_replication_tpu_torch.models.scalers import save_npz
from moeva2_ijcai22_replication_tpu_torch.problems import (
    PHISHING_SURROGATE, phishing_problem, spec_candidates, synthetic_botnet_problem, synthetic_botnet_spec_problem,
    synthetic_family_problem, synthetic_lcld_problem, synthetic_lcld_spec_problem,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "oracle_interior_rates.json")


def _fixture(domain: str):
    with open(FIXTURE) as f:
        fixture = json.load(f)
    return fixture["domains"][domain], fixture["parity_tolerance"]


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    """Per spec domain: (port constraints, JAX constraints, states)."""
    out = {}
    d = str(tmp_path_factory.mktemp("lcld_spec"))
    cons, _, _, x = synthetic_lcld_spec_problem(d, 4)
    out["lcld_spec"] = (cons, jdomains.get_constraints_class("lcld_spec")(*_paths(d)), x)
    cons, _, _, x = phishing_problem(_fixture("phishing")[0]["config"])
    out["phishing"] = (cons, jdomains.get_constraints_class("phishing")(
        *(os.path.join(domains.spec_domain_dir("phishing"), f) for f in ("features.csv", "constraints.csv"))), x[:4])
    return out


def _paths(d):
    return os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv")


def _scaler(cons, x):
    from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax

    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    return fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))


# -- the objectives against the JAX engine -------------------------------------------


@pytest.mark.parametrize("norm", [2, "inf"])
@pytest.mark.parametrize("name", ["lcld_spec", "phishing"])
def test_evaluate_plain_matches_jax(problems, name, norm):
    cons, jcons, x = problems[name]
    s, n = len(x), 60
    d = cons.schema.n_features
    model = jmlp.lcld_mlp()
    params = jmlp.init_params(model, d, seed=1)
    tree = jax.tree.map(np.asarray, params)
    scaler = _scaler(cons, x)
    knobs = dict(norm=norm, n_gen=2, n_pop=12, n_offsprings=10)
    jeng = JMoeva2(classifier=jio.Surrogate(model, params), constraints=jcons, ml_scaler=JMinMax(*scaler),
                   dtype=jnp.float64, **knobs)
    teng = Moeva2(Surrogate(params_from_numpy(tree, dtype=torch.float64)), cons, ml_scaler=scaler,
                  dtype=torch.float64, device="cpu", **knobs)
    mc = np.arange(s) % 2
    cand = spec_candidates(teng._codec_cpu, cons, x, n)
    run = teng.prepare(x, mc)
    xl, xu = run.xl_ml.numpy(), run.xu_ml.numpy()
    args = [jnp.asarray(a) for a in (cand, x, run.x_init_mm.numpy(), xl, xu)]
    want, want_g = (np.asarray(a) for a in jeng._evaluate(params, *args, jnp.asarray(mc)))
    got, rec = evaluate_hist_plain(teng._objective, teng.codec, run, torch.as_tensor(cand), cons, "full")
    assert not np.isfinite(want).all()  # the edge rows show
    # float64: XLA's pow differs from PyTorch's in the last ulp and g1 cancels
    # (tests/test_torch_engine.py's bound)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rec[..., 3:].numpy(), want_g, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(evaluate_plain(teng._objective, teng.codec, run, torch.as_tensor(cand), cons).numpy(),
                                  got.numpy())


# -- whole runs on the CPU -------------------------------------------------------------


def test_phishing_surrogate_fixture_is_jax_init_params(tmp_path):
    model = jmlp.lcld_mlp()
    jio.save_params(jio.Surrogate(model, jmlp.init_params(model, 14, seed=1)), str(tmp_path / "nn.msgpack"))
    with open(PHISHING_SURROGATE, "rb") as f:
        assert f.read() == (tmp_path / "nn.msgpack").read_bytes()


def test_phishing_rates_within_oracle_tolerance():
    dom, tol = _fixture("phishing")
    cfg = dom["config"]
    cons, sur, scaler, x = phishing_problem(cfg)
    calc = ObjectiveCalculator(classifier=sur, constraints=cons, thresholds=dict(cfg["thresholds"]),
                               min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=cfg["norm"])
    rates = []
    for seed in cfg["seeds"]:
        eng = Moeva2(sur, cons, ml_scaler=scaler, norm=cfg["norm"], n_gen=cfg["n_gen"], n_pop=cfg["n_pop"],
                     n_offsprings=cfg["n_offsprings"], archive_size=cfg["archive_size"], seed=seed, device="cpu")
        rates.append(calc.success_rate_3d(x, eng.generate(x, minimize_class=1).x_ml))
    mean = np.mean(rates, axis=0)
    want = np.asarray(dom["oracle_ga"]["mean"])
    assert np.all(np.abs(mean - want) <= tol), f"port {mean} vs oracle_ga {want}"


@pytest.mark.parametrize("name", ["lcld", "botnet"])
def test_spec_run_equals_handwritten_run(tmp_path, name):
    if name == "lcld":
        hand, sur, scaler, x = synthetic_lcld_problem(str(tmp_path), 3)
        spec, *_ = synthetic_lcld_spec_problem(str(tmp_path), 3)
        knobs = dict(n_gen=6, n_pop=16, n_offsprings=8, archive_size=4)
    else:
        hand, sur, scaler, x = synthetic_botnet_problem(str(tmp_path), 2)
        spec, *_ = synthetic_botnet_spec_problem(str(tmp_path), 2)
        knobs = dict(n_gen=3, n_pop=12, n_offsprings=6, archive_size=2)
    assert isinstance(hand, (LcldConstraints, BotnetConstraints))
    a = Moeva2(sur, hand, ml_scaler=scaler, seed=5, device="cpu", save_history="full", **knobs).generate(x, 1)
    b = Moeva2(sur, spec, ml_scaler=scaler, seed=5, device="cpu", save_history="full", **knobs).generate(x, 1)
    np.testing.assert_array_equal(b.x_ml, a.x_ml)
    np.testing.assert_array_equal(b.f, a.f)
    for hb, ha in zip(b.history, a.history):
        np.testing.assert_array_equal(hb, ha)


def test_family_run_keeps_its_history(tmp_path):
    cons, sur, scaler, x = synthetic_family_problem(str(tmp_path), 4, 3)
    eng = Moeva2(sur, cons, ml_scaler=scaler, n_gen=4, n_pop=12, n_offsprings=6, seed=1, device="cpu",
                 save_history="full")
    res = eng.generate(x, 1)
    assert np.isfinite(res.x_ml).all() and res.history[1].shape == (3, 6, 3 + cons.n_constraints)
    rec = torch.as_tensor(res.history[-1])
    g = rec[..., 3]
    for k in range(4, rec.shape[-1]):
        g = g + rec[..., k]
    np.testing.assert_array_equal(g.numpy(), rec[..., 2].numpy())


# -- the runner with a spec: key -------------------------------------------------------


def _runner_config(tmp, out, **over):
    with open(os.path.join(REPO, "config", "moeva.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({
        "project_name": "lcld",
        "paths": {"model": str(tmp / "nn.msgpack"), "features": str(tmp / "features.csv"),
                  "constraints": str(tmp / "constraints.csv"), "x_candidates": str(tmp / "x_candidates.npy"),
                  "min_max_scaler": str(tmp / "scaler.npz"), "ml_scaler": str(tmp / "scaler.npz")},
        "dirs": {"results": str(out)}, "misclassification_threshold": 0.25, "norm": 2, "n_initial_state": -1,
        "initial_state_offset": 0, "system": {"n_jobs": 1, "verbose": 0, "mesh_devices": 0},
        "save_history": False, "reconstruction": False, "seed": 42, "budget": 4, "n_pop": 16,
        "n_offsprings": 8, "archive_size": 4, "max_states_per_call": 8, "eps_list": [0.2],
    })
    cfg.update(over)
    return cfg


def test_runner_with_a_spec_key(tmp_path):
    art = tmp_path / "art"
    synth_lcld_schema(str(art))
    cons = LcldConstraints(str(art / "features.csv"), str(art / "constraints.csv"))
    x = synth_lcld(6, cons.schema, seed=3)
    np.save(art / "x_candidates.npy", x)
    save_params(Surrogate(lcld_mlp(47, seed=7)), str(art / "nn.msgpack"))
    save_npz(_scaler(cons, x), str(art / "scaler.npz"))
    spec_path = str(art / "lcld.yaml")
    shutil.copy(os.path.join(domains.SPEC_DIR, "lcld.yaml"), spec_path)
    common.ARTIFACTS.clear()
    common.ENGINES.clear()
    cfg = _runner_config(art, tmp_path / "spec", spec=spec_path)
    metrics = pmoeva.run(copy.deepcopy(cfg), device="cpu")
    h = metrics["config_hash"]
    assert os.path.exists(tmp_path / "spec" / f"metrics_moeva_{h}.json")
    assert len(metrics["objectives_list"][0]) == 7 and set(metrics["objectives_list"][0]) >= {"o1", "o7"}
    loaded = common.load_constraints(cfg)
    assert loaded.ledger_tag.startswith("spec:lcld:") and loaded.objective_kernel == "spec"
    assert pmoeva.run(copy.deepcopy(cfg), device="cpu") is None
    # the same point on the hand-written domain: the same attack, bit for bit
    hand = pmoeva.run(_runner_config(art, tmp_path / "hand"), device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "spec" / f"x_attacks_moeva_{h}.npy"),
                                  np.load(tmp_path / "hand" / f"x_attacks_moeva_{hand['config_hash']}.npy"))
    assert metrics["objectives_list"] == hand["objectives_list"]
    # an edited spec is compiled again: a new object, a new identity
    with open(spec_path, "a") as f:
        f.write("  - name: g11\n    expr: \"open_acc <= total_acc + 1.0\"\n")
    with pytest.raises(ValueError, match="defines 11 constraints but the constraint-bounds file has 10 rows"):
        common.load_constraints(cfg)


# -- PGD, AutoPGD and flip+sat on a spec domain ----------------------------------------


def test_pgd_autopgd_and_sat_refuse_spec_domains(problems):
    """Once refused on a spec domain, now run: PGD and AutoPGD on the CPU
    through the plain version (K10 on the card), ``flip+sat`` through the
    spec MILP builder, which takes ``lcld_spec`` before the ``lcld`` prefix."""
    cons, _, x = problems["phishing"]
    sur = Surrogate(lcld_mlp(14, seed=3))
    scaler = _scaler(cons, x)
    xs = scaler.transform(x)
    assert cons.pgd_kernel == "spec"
    for attack in (ConstrainedPGD, AutoPGD):
        atk = attack(sur, cons, scaler, eps=0.2, max_iter=3, loss_evaluation="constraints+flip+repair", device="cpu")
        out = atk.generate(xs, np.ones(len(x), int))
        assert out.shape == x.shape and np.all(np.abs(out - xs) <= 0.2 + 1e-6)
    from moeva2_ijcai22_replication_tpu_torch.domains.ir import make_spec_sat_builder

    rows = common.get_sat_builder("phishing", cons)(x[0], x[0])
    assert rows.feasible and rows.rows
    lcld_spec = problems["lcld_spec"][0]
    built = common.get_sat_builder("lcld_spec", lcld_spec)
    assert built.__qualname__ == make_spec_sat_builder(lcld_spec).__qualname__


def test_kernel_wrapper_refuses_cpu_tensors(problems):
    cons, _, x = problems["phishing"]
    eng = Moeva2(Surrogate(lcld_mlp(14, seed=3)), cons, ml_scaler=_scaler(cons, x), n_pop=12, n_offsprings=6,
                 device="cpu")
    run = eng.prepare(x, np.ones(len(x), int))
    cand = torch.as_tensor(spec_candidates(eng._codec_cpu, cons, x, 6), dtype=torch.float32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernels.objective_spec(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class,
                               eng._objective)

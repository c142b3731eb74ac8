"""The MILP repair (``flip+sat``) on domains compiled from a constraint spec,
against the JAX package on the CPU.

The port's spec MILP builder (``domains/ir/milp_backend.py``) must build
JAX's ``LinearRows`` array by array, in order, on every spec domain and
for the builder's options (an explicit ε-box, the refinement rounds'
``focus`` and ``window``, a program proved infeasible); ``SatAttack`` fed
the same states and hot starts must return JAX's arrays; and phishing's
``flip+sat`` point through the runners must give JAX's success rates (the
JAX judgement with ``precise=False``, as ``tests/test_torch_runners.py``
patches it).
"""

from __future__ import annotations

import copy
import functools
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu import domains as jdomains
from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.attacks.sat import SatAttack as JSat
from moeva2_ijcai22_replication_tpu.domains.ir import make_spec_sat_builder as j_make_spec_sat_builder
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.experiments import pgd as jpgd
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch import domains
from moeva2_ijcai22_replication_tpu_torch.attacks.sat import SatAttack
from moeva2_ijcai22_replication_tpu_torch.domains import ir, synth
from moeva2_ijcai22_replication_tpu_torch.domains.ir import SpecMilpError, make_spec_sat_builder
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import pgd as ppgd
from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax
from moeva2_ijcai22_replication_tpu_torch.problems import PHISHING_SURROGATE

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ("lcld_spec", "botnet_spec", "phishing", *(f"family{k}" for k in range(6)))


def _files(name, tmp):
    if name == "lcld_spec":
        p = synth.synth_lcld_schema(tmp)
        return p["features"], p["constraints"]
    if name == "botnet_spec":
        p = synth.synth_botnet_schema(tmp)
        return p["features"], p["constraints"]
    if name == "phishing":
        d = domains.spec_domain_dir("phishing")
        return os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv")
    ir.write_family(tmp, int(name[len("family"):]))
    return os.path.join(tmp, "features.csv"), os.path.join(tmp, "constraints.csv")


def _rows(name, cons, n):
    if name == "lcld_spec":
        return synth.synth_lcld(n, cons.schema, seed=2)
    if name == "botnet_spec":
        return synth.synth_botnet(n, cons.schema, seed=2)
    if name == "phishing":
        return synth.synth_phishing(n, cons.schema, seed=2)
    return ir.sample_family(n, int(name[len("family"):]))[0]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Per domain: (JAX set, port set, states, hot starts): the hot start a
    seeded perturbation of the mutable features within the bounds."""
    out = {}
    for name in DOMAINS:
        files = _files(name, str(tmp_path_factory.mktemp(name)))
        jcons, tcons = jdomains.get_constraints_class(name)(*files), domains.get_constraints_class(name)(*files)
        x = _rows(name, tcons, 6)
        xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in tcons.get_feature_min_max(x))
        move = np.random.default_rng(11).normal(size=x.shape) * 0.02 * (xu - xl) * np.asarray(tcons.schema.mutable)
        out[name] = (jcons, tcons, x, np.clip(x + move, xl, xu))
    return out


def _same_rows(got, want, what):
    assert (got.feasible, got.n_extra_bin, got.fixes) == (want.feasible, want.n_extra_bin, want.fixes), what
    assert len(got.rows) == len(want.rows), what
    for k, (g, w) in enumerate(zip(got.rows, want.rows)):
        assert np.array_equal(np.asarray(g[0]), np.asarray(w[0])), f"{what} row {k} columns"
        assert np.array_equal(np.asarray(g[1], float), np.asarray(w[1], float)), f"{what} row {k} coefficients"
        assert (g[2], g[3]) == (w[2], w[3]) or np.array_equal(np.asarray(g[2:]), np.asarray(w[2:])), \
            f"{what} row {k} bounds"


@pytest.mark.parametrize("name", DOMAINS)
def test_spec_rows_equal_jax_array_by_array(sets, name):
    jcons, tcons, x, hot = sets[name]
    jb, tb = j_make_spec_sat_builder(jcons), make_spec_sat_builder(tcons)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in tcons.get_feature_min_max(x))
    for i in range(len(x)):
        _same_rows(tb(x[i], hot[i]), jb(x[i], hot[i]), f"{name} state {i}")
        box = (np.maximum(xl[i], np.minimum(x[i], hot[i]) - 0.1 * (xu[i] - xl[i])),
               np.minimum(xu[i], np.maximum(x[i], hot[i]) + 0.1 * (xu[i] - xl[i])))
        _same_rows(tb(x[i], hot[i], box=box), jb(x[i], hot[i], box=box), f"{name} state {i} in a box")
        for window in (1.0, 0.25):
            _same_rows(tb(x[i], hot[i], box=box, focus=hot[i], window=window),
                       jb(x[i], hot[i], box=box, focus=hot[i], window=window), f"{name} state {i} focus {window}")


def test_lcld_spec_zero_month_difference_is_infeasible(sets):
    jcons, tcons, x, hot = sets["lcld_spec"]
    x0, h0 = x[0].copy(), hot[0].copy()
    x0[9] = h0[9] = h0[7] = x0[7]  # earliest_cr_line == issue_d: a pinned zero denominator
    got, want = make_spec_sat_builder(tcons)(x0, h0), j_make_spec_sat_builder(jcons)(x0, h0)
    assert not got.feasible and not want.feasible


def test_compound_membership_is_refused_by_name(tmp_path):
    p = synth.synth_lcld_schema(str(tmp_path))
    with open(tmp_path / "bad.yaml", "w") as f:
        f.write("name: bad\nconstraints:\n  - name: twice_term\n    expr: \"term * 2.0 in {72.0, 120.0}\"\n")
    cons = ir.compile_spec_path(str(tmp_path / "bad.yaml"))(p["features"])
    x = synth.synth_lcld(1, cons.schema, seed=1)[0]
    with pytest.raises(SpecMilpError, match="twice_term: membership on a compound expression"):
        make_spec_sat_builder(cons)(x, x)


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("name", ["lcld_spec", "phishing", "family2"])
def test_sat_attack_on_spec_domains_equals_jax(sets, name, norm):
    jcons, tcons, x, hot = sets[name]
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in tcons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    kw = dict(eps=0.1, norm=norm, n_sample=1, time_limit=None, refine_rounds=1)
    got = SatAttack(tcons, make_spec_sat_builder(tcons), scaler, **kw).generate(x, hot)
    want = JSat(jcons, j_make_spec_sat_builder(jcons), JMinMax(scaler.scale, scaler.min_), **kw).generate(x, hot)
    np.testing.assert_array_equal(got, np.asarray(want))


# -- phishing's flip+sat through the runners --------------------------------------------------


@pytest.fixture
def phishing_artifacts(tmp_path):
    import joblib
    from sklearn.preprocessing import MinMaxScaler

    with open(os.path.join(REPO, "tests", "fixtures", "oracle_interior_rates.json")) as f:
        import json

        cfg = json.load(f)["domains"]["phishing"]["config"]
    d = domains.spec_domain_dir("phishing")
    cons = domains.get_constraints_class("phishing")(os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv"))
    x = synth.synth_phishing(cfg["pool"], cons.schema, seed=cfg["pool_seed"])[:24]
    np.save(tmp_path / "x_candidates.npy", x)
    shutil.copy(PHISHING_SURROGATE, tmp_path / "nn.msgpack")
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    joblib.dump(MinMaxScaler().fit(np.vstack([x, xl, xu])), tmp_path / "scaler.joblib")
    return tmp_path, d


def test_phishing_flip_sat_rates_equal_jax(phishing_artifacts, tmp_path, monkeypatch):
    art, d = phishing_artifacts

    class Float64PGD(JPGD):
        def __init__(self, *args, **kwargs):
            import jax.numpy as jnp

            super().__init__(*args, dtype=jnp.float64, **kwargs)

    monkeypatch.setattr(jpgd, "ObjectiveCalculator", functools.partial(JObjective, precise=False))
    monkeypatch.setattr(jpgd, "ConstrainedPGD", Float64PGD)
    jcommon.ENGINES.clear()
    jcommon.ARTIFACTS.clear()
    common.ARTIFACTS.clear()
    with open(os.path.join(REPO, "config", "pgd.yaml")) as f:
        cfg = yaml.safe_load(f)
    out = tmp_path / "out"
    cfg.update({
        "project_name": "phishing",
        "paths": {"model": str(art / "nn.msgpack"), "features": os.path.join(d, "features.csv"),
                  "constraints": os.path.join(d, "constraints.csv"), "x_candidates": str(art / "x_candidates.npy"),
                  "min_max_scaler": str(art / "scaler.joblib"), "ml_scaler": str(art / "scaler.joblib")},
        "dirs": {"results": str(out)}, "misclassification_threshold": 0.5, "norm": 2, "n_initial_state": -1,
        "initial_state_offset": 0, "system": {"n_jobs": 1, "verbose": 0, "mesh_devices": 0, "jax_cache_dir": ""},
        "save_history": False, "reconstruction": False, "seed": 42, "budget": 10, "eps": 0.2,
        "loss_evaluation": "flip+sat",
    })
    jm = jpgd.run(copy.deepcopy(cfg))
    shutil.move(str(out), str(tmp_path / "out_jax"))
    pm = ppgd.run(copy.deepcopy(cfg), device="cpu", dtype=torch.float64)
    jcommon.ENGINES.clear()
    assert pm["config_hash"] == jm["config_hash"]
    assert pm["objectives"] == jm["objectives"]
    name = f"x_attacks_pgd_flip+sat_{pm['config_hash']}.npy"
    np.testing.assert_allclose(np.load(out / name), np.load(tmp_path / "out_jax" / name), rtol=1e-9, atol=0)

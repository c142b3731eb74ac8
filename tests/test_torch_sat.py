"""The port's MILP repair against the JAX package's, on the CPU.

The same initial states and hot start (a seeded perturbation of the mutable
features) go into both packages' ``SatAttack``: the outputs must be equal
arrays, since both hand scipy's HiGHS the same program built in the same
row order. Covered: LCLD under L2 (the tangent-cut loop, then the
inscribed box where it runs dry) and L-inf (the box), a pool of two
samples (the no-good cuts), 0 and 2 refinement rounds, two worker threads,
and botnet under L2 and L-inf; one LCLD state whose program is infeasible
(a zero month difference) falls back to its initial state. The builders'
``LinearRows`` are held equal row for row, in order.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.sat import SatAttack as JSat
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.domains.botnet_sat import make_botnet_sat_builder as j_botnet_builder
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.domains.lcld_sat import make_lcld_sat_builder as j_lcld_builder
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.sat import SatAttack
from moeva2_ijcai22_replication_tpu_torch.domains.botnet_sat import make_botnet_sat_builder
from moeva2_ijcai22_replication_tpu_torch.domains.lcld_sat import make_lcld_sat_builder
from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_problem, synthetic_lcld_problem

torch.set_num_threads(1)


def _setup(tmp, name, n, scale):
    make = synthetic_lcld_problem if name == "lcld" else synthetic_botnet_problem
    cons, _, scaler, x = make(str(tmp), n)
    jcls = JLcld if name == "lcld" else JBotnet
    jcons = jcls(os.path.join(tmp, "features.csv"), os.path.join(tmp, "constraints.csv"))
    rng = np.random.default_rng(11)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    move = rng.normal(size=x.shape) * scale * (xu - xl) * np.asarray(cons.schema.mutable)
    hot = np.clip(x + move, xl, xu)
    if name == "lcld":
        # state 0: earliest_cr_line == issue_d, a zero month difference,
        # which the builder proves infeasible: the state falls back
        x = x.copy()
        x[0, 9] = x[0, 7]
        hot[0, 9] = hot[0, 7] = x[0, 7]
        builders = (j_lcld_builder(jcons.schema), make_lcld_sat_builder(cons.schema))
    else:
        builders = (j_botnet_builder(jcons), make_botnet_sat_builder(cons))
    return dict(cons=cons, jcons=jcons, scaler=scaler, x=x, hot=hot, builders=builders)


@pytest.fixture(scope="module")
def lcld(tmp_path_factory):
    return _setup(tmp_path_factory.mktemp("sat_lcld"), "lcld", 8, 0.02)


@pytest.fixture(scope="module")
def botnet(tmp_path_factory):
    return _setup(tmp_path_factory.mktemp("sat_botnet"), "botnet", 3, 0.01)


def _attacks(s, eps, norm, **kw):
    jb, pb = s["builders"]
    sc = s["scaler"]
    return (JSat(s["jcons"], jb, JMinMax(sc.scale, sc.min_), eps, norm, **kw),
            SatAttack(s["cons"], pb, sc, eps, norm, **kw))


@pytest.mark.parametrize(
    "norm, n_sample, refine_rounds, n_jobs",
    [(2, 1, 2, 1), (2, 1, 0, 1), (np.inf, 1, 2, 1), (np.inf, 2, 0, 1), (2, 2, 2, 2)],
)
def test_lcld_repair_equals_jax(lcld, norm, n_sample, refine_rounds, n_jobs):
    ja, pa = _attacks(lcld, 0.1, norm, n_sample=n_sample, refine_rounds=refine_rounds, n_jobs=n_jobs)
    want = ja.generate(lcld["x"], lcld["hot"])
    got = pa.generate(lcld["x"], lcld["hot"])
    assert got.shape == (len(lcld["x"]), n_sample, lcld["x"].shape[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.tile(lcld["x"][0], (n_sample, 1)))  # the fallback
    assert not (got[1:] == lcld["x"][1:, None, :]).all(-1).all(), "every state fell back"


@pytest.mark.parametrize("norm", [2, np.inf])
def test_botnet_repair_equals_jax(botnet, norm):
    ja, pa = _attacks(botnet, 2.0, norm, refine_rounds=2)
    want = ja.generate(botnet["x"], botnet["hot"])
    got = pa.generate(botnet["x"], botnet["hot"])
    np.testing.assert_array_equal(got, want)
    g = botnet["cons"].evaluate(torch.as_tensor(got[:, 0])).numpy()
    assert (g == 0).all(), "a botnet repair violates a constraint"


def _same_rows(got, want):
    assert (got.feasible, got.n_extra_bin, got.fixes) == (want.feasible, want.n_extra_bin, want.fixes)
    assert len(got.rows) == len(want.rows)
    for i, (g, w) in enumerate(zip(got.rows, want.rows)):
        for a, b in zip(g[:2], w[:2]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"row {i}")
        assert g[2:] == w[2:], f"row {i}"


def test_lcld_rows_equal_jax_in_order(lcld):
    jb, pb = lcld["builders"]
    xl, xu = (np.broadcast_to(np.asarray(a, float), lcld["x"].shape) for a in lcld["cons"].get_feature_min_max(lcld["x"]))
    for i in range(len(lcld["x"])):
        x, hot = lcld["x"][i], lcld["hot"][i]
        box = (np.minimum(x, hot) - 0.1 * (xu[i] - xl[i]), np.maximum(x, hot) + 0.1 * (xu[i] - xl[i]))
        _same_rows(pb(x, hot, box), jb(x, hot, box))
        _same_rows(pb(x, hot), jb(x, hot))
        _same_rows(pb(x, hot, box, focus=hot, window=0.25), jb(x, hot, box, focus=hot, window=0.25))


def test_botnet_rows_equal_jax_in_order(botnet):
    jb, pb = botnet["builders"]
    x, hot = botnet["x"][0], botnet["hot"][0]
    got, want = pb(x, hot, None), jb(x, hot, None)
    assert len(got.rows) == 2 + 34 + 324
    _same_rows(got, want)

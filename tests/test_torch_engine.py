"""Port parity of the MoEvA2 engine: the init round and one generation step
against the JAX engine's ``init`` and ``gen_step`` fed the same draws, and
the whole slice's success rates against the pymoo-validated ``oracle_ga``
rates of ``tests/fixtures/oracle_interior_rates.json``."""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import _niche_gumbels
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import GenerationDraws
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax
from test_torch_operators import jax_offspring_draws

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_interior_rates.json")


@pytest.fixture(scope="module")
def lcld(tmp_path_factory):
    paths = synth_lcld_schema(str(tmp_path_factory.mktemp("engine")))
    model = jmlp.lcld_mlp()
    params = jmlp.init_params(model, 47, seed=1)
    return {
        "jcons": JLcld(paths["features"], paths["constraints"]),
        "cons": LcldConstraints(paths["features"], paths["constraints"]),
        "jsur": jio.Surrogate(model, params),
        "tree": jax.tree.map(np.asarray, params),
    }


def _scaler(cons, pool):
    xl, xu = (np.broadcast_to(np.asarray(a, float), pool.shape) for a in cons.get_feature_min_max(pool))
    return fit_minmax(np.minimum(pool.min(0), xl.min(0)), np.maximum(pool.max(0), xu.max(0)))


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_carry_equal(jcarry, carry, what):
    jpx, jpf, jax_, jaf, jns = (np.asarray(a) if not isinstance(a, tuple) else a for a in jcarry[:5])
    # genes: equal; a mutated real gene may differ in its last ulp (pow()
    # rounds differently in XLA and PyTorch), hence 1e-15 relative
    np.testing.assert_allclose(carry.pop_x.numpy(), jpx, rtol=1e-15, atol=0, err_msg=what)
    np.testing.assert_allclose(carry.arch_x.numpy(), jax_, rtol=1e-15, atol=0, err_msg=what)
    np.testing.assert_allclose(carry.pop_f.numpy(), jpf, rtol=1e-12, atol=1e-12, err_msg=what)
    np.testing.assert_allclose(carry.arch_f.numpy(), jaf, rtol=1e-12, atol=1e-12, err_msg=what)
    for name, want, got in zip(carry.norm_state._fields, jns, carry.norm_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12, err_msg=f"{what} {name}")


@pytest.mark.parametrize("seed", [0, 5])
def test_init_and_generation_step_match_jax(lcld, seed):
    s, n_pop, n_off, arch = 5, 12, 10, 6
    x = synth_lcld(s, lcld["cons"].schema, seed=20 + seed)
    scaler = _scaler(lcld["cons"], x)
    knobs = dict(norm=2, n_gen=2, n_pop=n_pop, n_offsprings=n_off, archive_size=arch, seed=seed)
    jeng = JMoeva2(
        classifier=lcld["jsur"], constraints=lcld["jcons"], ml_scaler=JMinMax(*scaler),
        dtype=jnp.float64, **knobs,
    )
    teng = Moeva2(
        Surrogate(params_from_numpy(lcld["tree"], dtype=torch.float64)), lcld["cons"],
        ml_scaler=scaler, dtype=torch.float64, device="cpu", **knobs,
    )
    teng.asp_points = _t(jeng.asp_points)
    assert teng.pop_size == jeng.pop_size

    mc = np.ones(s, dtype=np.int64)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in lcld["cons"].get_feature_min_max(x))
    key = jax.random.PRNGKey(seed)
    jargs = (lcld["jsur"].params, jnp.asarray(x), jnp.asarray(mc, jnp.int32), jnp.asarray(xl), jnp.asarray(xu))
    jcarry, _ = jax.jit(jeng._build_init())(*jargs, key)
    run = teng.prepare(x, mc)
    _, _, k0 = jax.random.split(key, 3)
    gums = _niche_gumbels(k0, (s,), teng.n_dirs, teng.pop_size)
    carry = teng.init_carry(run, *map(_t, gums))
    _assert_carry_equal(jcarry, carry, "init")

    # one generation with the draws gen_step takes from the carried key
    jnext, _ = jax.jit(jeng._build_segment(), static_argnames="length")(*jargs, jcarry, length=1)
    _, k_mate, k_surv = jax.random.split(jcarry[5], 3)
    offspring = jax_offspring_draws(jax.random.split(k_mate, s), n_off, teng.codec.gen_length, teng.pop_size)
    gum_cut, gum_mem = _niche_gumbels(k_surv, (s,), teng.n_dirs, teng.pop_size + n_off)
    carry = teng.gen_step(run, carry, GenerationDraws(offspring, _t(gum_cut), _t(gum_mem)))
    _assert_carry_equal(jnext, carry, "gen_step")
    assert not np.array_equal(carry.pop_x.numpy(), np.asarray(jcarry[0]))  # it evolved


def test_generate_shapes_and_mutable_only(lcld):
    cons = lcld["cons"]
    x = synth_lcld(4, cons.schema, seed=3)
    eng = Moeva2(
        Surrogate(params_from_numpy(lcld["tree"])), cons, ml_scaler=_scaler(cons, x),
        n_gen=4, n_pop=10, n_offsprings=6, archive_size=3, seed=1, device="cpu",
        max_states_per_call=3,
    )
    res = eng.generate(x, minimize_class=1)
    assert res.x_ml.shape == (4, 13 + 3, 47) and res.x_gen.shape[:2] == (4, 16) and res.f.shape == (4, 16, 3)
    frozen = ~cons.schema.mutable
    np.testing.assert_array_equal(res.x_ml[:, :, frozen], np.broadcast_to(x[:, None, frozen].astype(np.float32), res.x_ml[:, :, frozen].shape))
    again = eng.generate(x, minimize_class=1)
    np.testing.assert_array_equal(res.x_ml, again.x_ml)  # seeded: reproducible


def test_entry_points_refuse_missing_cuda(lcld):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Moeva2(Surrogate(params_from_numpy(lcld["tree"])), lcld["cons"], n_pop=10)


def test_lp_ratio_init_is_not_ported(lcld):
    with pytest.raises(NotImplementedError):
        Moeva2(Surrogate(params_from_numpy(lcld["tree"])), lcld["cons"], n_pop=10, init="lp_ratio", device="cpu")


def _lcld_synth_problem(cons, tree, cfg):
    """``tools/oracle_check.py::build_lcld_synth`` with the port."""
    model = params_from_numpy(tree, dtype=torch.float64)
    pool = synth_lcld(cfg["pool"], cons.schema, seed=cfg["pool_seed"])
    scaler = _scaler(cons, pool)
    with torch.no_grad():
        p1 = Surrogate(model).predict_proba(torch.as_tensor(scaler.transform(pool)))[:, 1].numpy()
    cand = np.where(p1 >= cfg["thresholds"]["f1"])[0]
    cand = cand[np.argsort(-p1[cand])]
    sel = cand[np.linspace(0, len(cand) - 1, cfg["n_states"]).astype(int)]
    return Surrogate(model), scaler, pool[sel]


def test_slice_rates_within_oracle_tolerance(lcld):
    with open(FIXTURE) as f:
        fixture = json.load(f)
    dom = fixture["domains"]["lcld_synth"]
    cfg, tol = dom["config"], fixture["parity_tolerance"]
    sur, scaler, x = _lcld_synth_problem(lcld["cons"], lcld["tree"], cfg)
    calc = ObjectiveCalculator(
        classifier=sur, constraints=lcld["cons"], thresholds=dict(cfg["thresholds"]),
        min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=cfg["norm"],
    )
    rates = []
    for seed in cfg["seeds"]:
        eng = Moeva2(
            sur, lcld["cons"], ml_scaler=scaler, norm=cfg["norm"], n_gen=cfg["n_gen"],
            n_pop=cfg["n_pop"], n_offsprings=cfg["n_offsprings"],
            archive_size=cfg["archive_size"], seed=seed, device="cpu",
        )
        rates.append(calc.success_rate_3d(x, eng.generate(x, minimize_class=1).x_ml))
    mean = np.mean(rates, axis=0)
    want = np.asarray(dom["oracle_ga"]["mean"])
    assert np.all(np.abs(mean - want) <= tol), f"port {mean} vs oracle_ga {want}"

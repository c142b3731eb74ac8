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
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
    GenerationDraws, archive_select_plain, evaluate_plain, extract_archive_plain,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.core.norms import lp_distance
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


def _head_engine(lcld, head):
    """A small CPU engine on a surrogate with a 2-column or a 1-column
    (sigmoid) head, and 4 states for it."""
    tree = lcld["tree"]
    if head == 1:
        tree = jax.tree.map(np.asarray, jmlp.init_params(jmlp.MLP(hidden=(16, 8), n_classes=1), 47, seed=3))
    cons = lcld["cons"]
    x = synth_lcld(4, cons.schema, seed=5)
    eng = Moeva2(Surrogate(params_from_numpy(tree)), cons, ml_scaler=_scaler(cons, x),
                 n_gen=2, n_pop=10, n_offsprings=6, seed=1, device="cpu")
    return eng, x


@pytest.mark.parametrize("head", [2, 1])
@pytest.mark.parametrize("cls", [2, -1])
def test_generate_refuses_a_class_outside_the_head(lcld, head, cls):
    eng, x = _head_engine(lcld, head)
    with pytest.raises(ValueError, match=r"minimize_class must be a class of the 2-class head"):
        eng.generate(x, minimize_class=cls)
    with pytest.raises(ValueError, match=rf"got \[{cls}\]"):
        eng.generate(x, minimize_class=np.array([0, cls, 1, 0]))


@pytest.mark.parametrize("head", [2, 1])
@pytest.mark.parametrize("cls", [0, 1])
def test_generate_takes_either_class_of_the_head(lcld, head, cls):
    eng, x = _head_engine(lcld, head)
    res = eng.generate(x, minimize_class=cls)
    assert res.f.shape == (4, eng.pop_size, 3)
    # f1 is the probability of the class to minimise, as the head gives it
    x_in = torch.as_tensor(eng.ml_scaler.transform(res.x_ml.astype(np.float64)), dtype=torch.float32)
    with torch.no_grad():
        p = eng.classifier.predict_proba(x_in)[..., cls].numpy()
    np.testing.assert_allclose(res.f[..., 0], p, rtol=1e-5, atol=1e-6)


def test_entry_points_refuse_missing_cuda(lcld):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Moeva2(Surrogate(params_from_numpy(lcld["tree"])), lcld["cons"], n_pop=10)


def test_lp_ratio_init_is_not_ported(lcld):
    """The name is the refusal's this test once held; the lp_ratio init is
    ported now (``tests/test_torch_early_exit.py`` holds it against JAX):
    the engine runs it, moving the last ``round(init_ratio * pop)`` rows of
    the initial population off the initial state, and refuses other
    names with the JAX engine's ``ValueError``."""
    x = synth_lcld(3, lcld["cons"].schema, seed=2)
    sur = Surrogate(params_from_numpy(lcld["tree"]))
    eng = Moeva2(sur, lcld["cons"], ml_scaler=_scaler(lcld["cons"], x), n_pop=10, n_gen=1, init="lp_ratio",
                 init_eps=0.3, init_ratio=0.5, device="cpu")
    pop = eng.generate(x, 1).x_gen
    moved = (pop != pop[:, :1]).any(-1)
    n_pert = round(0.5 * eng.pop_size)
    assert moved[:, -n_pert:].any() and not moved[:, : eng.pop_size - n_pert].any()
    with pytest.raises(ValueError, match="init must be 'tile' or 'lp_ratio'"):
        Moeva2(sur, lcld["cons"], n_pop=10, init="sobol", device="cpu")


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


# -- objectives (K1): evaluate_plain against the JAX engine's _evaluate ------


def _hard_candidates(codec, x, xl, xu, seed):
    """(S, 12, L) genetic candidates around the states, with rows the main
    path makes rarely: 0 denominators of the ratio constraints (annual_inc,
    total_acc, pub_rec, the derived month count), a term outside {36, 60} and
    categorical genes at .5."""
    rng = np.random.default_rng(seed)
    xlg, xug = (np.asarray(a) for a in codec_lib.genetic_bounds(codec, _t(xl), _t(xu)))
    g0 = codec_lib.ml_to_genetic(codec, _t(x)).numpy()[:, None, :]
    cand = g0 + rng.normal(size=(x.shape[0], 12, codec.gen_length)) * (xug - xlg)[:, None, :] * 0.1
    cand = np.clip(cand, xlg[:, None], xug[:, None])
    cand = np.where(codec.int_mask_gen.numpy(), np.round(cand), cand)
    gene = {int(d): i for i, d in enumerate(codec.non_ohe_ml_idx)}
    for k, feat in enumerate((6, 14, 11, 22)):
        cand[:, 1 + k, gene[feat]] = 0.0
    cand[:, 5, gene[0]] = 0.0  # 0 / 0 with a 0 annual_inc
    cand[:, 5, gene[6]] = 0.0
    cand[:, 6, gene[1]] = 48.0  # term not in {36, 60}
    cand[:, 7, codec.n_non_ohe:] += 0.5
    return cand


def _objective_pair(lcld, x, dtype, norm=2, scaled=True, head=2):
    """The JAX engine and the port's on one surrogate; ``head=1`` is a
    sigmoid (1-column) head."""
    if head == 2:
        jsur, tree = lcld["jsur"], lcld["tree"]
    else:
        model = jmlp.MLP(hidden=(16, 8), n_classes=1)
        params = jmlp.init_params(model, 47, seed=3)
        jsur, tree = jio.Surrogate(model, params), jax.tree.map(np.asarray, params)
    scaler = _scaler(lcld["cons"], x) if scaled else None
    knobs = dict(norm=norm, n_gen=2, n_pop=12, n_offsprings=10)
    jeng = JMoeva2(classifier=jsur, constraints=lcld["jcons"], ml_scaler=JMinMax(*scaler) if scaled else None,
                   dtype=jnp.float64, **knobs)
    teng = Moeva2(Surrogate(params_from_numpy(tree, dtype=dtype)), lcld["cons"], ml_scaler=scaler,
                  dtype=dtype, device="cpu", **knobs)
    return jeng, teng, jsur


def _jax_objectives(jeng, jsur, x, xl, xu, mc, cand):
    x_mm = (x - xl) / np.where(xu - xl == 0, 1.0, xu - xl)
    f, _ = jeng._evaluate(jsur.params, *(jnp.asarray(a) for a in (cand, x, x_mm, xl, xu)), jnp.asarray(mc))
    return np.asarray(f)


@pytest.mark.parametrize("norm,scaled,head", [(2, True, 2), ("inf", True, 2), (2, False, 2), (2, True, 1)])
def test_evaluate_plain_matches_jax(lcld, norm, scaled, head):
    s = 6
    x = synth_lcld(s, lcld["cons"].schema, seed=40)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in lcld["cons"].get_feature_min_max(x))
    mc = np.arange(s) % 2
    jeng, teng, jsur = _objective_pair(lcld, x, torch.float64, norm, scaled, head)
    cand = _hard_candidates(teng.codec, x, xl, xu, seed=len(str(norm)) + head)
    want = _jax_objectives(jeng, jsur, x, xl, xu, mc, cand)
    got = evaluate_plain(teng._objective, teng.codec, teng.prepare(x, mc), _t(cand), teng.constraints).numpy()
    assert not np.isfinite(want).all()  # the 0 denominators show
    # float64: XLA's pow differs from PyTorch's in the last ulp and g1 cancels
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    # the engine's CPU entry point is the plain version
    assert torch.equal(teng._evaluate(teng.prepare(x, mc), _t(cand)).isnan(), torch.isnan(_t(got)))


def test_evaluate_plain_float32_within_tolerance(lcld):
    s = 6
    x = synth_lcld(s, lcld["cons"].schema, seed=41)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in lcld["cons"].get_feature_min_max(x))
    mc = np.arange(s) % 2
    jeng, teng, jsur = _objective_pair(lcld, x, torch.float32)
    cand = _hard_candidates(teng.codec, x, xl, xu, seed=9)
    want = _jax_objectives(jeng, jsur, x, xl, xu, mc, cand)
    run = teng.prepare(x, mc)
    got = evaluate_plain(teng._objective, teng.codec, run, torch.as_tensor(cand, dtype=torch.float32), teng.constraints)
    # today's composition of the port's library functions, in float32
    x_gen = torch.as_tensor(cand, dtype=torch.float32)
    x_f = codec_lib.genetic_to_ml(teng.codec, x_gen, run.x_init_ml[:, None, :])
    x_mm = codec_lib.minmax_normalize(x_f, run.xl_ml[:, None, :], run.xu_ml[:, None, :])
    probs = Surrogate(teng._model).predict_proba(teng.ml_scaler.transform(x_f))
    old = torch.stack([
        torch.gather(probs, -1, run.minimize_class[:, None, None].expand(-1, probs.shape[1], 1))[..., 0],
        lp_distance(x_mm - run.x_init_mm[:, None, :], 2) / float(np.sqrt(47)),
        teng.constraints.evaluate(x_f).sum(-1),
    ], dim=-1)
    # float32 against float64: f1 within 1e-6 (measured 6e-7), f2 within
    # 1e-5 relative, the violation sum within 1e-4 relative plus 2e-3 (g1
    # subtracts two installments of a few hundred, and a term within float32
    # rounding of the 1e-3 threshold may count on one side and not the other)
    for ref in (want, old.double().numpy()):
        np.testing.assert_allclose(got[..., 0].numpy(), ref[..., 0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[..., 1].numpy(), ref[..., 1], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[..., 2].numpy(), ref[..., 2], rtol=1e-4, atol=2e-3)


# -- extraction and archive (K4b's tail) against the JAX engine --------------


def _jax_extract(mask, merged_x, merged_f, pop_size):
    """The survivor extraction of the JAX ``gen_step``
    (``attacks/moeva/engine.py:608-625``), over given arrays."""
    n_true = mask.sum(1, keepdims=True)
    dest = jnp.where(mask, jnp.cumsum(mask, axis=1) - 1, n_true + jnp.cumsum(~mask, axis=1) - 1)
    order = (
        jnp.zeros_like(dest).at[jnp.arange(dest.shape[0])[:, None], dest]
        .set(jnp.broadcast_to(jnp.arange(mask.shape[1]), dest.shape))
    )[:, :pop_size]
    return (jnp.take_along_axis(merged_x, order[..., None], axis=1),
            jnp.take_along_axis(merged_f, order[..., None], axis=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_archive_plain_matches_jax(lcld, seed):
    """Survivors first in stable order, and the archive's top A by
    feasible-first score in a stable sort with NaN last, equal to the JAX
    engine's; the scores have ties (duplicate rows, equal feasible scores)
    and NaNs (an inf violation scores 2 + inf/inf)."""
    rng = np.random.default_rng(seed)
    s, p, n, size, length = 5, 12, 10, 6, 7
    jeng = JMoeva2(classifier=lcld["jsur"], constraints=lcld["jcons"], n_gen=2, n_pop=12, n_offsprings=10,
                   archive_size=size, dtype=jnp.float64)
    mask = np.zeros((s, p + n), dtype=bool)
    for row in mask:
        row[rng.choice(p + n, p, replace=False)] = True
    pop_x, off = rng.normal(size=(s, p, length)), rng.normal(size=(s, n, length))
    arch_x = rng.normal(size=(s, size, length))

    def objectives(k):
        f = np.stack([rng.uniform(size=(s, k)), rng.uniform(size=(s, k)),
                      np.where(rng.random((s, k)) < 0.5, 0.0, rng.exponential(size=(s, k)))], -1)
        f[:, 1::4] = f[:, ::4][:, : f[:, 1::4].shape[1]]  # duplicate rows: tied scores
        f[rng.random((s, k)) < 0.15, 2] = np.inf  # NaN scores
        return f

    pop_f, off_f, arch_f = objectives(p), objectives(n), objectives(size)
    got = extract_archive_plain(*(_t(a) for a in (mask, pop_x, off, pop_f, off_f, arch_x, arch_f)))
    want_x, want_f = _jax_extract(jnp.asarray(mask), jnp.concatenate([pop_x, off], 1),
                                  jnp.concatenate([pop_f, off_f], 1), p)
    want_ax, want_af = jeng._archive_select(jnp.concatenate([arch_x, off], 1), jnp.concatenate([arch_f, off_f], 1))
    assert np.isnan(np.asarray(jeng._archive_score(jnp.concatenate([arch_f, off_f], 1)))).any()
    for g, w in zip(got, (want_x, want_f, want_ax, want_af)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the archive seeding of init_carry: one row set
    for g, w in zip(archive_select_plain(_t(pop_x), _t(pop_f), size), jeng._archive_select(pop_x, pop_f)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

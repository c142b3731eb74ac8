"""Port parity of the botnet domain: the synthetic schema and rows, the 360
constraint terms, per-state dynamic bounds, the objectives, the init round
and one generation step against the JAX package (CPU, x64), and the whole
attack's success rates against the JAX engine's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import _niche_gumbels
from moeva2_ijcai22_replication_tpu.core import codec as jcodec
from moeva2_ijcai22_replication_tpu.domains import synth as jsynth
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import GenerationDraws, evaluate_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_botnet, synth_botnet_schema
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.mlp import botnet_mlp
from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax
from moeva2_ijcai22_replication_tpu_torch.problems import botnet_hard_candidates
from test_torch_engine import _assert_carry_equal
from test_torch_operators import jax_offspring_draws

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def botnet(tmp_path_factory):
    paths = synth_botnet_schema(str(tmp_path_factory.mktemp("botnet")))
    model = jmlp.botnet_mlp()
    params = jmlp.init_params(model, 756, seed=1)
    return {
        "paths": paths,
        "jcons": JBotnet(paths["features"], paths["constraints"]),
        "cons": BotnetConstraints(paths["features"], paths["constraints"]),
        "jsur": jio.Surrogate(model, params),
        "tree": jax.tree.map(np.asarray, params),
    }


def _t(a):
    return torch.as_tensor(np.array(a))


def _bounds(cons, x):
    return (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))


def _scaler(cons, pool):
    xl, xu = _bounds(cons, pool)
    return fit_minmax(np.minimum(pool.min(0), xl.min(0)), np.maximum(pool.max(0), xu.max(0)))


def _edge_rows(cons, x):
    """``x`` (n, 756) with, on every ninth row from row 1 to 8, the terms'
    edge cases (``problems.botnet_hard_candidates``: 0, -0.0 and NaN packets,
    infinite and inf - inf flow sums, a ratio of exactly 1500, an ordering
    at -inf)."""
    codec = codec_lib.make_codec(cons.schema)
    return botnet_hard_candidates(codec, cons.schema.names, torch.as_tensor(x)[None])[0].numpy()


# -- the synthetic domain -------------------------------------------------------


def test_synth_botnet_writes_and_draws_what_jax_does(botnet, tmp_path):
    jpaths = jsynth.synth_botnet_schema(str(tmp_path))
    for key in ("features", "constraints", "feat_idx"):
        with open(jpaths[key], "rb") as a, open(botnet["paths"][key], "rb") as b:
            assert a.read() == b.read(), key
    x = synth_botnet(40, botnet["cons"].schema, seed=5)
    np.testing.assert_array_equal(x, jsynth.synth_botnet(40, botnet["jcons"].schema, seed=5))
    botnet["cons"].check_constraints_error(x)


def test_tables_follow_the_reference_layout(botnet):
    cons = botnet["cons"]
    assert cons.n_constraints == 360 and cons.objective_kernel == "botnet"
    tables = cons.kernel_tables("cpu")
    assert tables.counts == (54, 36, 54, 36, 34, 34) + (108,) * 6
    assert tables.index.dtype == torch.int32 and tables.index.numel() == sum(tables.counts)
    assert int(tables.index.min()) >= 0 and int(tables.index.max()) < 756
    np.testing.assert_array_equal(cons.repair(torch.ones(3, 756)).numpy(), np.ones((3, 756)))


# -- (a) the 360 terms against JAX's ----------------------------------------------


def _term_rows(cons, seed):
    """Feasible rows, the same rows scaled by 1 + 0.05 N (as tests/test_ir.py's
    botnet_pair) and edge rows."""
    x = synth_botnet(27, cons.schema, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x_pert = x * (1.0 + 0.05 * rng.standard_normal(x.shape))
    return {"feasible": x, "perturbed": x_pert, "edges": _edge_rows(cons, x_pert)}


def _term_scale(cons, x):
    """Per term, the magnitude its float32 rounding scales with: the summed
    absolute features of a flow equality, |b / p| + 1500 for a ratio, |lower|
    + |upper| for an ordering."""
    fs, bs, fd, bd, rb, rp, *orders = (t.numpy() for t in cons._tables("cpu"))
    a = np.abs(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.abs(np.where(x[:, rp] != 0, x[:, rb] / np.where(x[:, rp] != 0, x[:, rp], 1.0), 0.0)) + 1500.0
    parts = [(a[:, f].sum(-1) + a[:, b].sum(-1))[:, None] for f, b in ((fs, bs), (fd, bd))]
    parts += [ratio] + [a[:, lo] + a[:, up] for lo, up in zip(orders[::2], orders[1::2])]
    return np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("kind", ["feasible", "perturbed", "edges"])
def test_terms_match_jax(botnet, kind):
    cons, jcons = botnet["cons"], botnet["jcons"]
    x = _term_rows(cons, seed=3)[kind]
    want = np.asarray(jcons._raw(jnp.asarray(x)))
    got = cons._raw(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (27, 360)
    # float64: JAX sums in its own order, the port left to right
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # which terms count: exactly the same ones
    np.testing.assert_array_equal(cons.evaluate(torch.as_tensor(x)).numpy() > 0,
                                  np.asarray(jcons.evaluate(jnp.asarray(x))) > 0)
    if kind == "feasible":
        assert not (got > cons.tol).any()
    if kind == "edges":
        assert np.isnan(got).any() and np.isinf(got).any()
    # float32: each term within 1e-5 of its scale (90 rounded adds of at most
    # 2^-24 of the partial sum each, and the inputs' rounding), the same
    # terms above the tolerance (the perturbed rows' violations are far
    # above it, the feasible rows' terms exactly 0 in float32 too: their
    # values are multiples of 1/16 below 2^18)
    got32 = cons._raw(torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got32), fin)
    assert (np.abs(got32 - want)[fin] <= 1e-5 * _term_scale(cons, x)[fin]).all()
    np.testing.assert_array_equal(cons.evaluate(torch.as_tensor(x, dtype=torch.float32)).numpy() > 0, want > cons.tol)


# -- (b) per-state dynamic bounds ---------------------------------------------------


@pytest.fixture(scope="module")
def dynamic(botnet, tmp_path_factory):
    """The synthetic schema with "dynamic" bounds: min on 20 context
    features, max on 18 duration sums, both on 6 bytes_in sums."""
    out = tmp_path_factory.mktemp("dynamic")
    with open(botnet["paths"]["features"]) as f:
        lines = f.read().splitlines()
    names = [ln.split(",")[0] for ln in lines[1:]]
    for k, name in enumerate(names):
        cols = lines[k + 1].split(",")
        if name.startswith("ctx_") and int(name[4:]) >= 736:
            cols[3] = "dynamic"
        if name.startswith("duration_sum_s"):
            cols[4] = "dynamic"
        if name.startswith("bytes_in_sum_d_p") and int(name.rsplit("p", 1)[1]) < 6:
            cols[3] = cols[4] = "dynamic"
        lines[k + 1] = ",".join(cols)
    for name in ("constraints.csv", "feat_idx.pickle"):
        with open(botnet["paths"]["constraints" if name.endswith("csv") else "feat_idx"], "rb") as src:
            (out / name).write_bytes(src.read())
    (out / "features.csv").write_text("\n".join(lines) + "\n")
    paths = (str(out / "features.csv"), str(out / "constraints.csv"))
    return BotnetConstraints(*paths), JBotnet(*paths)


def test_dynamic_bounds_and_prepare_match_jax(botnet, dynamic):
    cons, jcons = dynamic
    assert cons.schema.has_dynamic_bounds
    assert int(cons.schema.min_dynamic.sum()) == 26 and int(cons.schema.max_dynamic.sum()) == 24
    x = synth_botnet(5, cons.schema, seed=8)
    for a, b in zip(cons.get_feature_min_max(x), jcons.get_feature_min_max(x)):
        np.testing.assert_array_equal(a, b)
    xl, xu = _bounds(jcons, x)
    assert (xl[:, cons.schema.min_dynamic] == x[:, cons.schema.min_dynamic]).all()
    eng = Moeva2(Surrogate(params_from_numpy(botnet["tree"], dtype=torch.float64)), cons, dtype=torch.float64,
                 n_pop=12, n_offsprings=10, device="cpu")
    jeng = JMoeva2(classifier=botnet["jsur"], constraints=jcons, n_pop=12, n_offsprings=10, dtype=jnp.float64)
    run = eng.prepare(x, np.ones(5, dtype=np.int64))
    xl_gen, xu_gen = jcodec.genetic_bounds(jeng.codec, jnp.asarray(xl), jnp.asarray(xu))
    want = {
        "x_init_ml": x, "xl_ml": xl, "xu_ml": xu, "xl_gen": xl_gen, "xu_gen": xu_gen,
        "x_init_mm": jcodec.minmax_normalize(jnp.asarray(x), jnp.asarray(xl), jnp.asarray(xu)),
    }
    for name, w in want.items():
        np.testing.assert_array_equal(getattr(run, name).numpy(), np.asarray(w), err_msg=name)
    # each state's own bounds: the states differ on the dynamic features
    assert not np.array_equal(run.xl_ml[0].numpy(), run.xl_ml[1].numpy())


# -- (c) the objectives against JAX's _evaluate ---------------------------------------


def _objective_pair(botnet, x, norm, scaled, head):
    tree, jsur = botnet["tree"], botnet["jsur"]
    if head == 1:
        model = jmlp.MLP(hidden=(64, 64, 32), n_classes=1)
        params = jmlp.init_params(model, 756, seed=3)
        jsur, tree = jio.Surrogate(model, params), jax.tree.map(np.asarray, params)
    scaler = _scaler(botnet["cons"], x) if scaled else None
    knobs = dict(norm=norm, n_gen=2, n_pop=12, n_offsprings=10)
    jeng = JMoeva2(classifier=jsur, constraints=botnet["jcons"], ml_scaler=JMinMax(*scaler) if scaled else None,
                   dtype=jnp.float64, **knobs)
    teng = Moeva2(Surrogate(params_from_numpy(tree, dtype=torch.float64)), botnet["cons"], ml_scaler=scaler,
                  dtype=torch.float64, device="cpu", **knobs)
    return jeng, teng, jsur


@pytest.mark.parametrize("norm,scaled,head", [(2, True, 2), ("inf", True, 2), (2, False, 2), (2, True, 1)])
def test_evaluate_plain_matches_jax(botnet, norm, scaled, head):
    s = 4
    x = synth_botnet(s, botnet["cons"].schema, seed=40 + head)
    xl, xu = _bounds(botnet["cons"], x)
    mc = np.arange(s) % 2
    jeng, teng, jsur = _objective_pair(botnet, x, norm, scaled, head)
    rng = np.random.default_rng(len(str(norm)) + head)
    cand = x[:, None, :] * (1.0 + 0.05 * rng.standard_normal((s, 18, 756)))
    cand = np.stack([_edge_rows(botnet["cons"], c) for c in cand])
    x_mm = (x - xl) / np.where(xu - xl == 0, 1.0, xu - xl)
    want, _ = jeng._evaluate(jsur.params, *(jnp.asarray(a) for a in (cand, x, x_mm, xl, xu)), jnp.asarray(mc))
    want = np.asarray(want)
    run = teng.prepare(x, mc)
    got = evaluate_plain(teng._objective, teng.codec, run, _t(cand), teng.constraints).numpy()
    assert not np.isfinite(want).all()  # the edge rows show
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(teng._evaluate(run, _t(cand)).numpy(), got)  # the engine's CPU entry point


def test_evaluate_plain_float32_within_tolerance(botnet):
    s = 4
    x = synth_botnet(s, botnet["cons"].schema, seed=44)
    xl, xu = _bounds(botnet["cons"], x)
    mc = np.arange(s) % 2
    jeng, teng, jsur = _objective_pair(botnet, x, 2, True, 2)
    rng = np.random.default_rng(9)
    cand = x[:, None, :] * (1.0 + 0.05 * rng.standard_normal((s, 12, 756)))
    x_mm = (x - xl) / np.where(xu - xl == 0, 1.0, xu - xl)
    want, _ = jeng._evaluate(jsur.params, *(jnp.asarray(a) for a in (cand, x, x_mm, xl, xu)), jnp.asarray(mc))
    want = np.asarray(want)
    t32 = Moeva2(Surrogate(params_from_numpy(botnet["tree"])), botnet["cons"], ml_scaler=teng.ml_scaler, norm=2,
                 n_pop=12, n_offsprings=10, device="cpu")
    got = evaluate_plain(t32._objective, t32.codec, t32.prepare(x, mc), torch.as_tensor(cand, dtype=torch.float32),
                         t32.constraints).double().numpy()
    # float32 against float64: f1 within 1e-6 (756 inputs summed in order), f2
    # within 1e-5 relative, the violation sum within 1e-5 of its terms'
    # summed scales (a flow term is the difference of two sums near 2e5,
    # each add rounded at 2^-24 of its partial sum)
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-5, atol=0)
    scale = _term_scale(botnet["cons"], cand.reshape(-1, 756)).sum(-1).reshape(s, -1)
    assert (np.abs(got[..., 2] - want[..., 2]) <= 1e-5 * scale).all()


# -- (d) init and one generation step against JAX fed the same draws ---------------


def test_init_and_generation_step_match_jax(botnet):
    s, n_pop, n_off, arch, seed = 4, 12, 10, 6, 3
    cons = botnet["cons"]
    x = synth_botnet(s, cons.schema, seed=20)
    scaler = _scaler(cons, x)
    knobs = dict(norm=2, n_gen=2, n_pop=n_pop, n_offsprings=n_off, archive_size=arch, seed=seed)
    jeng = JMoeva2(classifier=botnet["jsur"], constraints=botnet["jcons"], ml_scaler=JMinMax(*scaler),
                   dtype=jnp.float64, **knobs)
    teng = Moeva2(Surrogate(params_from_numpy(botnet["tree"], dtype=torch.float64)), cons, ml_scaler=scaler,
                  dtype=torch.float64, device="cpu", **knobs)
    teng.asp_points = _t(jeng.asp_points)
    assert teng.pop_size == jeng.pop_size and teng.codec.gen_length == 756

    mc = np.ones(s, dtype=np.int64)
    xl, xu = _bounds(cons, x)
    key = jax.random.PRNGKey(seed)
    jargs = (botnet["jsur"].params, jnp.asarray(x), jnp.asarray(mc, jnp.int32), jnp.asarray(xl), jnp.asarray(xu))
    jcarry, _ = jax.jit(jeng._build_init())(*jargs, key)
    run = teng.prepare(x, mc)
    _, _, k0 = jax.random.split(key, 3)
    carry = teng.init_carry(run, *map(_t, _niche_gumbels(k0, (s,), teng.n_dirs, teng.pop_size)))
    _assert_carry_equal(jcarry, carry, "init")

    jnext, _ = jax.jit(jeng._build_segment(), static_argnames="length")(*jargs, jcarry, length=1)
    _, k_mate, k_surv = jax.random.split(jcarry[5], 3)
    offspring = jax_offspring_draws(jax.random.split(k_mate, s), n_off, 756, teng.pop_size)
    gum_cut, gum_mem = _niche_gumbels(k_surv, (s,), teng.n_dirs, teng.pop_size + n_off)
    carry = teng.gen_step(run, carry, GenerationDraws(offspring, _t(gum_cut), _t(gum_mem)))
    _assert_carry_equal(jnext, carry, "gen_step")
    assert not np.array_equal(carry.pop_x.numpy(), np.asarray(jcarry[0]))  # it evolved


# -- (e) the whole attack's rates against the JAX engine's ----------------------------

#: 16 states x 40 generations, pop 40, 20 offspring, seeds 42-44, judged at
#: f1 0.5 and f2 RATES_EPS
RATES = dict(n_states=16, n_gen=40, n_pop=40, n_offsprings=20, seeds=(42, 43, 44), pool=256, pool_seed=11)
RATES_EPS = 0.05
#: the oracle fixture's tolerance for mean rates
PARITY_TOLERANCE = 0.3
#: the head's logits times this, centred on the pool: an untrained 756-input
#: stack puts every state within 0.1 of p = 0.5, where 40 generations
#: cannot cross the threshold
HEAD_GAIN = 10.0


def _sharp_surrogate(botnet, pool, scaler):
    """The botnet surrogate's params with the head's logit difference
    centred on ``pool``'s median and scaled by ``HEAD_GAIN``."""
    tree = jax.tree.map(np.array, botnet["tree"])
    with torch.no_grad():
        logits = Surrogate(params_from_numpy(tree, dtype=torch.float64)).logits(
            torch.as_tensor(scaler.transform(pool))).numpy()
    mid = np.median(logits[:, 1] - logits[:, 0])
    head = tree["params"]["Dense_3"]
    head["bias"] = (head["bias"] + np.array([mid / 2, -mid / 2], dtype=head["bias"].dtype)) * HEAD_GAIN
    head["kernel"] = head["kernel"] * HEAD_GAIN
    return tree


def test_attack_rates_match_the_jax_engine(botnet):
    cons = botnet["cons"]
    pool = synth_botnet(RATES["pool"], cons.schema, seed=RATES["pool_seed"])
    scaler = _scaler(cons, pool)
    tree = _sharp_surrogate(botnet, pool, scaler)
    sur = Surrogate(params_from_numpy(tree))
    jsur = jio.Surrogate(jmlp.botnet_mlp(), tree)
    with torch.no_grad():
        p1 = sur.predict_proba(torch.as_tensor(scaler.transform(pool), dtype=torch.float32))[:, 1].numpy()
    # states the surrogate puts in class 1, spread over the third of them
    # nearest the threshold (p1 from 0.50 to 0.55)
    cand = np.where(p1 >= 0.5)[0]
    cand = cand[np.argsort(p1[cand])]
    x = pool[cand[np.linspace(0, len(cand) // 3, RATES["n_states"]).astype(int)]]
    calc = ObjectiveCalculator(classifier=sur, constraints=cons, thresholds={"f1": 0.5, "f2": RATES_EPS},
                               min_max_scaler=scaler, ml_scaler=scaler, minimize_class=1, norm=2)
    knobs = {k: RATES[k] for k in ("n_gen", "n_pop", "n_offsprings")}
    # the port in float64 (one matmul per layer on the CPU); the seed is a
    # runtime argument of the JAX engine's programs, so one engine serves
    # the three seeds with one compile
    jeng = JMoeva2(classifier=jsur, constraints=botnet["jcons"], ml_scaler=JMinMax(*scaler), norm=2, **knobs)
    port, ref = [], []
    for seed in RATES["seeds"]:
        eng = Moeva2(sur, cons, ml_scaler=scaler, norm=2, seed=seed, device="cpu", dtype=torch.float64, **knobs)
        port.append(calc.success_rate_3d(x, eng.generate(x, minimize_class=1).x_ml))
        jeng.seed = seed
        ref.append(calc.success_rate_3d(x, np.asarray(jeng.generate(x, minimize_class=1).x_ml)))
    port, ref = np.mean(port, axis=0), np.mean(ref, axis=0)
    assert np.all(np.abs(port - ref) <= PARITY_TOLERANCE), f"port {port} vs JAX engine {ref}"
    # o1 (C) and o3 (D) hold from the initial states (feasible, at distance
    # 0); the columns with M, o2, o4, o6 and o7, depend on the attack and are
    # interior (measured: port 0.417 0.250 0.125 0.125, JAX 0.438 0.229 0.125
    # 0.083); o2 must stay so in both engines
    assert port[0] == ref[0] == 1.0 and port[2] == ref[2] == 1.0
    assert 0 < ref[1] < 1 and 0 < port[1] < 1, f"o2 is not interior: port {port} vs JAX engine {ref}"


def test_botnet_mlp_matches_jax():
    """``botnet_mlp``'s topology and ``params_from_numpy`` carrying a JAX
    botnet stack across (float64 logits within 1e-12)."""
    model = jmlp.botnet_mlp()
    params = jmlp.init_params(model, 756, seed=4)
    port = params_from_numpy(jax.tree.map(np.asarray, params), dtype=torch.float64)
    assert port.hidden == botnet_mlp().hidden == (64, 64, 32) and port.n_classes == 2
    assert [tuple(m.weight.shape) for m in port.layers] == [(64, 756), (64, 64), (32, 64), (2, 32)]
    x = np.random.default_rng(0).uniform(0, 1, (16, 756))
    with torch.no_grad():
        got = port(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(model.apply(params, jnp.asarray(x))), rtol=0, atol=1e-12)
    a, b = botnet_mlp(seed=3), botnet_mlp(seed=3)
    assert all(torch.equal(la.weight, lb.weight) for la, lb in zip(a.layers, b.layers))


def test_botnet_runs_on_the_cpu_and_is_refused_without_cuda(botnet):
    x = synth_botnet(3, botnet["cons"].schema, seed=2)
    eng = Moeva2(Surrogate(params_from_numpy(botnet["tree"])), botnet["cons"], ml_scaler=_scaler(botnet["cons"], x),
                 n_gen=3, n_pop=10, n_offsprings=6, archive_size=2, device="cpu")
    res = eng.generate(x, minimize_class=1)
    assert res.x_ml.shape == (3, eng.pop_size + 2, 756) and np.isfinite(res.f).any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Moeva2(Surrogate(params_from_numpy(botnet["tree"])), botnet["cons"], n_pop=10)


def test_a_set_without_an_objective_kernel_is_refused_on_the_card(botnet, monkeypatch):
    # Moeva2 refuses the card before it looks for one: the refusal does not
    # depend on a card being present
    monkeypatch.setattr(type(botnet["cons"]), "objective_kernel", None)
    monkeypatch.setattr("moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine.resolve_device",
                        lambda d: torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="has no objective kernel"):
        Moeva2(Surrogate(params_from_numpy(botnet["tree"])), botnet["cons"], n_pop=10)

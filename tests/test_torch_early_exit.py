"""Port parity of MoEvA2's engine extras: the gate statistics, the repack
gather, the bucket menu, the ``lp_ratio`` init and a whole early-exit run
with active-set compaction against the JAX engine fed the same draws, in
float64; within the port, the knobs that must not change a result (double
buffering, quality samples, a gate that never fires) against strict mode."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.attacks.moeva import initialisation as jinit
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import NormState as JNormState
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import _niche_gumbels
from moeva2_ijcai22_replication_tpu.attacks.objective import engine_quality_stats as j_quality_stats
from moeva2_ijcai22_replication_tpu.core import codec as jcodec
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
    GenerationDraws, InitDraws, final_columns_plain, take_carry_plain,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.initialisation import (
    ball_draw_shape, lp_ratio_init, n_perturbed,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import engine_quality_stats
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.observability.quality import (
    merge_chunk_quality, sample_from_per_state, trim_quality,
)
from test_torch_engine import _scaler, _t
from test_torch_operators import jax_offspring_draws

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lcld(tmp_path_factory):
    paths = synth_lcld_schema(str(tmp_path_factory.mktemp("early_exit")))
    model = jmlp.lcld_mlp()
    params = jmlp.init_params(model, 47, seed=1)
    return {
        "jcons": JLcld(paths["features"], paths["constraints"]),
        "cons": LcldConstraints(paths["features"], paths["constraints"]),
        "jsur": jio.Surrogate(model, params),
        "tree": jax.tree.map(np.asarray, params),
    }


def _gate_objectives(rng, s, m):
    """Objectives with the gate's edges: NaN and ±inf entries, all-NaN
    states, f1 exactly at the threshold 0.5 and f2 exactly at eps 0.25,
    violations exactly 0 and -0."""
    f = rng.uniform(-0.2, 1.0, size=(s, m, 3))
    f[..., 2] = np.where(rng.random((s, m)) < 0.4, 0.0, np.abs(f[..., 2]))
    f[rng.random((s, m)) < 0.05, 2] = -0.0
    f[rng.random((s, m)) < 0.05, 0] = 0.5
    f[rng.random((s, m)) < 0.05, 1] = 0.25
    for col in range(3):
        f[rng.random((s, m)) < 0.03, col] = np.nan
        f[rng.random((s, m)) < 0.02, col] = np.inf
        f[rng.random((s, m)) < 0.02, col] = -np.inf
    f[0] = np.nan  # an all-NaN state
    return f


@pytest.mark.parametrize("s,m", [(1, 7), (9, 40), (33, 113)])
def test_engine_quality_stats_matches_jax(s, m):
    f = _gate_objectives(np.random.default_rng(s), s, m)
    for thr, eps in ((0.5, 0.25), (0.5, np.inf), (0.0, 0.0)):
        want = np.asarray(j_quality_stats(jnp.asarray(f), thr, eps, xp=jnp))
        np.testing.assert_array_equal(engine_quality_stats(torch.as_tensor(f), thr, eps).numpy(), want)
        np.testing.assert_array_equal(engine_quality_stats(f, thr, eps), j_quality_stats(f, thr, eps, xp=np))


def _jax_engine(lcld, x, **knobs):
    return JMoeva2(classifier=lcld["jsur"], constraints=lcld["jcons"], ml_scaler=JMinMax(*_scaler(lcld["cons"], x)),
                   dtype=jnp.float64, **knobs)


def _port_engine(lcld, x, jeng=None, **knobs):
    eng = Moeva2(Surrogate(params_from_numpy(lcld["tree"], dtype=torch.float64)), lcld["cons"],
                 ml_scaler=_scaler(lcld["cons"], x), dtype=torch.float64, device="cpu", **knobs)
    if jeng is not None:
        eng.asp_points = _t(jeng.asp_points)
        assert eng.pop_size == jeng.pop_size
    return eng


@pytest.mark.parametrize("archive", [0, 5])
def test_take_carry_and_final_columns_match_jax(lcld, archive):
    rng = np.random.default_rng(archive)
    s, p, l = 7, 13, 27
    leaves = [rng.normal(size=shape) for shape in ((s, p, l), (s, p, 3), (s, archive, l), (s, archive, 3),
                                                     (s, 3), (s, 3), (s, 3, 3))]
    leaves[1][0, 0] = np.nan
    x = synth_lcld(2, lcld["cons"].schema, seed=1)
    jeng = _jax_engine(lcld, x, n_pop=10, n_offsprings=4, archive_size=archive)
    jcarry = (*map(jnp.asarray, leaves[:4]), JNormState(*map(jnp.asarray, leaves[4:])), jax.random.PRNGKey(0))
    for sel in (np.array([6, 2, 2, 0]), np.arange(s), np.arange(s)[::-1].copy(), np.array([3, 3, 3])):
        got = take_carry_plain(torch.as_tensor(sel), [torch.as_tensor(a) for a in leaves])
        want = jeng._take_carry(jcarry, sel)
        want = [*want[:4], *want[4]]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        gx, gf = final_columns_plain(torch.as_tensor(sel), *(torch.as_tensor(a) for a in leaves[:4]))
        wx, wf = jeng._final_columns(jcarry, sel)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


def test_bucket_menu_matches_jax():
    for sizes in (common.DEFAULT_BUCKET_SIZES, (2, 4), (3, 1, 10), (5,)):
        menu, jmenu = common.BucketMenu(sizes), jcommon.BucketMenu(sizes)
        assert menu.sizes == jmenu.sizes and menu.max_size == jmenu.max_size
        for n in range(0, 300, 7):
            for current in (1, 2, 5, 8, 16, 100, 256, 400):
                assert menu.shrink_bucket(n, current) == jmenu.shrink_bucket(n, current)
            try:
                want = jmenu.bucket_for(n)
            except jcommon.RequestTooLarge:
                with pytest.raises(common.RequestTooLarge):
                    menu.bucket_for(n)
            else:
                assert menu.bucket_for(n) == want
    for bad in ((), (0, 4), (4, 4)):
        with pytest.raises(ValueError):
            common.BucketMenu(bad)
    x = np.arange(6.0).reshape(3, 2)
    padded, n = common.pad_states(x, 5)
    want, _ = jcommon.pad_states(x, None, 5)
    assert n == 3 and np.array_equal(padded, want)
    assert common.pad_states(x)[0] is x
    with pytest.raises(ValueError):
        common.pad_states(x, 2)


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_lp_ratio_init_matches_jax(lcld, norm, ratio):
    s, n_pop, eps = 5, 20, 0.3
    x = synth_lcld(s, lcld["cons"].schema, seed=4)
    jc = jcodec.make_codec(lcld["jcons"].schema)
    codec = codec_lib.make_codec(lcld["cons"].schema)
    xl, xu = (np.array(np.broadcast_to(np.asarray(a, float), x.shape)) for a in lcld["cons"].get_feature_min_max(x))
    jxl, jxu = jcodec.genetic_bounds(jc, jnp.asarray(xl), jnp.asarray(xu))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jinit.lp_ratio_init(key, jc, jnp.asarray(x), n_pop, jxl, jxu, eps=eps, ratio=ratio, norm=norm))
    shape = ball_draw_shape(norm, (s, n_perturbed(n_pop, ratio), codec.gen_length))
    draws = jax.random.normal(key, shape) if norm == 2 else jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)
    xl_gen, xu_gen = codec_lib.genetic_bounds(codec, torch.as_tensor(xl), torch.as_tensor(xu))
    got = lp_ratio_init(codec, torch.as_tensor(x), n_pop, xl_gen, xu_gen, _t(draws), eps=eps, ratio=ratio, norm=norm)
    # 1e-12 relative: a denormalised gene of ~4e4 may differ in its last
    # ulp (XLA's norm reduces in another order than the left-to-right sum)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    moved = (want != want[:, :1]).any(-1)
    assert moved[:, -n_perturbed(n_pop, ratio):].any() and not moved[:, : n_pop - n_perturbed(n_pop, ratio)].any()


class JaxDraws:
    """A draw source that gives the port the JAX engine's draws: the key
    path of ``init`` and ``gen_step`` at the current row count."""

    def __init__(self, key, eng):
        self.key, self.eng = key, eng
        self.rows = []  # the row count of every generation's draws

    def init(self, n):
        eng = self.eng
        self.key, k_init, k0 = jax.random.split(self.key, 3)
        ball = None
        n_pert = n_perturbed(eng.pop_size, eng.init_ratio)
        if eng.init == "lp_ratio" and n_pert:
            shape = ball_draw_shape(eng.norm, (n, n_pert, eng.codec.gen_length))
            ball = _t(jax.random.normal(k_init, shape) if eng.norm == 2
                      else jax.random.uniform(k_init, shape, minval=-1.0, maxval=1.0))
        gums = _niche_gumbels(k0, (n,), eng.n_dirs, eng.pop_size)
        return InitDraws(ball, *map(_t, gums))

    def generation(self, n):
        eng = self.eng
        self.rows.append(n)
        self.key, k_mate, k_surv = jax.random.split(self.key, 3)
        offspring = jax_offspring_draws(jax.random.split(k_mate, n), eng.n_offsprings, eng.codec.gen_length,
                                        eng.pop_size)
        gum_cut, gum_mem = _niche_gumbels(k_surv, (n,), eng.n_dirs, eng.pop_size + eng.n_offsprings)
        return GenerationDraws(offspring, _t(gum_cut), _t(gum_mem))


#: the early exit's runs: 8 states, pop 12 (+ 6 archive), a gate every 2 of
#: 12 steps, buckets (2, 4)
EARLY = dict(norm=2, n_gen=13, n_pop=12, n_offsprings=10, archive_size=6, seed=3, early_stop_check_every=2,
             early_stop_threshold=0.5, compaction_buckets=(2, 4), record_quality=True)
EARLY_STATES = 8


def _both_runs(lcld, knobs, x_seed):
    x = synth_lcld(EARLY_STATES, lcld["cons"].schema, seed=x_seed)
    jsink, sink = [], []
    jeng = _jax_engine(lcld, x, partial_sink=lambda *a: jsink.append(a), **knobs)
    want = jeng.generate(x, 1)
    eng = _port_engine(lcld, x, jeng, partial_sink=lambda *a: sink.append(a), **knobs)
    key = jax.random.PRNGKey(knobs["seed"])
    sources = []

    def hook(i):
        # JAX folds the chunk's index into the seed's key
        sources.append(JaxDraws(key if not knobs.get("max_states_per_call") else jax.random.fold_in(key, i), eng))
        return sources[-1]

    eng.draw_hook = hook
    got = eng.generate(x, 1)
    return want, got, jsink, sink, sources


def _assert_runs_equal(want, got, jsink, sink):
    assert got.gens_executed == want.gens_executed
    assert got.early_stop == want.early_stop
    # _assert_carry_equal's tolerances (test_torch_engine.py)
    np.testing.assert_allclose(got.x_gen, want.x_gen, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got.f, want.f, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.x_ml, want.x_ml, rtol=1e-15, atol=0)
    assert [(rows, gen) for rows, _, gen in sink] == [(rows, gen) for rows, _, gen in jsink]
    for (_, x_ml, _), (_, want_ml, _) in zip(sink, jsink):
        np.testing.assert_allclose(x_ml, want_ml, rtol=1e-15, atol=0)
    wq, gq = want.quality, got.quality
    assert {k: v for k, v in gq.items() if k != "samples"} == {k: v for k, v in wq.items() if k != "samples"}
    assert [s["gen"] for s in gq["samples"]] == [s["gen"] for s in wq["samples"]]
    for gs, ws in zip(gq["samples"], wq["samples"]):
        np.testing.assert_allclose(gs["per_state"], ws["per_state"], rtol=1e-12, atol=1e-12)
        assert gs.get("final") == ws.get("final") and gs["states_known"] == ws["states_known"]
        np.testing.assert_allclose(np.array(gs["o_rates"], float), np.array(ws["o_rates"], float), rtol=1e-12)


def test_early_exit_run_matches_jax(lcld):
    want, got, jsink, sink, sources = _both_runs(lcld, EARLY, x_seed=12)
    # the run exercises what it is for: states parked at three gates, the
    # active set repacked 8 -> 4 -> 2, draws at the bucket's row count
    trace = got.early_stop["compaction"]
    assert len(sink) == 3 and [t["bucket"] for t in trace] == [4, 4, 2]
    assert sorted(set(sources[0].rows)) == [2, 4, 8]
    _assert_runs_equal(want, got, jsink, sink)


def test_early_exit_chunked_run_matches_jax(lcld):
    """The same run in two chunks of 4 states, with the lp_ratio init: one
    chunk exits at its first gate, the whole run skips part of its budget."""
    knobs = dict(EARLY, early_stop_threshold=0.51, max_states_per_call=4, init="lp_ratio", init_eps=0.2)
    want, got, jsink, sink, sources = _both_runs(lcld, knobs, x_seed=13)
    assert len(sources) == 2 and {t.get("chunk") for t in got.early_stop["compaction"]} == {0, 1}
    assert {"gen": 2, "active": 0, "bucket": 4, "chunk": 1} in got.early_stop["compaction"]
    assert got.gens_executed < got.early_stop["budget_gens"] == 24
    _assert_runs_equal(want, got, jsink, sink)


def _strict_and(lcld, **knobs):
    x = synth_lcld(EARLY_STATES, lcld["cons"].schema, seed=11)
    base = dict(norm=2, n_gen=13, n_pop=12, n_offsprings=10, archive_size=6, seed=3)
    strict = _port_engine(lcld, x, **base).generate(x, 1)
    eng = _port_engine(lcld, x, **base, **knobs)
    return strict, eng.generate(x, 1), eng


def _assert_bits_equal(a, b):
    for k in ("x_gen", "f", "x_ml"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.gens_executed == b.gens_executed


@pytest.mark.parametrize("knobs", [
    dict(early_stop_check_every=3, early_stop_threshold=0.0),
    dict(record_quality=True, quality_every=4),
    dict(record_quality=True, quality_every=5, double_buffer=False),
], ids=["gate-never-fires", "quality-every", "quality-every-serial"])
def test_knobs_without_effect_are_bit_identical_to_strict(lcld, knobs):
    strict, got, _ = _strict_and(lcld, **knobs)
    _assert_bits_equal(strict, got)
    if "early_stop_check_every" in knobs:
        assert got.early_stop == {"check_every": 3, "gens_executed": 12, "budget_gens": 12, "compaction": []}
    else:
        assert [s["gen"] for s in got.quality["samples"]][-1] == 12 and got.quality["samples"][-1]["final"]


def test_double_buffer_on_and_off_give_the_same_run(lcld):
    runs = {}
    for db in (True, False):
        _, runs[db], eng = _strict_and(lcld, **{**{k: v for k, v in EARLY.items() if k not in (
            "norm", "n_gen", "n_pop", "n_offsprings", "archive_size", "seed")}, "double_buffer": db})
        runs[db].flushes = eng.last_deferred_gate_flushes
    _assert_bits_equal(runs[True], runs[False])
    assert runs[True].early_stop == runs[False].early_stop
    assert runs[True].flushes > 0 and runs[False].flushes == 0
    for a, b in zip(runs[True].quality["samples"], runs[False].quality["samples"]):
        np.testing.assert_array_equal(a["per_state"], b["per_state"])


def test_strict_quality_is_the_final_sample(lcld):
    strict, got, _ = _strict_and(lcld, record_quality=True, early_stop_threshold=0.4)
    _assert_bits_equal(strict, got)
    (final,) = got.quality["samples"]
    assert final["final"] and final["gen"] == 12 and got.quality["gate_every"] == 0
    np.testing.assert_array_equal(final["per_state"], engine_quality_stats(strict.f.astype(np.float64), 0.4, np.inf))


def test_save_history_is_refused(lcld):
    """The history with the early exit raises the JAX engine's ValueError,
    at construction and at ``generate``; the history alone runs."""
    x = synth_lcld(2, lcld["cons"].schema, seed=1)
    msg = "incompatible with save_history"
    with pytest.raises(ValueError, match=msg):
        _port_engine(lcld, x, n_pop=10, save_history="reduced", early_stop_check_every=2)
    eng = _port_engine(lcld, x, n_pop=10, n_gen=3, save_history="full")
    eng.early_stop_check_every = 2
    with pytest.raises(ValueError, match=msg):
        eng.generate(x, 1)
    jeng = _jax_engine(lcld, x, n_pop=10, n_gen=3, save_history="full", early_stop_check_every=2)
    with pytest.raises(ValueError, match=msg):
        jeng.generate(x, 1)
    eng.early_stop_check_every = 0
    res = eng.generate(x, 1)
    assert [h.shape for h in res.history] == [(2, eng.pop_size, 13)] + [(2, eng.n_offsprings, 13)] * 2


def test_quality_helpers_match_jax():
    from moeva2_ijcai22_replication_tpu.observability import quality as jq

    rng = np.random.default_rng(0)
    ps = [engine_quality_stats(_gate_objectives(rng, 6, 9), 0.5, 0.25) for _ in range(3)]
    ps[0][2] = np.nan  # a state with no stats yet
    for gen, p in enumerate(ps):
        got, want = sample_from_per_state(gen, p), jq.sample_from_per_state(gen, p)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_equal(got[k], want[k])
    parts = [{"gate_every": 2, "samples": [sample_from_per_state(2, ps[0]), sample_from_per_state(4, ps[1]),
                                           sample_from_per_state(4, ps[1], final=True)]},
             {"gate_every": 2, "samples": [sample_from_per_state(2, ps[2]), sample_from_per_state(2, ps[2], final=True)]}]
    for got, want in ((merge_chunk_quality(parts, [6, 5]), jq.merge_chunk_quality(parts, [6, 5])),
                      (trim_quality(parts[0], 4), jq.trim_quality(parts[0], 4))):
        assert [s["gen"] for s in got["samples"]] == [s["gen"] for s in want["samples"]]
        for a, b in zip(got["samples"], want["samples"]):
            for k in b:
                np.testing.assert_equal(a[k], b[k])
    assert merge_chunk_quality([None], [1]) is None and trim_quality(None, 3) is None


def test_a_failing_partial_sink_does_not_stop_the_run(lcld, caplog):
    calls = []

    def sink(rows, x_ml, gen):
        calls.append(gen)
        raise RuntimeError("consumer gone")

    knobs = {k: v for k, v in EARLY.items() if k not in ("norm", "n_gen", "n_pop", "n_offsprings", "archive_size",
                                                        "seed")}
    want = _strict_and(lcld, **knobs)[1]
    _, got, _ = _strict_and(lcld, partial_sink=sink, **knobs)
    _assert_bits_equal(got, want)
    assert calls and "partial_sink failed" in caplog.text

"""The history of every evaluation (``Moeva2(save_history=...)``) in the
port against the JAX package, on the CPU in float64.

The plain history form (``engine.evaluate_hist_plain``) against JAX's
``Moeva2._evaluate_hist`` on LCLD, augmented LCLD, botnet and augmented
botnet, "reduced" and "full", with candidates at the ratio terms' poles
(NaN and infinite terms, which the record keeps as the sum does); whole
strict runs fed JAX's draws (``draw_hook``): one chunk of states, segments
of ``history_chunk`` 2 against 999, and ``max_states_per_call`` 2 over 5
states, where the JAX engine pads its tail chunk and draws at the padded
row count; and the runner's ``x_history`` file against the JAX runner's.
Tolerances: the records within rtol 1e-12 and atol 1e-12 (the objectives'
tolerance of ``test_torch_early_exit.py``; the violation columns also
within 1e-12 of the row's summed features, for botnet's flow sums), NaN
and inf where JAX has them; within the port, exactly. Whole runs on
augmented botnet are not held against JAX: its float64 program gives
identical tiled rows (the initial population) f1 values 1 ulp apart by row
position at 927 inputs, which breaks ties the port keeps, so the survivors
differ after the first step.
"""

from __future__ import annotations

import os
import shutil

import yaml

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import Moeva2 as JMoeva2
from moeva2_ijcai22_replication_tpu.attacks.moeva.refdirs import energy_ref_dirs as j_energy_ref_dirs
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import _niche_gumbels
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetAugmentedConstraints as JBotAug
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldAugmentedConstraints as JLcldAug
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.experiments import moeva as jmoeva
from moeva2_ijcai22_replication_tpu.experiments import rq as jrq
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
    GenerationDraws, InitDraws, evaluate_hist_plain, evaluate_plain,
)
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import moeva as pmoeva
from moeva2_ijcai22_replication_tpu_torch.experiments import rq as prq
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.problems import (
    botnet_hard_candidates, synthetic_botnet_augmented_problem, synthetic_botnet_problem,
    synthetic_lcld_augmented_problem, synthetic_lcld_problem,
)
from test_torch_engine import _scaler, _t
from test_torch_operators import jax_offspring_draws
from test_torch_runners import _config, _run_both, artifacts, jax_runners  # noqa: F401

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

#: domain -> (the port's synthetic problem, the JAX set, the JAX surrogate,
#: the record's columns under "full")
DOMAINS = {
    "lcld": (synthetic_lcld_problem, JLcld, jmlp.lcld_mlp, 13),
    "lcld_augmented": (synthetic_lcld_augmented_problem, JLcldAug, jmlp.lcld_mlp, 23),
    "botnet": (synthetic_botnet_problem, JBotnet, jmlp.botnet_mlp, 363),
    "botnet_augmented": (synthetic_botnet_augmented_problem, JBotAug, jmlp.botnet_mlp, 534),
}
STATES = 5


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    """Each domain's constraint sets in both packages over the same files,
    STATES feasible rows and a seeded JAX surrogate with its weights."""
    out = {}
    for name, (problem, jcls, jmodel, _) in DOMAINS.items():
        tmp = tmp_path_factory.mktemp(name)
        cons, _, _, x = problem(str(tmp), STATES)
        features = "features_augmented.csv" if name.endswith("augmented") else "features.csv"
        constraints = "constraints_augmented.csv" if name.endswith("augmented") else "constraints.csv"
        model = jmodel()
        params = jmlp.init_params(model, cons.schema.n_features, seed=1)
        out[name] = {
            "cons": cons, "jcons": jcls(str(tmp / features), str(tmp / constraints)), "x": x,
            "jsur": jio.Surrogate(model, params), "tree": jax.tree.map(np.asarray, params),
        }
    return out


def _engines(dom, x, **knobs):
    """The JAX and the port's engines in float64 on the same surrogate and
    scaler, the port's with JAX's aspiration points."""
    scaler = _scaler(dom["cons"], x)
    jeng = JMoeva2(classifier=dom["jsur"], constraints=dom["jcons"], ml_scaler=JMinMax(*scaler),
                   dtype=jnp.float64, **knobs)
    eng = Moeva2(Surrogate(params_from_numpy(dom["tree"], dtype=torch.float64)), dom["cons"], ml_scaler=scaler,
                 dtype=torch.float64, device="cpu", **knobs)
    eng.asp_points = _t(jeng.asp_points)
    return jeng, eng


def _pole_candidates(eng, x, n, seed):
    """(S, n, L) candidates around the states with the poles the main path
    reaches: on LCLD 0 denominators of the ratio terms (x6, x14, x11, x22,
    x0: inf and NaN terms), on botnet ``problems.botnet_hard_candidates``."""
    rng = np.random.default_rng(seed)
    codec = eng.codec
    x_gen = codec_lib.ml_to_genetic(codec, torch.as_tensor(x))[:, None, :].repeat(1, n, 1)
    noise = torch.as_tensor(rng.uniform(0.9, 1.1, size=tuple(x_gen.shape)))
    x_gen = torch.where(codec.int_mask_gen, x_gen, x_gen * noise)
    if type(eng.constraints).__name__.startswith("Botnet"):
        return botnet_hard_candidates(codec, eng.constraints.schema.names, x_gen)
    gene = {int(d): i for i, d in enumerate(codec.non_ohe_ml_idx)}
    for k, feat in enumerate(f for f in (6, 14, 11, 22, 0) if f in gene):
        x_gen[:, 1 + k :: 7, gene[feat]] = 0.0
    return x_gen


def _close(got, want, what=""):
    """Within rtol 1e-12 and atol 1e-12, NaN and inf where JAX has them."""
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=what)


def _close_terms(got, want, scale, what=""):
    """The violation columns: within rtol 1e-12 and 1e-12 of the row's
    summed absolute features (a flow equality of botnet subtracts two sums
    of up to 90 features, each rounded in another order by JAX), NaN and
    inf where JAX has them."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    fin = np.isfinite(want)
    bound = 1e-12 * np.abs(want) + 1e-12 * np.broadcast_to(scale, want.shape)
    assert (np.abs(got[fin] - want[fin]) <= bound[fin]).all(), what


def _left_to_right_sum(rec):
    s = rec[..., 3]
    for k in range(4, rec.shape[-1]):
        s = s + rec[..., k]
    return s


@pytest.mark.parametrize("mode", ["reduced", "full"])
@pytest.mark.parametrize("domain", list(DOMAINS))
def test_evaluate_hist_plain_matches_jax(domains, domain, mode):
    dom = domains[domain]
    x = dom["x"]
    jeng, eng = _engines(dom, x, n_gen=2, n_pop=12, n_offsprings=10, save_history=mode)
    cand = _pole_candidates(eng, x, 18, seed=len(domain))
    mc = np.arange(STATES) % 2
    run = eng.prepare(x, mc)
    f, rec = evaluate_hist_plain(eng._objective, eng.codec, run, cand, eng.constraints, mode)
    want_f, want_rec = jeng._evaluate_hist(
        dom["jsur"].params, jnp.asarray(cand.numpy()),
        *(jnp.asarray(t.numpy()) for t in (run.x_init_ml, run.x_init_mm, run.xl_ml, run.xu_ml)), jnp.asarray(mc),
    )
    cols = DOMAINS[domain][3] if mode == "full" else 3
    assert rec.shape == (STATES, 18, cols) == np.shape(want_rec)
    x_ml = codec_lib.genetic_to_ml(eng.codec, cand, run.x_init_ml[:, None, :]).abs().numpy()
    scale = np.where(np.isfinite(x_ml), x_ml, 0.0).sum(-1, keepdims=True)
    want_f, want_rec = np.asarray(want_f), np.asarray(want_rec)
    for got, want, what in ((f.numpy(), want_f, "f"), (rec.numpy(), want_rec, "record")):
        _close(got[..., :2], want[..., :2], what)
        _close_terms(got[..., 2:], want[..., 2:], scale, what)
    # the poles show: an infinite or a NaN objective, and in "full" a term
    # that is infinite, which the record keeps as the sum does
    assert not np.isfinite(rec.numpy()).all()
    torch.testing.assert_close(rec[..., :3], f, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(f, evaluate_plain(eng._objective, eng.codec, run, cand, eng.constraints),
                               rtol=0, atol=0, equal_nan=True)
    if mode == "full":
        assert np.isinf(rec[..., 3:].numpy()).any()
        # column 2 is the left-to-right sum of the kept terms, bit for bit
        torch.testing.assert_close(_left_to_right_sum(rec), rec[..., 2], rtol=0, atol=0, equal_nan=True)


class JaxDraws:
    """JAX's draws for the port's engine: the key path of the JAX engine's
    ``init`` and ``gen_step`` at ``pad`` rows, of which the port's ``n``
    take the first (the JAX engine pads a tail chunk of states with its
    last state and draws for every row)."""

    def __init__(self, key, eng, pad: int):
        self.key, self.eng, self.pad = key, eng, pad

    def init(self, n):
        eng = self.eng
        self.key, _, k0 = jax.random.split(self.key, 3)
        gum_cut, gum_mem = _niche_gumbels(k0, (self.pad,), eng.n_dirs, eng.pop_size)
        return InitDraws(None, _t(gum_cut)[:n], _t(gum_mem)[:n])

    def generation(self, n):
        eng = self.eng
        self.key, k_mate, k_surv = jax.random.split(self.key, 3)
        offspring = jax_offspring_draws(jax.random.split(k_mate, self.pad)[:n], eng.n_offsprings,
                                        eng.codec.gen_length, eng.pop_size)
        gum_cut, gum_mem = _niche_gumbels(k_surv, (self.pad,), eng.n_dirs, eng.pop_size + eng.n_offsprings)
        return GenerationDraws(offspring, _t(gum_cut)[:n], _t(gum_mem)[:n])


#: the strict runs: 5 states, pop 12 (15 with R-NSGA-III's geometry), 6
#: offspring, archive 3, 7 generations
RUN = dict(norm=2, n_gen=7, n_pop=12, n_offsprings=6, archive_size=3, seed=3)


def _both_runs(dom, x, **knobs):
    """The JAX engine's run and the port's fed JAX's draws, each state chunk
    its own key (the JAX engine folds the chunk's index into the seed's
    when it chunks) at JAX's padded row count."""
    knobs = {**RUN, **knobs}
    jeng, eng = _engines(dom, x, **knobs)
    want = jeng.generate(x, 1)
    key = jax.random.PRNGKey(knobs["seed"])
    chunk = knobs.get("max_states_per_call")
    if chunk and len(x) > chunk:
        eng.draw_hook = lambda i: JaxDraws(jax.random.fold_in(key, i), eng, chunk)
    else:
        eng.draw_hook = lambda i: JaxDraws(key, eng, len(x))
    return want, eng.generate(x, 1)


def _assert_histories_close(got, want, n_off, cols):
    assert len(got.history) == len(want.history) == RUN["n_gen"]
    assert got.history[0].shape == (STATES, got.x_gen.shape[1] - RUN["archive_size"], cols)
    for i, (g, w) in enumerate(zip(got.history, want.history)):
        assert g.shape == np.shape(w) and (i == 0 or g.shape == (STATES, n_off, cols))
        _close(g, np.asarray(w), f"history entry {i}")
    # a mutated real gene may differ in its last ulp (pow rounds otherwise
    # in XLA), and a gene mutated again from it carries that on: 4.5e-14
    # relative after 6 steps on botnet
    np.testing.assert_allclose(got.x_gen, want.x_gen, rtol=1e-12, atol=0)
    _close(got.f, want.f, "f")


@pytest.mark.parametrize("mode", ["reduced", "full"])
def test_strict_run_history_matches_jax(domains, mode):
    dom = domains["lcld"]
    want, got = _both_runs(dom, dom["x"], save_history=mode, history_chunk=3)
    _assert_histories_close(got, want, RUN["n_offsprings"], 13 if mode == "full" else 3)


@pytest.mark.parametrize("domain", ["lcld_augmented", "botnet"])
def test_full_history_on_other_domains_matches_jax(domains, domain):
    dom = domains[domain]
    want, got = _both_runs(dom, dom["x"], save_history="full", history_chunk=3)
    _assert_histories_close(got, want, RUN["n_offsprings"], DOMAINS[domain][3])


def test_history_chunk_does_not_change_the_run(domains):
    """Segments of 2 generations and one of all (JAX's
    ``test_chunked_history_matches_single_scan``): the same populations and
    records, bit for bit, fed JAX's draws (``test_strict_run_history_
    matches_jax`` holds segments of 3 against JAX)."""
    dom = domains["lcld"]
    x = dom["x"]
    runs = []
    for chunk in (2, 999):
        _, eng = _engines(dom, x, **RUN, save_history="full", history_chunk=chunk)
        eng.draw_hook = lambda i, e=eng: JaxDraws(jax.random.PRNGKey(RUN["seed"]), e, len(x))
        runs.append(eng.generate(x, 1))
    small, big = runs
    assert len(small.history) == RUN["n_gen"]
    for a, b in zip(small.history, big.history):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(small.x_gen, big.x_gen)
    np.testing.assert_array_equal(small.f, big.f)


def test_state_chunked_history_matches_jax(domains):
    """``max_states_per_call`` 2 over 5 states: each record's states axis
    reassembled from the three chunks (the last one state, which the JAX
    engine pads to two), against JAX's chunked run fed each chunk's keys."""
    dom = domains["lcld"]
    want, got = _both_runs(dom, dom["x"], save_history="full", history_chunk=3, max_states_per_call=2)
    _assert_histories_close(got, want, RUN["n_offsprings"], 13)


def test_history_with_quality_gates_and_checkpoints_is_the_same(domains, tmp_path):
    """Segments that end at quality gates, checkpoints and ``history_chunk``
    give the same records as one segment, bit for bit."""
    dom = domains["lcld"]
    x = dom["x"]
    _, plain = _engines(dom, x, **RUN, save_history="full", history_chunk=999)
    _, cut = _engines(dom, x, **RUN, save_history="full", history_chunk=2, record_quality=True, quality_every=3,
                      checkpoint_every=4, checkpoint_path=str(tmp_path / "c.npz"))
    a, b = plain.generate(x, 1), cut.generate(x, 1)
    for g, w in zip(b.history, a.history):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(b.x_gen, a.x_gen)
    assert not list(tmp_path.iterdir())  # a completed run clears its checkpoint and sidecars


class _JaxFloat64Moeva(JMoeva2):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, dtype=jnp.float64, **kwargs)


class _JaxDrawnMoeva(Moeva2):
    """The port's engine as the runner builds it, fed JAX's draws and JAX's
    aspiration points (one chunk of states)."""

    def __post_init__(self):
        super().__post_init__()
        self.asp_points = torch.as_tensor(np.array(j_energy_ref_dirs(3, self.n_pop, seed=1)), dtype=self.dtype)

    def generate(self, x, minimize_class=1):
        self.draw_hook = lambda i: JaxDraws(jax.random.PRNGKey(self.seed), self, len(x))
        return super().generate(x, minimize_class)


def test_runner_writes_the_jax_runners_history(artifacts, jax_runners, tmp_path, monkeypatch):  # noqa: F811
    """``x_history_moeva_{hash}.npy`` under "full": the JAX runner's name
    and shape (n_gen - 1, S, n_offsprings, C), and its values, both runners
    in float64, the port's fed JAX's draws ("reduced" through the runner:
    ``test_torch_runners.py::test_save_history_is_refused_naming_its_item``)."""
    monkeypatch.setattr(jmoeva, "Moeva2", _JaxFloat64Moeva)
    monkeypatch.setattr(pmoeva, "Moeva2", _JaxDrawnMoeva)
    common.ENGINES.clear()
    out = tmp_path / "out"
    cfg = _config(artifacts, out, "moeva", budget=5, n_pop=16, n_offsprings=8, archive_size=4,
                  eps_list=[0.2], save_history="full", history_chunk=3)
    jm, jfiles, pm, pfiles, jdir = _run_both(jmoeva.run, pmoeva.run, cfg, out, torch.float64)
    name = f"x_history_moeva_{pm['config_hash']}.npy"
    assert name in pfiles and pfiles == jfiles and pm["config_hash"] == jm["config_hash"]
    got, want = np.load(out / name), np.load(jdir / name)
    assert got.shape == want.shape == (4, len(artifacts["x"]), 8, 13)
    assert got.dtype == want.dtype == np.float64
    _close(got, want)
    assert pm["objectives_list"] == jm["objectives_list"]
    common.ENGINES.clear()
    jcommon.ENGINES.clear()


def test_grid_with_a_history_project_matches_jax(artifacts, jax_runners, tmp_path, monkeypatch):  # noqa: F811
    """The grid runner takes a project config that sets ``save_history``
    as it is: a MoEvA grid over ``config/moeva.yaml`` (a small population)
    and a static project yaml with ``save_history: "full"`` and
    ``history_chunk``, through both packages' ``rq.run``; the same files,
    ``x_history`` among them, and the same records, as the runner test
    holds them."""
    monkeypatch.setattr(jmoeva, "Moeva2", _JaxFloat64Moeva)
    monkeypatch.setattr(pmoeva, "Moeva2", _JaxDrawnMoeva)
    common.ENGINES.clear()
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    cfg = _config(artifacts, tmp_path / "out", "moeva", n_pop=16, n_offsprings=8, archive_size=4,
                  save_history="full", history_chunk=2)
    moeva_yaml = {k: cfg.pop(k) for k in ("attack_name", "n_pop", "n_offsprings", "archive_size",
                                          "max_states_per_call", "early_stop_check_every", "record_quality",
                                          "quality_every")}
    for name, body in (("moeva", moeva_yaml), ("hist.static", cfg)):
        with open(config_dir / f"{name}.yaml", "w") as f:
            yaml.safe_dump(body, f)
    grid = {"config_dir": str(config_dir), "attacks": ["moeva"], "seeds": [42], "projects": ["hist.static"],
            "eps_list": [0.2], "budgets": [3, 4]}
    out = tmp_path / "out"
    assert jrq.run(dict(grid)) == 2
    jdir = tmp_path / "jax"
    shutil.move(str(out), str(jdir))
    assert prq.run(dict(grid), device="cpu", dtype=torch.float64) == 2
    names = sorted(f for f in os.listdir(out) if f.startswith("x_history_"))
    assert len(names) == 2 and names == sorted(f for f in os.listdir(jdir) if f.startswith("x_history_"))
    assert sorted(os.listdir(out)) == sorted(os.listdir(jdir))
    for name in names:
        got, want = np.load(out / name), np.load(jdir / name)
        assert got.shape == want.shape and got.shape[1:] == (len(artifacts["x"]), 8, 13)
        _close(got, want, name)
    common.ENGINES.clear()
    jcommon.ENGINES.clear()


def test_history_with_the_early_exit_raises_jaxs_error(domains):
    dom = domains["lcld"]
    x = dom["x"]
    msg = "early_stop_check_every is incompatible with save_history"
    with pytest.raises(ValueError, match=msg):
        _engines(dom, x, **RUN, save_history="reduced", early_stop_check_every=2)
    jeng, eng = _engines(dom, x, **RUN, save_history="full")
    for e in (jeng, eng):
        e.early_stop_check_every = 2
        with pytest.raises(ValueError, match=msg):
            e.generate(x, 1)
    with pytest.raises(ValueError, match="save_history must be"):
        _engines(dom, x, **RUN, save_history="everything")


def test_wrapper_refuses_a_bad_record(domains):
    """The wrappers check the record on the CPU before anything builds: a
    CPU record is refused as the other CPU tensors are, and a record of the
    wrong width names the widths it takes."""
    from moeva2_ijcai22_replication_tpu_torch import kernels

    dom = domains["lcld"]
    x = dom["x"]
    _, eng = _engines(dom, x, **RUN, save_history="full")
    out = torch.empty((STATES, 6, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels._history_record(torch.empty((STATES, 6, 13)), out, 10, "objective_lcld")
    with pytest.raises(ValueError, match=r"\(S, N, 3\) or \(S, N, 13\)"):
        kernels._history_record(torch.empty((STATES, 6, 12)), out, 10, "objective_lcld")
    assert kernels._history_record(None, out, 10, "objective_lcld") == (None, out)
    assert eng.history_columns() == 13


def test_reduced_history_is_the_full_ones_objectives(domains):
    """One run with "reduced" and with "full": the same populations, and
    each "reduced" record, in the engine's dtype, the first 3 columns of the
    "full" one."""
    dom = domains["lcld"]
    x = dom["x"]
    runs = {}
    for mode in ("reduced", "full"):
        _, eng = _engines(dom, x, **RUN, save_history=mode, history_chunk=3)
        eng.draw_hook = lambda i, e=eng: JaxDraws(jax.random.PRNGKey(3), e, len(x))
        runs[mode] = eng.generate(x, 1)
    for r, f in zip(runs["reduced"].history, runs["full"].history):
        assert r.dtype == np.float64
        np.testing.assert_array_equal(r, f[..., :3])
    np.testing.assert_array_equal(runs["reduced"].x_gen, runs["full"].x_gen)
    assert runs["full"].history[1].shape == (STATES, RUN["n_offsprings"], 13)

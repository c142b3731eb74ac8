"""Port parity of constrained PGD and AutoPGD on the augmented botnet domain
(``botnet_augmented``: 756 base features and C(19, 2) = 171 XOR pair
features, 360 + 171 = 531 terms) against the JAX package, on the CPU: one
run (``pgd_run_plain``, ``autopgd_run_plain``) against JAX's ``_one_run``,
restarts fed JAX's starts, the refusal of ``+repair``, and the PGD runner on
rq2.botnet's scenario against JAX's.

Every input comes from ``problems.synthetic_botnet_augmented_problem``'s
artifacts (k = 19, 12 states) and a 927-input surrogate made by the JAX
package's ``init_params``. Tolerances are ``tests/test_torch_pgd.py``'s
(``_close``): in float64 rtol 1e-12 with an absolute floor of 1e-12 of the
largest finite entry, NaN and inf where JAX has them, the recorded
history's columns to 1e-9 of each column's scale (a violation is the
difference of sums of up to 1e7, which loses digits in any order, as
``tests/test_torch_pgd_botnet.py`` holds them); in float32 rtol 1e-3 with a
floor of 1e-4 of the largest entry, on the ``flip`` loss, whose step does not
read the constraint branch that JAX runs in float64 under x64. AutoPGD's
final steps are equal. The runners: the same files and config hash, o1..o7
equal and ``x_attacks`` within rtol 1e-9, JAX's judgement patched to
``precise=False`` and its engines to float64 (ROADMAP C3).
"""

from __future__ import annotations

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import AutoPGD as JAutoPGD
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetAugmentedConstraints as JBotAug
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.experiments import pgd as jpgd
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import pgd as ppgd
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_botnet_augmented_problem
from moeva2_ijcai22_replication_tpu_torch.utils.config import get_dict_hash
from test_torch_autopgd import _jax_run
from test_torch_pgd import _close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STATES = 12
D = 927
K = 531
T = 8
#: ε per norm: under L2 a ball the steps of 0.1 reach, under L-inf one the
#: first step leaves (``tests/test_torch_pgd_botnet.py``'s)
RUN_EPS = {2: 0.25, np.inf: 0.05}
#: a pair's term: the one ``single_constraints`` optimises
PAIR_TERM = 400
#: rq1.botnet's PGD losses without repair, which the set does not have
#: (``flip+sat`` runs as ``flip`` before its MILP repair)
LOSSES = ("flip", "constraints+flip", "constraints+flip+adaptive_eps_step")
NO_REPAIR = "Repair is undefined for the augmented botnet domain (reference parity)."


@pytest.fixture(scope="module")
def aug(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pgd_botnet_augmented")
    cons, _, scaler, x = synthetic_botnet_augmented_problem(str(tmp), N_STATES)
    paths = {"features": str(tmp / "features_augmented.csv"), "constraints": str(tmp / "constraints_augmented.csv")}
    model = jmlp.botnet_mlp()
    params = jmlp.init_params(model, D, seed=1)
    rng = np.random.default_rng(0)
    # rows off the data: violated base terms, XOR columns off their pairs
    xs = np.clip(scaler.transform(x) + rng.normal(scale=0.02, size=x.shape), 0.0, 1.0)
    xs[:, 756:] = rng.integers(0, 2, (N_STATES, 171))
    return {
        "dir": tmp, "paths": paths, "cons": cons, "jcons": JBotAug(paths["features"], paths["constraints"]),
        "x": x, "xs": xs, "y": rng.integers(0, 2, N_STATES), "scaler": scaler,
        "jsur": jio.Surrogate(model, params), "tree": jax.tree.map(np.asarray, params),
    }


def _pair(aug, cls=(JPGD, ConstrainedPGD), dtype=torch.float64, **kw):
    """The same attack in both packages."""
    scaler = aug["scaler"]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ja = cls[0](classifier=aug["jsur"], constraints=aug["jcons"], scaler=JMinMax(scaler.scale, scaler.min_),
                dtype=jdt, **kw)
    ta = cls[1](Surrogate(params_from_numpy(aug["tree"], dtype)), aug["cons"], scaler, dtype=dtype, device="cpu",
                **kw)
    return ja, ta, aug["jsur"].params


def _jax_start(ja, x, eps):
    return ja._random_start(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(eps, jnp.asarray(x).dtype))


def _close_hist(got_h, want_h, names):
    """The histories column by column, each to 1e-9 of its scale."""
    assert got_h.shape == want_h.shape and got_h.shape[-1] == len(names)
    for c, name in enumerate(names):
        w, g = want_h[..., c], got_h[..., c]
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=1e-9 * max(np.abs(w[fin]).max(), 1.0),
                                   err_msg=name)


def _pgd_runs(aug, dtype, norm, **kw):
    """JAX's ``_one_run`` and ``pgd_run_plain`` from JAX's random start:
    ((x_adv, hist), (x_adv, pred, hist), the port's attack)."""
    eps = RUN_EPS[norm]
    ja, ta, params = _pair(aug, dtype=dtype, norm=norm, eps=eps, eps_step=0.1, max_iter=T, **kw)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    xs, y = aug["xs"].astype(np_dt), aug["y"]
    start = np.array(_jax_start(ja, xs, eps), np_dt)
    want = jax.jit(ja._one_run, static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), jnp.asarray(start), jnp.asarray(eps, np_dt),
        jnp.asarray(0.1, np_dt), T,
    )
    got = pgd_run_plain(
        ta.tables, ta.constraints, ta.schedule(eps, 0.1, T), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(start), eps, ta.clip, norm, False, ta.targeted, ta.history_layout(),
    )
    return want, got, ta


# -- PGD's runs against JAX's _one_run ------------------------------------------------


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("loss", LOSSES)
def test_run_matches_jax_one_run(aug, loss, norm):
    record = "full" if "adaptive" in loss else "reduced"
    (want_x, want_h), (got_x, pred, got_h), ta = _pgd_runs(aug, torch.float64, norm, loss_evaluation=loss,
                                                            record_loss=record, record_grad_norm=record == "full")
    _close(got_x.numpy(), want_x, torch.float64, "x_adv")
    assert not np.array_equal(got_x.numpy(), aug["xs"])
    probs = np.asarray(aug["jsur"].predict_proba(want_x))
    np.testing.assert_array_equal(pred.numpy(), probs.argmax(-1))
    names = ta.hist_column_names()
    assert len(names) == 3 + (1 + K if record == "full" else 0)
    _close_hist(got_h.numpy(), np.asarray(want_h), names)


def test_single_pair_term_run_matches_jax(aug):
    """``single_constraints`` optimising a pair's term, targeted: the term's
    cotangent reaches its augmented column alone among the terms."""
    (want_x, want_h), (got_x, _, got_h), ta = _pgd_runs(
        aug, torch.float64, 2, loss_evaluation="constraints+flip+constraints", constraints_optim="single_constraints",
        ctr_id=PAIR_TERM, targeted=True, record_loss="full")
    _close(got_x.numpy(), want_x, torch.float64, "x_adv")
    _close_hist(got_h.numpy(), np.asarray(want_h), ta.hist_column_names())
    # the recorded cons is the pair's term
    np.testing.assert_array_equal(got_h.numpy()[..., 2], got_h.numpy()[..., 3 + PAIR_TERM])


@pytest.mark.parametrize("norm", [2, np.inf])
def test_run_matches_jax_float32(aug, norm):
    (want_x, want_h), (got_x, _, got_h), _ = _pgd_runs(aug, torch.float32, norm, loss_evaluation="flip",
                                                        record_loss="reduced")
    assert got_x.dtype == torch.float32
    _close(got_x.numpy(), np.asarray(want_x), torch.float32, "x_adv")
    _close(got_h.numpy()[..., :2], np.asarray(want_h)[..., :2], torch.float32, "history's loss columns")


def test_restarts_fed_jax_starts_match(aug):
    r, eps = 2, 0.3
    ja, ta, params = _pair(aug, loss_evaluation="constraints+flip", norm=2, num_random_init=r, record_loss="reduced",
                           eps=eps, eps_step=0.05, max_iter=T)
    xs, y = aug["xs"], aug["y"]
    key = jax.random.PRNGKey(ja.seed)
    best, hist, succ = jax.jit(ja._build(), static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), key, jnp.asarray(eps), jnp.asarray(0.05), T
    )
    starts = [torch.as_tensor(np.array(ja._random_start(jax.random.fold_in(key, k), jnp.asarray(xs), eps)))
              for k in range(r)]
    got_x, got_h, got_succ = ta.attack(torch.as_tensor(xs), torch.as_tensor(y), ta.schedule(eps, 0.05, T), eps,
                                       starts)
    np.testing.assert_array_equal(got_succ.numpy(), np.asarray(succ))
    _close(got_x.numpy(), best, torch.float64, "best_x")
    never = ~got_succ.numpy()[-1]
    np.testing.assert_array_equal(got_x.numpy()[never], xs[never])
    _close_hist(got_h.numpy(), np.asarray(hist), ta.hist_column_names())


# -- AutoPGD's runs against JAX's AutoPGD._one_run ---------------------------------------


#: (loss, norm, constraints_optim, first step): at the small first step the
#: checkpoints halve some rows' steps and keep the others'
AUTO_RUNS = (
    pytest.param("autopgd+constraints+flip", 2, "sum", 0.01, id="constraints+flip-2"),
    pytest.param("autopgd+constraints", np.inf, "single_constraints", 0.001, id="pair-term-inf"),
)


@pytest.mark.parametrize("loss,norm,optim,eta0", AUTO_RUNS)
def test_autopgd_run_matches_jax_one_run(aug, loss, norm, optim, eta0):
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain

    eps, t = 4.0, 12
    ja, ta, params = _pair(aug, (JAutoPGD, AutoPGD), loss_evaluation=loss, norm=norm, constraints_optim=optim,
                           ctr_id=PAIR_TERM, record_loss="full", eps=eps, max_iter=t)
    xs, y = aug["xs"], aug["y"]
    start = np.array(_jax_start(ja, xs, eps))
    want_x, want_h, want_eta = _jax_run(ja, params, xs, y, start, eps, eta0)
    got_x, pred, got_h, eta = autopgd_run_plain(
        ta.tables, ta.constraints, ta.schedule(eps, eta0, t), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(start), eps, ta.clip, norm, False, False, ta.history_layout(),
    )
    _close(got_x.numpy(), want_x, torch.float64, "x_best")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    _close_hist(got_h.numpy(), want_h, ta.hist_column_names())
    assert (eta < eta0).any() and (eta == eta0).any(), f"eta {np.unique(eta.numpy())}"


# -- repair: undefined on the set, refused before anything runs ------------------------


class _Launched(Exception):
    """Raised by a stand-in kernel: something launched."""


@pytest.mark.parametrize("cls", [(JPGD, ConstrainedPGD), (JAutoPGD, AutoPGD)], ids=["pgd", "autopgd"])
def test_repair_raises_jax_error_in_both_packages_and_on_the_card_before_any_launch(aug, cls, monkeypatch):
    prefix = "autopgd+" if cls[1] is AutoPGD else ""
    loss = prefix + "constraints+flip+adaptive_eps_step+repair"
    ja, ta, _ = _pair(aug, cls, loss_evaluation=loss, norm=2, eps=4.0, eps_step=0.1, max_iter=3)
    xs, y = aug["xs"], aug["y"]
    with pytest.raises(NotImplementedError) as want:
        ja.generate(xs, y)
    with pytest.raises(NotImplementedError) as got:
        ta.generate(xs, y)
    assert str(got.value) == str(want.value) == NO_REPAIR
    # a pretended card: every tensor reads is_cuda, every kernel is stood in
    # for by one that raises; the refusal comes first
    card = cls[1](Surrogate(params_from_numpy(aug["tree"], torch.float32)), aug["cons"], aug["scaler"],
                  loss_evaluation=loss, norm=2, eps=4.0, max_iter=3, num_random_init=1, device="cpu")

    def launched(*a, **k):
        raise _Launched

    for name in ("pgd_botnet", "pgd_start", "restart", "forward_labels"):
        monkeypatch.setattr(kernels, name, launched)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    with pytest.raises(NotImplementedError, match="Repair is undefined for the augmented botnet domain"):
        card.generate(xs.astype(np.float32), y)


# -- the runner on rq2.botnet's scenario ----------------------------------------------------


@pytest.fixture
def jax_runners(monkeypatch):
    """The JAX PGD runner with ``tests/test_torch_runners.py``'s test-side
    patches (``precise=False``, float64 engines), and empty caches."""

    class Float64PGD(JPGD):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dtype=jnp.float64, **kwargs)

    class Float64AutoPGD(JAutoPGD):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dtype=jnp.float64, **kwargs)

    monkeypatch.setattr(jpgd, "ObjectiveCalculator", functools.partial(JObjective, precise=False))
    monkeypatch.setattr(jpgd, "ConstrainedPGD", Float64PGD)
    monkeypatch.setattr(jpgd, "AutoPGD", Float64AutoPGD)
    for cache in (jcommon.ENGINES, jcommon.ARTIFACTS, common.ENGINES, common.ARTIFACTS):
        cache.clear()
    yield
    jcommon.ENGINES.clear()
    common.ENGINES.clear()


def _rq2_botnet_pgd_config(aug, out_dir, loss: str, budget: int) -> dict:
    """rq2.botnet's scenario composed from ``config/`` (``pgd.yaml``,
    ``rq2.botnet.static``, seed, budget, the scenario, ε 4, ``loss``) over
    the test's artifacts; no random start."""
    import joblib
    from sklearn.preprocessing import MinMaxScaler

    art = aug["dir"]
    np.save(art / "x_candidates_common_augmented.npy", aug["x"])
    jio.save_params(aug["jsur"], str(art / "nn_augmented_19.msgpack"))
    # the problem's scaler as a fitted sklearn MinMaxScaler, which the JAX
    # runner reads
    scaler = MinMaxScaler().fit(aug["x"][:2])
    scaler.scale_, scaler.min_ = aug["scaler"].scale.copy(), aug["scaler"].min_.copy()
    joblib.dump(scaler, art / "scaler_augmented_19.joblib")
    cfg = {}
    for name in ("pgd", "rq2.botnet.static"):
        with open(os.path.join(REPO, "config", f"{name}.yaml")) as f:
            cfg.update(yaml.safe_load(f))
    with open(os.path.join(REPO, "config", "rq2.botnet.yaml")) as f:
        grid = yaml.safe_load(f)
    (scenario,) = grid["scenari"]
    cfg.update(seed=grid["seeds"][0], budget=budget, project_name=scenario["project_name"],
               reconstruction=scenario["reconstruction"], eps=grid["eps_list"][0], loss_evaluation=loss,
               nb_random=0)
    cfg["paths"] = {
        "model": str(art / "nn_augmented_19.msgpack"),
        "x_candidates": str(art / "x_candidates_common_augmented.npy"),
        "min_max_scaler": str(art / "scaler_augmented_19.joblib"),
        "ml_scaler": str(art / "scaler_augmented_19.joblib"),
        "features": aug["paths"]["features"],
        "constraints": aug["paths"]["constraints"],
        "important_features": str(art / "important_features_19.npy"),
    }
    cfg["evaluation"] = {"project_name": scenario["evaluation"]["project_name"],
                         "constraints": aug["paths"]["constraints"]}
    cfg["dirs"] = {"results": str(out_dir)}
    cfg["system"] = {"n_jobs": 1, "verbose": 0, "mesh_devices": 0}
    return cfg


@pytest.mark.parametrize("loss", ["constraints+flip+adaptive_eps_step", "autopgd+constraints+flip"])
def test_runner_on_rq2_botnet_matches_jax(aug, jax_runners, tmp_path, loss):
    out = tmp_path / "out"
    cfg = _rq2_botnet_pgd_config(aug, out, loss, budget=5)
    assert cfg["project_name"] == "botnet_augmented" and cfg["eps"] == 4 and cfg["norm"] == 2
    jm = jpgd.run(copy.deepcopy(cfg))
    jdir = tmp_path / "out_jax"
    os.rename(out, jdir)
    pm = ppgd.run(copy.deepcopy(cfg), device="cpu", dtype=torch.float64)
    h = get_dict_hash(cfg)
    assert pm["config_hash"] == jm["config_hash"] == h
    assert sorted(os.listdir(out)) == sorted(os.listdir(jdir))
    assert pm["objectives"] == jm["objectives"]
    name = f"x_attacks_pgd_{loss}_{h}.npy"
    got, want = np.load(out / name), np.load(jdir / name)
    assert got.shape == (N_STATES, 1, D)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert not np.array_equal(got[:, 0], aug["x"])
    # skip-if-done
    assert ppgd.run(copy.deepcopy(cfg), device="cpu", dtype=torch.float64) is None

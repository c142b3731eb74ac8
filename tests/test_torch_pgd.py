"""Port parity of constrained PGD: the iteration tables, the hand-written
gradient (``grad_and_terms_plain``) against ``jax.grad`` of JAX's
``_grad_and_terms``, one run (``pgd_run_plain``) against JAX's
``_one_run``, restarts fed JAX's starts, ``round_ints_toward_initial``, and
the slice's success rates against JAX's, all on the CPU.

Tolerances. In float64 both packages run the same operations up to their
order: gradients agree to rtol 1e-12 with an absolute floor of 1e-12 of the
largest finite entry (an entry summed from products that cancel loses
digits in any order), and the NaN and inf entries are the same. In
float32 the JAX package runs its constraint branch in float64 (x64 promotes
``x_f32 - min_f64``, the scaler's constants are float64), while the port
runs it in float32, as its kernel does: an unscaled feature of 4e4 carries
a float32 error of ~2e-3, which the violations' differences keep, so
float32 values agree to rtol 1e-3 with a floor of 1e-4 of the largest
entry. Runs are compared in float64, where a trajectory cannot drift.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.attacks.pgd import round_ints_toward_initial as j_round
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD, round_ints_toward_initial
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import grad_and_terms_plain, pgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.core.constraints import ConstraintSet
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import MinMaxParams, fit_minmax
from moeva2_ijcai22_replication_tpu_torch.problems import (
    LCLD_IMMUTABLE_TERMS, lcld_immutable_repair_rows, lcld_immutable_term_schema,
)

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

LOSSES = (
    "flip", "constraints", "constraints+flip", "constraints+flip+alternate",
    "constraints+flip+constraints", "constraints+flip+manual", "constraints+flip+adaptive_eps_step",
    "constraints+flip+adaptive_eps_step+repair", "flip+repair",
)
OPTIMS = ("sum", "alt_constraints", "single_constraints")
N_ROWS = 64
T = 12


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    paths = synth_lcld_schema(str(tmp_path_factory.mktemp("pgd")))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(128, cons.schema, seed=3)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    rng = np.random.default_rng(0)
    # rows off the data: violated constraints, features at the clip bounds
    xs = np.clip(scaler.transform(x) + rng.normal(scale=0.05, size=x.shape), 0.0, 1.0)
    models = {}
    for n_classes in (2, 1):
        model = jmlp.MLP(hidden=(64, 32, 16), n_classes=n_classes)
        params = jmlp.init_params(model, 47, seed=1)
        models[n_classes] = (jio.Surrogate(model, params), jax.tree.map(np.asarray, params))
    return {
        "jcons": JLcld(paths["features"], paths["constraints"]),
        "cons": cons,
        "x": x,
        "xs": xs,
        "y": rng.integers(0, 2, len(x)),
        "scaler": scaler,
        "models": models,
    }


def _pair(setup, dtype=torch.float64, n_classes=2, scaler=None, **kw):
    """The same attack in both packages."""
    scaler = setup["scaler"] if scaler is None else scaler
    jsur, tree = setup["models"][n_classes]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ja = JPGD(classifier=jsur, constraints=setup["jcons"], scaler=JMinMax(scaler.scale, scaler.min_),
              dtype=jdt, **kw)
    ta = ConstrainedPGD(Surrogate(params_from_numpy(tree, dtype)), setup["cons"], scaler, dtype=dtype,
                        device="cpu", **kw)
    return ja, ta, jsur.params


def _close(got, want, dtype, what=""):
    """Values as the module docstring states, NaN and inf where NaN and inf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN entries differ"
    assert np.array_equal(np.isinf(got), np.isinf(want)), f"{what}: inf entries differ"
    fin = np.abs(want[np.isfinite(want)])
    top = fin.max() if fin.size else 0.0
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * top, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * top, equal_nan=True, err_msg=what)


def _grad_pair(ja, ta, params, x, y, i, max_iter, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = ja._grad_and_terms(params, jnp.asarray(x, jdt), jnp.asarray(y, jnp.int32), jnp.asarray(i), max_iter)
    sched = ta.schedule(ta.eps, ta.eps_step, max_iter)
    got = grad_and_terms_plain(
        ta.tables, ta.constraints, torch.as_tensor(x, dtype=dtype), torch.as_tensor(y),
        sched.w_class[i], sched.w_cons[i], int(sched.ctr[i]), ta.targeted,
    )
    return want, got


@pytest.mark.parametrize("max_iter", [1, 13, 100])
@pytest.mark.parametrize("loss", LOSSES)
def test_schedule_matches_jax(setup, loss, max_iter):
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        for optim in OPTIMS:
            ja, ta, _ = _pair(setup, dtype, loss_evaluation=loss, constraints_optim=optim, ctr_id=4,
                              eps=0.2 - 1e-6, eps_step=0.1, max_iter=max_iter)
            sched = ta.schedule(ta.eps, ta.eps_step, max_iter)
            i = jnp.arange(max_iter)
            w_class, w_cons = ja._loss_weights(i, jdt, max_iter)
            np.testing.assert_array_equal(sched.w_class.numpy(), np.broadcast_to(np.asarray(w_class), (max_iter,)))
            np.testing.assert_array_equal(sched.w_cons.numpy(), np.broadcast_to(np.asarray(w_cons), (max_iter,)))
            step = ja._step_size(i, jdt, jnp.asarray(ta.eps, jdt), jnp.asarray(ta.eps_step, jdt), max_iter)
            # numpy's pow and XLA's differ in the last ulp at 10 ** -5
            np.testing.assert_array_max_ulp(
                sched.step.numpy(), np.broadcast_to(np.asarray(step, sched.step.numpy().dtype), (max_iter,)), maxulp=1
            )
            want_ctr = {"sum": -1, "alt_constraints": np.arange(max_iter) % 10, "single_constraints": 4}[optim]
            np.testing.assert_array_equal(sched.ctr.numpy(), np.broadcast_to(want_ctr, (max_iter,)))
            assert sched.ctr.dtype == torch.int32 and sched.step.dtype == dtype


@pytest.mark.parametrize("optim", OPTIMS)
@pytest.mark.parametrize("loss", LOSSES)
def test_gradient_matches_jax_float64(setup, loss, optim):
    targeted = LOSSES.index(loss) % 2 == 1
    ja, ta, params = _pair(setup, loss_evaluation=loss, constraints_optim=optim, ctr_id=5, targeted=targeted,
                           eps=0.2, eps_step=0.1, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    for i in (0, 6, T - 1):
        want, got = _grad_pair(ja, ta, params, xs, y, i, T, torch.float64)
        for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
            _close(g.numpy(), w, torch.float64, f"{loss} {optim} i={i} {name}")


@pytest.mark.parametrize("loss", ["flip", "constraints+flip", "constraints+flip+alternate", "constraints"])
def test_gradient_matches_jax_float32(setup, loss):
    ja, ta, params = _pair(setup, torch.float32, loss_evaluation=loss, eps=0.2, eps_step=0.1, max_iter=T)
    xs, y = setup["xs"][:N_ROWS].astype(np.float32), setup["y"][:N_ROWS]
    for i in (0, 5):
        want, got = _grad_pair(ja, ta, params, xs, y, i, T, torch.float32)
        for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
            assert g.dtype == torch.float32
            _close(g.numpy(), w, torch.float32, f"{loss} i={i} {name}")


def _edge_rows(setup):
    """Rows in unscaled space (the attack given a unit scaler) at the
    backward's edges: every denominator 0 (x6, x14, x22, x11) with 0 and
    non-0 numerators, a term exactly at the tolerance (x10 - x14 = 1e-3),
    ±0 inside an abs (term x1 = 60 gives (36 - 60) * 0 = -0, x1 = 36 gives
    +0; x22 equal to the month count gives ±0), and the term +inf."""
    x = setup["x"][:16].copy()
    x[0, 6] = 0.0  # x0 / 0 = inf: g5 = inf
    x[1, [0, 6]] = 0.0  # 0 / 0
    x[2, 14] = 0.0  # x10 / 0
    x[3, [10, 14]] = 0.0  # 0 / 0
    x[4, 22] = 0.0  # x11 / 0 and x16 / 0, and g7's difference
    x[5, [11, 16, 22]] = 0.0
    x[6, 11] = 0.0  # g10's sentinel branch
    x[7, 11], x[7, 16] = 3e-308, 8.0  # g10's ratio overflows: the sentinel (no denormal: XLA flushes them)
    x[8, 10], x[8, 14] = 1e-3, 0.0  # g2 - tol == 0 exactly: clip's 0.5
    x[9, 1] = 60.0  # g4's product is -0
    x[10, 1] = 36.0  # +0
    x[11, [0, 6, 10, 14, 11, 22]] = 0.0  # every zero denominator at once
    return x


@pytest.mark.parametrize("optim", OPTIMS)
@pytest.mark.parametrize("loss", ["flip", "constraints", "constraints+flip"])
def test_gradient_nan_mask_at_the_edges(setup, loss, optim):
    unit = MinMaxParams(scale=np.ones(47), min_=np.zeros(47))
    x = _edge_rows(setup)
    assert x[8, 10] - x[8, 14] - 1e-3 == 0.0
    y = setup["y"][: len(x)]
    for dtype in (torch.float64, torch.float32):
        ja, ta, params = _pair(setup, dtype, scaler=unit, loss_evaluation=loss, constraints_optim=optim, ctr_id=4,
                               eps=0.2, eps_step=0.1, max_iter=T)
        xin = x if dtype == torch.float64 else x.astype(np.float32)
        want, got = _grad_pair(ja, ta, params, xin, y, 3, T, dtype)
        grad, want_grad = got[0].double().numpy(), np.asarray(want[0], np.float64)
        np.testing.assert_array_equal(np.isnan(grad), np.isnan(want_grad), err_msg=f"{loss} {optim} {dtype}")
        np.testing.assert_array_equal(np.isinf(grad), np.isinf(want_grad), err_msg=f"{loss} {optim} {dtype}")
        assert np.isnan(want_grad[[1, 3, 5, 11]]).any(axis=1).all()  # 0 / 0 reaches the gradient
        if dtype == torch.float64:
            for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
                _close(g.numpy(), w, dtype, f"{loss} {optim} {name}")


def test_one_column_head_gradient_matches_jax(setup):
    # one_hot(y, 1): class 0 reads [1], class 1 [0]; the cross-entropy is 0
    # either way and the gradient is the constraints' alone
    ja, ta, params = _pair(setup, n_classes=1, loss_evaluation="constraints+flip", eps=0.2, eps_step=0.1,
                           max_iter=T)
    want, got = _grad_pair(ja, ta, params, setup["xs"][:N_ROWS], setup["y"][:N_ROWS], 2, T, torch.float64)
    assert not got[2].any()
    for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
        _close(g.numpy(), w, torch.float64, name)


RUNS = (
    ("constraints+flip+adaptive_eps_step+repair", "sum", "full"),
    ("flip", "sum", "reduced"),
    ("constraints+flip+alternate", "alt_constraints", "full"),
    ("constraints+flip+constraints+repair", "single_constraints", None),
    ("constraints", "sum", "reduced"),
)


def _jax_start(ja, x, eps):
    return ja._random_start(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(eps, jnp.float64))


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("loss,optim,record", RUNS)
def test_run_matches_jax_one_run(setup, loss, optim, record, norm):
    ja, ta, params = _pair(setup, loss_evaluation=loss, constraints_optim=optim, ctr_id=0, norm=norm,
                           record_loss=record, record_grad_norm=record == "full", eps=0.2, eps_step=0.1,
                           max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    start = _jax_start(ja, xs, 0.2)
    want_x, want_h = jax.jit(ja._one_run, static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), start, jnp.asarray(0.2), jnp.asarray(0.1), T
    )
    sched = ta.schedule(0.2, 0.1, T)
    got_x, pred, got_h = pgd_run_plain(
        ta.tables, ta.constraints, sched, torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(np.array(start)), 0.2, ta.clip, norm, "repair" in loss, False, ta.history_layout(),
    )
    # a row that reaches a 0 denominator with a finite cotangent takes an
    # infinite gradient, and L2's conditioning turns it into a NaN row: in
    # JAX too
    _close(got_x.numpy(), want_x, torch.float64, "x_adv")
    probs = np.asarray(ja.classifier.predict_proba(want_x))
    np.testing.assert_array_equal(pred.numpy()[~np.isnan(probs).any(1)], probs.argmax(-1)[~np.isnan(probs).any(1)])
    if record is None:
        assert got_h is None
        return
    want_h = np.asarray(want_h)
    assert got_h.shape == want_h.shape == (T, N_ROWS, len(ta.hist_column_names()))
    assert ta.hist_column_names() == ja.hist_column_names()
    # the history's violations cancel (|x3 - installment| - 0.099999 near 0):
    # compared to 1e-9 of each column's scale
    for c in range(want_h.shape[-1]):
        w, g = want_h[..., c], got_h[..., c].numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=1e-9 * max(np.abs(w[fin]).max(), 1.0))


@pytest.mark.parametrize("norm", [2, np.inf])
def test_run_repairing_an_immutable_feature_matches_jax(setup, tmp_path, norm):
    """A schema whose repair rewrites an immutable feature (term, marked
    immutable, on rows where it is off {36, 60}): the run keeps x there and
    takes the next iteration's unscaled row from x, as JAX's ``_one_run``
    does. Kernel K7 is held to this run on the card."""
    paths = lcld_immutable_term_schema(synth_lcld_schema(str(tmp_path / "base")), str(tmp_path / "immutable"))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    jcons = JLcld(paths["features"], paths["constraints"])
    assert not cons.get_mutable_mask()[1] and not jcons.get_mutable_mask()[1]
    scaler, (jsur, tree) = setup["scaler"], setup["models"][2]
    loss = "constraints+flip+adaptive_eps_step+repair"
    kw = dict(loss_evaluation=loss, norm=norm, record_loss="full", eps=0.2, eps_step=0.1, max_iter=T)
    ja = JPGD(classifier=jsur, constraints=jcons, scaler=JMinMax(scaler.scale, scaler.min_), dtype=jnp.float64, **kw)
    ta = ConstrainedPGD(Surrogate(params_from_numpy(tree, torch.float64)), cons, scaler, dtype=torch.float64,
                        device="cpu", **kw)
    xs = lcld_immutable_repair_rows(setup["x"][:N_ROWS], scaler, np.float64)
    y = setup["y"][:N_ROWS]
    start = _jax_start(ja, xs, 0.2)
    want_x, want_h = jax.jit(ja._one_run, static_argnums=6)(
        jsur.params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), start, jnp.asarray(0.2), jnp.asarray(0.1), T
    )
    got_x, _, got_h = pgd_run_plain(
        ta.tables, cons, ta.schedule(0.2, 0.1, T), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(np.array(start)), 0.2, ta.clip, norm, True, False, ta.history_layout(),
    )
    _close(got_x.numpy(), want_x, torch.float64, "x_adv")
    _close(got_h.numpy(), np.asarray(want_h), torch.float64, "history")
    # term stayed off {36, 60}, which the repair of the final rows rewrites
    n = len(LCLD_IMMUTABLE_TERMS)
    np.testing.assert_array_equal(got_x.numpy()[:n, 1], xs[:n, 1])
    u = (got_x - ta.tables.min_) / ta.tables.scale
    assert (cons.repair(u)[:n, 1] != u[:n, 1]).all()


@pytest.mark.parametrize("norm,targeted,eps", [(2, False, 0.3), (np.inf, False, 0.02), (np.inf, True, 0.02)])
def test_restarts_fed_jax_starts_match(setup, norm, targeted, eps):
    r = 3
    ja, ta, params = _pair(setup, loss_evaluation="constraints+flip", norm=norm, targeted=targeted,
                           num_random_init=r, record_loss="reduced", eps=eps, eps_step=0.01, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    key = jax.random.PRNGKey(ja.seed)
    best, hist, succ = jax.jit(ja._build(), static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), key, jnp.asarray(eps), jnp.asarray(0.01), T
    )
    starts = [torch.as_tensor(np.array(ja._random_start(jax.random.fold_in(key, k), jnp.asarray(xs), eps)))
              for k in range(r)]
    got_x, got_h, got_succ = ta.attack(torch.as_tensor(xs), torch.as_tensor(y), ta.schedule(eps, 0.01, T), eps, starts)
    np.testing.assert_array_equal(got_succ.numpy(), np.asarray(succ))
    assert got_succ.numpy()[-1].any() and not got_succ.numpy()[-1].all()
    _close(got_x.numpy(), best, torch.float64, "best_x")
    # rows that never succeed return x_init
    never = ~got_succ.numpy()[-1]
    np.testing.assert_array_equal(got_x.numpy()[never], xs[never])
    _close(got_h.numpy(), hist, torch.float64, "history")


def test_round_ints_toward_initial_matches_jax(setup):
    cons = setup["cons"]
    x0 = setup["x"][:32]
    rng = np.random.default_rng(4)
    adv = x0 + rng.normal(scale=2.0, size=x0.shape)
    adv[:, 5] = x0[:, 5]  # unmoved
    types = cons.get_feature_type()
    got = round_ints_toward_initial(adv, x0, types)
    np.testing.assert_array_equal(got, j_round(adv, x0, types))
    ints = np.array([str(t) not in ("real", "softmax") for t in types])
    assert np.array_equal(got[:, ~ints], adv[:, ~ints])
    assert (np.abs(got - x0)[:, ints] <= np.abs(adv - x0)[:, ints] + 1e-12).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_success_rates_match_jax(setup, dtype):
    """The slice end to end as ``experiments/pgd.py`` drives it: labels from
    the surrogate, the attack at ε - 1e-6, inverse scaling, directional
    rounding, o1..o7 with f2 ε and f1 0.5 (the runner's 0.25 leaves every
    rate but o3 at 0 with this untrained surrogate). float64 rates are equal; in
    float32 at most 2 of the 128 states may change a rate (trajectories
    drift with JAX's float64 constraint branch, see the module docstring)."""
    x, scaler, cons = setup["x"], setup["scaler"], setup["cons"]
    eps, F1 = 0.2, 0.5
    knobs = dict(loss_evaluation="constraints+flip+adaptive_eps_step+repair", norm=2, eps=eps - 1e-6,
                 eps_step=0.1, max_iter=20)
    ja, ta, params = _pair(setup, dtype, **knobs)
    xs = scaler.transform(x)
    y = np.asarray(ja.classifier.predict_proba(jnp.asarray(xs))).argmax(-1)
    jdt = np.float64 if dtype == torch.float64 else np.float32
    adv = {"jax": ja.generate(xs.astype(jdt), y), "port": ta.generate(xs.astype(jdt), y)}
    assert adv["port"].dtype == jdt and adv["port"].shape == x.shape
    rates = {}
    for name, a in adv.items():
        attacks = round_ints_toward_initial(scaler.inverse(a.astype(np.float64)), x, cons.get_feature_type())
        calc = ObjectiveCalculator(classifier=Surrogate(params_from_numpy(setup["models"][2][1], torch.float64)),
                                   constraints=cons, thresholds={"f1": F1, "f2": eps}, min_max_scaler=scaler,
                                   ml_scaler=scaler, minimize_class=1, norm=2)
        rates[name] = calc.success_rate_3d(x, attacks[:, None, :])
    jcalc = JObjective(classifier=setup["models"][2][0], constraints=setup["jcons"],
                       thresholds={"f1": F1, "f2": eps}, min_max_scaler=JMinMax(scaler.scale, scaler.min_),
                       ml_scaler=JMinMax(scaler.scale, scaler.min_), minimize_class=1, norm=2,
                       precise=False)  # float64 all the same: the tests run JAX with x64
    j_attacks = j_round(np.asarray(JMinMax(scaler.scale, scaler.min_).inverse(adv["jax"].astype(np.float64))), x,
                        cons.get_feature_type())
    np.testing.assert_allclose(rates["jax"], np.asarray(jcalc.success_rate_3d(x, j_attacks[:, None, :])), atol=1e-12)
    tol = 0.0 if dtype == torch.float64 else 2 / len(x)
    np.testing.assert_allclose(rates["port"], rates["jax"], rtol=0, atol=tol + 1e-12)
    assert rates["port"][5] > 0  # the attack flips some states within ε


def test_generate_history_restarts_and_determinism(setup):
    xs, y = setup["xs"][:16].astype(np.float32), setup["y"][:16]
    _, ta, _ = _pair(setup, torch.float32, loss_evaluation="constraints+flip", num_random_init=2, record_loss="full",
                     record_grad_norm=True, eps=0.3, eps_step=0.05, max_iter=5)
    a = ta.generate(xs, y)
    hist, quality = ta.loss_history, ta.quality_history
    assert hist.shape == (16, 5, 14) and ta.hist_column_names()[3] == "grad_norm"
    assert quality["restart_success"].shape == (2, 16) and len(quality["restart_flip_frac"]) == 2
    np.testing.assert_array_equal(ta.generate(xs, y), a)
    np.testing.assert_array_equal(ta.loss_history, hist)
    _, plain, _ = _pair(setup, torch.float32, eps=0.3, eps_step=0.05, max_iter=5)
    plain.generate(xs, y)
    assert plain.loss_history is None and plain.quality_history is None and plain.hist_column_names() == []
    # another budget needs no other engine
    assert ta.generate(xs, y, max_iter=3).shape == xs.shape and ta.loss_history.shape == (16, 3, 14)


@pytest.mark.parametrize("n_classes,labels", [(2, [0, 2]), (2, [-1, 1]), (1, [1, 2])])
def test_generate_refuses_labels_outside_the_head(setup, n_classes, labels):
    # the check is the same on the card (tests/test_torch_kernels.py)
    _, ta, _ = _pair(setup, torch.float32, n_classes=n_classes, max_iter=2)
    xs = setup["xs"][:2].astype(np.float32)
    with pytest.raises(ValueError, match=f"labels must be classes of the 2-class head"):
        ta.generate(xs, np.array(labels))
    assert ta.generate(xs, np.array([0, 1])).shape == xs.shape


class _NoBackward(ConstraintSet):
    """A constraint set with no hand-written backward and no kernel."""

    n_constraints = 10

    def _raw(self, x):
        return x[..., :10]


def test_refusals_before_any_device_work(setup, monkeypatch):
    cons, scaler = setup["cons"], setup["scaler"]
    sur = Surrogate(params_from_numpy(setup["models"][2][1]))
    plain_set = _NoBackward(cons.schema)
    with pytest.raises(NotImplementedError, match="no hand-written constraint backward"):
        ConstrainedPGD(sur, plain_set, scaler, device="cpu")
    with pytest.raises(NotImplementedError, match="Unsupported norm"):
        ConstrainedPGD(sur, cons, scaler, norm=1, device="cpu")
    with pytest.raises(ValueError, match="ctr_id=10"):
        ConstrainedPGD(sur, cons, scaler, constraints_optim="single_constraints", ctr_id=10, device="cpu")
    # on the card: a set without K7 and another dtype are refused before any
    # tensor reaches the device (here there is none to reach)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_NoBackward, "smooth_vjp", lambda self, u, ct: (u, ct))
    with pytest.raises(NotImplementedError, match="no PGD kernel"):
        ConstrainedPGD(sur, plain_set, scaler)
    with pytest.raises(NotImplementedError, match="take float32"):
        ConstrainedPGD(sur, cons, scaler, dtype=torch.float64)

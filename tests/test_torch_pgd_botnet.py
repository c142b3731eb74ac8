"""Port parity of constrained PGD on the botnet domain: the inverse table
of the gather lists, ``BotnetConstraints.smooth_vjp`` against ``jax.grad``,
the hand-written gradient (``grad_and_terms_plain``) against JAX's
``_grad_and_terms``, one run (``pgd_run_plain``) against JAX's ``_one_run``,
restarts fed JAX's starts and the success rates against JAX's, all on the
CPU, at 16 to 32 rows and at most 12 iterations.

Tolerances. In float64 both packages run the same operations up to their
order: the terms, the gradients and the runs agree to rtol 1e-12 with an
absolute floor of 1e-12 of the largest finite entry (a feature's cotangent
sums contributions that cancel, in any order), and the NaN and inf entries
are the same. In float32 the port runs the constraint branch in float32,
as kernel K7b does, while the JAX package runs it in float64 (x64 promotes
``x_f32 - min_f64``): a flow equality is the difference of two sums of 54
and 36 features of up to 1e7, whose float32 noise exceeds the tolerance
1e-3, so float32 is compared on the terms alone, each within 1e-5 of its
summed magnitudes (``tests/test_torch_botnet.py``). Success rates: equal in
float64; in float32 at most 2 of the 32 states may change a rate
(``tests/test_torch_pgd.py::test_success_rates_match_jax``'s rule).
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
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD, round_ints_toward_initial
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import grad_and_terms_plain, pgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.core.constraints import ConstraintSet
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints, BotnetTables, entry_terms
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_botnet, synth_botnet_schema
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import MinMaxParams, fit_minmax
from moeva2_ijcai22_replication_tpu_torch.problems import (
    BOTNET_EDGE_ROWS, botnet_edge_starts, botnet_hard_candidates,
)
from test_torch_botnet import _term_scale

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

LOSSES = (
    "flip", "constraints", "constraints+flip", "constraints+flip+alternate",
    "constraints+flip+constraints", "constraints+flip+manual", "constraints+flip+adaptive_eps_step",
    "constraints+flip+adaptive_eps_step+repair", "flip+repair",
)
#: config/rq1.botnet.yaml's PGD losses (flip+sat runs as flip without the MILP repair)
RQ1_LOSSES = ("flip", "constraints+flip", "constraints+flip+adaptive_eps_step",
              "constraints+flip+adaptive_eps_step+repair")
OPTIMS = ("sum", "alt_constraints", "single_constraints")
N_ROWS = 16
T = 12
UNIT = MinMaxParams(scale=np.ones(756), min_=np.zeros(756))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    paths = synth_botnet_schema(str(tmp_path_factory.mktemp("pgd_botnet")))
    cons = BotnetConstraints(paths["features"], paths["constraints"])
    x = synth_botnet(64, cons.schema, seed=3)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    rng = np.random.default_rng(0)
    # rows off the data: violated constraints, features at the clip bounds
    xs = np.clip(scaler.transform(x) + rng.normal(scale=0.02, size=x.shape), 0.0, 1.0)
    models = {}
    for n_classes in (2, 1):
        model = jmlp.MLP(hidden=(64, 64, 32), n_classes=n_classes)
        params = jmlp.init_params(model, 756, seed=1)
        models[n_classes] = (jio.Surrogate(model, params), jax.tree.map(np.asarray, params))
    return {
        "jcons": JBotnet(paths["features"], paths["constraints"]),
        "cons": cons,
        "x": x,
        "xs": xs,
        "y": rng.integers(0, 2, len(x)),
        "scaler": scaler,
        "models": models,
    }


def _pair(setup, dtype=torch.float64, n_classes=2, scaler=None, model=None, **kw):
    """The same attack in both packages; ``model`` a (JAX surrogate,
    numpy params) pair, by default the fixture's of ``n_classes``."""
    scaler = setup["scaler"] if scaler is None else scaler
    jsur, tree = setup["models"][n_classes] if model is None else model
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ja = JPGD(classifier=jsur, constraints=setup["jcons"], scaler=JMinMax(scaler.scale, scaler.min_),
              dtype=jdt, **kw)
    ta = ConstrainedPGD(Surrogate(params_from_numpy(tree, dtype)), setup["cons"], scaler, dtype=dtype,
                        device="cpu", **kw)
    return ja, ta, jsur.params


def _close(got, want, what=""):
    """float64 values as the module docstring states, NaN and inf where NaN
    and inf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN entries differ"
    assert np.array_equal(np.isinf(got), np.isinf(want)), f"{what}: inf entries differ"
    fin = np.abs(want[np.isfinite(want)])
    top = fin.max() if fin.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * top, equal_nan=True, err_msg=what)


def _edge_rows(setup):
    """Unscaled rows (the attack given a unit scaler) at the backward's
    edges: ``botnet_edge_starts``' twelve (0 and NaN packets, an infinite
    flow sum and inf - inf, an ordering and a flow equality exactly at the
    tolerance, ±0 inside a flow equality's abs, a ratio of exactly 1500, 0
    bytes with 0 packets) and, after them, ``botnet_hard_candidates``' on
    every ninth row (-0.0 packets among them)."""
    cons = setup["cons"]
    x = setup["x"][:30] * (1.0 + 0.05 * np.random.default_rng(6).standard_normal((30, 756)))
    x = botnet_edge_starts(cons.schema.names, UNIT, x, np.float64)
    codec = codec_lib.make_codec(cons.schema)
    x[BOTNET_EDGE_ROWS:] = botnet_hard_candidates(codec, cons.schema.names,
                                                  torch.as_tensor(x[None, BOTNET_EDGE_ROWS:]))[0].numpy()
    return x


def _grad_pair(ja, ta, params, x, y, i, max_iter, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = ja._grad_and_terms(params, jnp.asarray(x, jdt), jnp.asarray(y, jnp.int32), jnp.asarray(i), max_iter)
    sched = ta.schedule(ta.eps, ta.eps_step, max_iter)
    got = grad_and_terms_plain(
        ta.tables, ta.constraints, torch.as_tensor(x, dtype=dtype), torch.as_tensor(y),
        sched.w_class[i], sched.w_cons[i], int(sched.ctr[i]), ta.targeted,
    )
    return want, got


# -- the inverse of the gather lists ------------------------------------------------


def test_inverse_table_lists_each_features_entries_in_term_order(setup):
    cons = setup["cons"]
    tables = cons.kernel_tables("cpu")
    assert isinstance(tables, BotnetTables) and cons.pgd_kernel == "botnet"
    index, inverse = tables.index.numpy(), tables.inverse.numpy()
    terms = entry_terms(tables.counts)
    assert len(terms) == len(index) == 896 and terms.max() == 359
    # 468 features in the lists, at most 4 entries each
    assert inverse.shape == (756, 4) and inverse.dtype == np.int32
    assert int((inverse[:, 0] >= 0).sum()) == 468
    for f in range(756):
        want = sorted(np.nonzero(index == f)[0], key=lambda e: (terms[e], e))
        row = inverse[f]
        assert list(row[row >= 0]) == want and (row[len(want):] == -1).all()


# -- the terms' backward against jax.grad -----------------------------------------


@pytest.mark.parametrize("ct_kind", ["random", "sum", "single"])
@pytest.mark.parametrize("kind", ["feasible", "perturbed", "edges"])
def test_smooth_vjp_matches_jax_grad(setup, kind, ct_kind):
    cons, jcons = setup["cons"], setup["jcons"]
    rng = np.random.default_rng(len(kind) + len(ct_kind))
    u = {
        "feasible": setup["x"][:30],
        "perturbed": setup["x"][:30] * (1.0 + 0.05 * rng.standard_normal((30, 756))),
        "edges": _edge_rows(setup),
    }[kind]
    ct_g = {
        "random": rng.standard_normal((30, 360)),
        "sum": np.full((30, 360), -1.0),
        "single": np.where(np.arange(360) == 1 + 37 * (len(kind) % 3), -1.0, 0.0) * np.ones((30, 1)),
    }[ct_kind]
    want_g = np.asarray(jcons.evaluate_smooth(jnp.asarray(u)))
    want = np.asarray(jax.grad(lambda v: (jcons.evaluate_smooth(v) * ct_g).sum())(jnp.asarray(u)))
    g, got = cons.smooth_vjp(torch.as_tensor(u), torch.as_tensor(ct_g))
    np.testing.assert_array_equal(g.numpy(), cons.evaluate_smooth(torch.as_tensor(u)).numpy())
    _close(g.numpy(), want_g, f"{kind} {ct_kind} g")
    _close(got.numpy(), want, f"{kind} {ct_kind} ct_u")
    if kind == "edges":
        assert np.isnan(want).any(1)[[1, 15]].all()  # NaN packets reach the cotangent
        assert np.isinf(want_g[2]).any() and np.isnan(want_g[3]).any()  # an infinite flow sum, inf - inf
        # the terms exactly at the tolerance: clip's 0.5
        assert ((cons._raw(torch.as_tensor(u)) - cons.tol).numpy() == 0).any(1)[[4, 6]].all()
    if kind == "feasible":
        assert not want_g.any()


def test_smooth_vjp_float32_terms_within_tolerance(setup):
    cons, jcons = setup["cons"], setup["jcons"]
    u = setup["x"][:30] * (1.0 + 0.05 * np.random.default_rng(8).standard_normal((30, 756)))
    g, ct = cons.smooth_vjp(torch.as_tensor(u, dtype=torch.float32), torch.full((30, 360), -1.0))
    assert g.dtype == ct.dtype == torch.float32 and torch.isfinite(ct).all()
    want = np.asarray(jcons.evaluate_smooth(jnp.asarray(u)))
    assert (np.abs(g.double().numpy() - want) <= 1e-5 * _term_scale(cons, u)).all()


# -- the iteration's gradient against JAX's _grad_and_terms ------------------------


@pytest.mark.parametrize("optim", OPTIMS)
@pytest.mark.parametrize("loss", LOSSES)
def test_gradient_matches_jax_float64(setup, loss, optim):
    targeted = LOSSES.index(loss) % 2 == 1
    ja, ta, params = _pair(setup, loss_evaluation=loss, constraints_optim=optim, ctr_id=37, targeted=targeted,
                           eps=4.0, eps_step=0.1, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    for i in (0, 6, T - 1):
        want, got = _grad_pair(ja, ta, params, xs, y, i, T, torch.float64)
        for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
            _close(g.numpy(), w, f"{loss} {optim} i={i} {name}")


@pytest.mark.parametrize("optim", OPTIMS)
@pytest.mark.parametrize("loss", ["flip", "constraints", "constraints+flip"])
def test_gradient_nan_mask_at_the_edges(setup, loss, optim):
    x = _edge_rows(setup)
    y = setup["y"][: len(x)]
    for dtype in (torch.float64, torch.float32):
        ja, ta, params = _pair(setup, dtype, scaler=UNIT, loss_evaluation=loss, constraints_optim=optim, ctr_id=1,
                               eps=4.0, eps_step=0.1, max_iter=T)
        xin = x if dtype == torch.float64 else x.astype(np.float32)
        want, got = _grad_pair(ja, ta, params, xin, y, 3, T, dtype)
        grad, want_grad = got[0].double().numpy(), np.asarray(want[0], np.float64)
        np.testing.assert_array_equal(np.isnan(grad), np.isnan(want_grad), err_msg=f"{loss} {optim} {dtype}")
        np.testing.assert_array_equal(np.isinf(grad), np.isinf(want_grad), err_msg=f"{loss} {optim} {dtype}")
        assert np.isnan(want_grad[[1, 15]]).any(axis=1).all()  # NaN packets reach the gradient
        if dtype == torch.float64:
            for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
                _close(g.numpy(), w, f"{loss} {optim} {name}")


def test_one_column_head_gradient_matches_jax(setup):
    ja, ta, params = _pair(setup, n_classes=1, loss_evaluation="constraints+flip", eps=4.0, eps_step=0.1,
                           max_iter=T)
    want, got = _grad_pair(ja, ta, params, setup["xs"][:N_ROWS], setup["y"][:N_ROWS], 2, T, torch.float64)
    assert not got[2].any()
    for name, w, g in zip(("grad", "per", "loss_class", "cons", "g"), want, got):
        _close(g.numpy(), w, name)


# -- runs against JAX's _one_run -----------------------------------------------------

#: ε per norm: under L2 a ball the 12 steps of 0.1 reach (rq1.botnet's ε 4 is
#: out of their reach), under L-inf one the first step leaves
RUN_EPS = {2: 0.25, np.inf: 0.05}


def _jax_start(ja, x, eps):
    return ja._random_start(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(eps, jnp.float64))


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("loss", RQ1_LOSSES)
def test_run_matches_jax_one_run(setup, loss, norm):
    record = "full" if "repair" in loss else "reduced"
    eps = RUN_EPS[norm]
    ja, ta, params = _pair(setup, loss_evaluation=loss, norm=norm, record_loss=record,
                           record_grad_norm=record == "full", eps=eps, eps_step=0.1, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    start = _jax_start(ja, xs, eps)
    want_x, want_h = jax.jit(ja._one_run, static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), start, jnp.asarray(eps), jnp.asarray(0.1), T
    )
    got_x, pred, got_h = pgd_run_plain(
        ta.tables, ta.constraints, ta.schedule(eps, 0.1, T), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(np.array(start)), eps, ta.clip, norm, "repair" in loss, False, ta.history_layout(),
    )
    _close(got_x.numpy(), want_x, "x_adv")
    assert not np.array_equal(got_x.numpy(), xs)
    probs = np.asarray(ja.classifier.predict_proba(want_x))
    np.testing.assert_array_equal(pred.numpy(), probs.argmax(-1))
    want_h = np.asarray(want_h)
    assert got_h.shape == want_h.shape == (T, N_ROWS, len(ta.hist_column_names()))
    assert ta.hist_column_names() == ja.hist_column_names()
    # each column to 1e-9 of its scale: a violation is the difference of
    # sums of up to 1e7, which loses digits in any order
    for c in range(want_h.shape[-1]):
        w, g = want_h[..., c], got_h[..., c].numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=1e-9 * max(np.abs(w[fin]).max(), 1.0))


@pytest.mark.parametrize("norm,targeted,eps", [(2, False, 0.3), (np.inf, True, 0.02)])
def test_restarts_fed_jax_starts_match(setup, norm, targeted, eps):
    r = 2
    ja, ta, params = _pair(setup, loss_evaluation="constraints+flip", norm=norm, targeted=targeted,
                           num_random_init=r, record_loss="reduced", eps=eps, eps_step=0.05, max_iter=8)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    key = jax.random.PRNGKey(ja.seed)
    best, hist, succ = jax.jit(ja._build(), static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), key, jnp.asarray(eps), jnp.asarray(0.05), 8
    )
    starts = [torch.as_tensor(np.array(ja._random_start(jax.random.fold_in(key, k), jnp.asarray(xs), eps)))
              for k in range(r)]
    got_x, got_h, got_succ = ta.attack(torch.as_tensor(xs), torch.as_tensor(y), ta.schedule(eps, 0.05, 8), eps,
                                       starts)
    np.testing.assert_array_equal(got_succ.numpy(), np.asarray(succ))
    _close(got_x.numpy(), best, "best_x")
    never = ~got_succ.numpy()[-1]
    np.testing.assert_array_equal(got_x.numpy()[never], xs[never])
    _close(got_h.numpy(), hist, "history")


# -- the slice end to end ----------------------------------------------------------


def _centred(setup):
    """The 2-class surrogate with its head's bias moved so that the median
    state sits on the threshold: the untrained stack puts all 64 states in
    one class, so no attack could flip any of them into it."""
    tree = jax.tree.map(np.array, setup["models"][2][1])
    with torch.no_grad():
        logits = Surrogate(params_from_numpy(tree, dtype=torch.float64)).logits(
            torch.as_tensor(setup["scaler"].transform(setup["x"]))).numpy()
    mid = np.median(logits[:, 1] - logits[:, 0])
    head = tree["params"]["Dense_3"]
    head["bias"] = head["bias"] + np.array([mid / 2, -mid / 2], dtype=head["bias"].dtype)
    return jio.Surrogate(jmlp.botnet_mlp(), tree), tree


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_success_rates_match_jax(setup, dtype):
    """``generate`` as ``experiments/pgd.py`` drives it on botnet: labels
    from the surrogate, rq0.botnet's loss at ε - 1e-6, inverse scaling,
    directional rounding, o1..o7 at f1 0.5 and f2 ε, on the 32 states the
    surrogate puts in class 1 (the class the attack moves them out of)."""
    scaler, cons = setup["scaler"], setup["cons"]
    eps, f1 = 1.0, 0.5
    knobs = dict(loss_evaluation="constraints+flip+adaptive_eps_step+repair", norm=2, eps=eps - 1e-6,
                 eps_step=0.1, max_iter=T)
    model = _centred(setup)
    ja, ta, params = _pair(setup, dtype, model=model, **knobs)
    y = np.asarray(ja.classifier.predict_proba(jnp.asarray(scaler.transform(setup["x"])))).argmax(-1)
    x = setup["x"][y == 1]
    y = y[y == 1]
    xs = scaler.transform(x)
    assert len(x) == 32
    jdt = np.float64 if dtype == torch.float64 else np.float32
    adv = {"jax": np.asarray(ja.generate(xs.astype(jdt), y)), "port": ta.generate(xs.astype(jdt), y)}
    assert adv["port"].dtype == jdt and adv["port"].shape == x.shape
    calc = ObjectiveCalculator(classifier=Surrogate(params_from_numpy(model[1], torch.float64)),
                               constraints=cons, thresholds={"f1": f1, "f2": eps}, min_max_scaler=scaler,
                               ml_scaler=scaler, minimize_class=1, norm=2)
    rates = {}
    for name, a in adv.items():
        attacks = round_ints_toward_initial(scaler.inverse(a.astype(np.float64)), x, cons.get_feature_type())
        rates[name] = calc.success_rate_3d(x, attacks[:, None, :])
    jcalc = JObjective(classifier=model[0], constraints=setup["jcons"],
                       thresholds={"f1": f1, "f2": eps}, min_max_scaler=JMinMax(scaler.scale, scaler.min_),
                       ml_scaler=JMinMax(scaler.scale, scaler.min_), minimize_class=1, norm=2, precise=False)
    j_attacks = j_round(np.asarray(JMinMax(scaler.scale, scaler.min_).inverse(adv["jax"].astype(np.float64))), x,
                        cons.get_feature_type())
    np.testing.assert_allclose(rates["jax"], np.asarray(jcalc.success_rate_3d(x, j_attacks[:, None, :])), atol=1e-12)
    tol = 0.0 if dtype == torch.float64 else 2 / len(x)
    np.testing.assert_allclose(rates["port"], rates["jax"], rtol=0, atol=tol + 1e-12)
    assert 0 < rates["port"][1] < 1  # the attack flips some states within ε, not all


# -- the engine on botnet -----------------------------------------------------------


def test_pgd_accepts_botnet_on_the_cpu(setup):
    _, ta, _ = _pair(setup, torch.float32, loss_evaluation="constraints+flip", record_loss="full", eps=0.3,
                     eps_step=0.05, max_iter=3)
    assert isinstance(ta.tables.cons, BotnetTables) and ta.tables.first_t.shape == (756, 64)
    assert torch.equal(ta.tables.first_t, ta.tables.layers[0][0].t())
    xs, y = setup["xs"][:4].astype(np.float32), setup["y"][:4]
    a = ta.generate(xs, y)
    assert a.shape == xs.shape and np.isfinite(a).all() and ta.loss_history.shape == (4, 3, 363)
    np.testing.assert_array_equal(ta.generate(xs, y), a)


class _FakeCard:
    """A stand-in for a CUDA tensor: ``one_run`` reads ``is_cuda`` alone
    before it hands its arguments to the set's kernel."""

    is_cuda = True


def test_one_run_sends_botnet_to_k7b(setup, monkeypatch):
    _, ta, _ = _pair(setup, torch.float32, loss_evaluation="constraints+flip+repair", norm=np.inf, eps=0.1,
                     max_iter=2)
    calls = []
    monkeypatch.setattr(kernels, "pgd_botnet", lambda *a: calls.append(("pgd_botnet", a)) or "K7b")
    monkeypatch.setattr(kernels, "pgd_lcld", lambda *a: calls.append(("pgd_lcld", a)) or "K7")
    sched = ta.schedule(0.1, 0.1, 2)
    assert ta.one_run(_FakeCard(), "y", "start", sched, 0.1) == "K7b"
    (name, args), = calls
    assert name == "pgd_botnet" and args[0] is ta.tables and args[1] is sched
    assert args[5:] == (0.1, ta.clip, True, True, False, None)


class _NoKernel(BotnetConstraints):
    """The botnet set without its PGD kernel."""

    pgd_kernel = None


class _NoBackward(ConstraintSet):
    n_constraints = 360

    def _raw(self, x):
        return x[..., :360]


def test_the_card_refuses_a_set_without_a_pgd_kernel(setup, monkeypatch, tmp_path):
    cons, scaler = setup["cons"], setup["scaler"]
    sur = Surrogate(params_from_numpy(setup["models"][2][1]))
    paths = synth_botnet_schema(str(tmp_path))
    no_kernel = _NoKernel(paths["features"], paths["constraints"])
    # the CPU takes it: its backward is botnet's
    assert ConstrainedPGD(sur, no_kernel, scaler, device="cpu", max_iter=1).generate(
        setup["xs"][:2], setup["y"][:2]).shape == (2, 756)
    with pytest.raises(NotImplementedError, match="_NoBackward has no hand-written constraint backward"):
        ConstrainedPGD(sur, _NoBackward(cons.schema), scaler, device="cpu")
    # the card refuses it before any tensor reaches the device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="_NoKernel has no PGD kernel"):
        ConstrainedPGD(sur, no_kernel, scaler)

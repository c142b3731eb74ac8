"""Port parity of AutoPGD, on the CPU: the checkpoint schedule and the
budget's tables, the tracking loss, one run (``autopgd_run_plain``) against
JAX's ``AutoPGD._one_run``, the edge rows, botnet, restarts fed JAX's
starts, the budget rule, and the PGD runner's AutoPGD points against the
JAX runner's.

Tolerances are ``tests/test_torch_pgd.py``'s. In float64 both packages run
the same operations up to their order, so runs agree to rtol 1e-12 with an
absolute floor of 1e-12 of the largest finite entry, NaN and inf where NaN
and inf, and every row's final step η equal. In float32 the JAX package runs
its constraint branch in float64 (x64 promotes ``x_f32 - min_f64``) while
the port runs it in float32, as its kernel does; values agree to rtol 1e-3
with a floor of 1e-4 of the largest entry, on the rows whose best-point
choices and halvings are the same in both packages (a tracking loss within
float32 noise of the best, or of the previous one, can tip a comparison):
the test names those rows (``FLOAT32_TIPPED``).
"""

from __future__ import annotations

import copy
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.attacks.pgd import AutoPGD as JAutoPGD
from moeva2_ijcai22_replication_tpu.attacks.pgd import autopgd as jautopgd
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.experiments import common as jcommon
from moeva2_ijcai22_replication_tpu.experiments import pgd as jpgd
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import autopgd as autopgd_module
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import (
    autopgd_run_plain, checkpoint_schedule, make_autopgd_tables, tracking_loss_plain,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import grad_and_terms_plain
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import (
    synth_botnet, synth_botnet_schema, synth_lcld, synth_lcld_schema,
)
from moeva2_ijcai22_replication_tpu_torch.experiments import common
from moeva2_ijcai22_replication_tpu_torch.experiments import pgd as ppgd
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax
from moeva2_ijcai22_replication_tpu_torch.problems import (
    BOTNET_EDGE_ROWS, botnet_edge_starts, synthetic_botnet_augmented_problem,
)
from test_torch_runners import _config, _run_both, _same_identity, artifacts  # noqa: F401

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

N_ROWS = 64
#: a budget with 7 checkpoints (2, 3, 5, 7, 9, 10, 11, 12 less the 0)
T = 12
EPS = 0.2
#: the runner's first step, per_attack_eps / 3
ETA0 = EPS / 3
#: a first step small enough that some rows rise at every checkpoint while
#: others stall: at ETA0 every row of some runs halves
RUN_ETA0 = 0.01


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    paths = synth_lcld_schema(str(tmp_path_factory.mktemp("autopgd")))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(128, cons.schema, seed=3)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    rng = np.random.default_rng(0)
    # rows off the data: violated constraints, features at the clip bounds
    xs = np.clip(scaler.transform(x) + rng.normal(scale=0.05, size=x.shape), 0.0, 1.0)
    model = jmlp.MLP(hidden=(64, 32, 16), n_classes=2)
    params = jmlp.init_params(model, 47, seed=1)
    return {
        "jcons": JLcld(paths["features"], paths["constraints"]),
        "cons": cons,
        "x": x,
        "xs": xs,
        "y": rng.integers(0, 2, len(x)),
        "scaler": scaler,
        "model": (jio.Surrogate(model, params), jax.tree.map(np.asarray, params)),
    }


def _pair(setup, dtype=torch.float64, model=None, cons=None, **kw):
    """The same AutoPGD in both packages."""
    jsur, tree = setup["model"] if model is None else model
    jcons, tcons = (setup["jcons"], setup["cons"]) if cons is None else cons
    scaler = setup["scaler"]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ja = JAutoPGD(classifier=jsur, constraints=jcons, scaler=JMinMax(scaler.scale, scaler.min_), dtype=jdt, **kw)
    ta = AutoPGD(Surrogate(params_from_numpy(tree, dtype)), tcons, scaler, dtype=dtype, device="cpu", **kw)
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


def _jax_start(ja, x, eps):
    return ja._random_start(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(eps, jnp.asarray(x).dtype))


def _jax_run(ja, params, xs, y, start, eps, eta0):
    """JAX's ``_one_run``: ``(x_best, hist, eta)``, with each row's final
    step read from the loop's carry through a patched ``fori_loop``."""
    carry = {}
    orig = jax.lax.fori_loop

    def fori_loop(lo, hi, body, init):
        carry.update(orig(lo, hi, body, init))
        return carry

    jautopgd.jax.lax.fori_loop = fori_loop
    try:
        x_best, hist = ja._one_run(params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), jnp.asarray(start),
                                   jnp.asarray(eps, xs.dtype), jnp.asarray(eta0, xs.dtype), ja.max_iter)
    finally:
        jautopgd.jax.lax.fori_loop = orig
    return np.asarray(x_best), np.asarray(hist), np.asarray(carry["eta"])


def _runs(ja, ta, params, xs, y, start, eps=EPS, eta0=ETA0, iterates=None):
    """JAX's ``_one_run`` and ``autopgd_run_plain`` from the same start:
    ((x_best, hist, eta), (x_best, pred, hist, eta)); the port's iterate at
    each iteration's gradient is appended to the list ``iterates`` if
    given."""
    want = _jax_run(ja, params, xs, y, start, eps, eta0)
    grad_and_terms = autopgd_module.grad_and_terms_plain
    calls = []

    def recorded(tables, constraints, x, *args):
        calls.append(x.numpy().copy())
        return grad_and_terms(tables, constraints, x, *args)

    autopgd_module.grad_and_terms_plain = recorded
    try:
        got = autopgd_run_plain(
            ta.tables, ta.constraints, ta.schedule(eps, eta0, ta.max_iter), torch.as_tensor(xs),
            torch.as_tensor(y), torch.as_tensor(np.array(start)), eps, ta.clip, ta.norm,
            "repair" in ta.loss_evaluation, ta.targeted, ta.history_layout(),
        )
    finally:
        autopgd_module.grad_and_terms_plain = grad_and_terms
    if iterates is not None:
        # the tracking loss at x_start, then each iteration's gradient and
        # the tracking loss at its x_new
        iterates += calls[1::2]
    return want, got


#: the float64 discontinuity both packages keep: g10's ratio x16 / x11 takes
#: the sentinel -1 where the unscaled x11 is exactly 0. The momentum step can
#: cancel to 0 in exact arithmetic (x = 0.005, z = 0, x_prev = 0.01: 0.005 -
#: 0.00375 - 0.00125), where the port's rounded operations leave 4e-19 and
#: XLA's fused program, which contracts them, 0 or 1e-18: the two runs' x
#: then agree to 1e-18 and g10 by the sentinel's distance
SENTINEL_X11 = 1e-15


def _close_hist(got_h, want_h, names, iterates, scaler):
    """The recorded histories as ``_close`` holds runs, but to 1e-9 of each
    column's scale (the violations cancel), except the g10 entries of
    iterations whose unscaled x11 is within ``SENTINEL_X11`` of 0 in the
    port's run: those may differ by the sentinel, and are named."""
    assert got_h.shape == want_h.shape == (len(iterates), got_h.shape[1], len(names))
    u11 = np.stack([(x[:, 11] - scaler.min_[11]) / scaler.scale[11] for x in iterates])
    tipped = []
    for c, name in enumerate(names):
        w, g = want_h[..., c], got_h[..., c]
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        fin = np.isfinite(w)
        bad = np.zeros(w.shape, bool)
        bad[fin] = ~np.isclose(g[fin], w[fin], rtol=1e-9, atol=1e-9 * max(np.abs(w[fin]).max(), 1.0))
        if name == "g10":
            tipped += [(int(i), int(r), float(u11[i, r])) for i, r in zip(*np.nonzero(bad & (np.abs(u11) < SENTINEL_X11)))]
            bad &= np.abs(u11) >= SENTINEL_X11
        assert not bad.any(), f"{name}: (iteration, row) {list(zip(*np.nonzero(bad)))} differ"
    return tipped


class _Captured(Exception):
    pass


def _jax_tables(ja, max_iter: int):
    """JAX's ``is_ckpt`` and ``interval`` for ``max_iter``: its
    ``_one_run`` builds them on the host first, as two ``jnp.asarray``
    calls, which are caught here before anything is traced."""
    got = []

    def asarray(a, *args, **kwargs):
        got.append(np.asarray(a))
        if len(got) == 2:
            raise _Captured
        return a

    ja.max_iter = max_iter
    proxy = type("jnp", (), {"asarray": staticmethod(asarray)})
    orig = jautopgd.jnp
    jautopgd.jnp = proxy
    try:
        ja._one_run(None, np.zeros((1, 47)), None, None, None, None, max_iter)
    except _Captured:
        pass
    finally:
        jautopgd.jnp = orig
    return got


def test_checkpoint_schedule_and_tables_match_jax_for_budgets_1_to_2000(setup):
    ja, _, _ = _pair(setup, loss_evaluation="autopgd+flip", max_iter=1)
    budgets = range(1, 2001)
    ours, intervals = [], []
    for t in budgets:
        np.testing.assert_array_equal(checkpoint_schedule(t), jautopgd.checkpoint_schedule(t), err_msg=f"T={t}")
        tables = make_autopgd_tables("autopgd+flip", "sum", 0, ETA0, t, 0.75, 0.75, torch.float64, "cpu")
        is_ckpt, interval = _jax_tables(ja, t)
        np.testing.assert_array_equal(tables.is_ckpt.numpy(), is_ckpt, err_msg=f"T={t}")
        ours.append(tables.thr.numpy())
        intervals.append(interval)
    # JAX's threshold, rho * interval[i + 1] in float32 (one product over
    # every budget's table, so that XLA compiles it once)
    thr = np.asarray(ja.rho * jnp.asarray(np.concatenate(intervals)))
    assert thr.dtype == np.float32 and ours[0].dtype == np.float64
    np.testing.assert_array_equal(np.concatenate(ours), thr)
    assert int(_jax_tables(ja, T)[0][1:].sum()) == 7


@pytest.mark.parametrize("optim", ["sum", "alt_constraints", "single_constraints"])
@pytest.mark.parametrize("loss", ["autopgd+flip", "autopgd+constraints", "autopgd+constraints+flip",
                                  "autopgd+constraints+flip+alternate", "autopgd+constraints+flip+manual"])
def test_tracking_loss_matches_jax(setup, loss, optim):
    """The tracking weights are ``_static_loss_weights`` and the tracking
    constraint is iteration 0's choice: constraint 0 under
    ``alt_constraints`` (not the iteration's), ``ctr_id`` under
    ``single_constraints``, else the sum."""
    ja, ta, params = _pair(setup, loss_evaluation=loss, constraints_optim=optim, ctr_id=4, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    tw_class, tw_cons = ja._static_loss_weights()
    lc, cons = ja._loss_terms(params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), jnp.int32(0))
    want = tw_class * lc + tw_cons * (-cons)
    auto = ta.schedule(EPS, ETA0, T).auto
    assert (auto.w_class, auto.w_cons) == (tw_class, tw_cons)
    assert auto.ctr == {"sum": -1, "alt_constraints": 0, "single_constraints": 4}[optim]
    got = tracking_loss_plain(ta.tables, ta.constraints, auto, torch.as_tensor(xs), torch.as_tensor(y), False)
    _close(got.numpy(), want, torch.float64, f"{loss} {optim}")


#: (loss, constraints_optim, record_loss, record_grad_norm): every loss
#: strategy, the three constraints_optim and every history layout, each
#: under both norms
RUNS = (
    ("autopgd+flip", "sum", None, False),
    ("autopgd+constraints", "alt_constraints", "reduced", False),
    ("autopgd+constraints+flip", "single_constraints", "full", True),
    ("autopgd+constraints+flip+alternate", "alt_constraints", "full", False),
    ("autopgd+constraints+flip+manual", "sum", "reduced", True),
    ("autopgd+constraints+flip+adaptive_eps_step", "sum", "reduced", False),
    ("autopgd+constraints+flip+adaptive_eps_step+repair", "single_constraints", "full", True),
    ("autopgd+flip+repair", "alt_constraints", None, False),
    ("autopgd+constraints+flip+constraints", "sum", "full", False),
)


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("loss,optim,record,grad_norm", RUNS)
def test_run_matches_jax_one_run(setup, loss, optim, record, grad_norm, norm):
    ja, ta, params = _pair(setup, loss_evaluation=loss, constraints_optim=optim, ctr_id=2, norm=norm,
                           record_loss=record, record_grad_norm=grad_norm, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    start = _jax_start(ja, xs, EPS)
    iterates = []
    (want_x, want_h, want_eta), (got_x, pred, got_h, eta) = _runs(ja, ta, params, xs, y, start, eta0=RUN_ETA0,
                                                                  iterates=iterates)
    _close(got_x.numpy(), want_x, torch.float64, "x_best")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    probs = np.asarray(ja.classifier.predict_proba(want_x))
    ok = ~np.isnan(probs).any(1)
    np.testing.assert_array_equal(pred.numpy()[ok], probs.argmax(-1)[ok])
    # the step halved on some rows and not on all: the checkpoints fired
    assert (eta < RUN_ETA0).any() and (eta == RUN_ETA0).any(), f"eta {np.unique(eta.numpy())}"
    if record is None:
        assert got_h is None
        return
    assert got_h.shape == want_h.shape == (T, N_ROWS, len(ta.hist_column_names()))
    assert ta.hist_column_names() == ja.hist_column_names()
    tipped = _close_hist(got_h.numpy(), want_h, ta.hist_column_names(), iterates, setup["scaler"])
    assert len(tipped) <= 2, f"g10's sentinel tipped at (iteration, row, unscaled x11) {tipped}"


#: the rows whose final step differs from JAX's in float32, by (loss, norm):
#: with repair, the constraint terms of the tracking loss run in float32 in
#: the port and in float64 in JAX (x64), and a rise within that noise of the
#: previous or the best loss tips a comparison, then a halving
FLOAT32_TIPPED = {
    ("autopgd+flip", 2): [], ("autopgd+flip", np.inf): [],
    ("autopgd+constraints+flip+alternate+repair", 2): [0],
    ("autopgd+constraints+flip+alternate+repair", np.inf): [20],
}


@pytest.mark.parametrize("loss", ["autopgd+flip", "autopgd+constraints+flip+alternate+repair"])
@pytest.mark.parametrize("norm", [2, np.inf])
def test_run_matches_jax_float32(setup, loss, norm):
    ja, ta, params = _pair(setup, torch.float32, loss_evaluation=loss, norm=norm, record_loss="reduced",
                           max_iter=T)
    xs, y = setup["xs"][:N_ROWS].astype(np.float32), setup["y"][:N_ROWS]
    start = np.asarray(_jax_start(ja, xs, EPS), np.float32)
    (want_x, _, want_eta), (got_x, _, _, eta) = _runs(ja, ta, params, xs, y, start)
    assert got_x.dtype == torch.float32
    tipped = eta.numpy() != want_eta
    assert np.flatnonzero(tipped).tolist() == FLOAT32_TIPPED[(loss, norm)]
    same = ~tipped
    _close(got_x.numpy()[same], np.asarray(want_x)[same], torch.float32, f"{loss} x_best")


def _edge_starts(setup, rng):
    """Scaled starts at the edges: every denominator's unscaled feature
    exactly 0, alone and with its numerator (x6, x14, x22, x11), a NaN
    feature, a term exactly at the tolerance (x10 - x14 = 1e-3), ±0 inside
    an abs (term 60 and 36), rows of 0s and 1s; the rest perturbed."""
    scaler = setup["scaler"]
    sc, mn = scaler.scale, scaler.min_
    st = np.clip(setup["xs"][:N_ROWS] + rng.normal(scale=0.03, size=(N_ROWS, 47)), 0.0, 1.0)
    for row, feats in enumerate(([6], [0, 6], [14], [10, 14], [22], [11, 16, 22], [11], [0, 6, 10, 14, 11, 22])):
        st[row, feats] = mn[feats]  # unscales to exactly 0
    st[8, 5] = np.nan
    st[9, 10] = st[9, 14] + 1e-3 * sc[10]
    st[10, 1] = 60.0 * sc[1] + mn[1]
    st[11, 1] = 36.0 * sc[1] + mn[1]
    st[12], st[13] = 0.0, 1.0
    return st


def _huge_head(setup):
    """The seeded surrogate with class 0's head weights at -1e308: its logit
    is -inf on rows with enough activation, where the cross-entropy of
    class 0 is +inf."""
    jsur, tree = setup["model"]
    tree = jax.tree.map(lambda a: np.array(a, np.float64), tree)
    tree["params"]["Dense_3"]["kernel"][:, 0] = -1e308
    params = jax.tree.map(jnp.asarray, tree)
    return jio.Surrogate(jsur.model, params), tree


@pytest.mark.parametrize("head", ["seeded", "huge"])
@pytest.mark.parametrize("loss", ["autopgd+flip", "autopgd+constraints", "autopgd+constraints+flip+repair"])
def test_edge_starts_match_jax(setup, loss, head):
    """NaN, 0 denominators and (with the huge head) an infinite
    cross-entropy: under ``constraints`` the tracking loss's ``0 * CE`` is
    NaN there and stays NaN; a NaN or infinite loss never rises, so x_best
    keeps the start where it is NaN from the start."""
    model = setup["model"] if head == "seeded" else _huge_head(setup)
    ja, ta, params = _pair(setup, model=model, loss_evaluation=loss, norm=2, record_loss="reduced", max_iter=T)
    xs, y = setup["xs"][:N_ROWS], np.zeros(N_ROWS, np.int64)
    start = _edge_starts(setup, np.random.default_rng(7))
    (want_x, want_h, want_eta), (got_x, _, got_h, eta) = _runs(ja, ta, params, xs, y, start)
    _close(got_x.numpy(), want_x, torch.float64, "x_best")
    _close(got_h.numpy(), want_h, torch.float64, "history")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    f0 = tracking_loss_plain(ta.tables, ta.constraints, ta.schedule(EPS, ETA0, T).auto, torch.as_tensor(start),
                             torch.as_tensor(y), False)
    assert torch.isnan(f0[8])  # the NaN feature
    nan_start = torch.isnan(f0).numpy()
    np.testing.assert_array_equal(got_x.numpy()[nan_start], start[nan_start])
    if head == "huge":
        lc = _cross_entropy(ta, start, y)
        assert np.isposinf(lc).any()
        if loss == "autopgd+constraints":
            assert torch.isnan(f0[np.isposinf(lc)]).all()


def _cross_entropy(ta, x, y) -> np.ndarray:
    """(N,) the cross-entropy of the rows ``x`` (``loss_class`` of
    ``grad_and_terms_plain``)."""
    zero = torch.zeros((), dtype=torch.float64)
    return grad_and_terms_plain(ta.tables, ta.constraints, torch.as_tensor(x), torch.as_tensor(y), zero, zero, -1,
                                False)[2].numpy()


def test_adaptive_eps_step_changes_nothing(setup):
    """η replaces the schedule's step, so ``adaptive_eps_step`` changes no
    bit, in both packages; the loss weights still follow the schedule."""
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    out = {}
    for loss in ("autopgd+constraints+flip", "autopgd+constraints+flip+adaptive_eps_step"):
        ja, ta, params = _pair(setup, loss_evaluation=loss, norm=2, record_loss="full", max_iter=T)
        start = _jax_start(ja, xs, EPS)
        out[loss] = _runs(ja, ta, params, xs, y, start)
    (wa, wb), (ga, gb) = zip(*out.values())
    for a, b in zip(ga, gb):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(wa, wb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("norm,targeted,eps", [(2, False, 0.3), (np.inf, True, 0.02)])
def test_restarts_fed_jax_starts_match(setup, norm, targeted, eps):
    """The restart arbitration is PGD's: a row keeps the first run whose
    best point flips it, ``x_init`` when none does."""
    r = 3
    ja, ta, params = _pair(setup, loss_evaluation="autopgd+constraints+flip", norm=norm, targeted=targeted,
                           num_random_init=r, record_loss="reduced", eps=eps, eps_step=eps / 3, max_iter=T)
    xs, y = setup["xs"][:N_ROWS], setup["y"][:N_ROWS]
    key = jax.random.PRNGKey(ja.seed)
    best, hist, succ = jax.jit(ja._build(), static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), key, jnp.asarray(eps), jnp.asarray(eps / 3), T
    )
    starts = [torch.as_tensor(np.array(ja._random_start(jax.random.fold_in(key, k), jnp.asarray(xs), eps)))
              for k in range(r)]
    got_x, got_h, got_succ = ta.attack(torch.as_tensor(xs), torch.as_tensor(y), ta.schedule(eps, eps / 3, T), eps,
                                       starts)
    np.testing.assert_array_equal(got_succ.numpy(), np.asarray(succ))
    assert got_succ.numpy()[-1].any() and not got_succ.numpy()[-1].all()
    _close(got_x.numpy(), best, torch.float64, "best_x")
    never = ~got_succ.numpy()[-1]
    np.testing.assert_array_equal(got_x.numpy()[never], xs[never])
    _close(got_h.numpy(), hist, torch.float64, "history")


def test_budget_rule_is_jax_s(setup):
    """AutoPGD bakes its budget in both packages: ``generate`` raises
    ``ValueError`` for another; the engine's own budget runs."""
    ja, ta, _ = _pair(setup, torch.float32, loss_evaluation="autopgd+flip", max_iter=4)
    xs, y = setup["xs"][:4].astype(np.float32), setup["y"][:4]
    for attack in (ja, ta):
        with pytest.raises(ValueError, match="max_iter=5 differs"):
            attack.generate(xs, y, max_iter=5)
    assert ta.generate(xs, y, max_iter=4).shape == xs.shape
    assert ta.last_eta.shape == (4,)


@pytest.fixture(scope="module")
def botnet(tmp_path_factory):
    paths = synth_botnet_schema(str(tmp_path_factory.mktemp("autopgd_botnet")))
    cons = BotnetConstraints(paths["features"], paths["constraints"])
    x = synth_botnet(16, cons.schema, seed=3)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    rng = np.random.default_rng(0)
    model = jmlp.MLP(hidden=(64, 32), n_classes=2)
    params = jmlp.init_params(model, 756, seed=1)
    return {
        "cons": (JBotnet(paths["features"], paths["constraints"]), cons),
        "scaler": scaler,
        "xs": np.clip(scaler.transform(x) + rng.normal(scale=0.02, size=x.shape), 0.0, 1.0),
        "y": rng.integers(0, 2, len(x)),
        "model": (jio.Surrogate(model, params), jax.tree.map(np.asarray, params)),
    }


#: botnet's runs against JAX's ``_one_run`` in float64 at T = 12: (loss,
#: norm, constraints_optim, record_loss, first step, whether some rows keep
#: their step). At the runner's first step ε/3 the checkpoints halve every
#: row's step; at the small first steps of two runs they halve some rows'
#: and keep the others'. Under ``alternate`` the iterations that optimise
#: the constraints alone do not raise the tracking loss (its weights are
#: static), so every row halves at any first step
BOTNET_RUNS = (
    pytest.param("autopgd+constraints+flip", 2, "sum", "reduced", 4.0 / 3, False, id="autopgd+constraints+flip-2"),
    pytest.param("autopgd+flip+repair", np.inf, "sum", "reduced", 4.0 / 3, False, id="autopgd+flip+repair-inf"),
    pytest.param("autopgd+constraints+flip", 2, "sum", "reduced", 0.01, True, id="autopgd+constraints+flip-2-small"),
    pytest.param("autopgd+constraints", 2, "single_constraints", "reduced", 0.001, True,
                 id="autopgd+constraints-2-single_constraints"),
    pytest.param("autopgd+constraints+flip+alternate", 2, "sum", "full", 4.0 / 3, False,
                 id="autopgd+constraints+flip+alternate-2-full"),
)


def _botnet_pair(botnet, dtype=torch.float64, **kw):
    return _pair({"scaler": botnet["scaler"]}, dtype, model=botnet["model"], cons=botnet["cons"], eps=4.0,
                 max_iter=T, **kw)


@pytest.mark.parametrize("loss,norm,optim,record,eta0,kept", BOTNET_RUNS)
def test_botnet_runs_on_the_cpu_as_jax(botnet, loss, norm, optim, record, eta0, kept):
    ja, ta, params = _botnet_pair(botnet, loss_evaluation=loss, norm=norm, constraints_optim=optim, ctr_id=200,
                                  record_loss=record)
    xs, y = botnet["xs"], botnet["y"]
    start = _jax_start(ja, xs, 4.0)
    (want_x, want_h, want_eta), (got_x, _, got_h, eta) = _runs(ja, ta, params, xs, y, start, eps=4.0, eta0=eta0)
    _close(got_x.numpy(), want_x, torch.float64, "x_best")
    _close(got_h.numpy(), want_h, torch.float64, "history")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    assert got_h.shape == (T, len(xs), len(ta.hist_column_names()))
    # the checkpoints halved some rows' steps, and kept others' where `kept`
    assert (eta < eta0).any() and bool((eta == eta0).any()) == kept, f"eta {np.unique(eta.numpy())}"


def test_botnet_run_matches_jax_float32(botnet):
    """In float32 the tracking loss of ``flip`` is the cross-entropy alone
    (0 times a finite cons), so no row's best point or halving tips: every
    row agrees at the file's float32 tolerance, and every final step, and so
    do the history's loss and class-loss columns. Its cons column does not:
    JAX's constraint branch runs in float64 (the module docstring), and a
    ratio term near its pole magnifies that."""
    ja, ta, params = _botnet_pair(botnet, torch.float32, loss_evaluation="autopgd+flip", norm=2,
                                  record_loss="reduced")
    xs, y = botnet["xs"].astype(np.float32), botnet["y"]
    start = np.asarray(_jax_start(ja, xs, 4.0), np.float32)
    (want_x, want_h, want_eta), (got_x, _, got_h, eta) = _runs(ja, ta, params, xs, y, start, eps=4.0,
                                                                eta0=4.0 / 3)
    assert got_x.dtype == torch.float32
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    _close(got_x.numpy(), np.asarray(want_x), torch.float32, "x_best")
    _close(got_h.numpy()[..., :2], np.asarray(want_h)[..., :2], torch.float32, "history's loss columns")


#: a scaled packets value that the momentum leaves where it cancels to 0 in
#: exact arithmetic: below this and not 0 (about 1e-17 in the port, where
#: XLA's fused program leaves another residual or 0)
POLE_RESIDUAL = 1e-15


def test_botnet_small_linf_step_matches_jax_off_the_ratio_poles(botnet):
    """``flip+repair`` under L-inf from a first step of 0.1, at which the
    checkpoints halve some rows' steps and keep the others': x_best, η and
    the history's loss columns equal JAX's, and so does the history's cons
    but at the iterations whose iterate holds a ratio term's packets feature
    at a momentum's rounding residual (``POLE_RESIDUAL``): the ratio's pole
    turns the two programs' residuals into different cons (PR 18 met the
    same contraction at g10's sentinel). Such iterations occur here."""
    ja, ta, params = _botnet_pair(botnet, loss_evaluation="autopgd+flip+repair", norm=np.inf, record_loss="reduced")
    xs, y = botnet["xs"], botnet["y"]
    start = _jax_start(ja, xs, 4.0)
    iterates = []
    (want_x, want_h, want_eta), (got_x, _, got_h, eta) = _runs(ja, ta, params, xs, y, start, eps=4.0, eta0=0.1,
                                                                iterates=iterates)
    _close(got_x.numpy(), want_x, torch.float64, "x_best")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    assert (eta < 0.1).any() and (eta == 0.1).any(), f"eta {np.unique(eta.numpy())}"
    got_h = got_h.numpy()
    _close(got_h[..., :2], want_h[..., :2], torch.float64, "history's loss columns")
    pkts = np.asarray(botnet["cons"][1].segments()[5])
    x = np.stack(iterates)[..., pkts]  # (T, N, the ratios' packets)
    residual = ((x != 0) & (np.abs(x) < POLE_RESIDUAL)).any(-1)
    got_c, want_c = got_h[..., 2], want_h[..., 2]
    _close(got_c[~residual], want_c[~residual], torch.float64, "cons off the poles")
    assert not np.isclose(got_c[residual], want_c[residual], rtol=1e-12, atol=0).all()


def test_botnet_edge_starts_match_jax(botnet):
    """``botnet_edge_starts``' twelve rows (0 and NaN packets, infinite sums,
    inf - inf, terms exactly at the tolerance, rows at the clip bounds): a
    NaN tracking loss never rises, so x_best keeps the start where it is NaN
    from the start."""
    ja, ta, params = _botnet_pair(botnet, loss_evaluation="autopgd+constraints+flip+repair", norm=2,
                                  record_loss="full")
    xs, y = botnet["xs"], botnet["y"]
    jcons, tcons = botnet["cons"]
    start = botnet_edge_starts(tcons.schema.names, botnet["scaler"], xs, np.float64)
    (want_x, want_h, want_eta), (got_x, _, got_h, eta) = _runs(ja, ta, params, xs, y, start, eps=4.0, eta0=0.1)
    _close(got_x.numpy(), want_x, torch.float64, "x_best")
    _close(got_h.numpy(), want_h, torch.float64, "history")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    f0 = tracking_loss_plain(ta.tables, tcons, ta.schedule(4.0, 0.1, T).auto, torch.as_tensor(start),
                             torch.as_tensor(y), False)
    nan_start = torch.isnan(f0).numpy()
    assert nan_start[:BOTNET_EDGE_ROWS].any() and not nan_start[BOTNET_EDGE_ROWS:].any()
    np.testing.assert_array_equal(got_x.numpy()[nan_start], start[nan_start])


class _FakeCard:
    """A stand-in for a CUDA tensor: ``one_run`` reads ``is_cuda`` only."""

    is_cuda = True


def test_one_run_sends_each_set_to_its_kernels_autopgd_instantiation(setup, botnet, monkeypatch):
    """On the card a run is one launch of the set's PGD kernel with the
    AutoPGD tables: K7 on LCLD, K7b on botnet; each row's final step lands
    in ``last_eta``."""
    calls = []
    for name in ("pgd_lcld", "pgd_botnet"):
        monkeypatch.setattr(kernels, name, lambda *a, name=name, **k: calls.append((name, a, k)) or (
            "x_best", "pred", "hist", f"eta of {name}"))
    for (_, ta, _), want in ((_pair(setup, torch.float32, loss_evaluation="autopgd+flip", max_iter=2), "pgd_lcld"),
                             (_botnet_pair(botnet, torch.float32, loss_evaluation="autopgd+flip+repair",
                                           norm=np.inf), "pgd_botnet")):
        sched = ta.schedule(0.1, 0.1 / 3, ta.max_iter)
        assert ta.one_run(_FakeCard(), "y", "start", sched, 0.1) == ("x_best", "pred", "hist")
        name, args, kw = calls.pop()
        assert name == want and args[0] is ta.tables and args[1] is sched.pgd and kw == {"auto": sched.auto}
        assert args[5:] == (0.1, ta.clip, ta.norm == np.inf, "repair" in ta.loss_evaluation, False, None)
        assert ta.last_eta == f"eta of {want}"


def test_the_card_refuses_autopgd_off_lcld(tmp_path, monkeypatch):
    """On the card AutoPGD runs wherever constrained PGD has a kernel: the
    augmented botnet domain reaches K7b's AutoPGD instantiation (a card
    pretended here, ``kernels.pgd_botnet`` stood in for) with its pairs'
    tables, and the refusal is gone."""
    cons, sur, scaler, _ = synthetic_botnet_augmented_problem(str(tmp_path), 8)
    calls = []
    monkeypatch.setattr(kernels, "pgd_botnet", lambda *a, **k: calls.append((a, k)) or (
        "x_best", "pred", "hist", "eta"))
    atk = AutoPGD(sur, cons, scaler, loss_evaluation="autopgd+constraints+flip", max_iter=3, device="cpu")
    sched = atk.schedule(4.0, 4.0 / 3, 3)
    assert atk.one_run(_FakeCard(), "y", "start", sched, 4.0) == ("x_best", "pred", "hist")
    (args, kw), = calls
    assert args[0] is atk.tables and args[1] is sched.pgd and kw == {"auto": sched.auto}
    assert args[5:] == (4.0, atk.clip, True, False, False, None)  # L-inf, the default norm
    tables = args[0].cons
    assert tables.pair_idx.shape == (171, 2) and tables.pair_thr.shape == (171, 2)
    assert atk.tables.scale.shape == (927,) and atk.last_eta == "eta"
    assert not hasattr(autopgd_module, "NO_AUTOPGD_KERNEL")


# -- the runner -----------------------------------------------------------------


@pytest.fixture
def jax_runners(monkeypatch):
    """The JAX PGD runner with the test-side patches of
    ``tests/test_torch_runners.py`` (``precise=False``, float64 engines),
    AutoPGD's among them, and empty caches."""

    class Float64AutoPGD(JAutoPGD):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, dtype=jnp.float64, **kwargs)

    monkeypatch.setattr(jpgd, "ObjectiveCalculator", functools.partial(JObjective, precise=False))
    monkeypatch.setattr(jpgd, "AutoPGD", Float64AutoPGD)
    jcommon.ENGINES.clear()
    jcommon.ARTIFACTS.clear()
    common.ENGINES.clear()
    common.ARTIFACTS.clear()
    yield
    jcommon.ENGINES.clear()
    common.ENGINES.clear()


@pytest.mark.parametrize("loss", ["autopgd+flip", "autopgd+constraints+flip"])
def test_runner_autopgd_point_matches_jax(artifacts, jax_runners, tmp_path, loss):  # noqa: F811
    out = tmp_path / "out"
    cfg = _config(artifacts, out, "pgd", budget=12, eps=0.2, loss_evaluation=loss, nb_random=0)
    jm, jfiles, pm, pfiles, jdir = _run_both(jpgd.run, ppgd.run, cfg, out, torch.float64)
    mid_fix = f"pgd_{loss}"
    _same_identity(cfg, jm, jfiles, pm, pfiles, mid_fix)
    assert pm["objectives"] == jm["objectives"]
    name = f"x_attacks_{mid_fix}_{pm['config_hash']}.npy"
    np.testing.assert_allclose(np.load(out / name), np.load(jdir / name), rtol=1e-9, atol=0)
    csv = f"success_rate_{mid_fix}_{pm['config_hash']}.csv"
    assert (out / csv).read_bytes() == (jdir / csv).read_bytes()
    assert ppgd.run(copy.deepcopy(cfg), device="cpu", dtype=torch.float64) is None
    shutil.rmtree(jdir)


def test_runner_keys_autopgd_engines_by_budget(artifacts, jax_runners, tmp_path):  # noqa: F811
    """With the default ``nb_random`` (one random start) an ε sweep shares
    one engine and another budget builds its own, in both packages."""
    points = [(0.2, 6), (0.3, 6), (0.2, 7)]
    for runner, cache in ((jpgd.run, jcommon.ENGINES), (functools.partial(ppgd.run, device="cpu"), common.ENGINES)):
        before = (cache.misses, cache.hits)
        for k, (eps, budget) in enumerate(points):
            cfg = _config(artifacts, tmp_path / f"{cache is common.ENGINES}_{k}", "pgd", budget=budget, eps=eps,
                          loss_evaluation="autopgd+flip")
            runner(cfg)
        assert (cache.misses - before[0], cache.hits - before[1]) == (2, 1)
    engine = next(iter(common.ENGINES._engines.values()))
    assert isinstance(engine, AutoPGD) and engine.num_random_init == 1
    assert sorted(k[4] for k in common.ENGINES._engines) == [6, 7]

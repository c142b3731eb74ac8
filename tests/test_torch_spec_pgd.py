"""Constrained PGD and AutoPGD on domains compiled from a constraint spec,
against the JAX package on the CPU (x64 on).

- the backward rules of the spec's operators (``core/vjp.py``) against
  ``jax.grad`` in float64;
- a spec set's ``smooth_vjp`` (the reverse program interpreted) against
  ``jax.grad`` of the JAX set's ``evaluate_smooth``, with the operators'
  edge rows (``spec_edge_rows``: 0, -0.0, NaN and ±inf denominators,
  members met, ±0, features at their bounds): in float64 to rtol 1e-12 with
  a floor of 1e-12 of the largest finite entry and the same NaN and inf
  entries (``tests/test_torch_pgd.py``'s bound); in float32 to that file's
  float32 bound (rtol 1e-3, floor 1e-4 of the largest entry);
- the reverse program against its AST twin (``smooth_vjp_ast``) bit for bit
  in float32 and float64, and the repair program against JAX's
  ``compile_repair``;
- the spec backward against the hand-written one of its twin domain:
  botnet's bit for bit; LCLD's bit for bit but for the entries named in
  ``LCLD_NOT_BIT_EXACT``;
- ``pgd_run_plain`` and ``autopgd_run_plain`` on spec sets against JAX's
  ``_one_run`` in float64 (losses, ``constraints_optim``, both norms,
  ``repair``, the history layouts), and restarts fed JAX's starts.

Kernel K10 is held to these plain versions on the card by
``tests/test_torch_kernels.py -m cuda -k pgd_spec`` and ``chip_smoke.py``
phase 18.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu import domains as jdomains
from moeva2_ijcai22_replication_tpu.attacks.pgd import AutoPGD as JAutoPGD
from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.attacks.pgd import autopgd as jautopgd
from moeva2_ijcai22_replication_tpu.core.codec import full_ohe_tables as j_full_ohe_tables
from moeva2_ijcai22_replication_tpu.domains.ir import ops as jops
from moeva2_ijcai22_replication_tpu.domains.ir.repair_backend import compile_repair as j_compile_repair
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch import domains
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.core import vjp as V
from moeva2_ijcai22_replication_tpu_torch.core.codec import harden_onehot
from moeva2_ijcai22_replication_tpu_torch.domains import ir, synth
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.ir import program as P
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax
from moeva2_ijcai22_replication_tpu_torch.problems import spec_edge_rows

torch.set_num_threads(1)

DOMAINS = ("lcld_spec", "botnet_spec", "phishing", *(f"family{k}" for k in range(6)))
#: the entries of LCLD's backward that the spec's does not give bit for bit:
#: g1 reads int_rate (feature 2) three times and term (feature 1) twice, and
#: the spec's backward adds each read's contribution to the feature, where
#: the hand-written one sums them first (``lcld_smooth_vjp``: the growth's
#: and the rate's cotangents combined, then divided by 1200 once). Their
#: bound: rtol 1e-12 in float64 with a floor of 1e-12 of the column's
#: largest finite entry, and 2e-6 with a floor of 2e-6 in float32 (a few
#: ulps of the sum's terms)
LCLD_NOT_BIT_EXACT = (1, 2)
T = 8


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Per domain: (JAX set, port set, rows): feasible rows, the same rows
    perturbed, and the spec operators' edge rows."""
    out = {}
    for name in DOMAINS:
        if name == "lcld_spec":
            p = synth.synth_lcld_schema(str(tmp_path_factory.mktemp("lcld")))
            files = (p["features"], p["constraints"])
        elif name == "botnet_spec":
            p = synth.synth_botnet_schema(str(tmp_path_factory.mktemp("botnet")))
            files = (p["features"], p["constraints"])
        elif name == "phishing":
            d = domains.spec_domain_dir("phishing")
            files = (os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv"))
        else:
            d = str(tmp_path_factory.mktemp(name))
            ir.write_family(d, int(name[len("family"):]))
            files = (os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv"))
        jcons, tcons = jdomains.get_constraints_class(name)(*files), domains.get_constraints_class(name)(*files)
        if name == "lcld_spec":
            x = synth.synth_lcld(8, tcons.schema, seed=5)
        elif name == "botnet_spec":
            x = synth.synth_botnet(4, tcons.schema, seed=5)
        elif name == "phishing":
            x = synth.synth_phishing(8, tcons.schema, seed=5)
        else:
            x, _, _ = ir.sample_family(8, int(name[len("family"):]))
        pert = x * (1.0 + 0.05 * np.random.default_rng(5).standard_normal(x.shape))
        out[name] = (jcons, tcons, np.concatenate([x, pert, spec_edge_rows(tcons, pert)]))
    return out


def _ct_g(n, k, dtype, seed=0):
    """Cotangents of the violations: PGD's -w_cons, zeros (an optimised
    term's neighbours) and random magnitudes."""
    rng = np.random.default_rng(seed)
    ct = -rng.uniform(0.1, 2.0, (n, k))
    ct[::3] = -1.0
    ct[1::5] = 0.0
    return ct.astype(dtype)


def _close(got, want, dtype, what=""):
    """Values as the module docstring states, NaN and inf where NaN and inf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN entries differ"
    assert np.array_equal(np.isinf(got), np.isinf(want)), f"{what}: inf entries differ"
    fin = np.abs(want[np.isfinite(want)])
    top = fin.max() if fin.size else 0.0
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * top, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * top, equal_nan=True, err_msg=what)


def _bits(a, b, what=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


# -- the operators' backward rules -------------------------------------------------------


def _jax_vjp(fn, *args, ct):
    out, back = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(g) for g in back(jnp.asarray(ct))]


BASES = np.array([0.0, -0.0, 0.5, 1.0, 1.0016666666666667, 2.0, 7.5, -2.0, np.inf, np.nan])
EXPONENTS = np.array([0.0, 1.0, 2.0, 36.0, 60.0, -1.5, 0.5, 3.0, 2.0, 1.0])


def test_pow_rules_match_jax():
    ct = np.linspace(-2.0, 2.0, len(BASES))
    _, (c_b, c_t) = _jax_vjp(jnp.power, BASES, EXPONENTS, ct=ct)
    b, t, c = (torch.as_tensor(a) for a in (BASES, EXPONENTS, ct))
    _close(c * V.pow_base_jac(b, t), c_b, np.float64, "base")
    _close(c * V.pow_exp_jac(b, t), c_t, np.float64, "exponent")


def test_neg_and_months_rules_match_jax():
    d = np.array([201203.0, 198001.0, -201812.0, 0.0, 99.5, 1e12])
    for ct in (np.linspace(-3.0, 3.0, len(d)), np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0])):
        _, (want,) = _jax_vjp(jops.months, d, ct=ct)
        # JAX's is ct + 0: equal but for a zero's sign (see months_vjp)
        _close(V.months_vjp(torch.as_tensor(ct)).numpy(), want, np.float64, "months")
        _, (want,) = _jax_vjp(jnp.negative, d, ct=ct)
        _bits(V.neg_vjp(torch.as_tensor(ct)).numpy(), want, "neg")


@pytest.mark.parametrize("finite", [False, True])
def test_guarded_division_rules_match_jax(finite):
    num = np.array([3.0, 0.0, 1e300, -2.0, np.nan, 5.0, 1.0, 4.0])
    den = np.array([2.0, 0.0, 1e-300, -0.0, 1.0, np.inf, np.nan, -8.0])
    ct = np.array([1.5, -1.0, 2.0, 1.0, -0.5, 3.0, 1.0, np.nan])
    fn = jops.finite_div if finite else jops.safe_div
    _, (want_n, want_d) = _jax_vjp(lambda n, d: fn(n, d, -1.0), num, den, ct=ct)
    got_n, got_d = V.guarded_div_vjp(*(torch.as_tensor(a) for a in (ct, num, den)), finite)
    _close(got_n.numpy(), want_n, np.float64, "numerator")
    _close(got_d.numpy(), want_d, np.float64, "denominator")


@pytest.mark.parametrize("values", [(36.0, 60.0), (0.0, 1.0), (1.0, 2.0, 4.0)])
def test_member_rule_matches_jax(values):
    x = np.array([36.0, 60.0, 48.0, 0.0, 1.0, 2.5, -7.0, 3.0])
    ct = np.array([1.0, -2.0, 0.5, 1.0, -1.0, 2.0, 1.0, -0.25])

    def term(v):
        prod = values[0] - v
        for val in values[1:]:
            prod = prod * (val - v)
        return jnp.abs(prod)

    _, (want,) = _jax_vjp(term, x, ct=ct)
    xt, c = torch.as_tensor(x), torch.as_tensor(ct)
    factors = [val - xt for val in values]
    prod = factors[0]
    for f in factors[1:]:
        prod = prod * f
    got = torch.zeros_like(xt)
    for cf in V.member_vjp(V.abs_vjp(prod, c), factors):
        got = got + V.neg_vjp(cf)
    _close(got.numpy(), want, np.float64, "member")


def test_literal_term_rule_matches_jax():
    x = np.zeros(5)
    ct = np.array([1.0, np.nan, np.inf, -np.inf, -1.0])
    _, (want,) = _jax_vjp(lambda v: 4.0 + 0.0 * v, x, ct=ct)
    _bits(V.literal_term_vjp(torch.as_tensor(ct)).numpy(), want, "literal term")


def test_group_sum_rule_matches_jax():
    x = np.arange(12.0).reshape(3, 4)
    ct = np.array([1.0, -2.0, np.nan])
    _, (want,) = _jax_vjp(lambda v: v.sum(-1), x, ct=ct)
    _bits(np.broadcast_to(ct[:, None], x.shape), want, "sum")


# -- the spec backward ---------------------------------------------------------------------


@pytest.mark.parametrize("name", DOMAINS)
def test_smooth_vjp_matches_jax_grad_float64(sets, name):
    jcons, tcons, x = sets[name]
    ct = _ct_g(len(x), tcons.n_constraints, np.float64)
    want_g, (want,) = _jax_vjp(jcons.evaluate_smooth, x, ct=ct)
    g, got = tcons.smooth_vjp(torch.as_tensor(x), torch.as_tensor(ct))
    _close(g.numpy(), want_g, np.float64, f"{name} g")
    _close(got.numpy(), want, np.float64, f"{name} ct_u")
    assert np.isnan(want).any() or name.startswith("family") or name == "phishing"


@pytest.mark.parametrize("name", DOMAINS)
def test_smooth_vjp_matches_jax_grad_float32(sets, name):
    jcons, tcons, x = sets[name]
    # float32 overflows where float64 does not: the rows whose features all
    # stay below 1e30, and edge values within float32's range
    x = x[(np.abs(np.nan_to_num(x, posinf=0.0, neginf=0.0)) < 1e30).all(-1)].astype(np.float32)
    ct = _ct_g(len(x), tcons.n_constraints, np.float32)
    want_g, (want,) = _jax_vjp(jcons.evaluate_smooth, x, ct=ct)
    g, got = tcons.smooth_vjp(torch.as_tensor(x), torch.as_tensor(ct))
    assert got.dtype == torch.float32
    _close(g.numpy(), want_g, np.float32, f"{name} g")
    _close(got.numpy(), want, np.float32, f"{name} ct_u")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", DOMAINS)
def test_reverse_program_equals_the_ast_twin(sets, name, dtype):
    _, tcons, x = sets[name]
    u = torch.as_tensor(x, dtype=dtype)
    ct = torch.as_tensor(_ct_g(len(x), tcons.n_constraints, np.float64, seed=2), dtype=dtype)
    g, got = P.run_program_vjp_plain(tcons.pgd_program.vjp, u, ct, tcons.tol)
    want_g, want = ir.smooth_vjp_ast(tcons.resolved, u, ct, tcons.tol)
    _bits(g.numpy(), want_g.numpy(), f"{name} g")
    _bits(got.numpy(), want.numpy(), f"{name} ct_u")
    # and the violations are evaluate_smooth's
    _bits(g.numpy(), tcons.evaluate_smooth(u).numpy(), f"{name} evaluate_smooth")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", DOMAINS)
def test_repair_program_matches_jax_compile_repair(sets, name, dtype):
    """The repair program and the hardening against JAX's
    ``compile_repair`` in float64, bit for bit; in float32 against the
    port's ``compile_repair`` (its twin; JAX's float32 takes ``^`` in
    float32, the port's in float64 rounded once)."""
    jcons, tcons, x = sets[name]
    x = x * (1.0 + 0.3 * np.random.default_rng(1).standard_normal(x.shape))
    x = x.astype(np.float64 if dtype == torch.float64 else np.float32)
    u = P.run_repair_plain(tcons.pgd_program.repair, torch.as_tensor(x))
    got = harden_onehot(u, tcons._ohe_idx, tcons._ohe_mask).numpy()
    if dtype == torch.float64:
        want = np.asarray(j_compile_repair(jcons.resolved, jcons.schema, *j_full_ohe_tables(jcons.schema))(
            jnp.asarray(x)))
    else:
        twin = ir.repair_backend.compile_repair(tcons.resolved, tcons.schema, tcons._ohe_idx, tcons._ohe_mask)
        want = twin(torch.as_tensor(x)).numpy()
    _bits(got, want, name)


def _hand_written(tmp, name):
    if name == "lcld_spec":
        p = synth.synth_lcld_schema(tmp)
        return LcldConstraints(p["features"], p["constraints"]), domains.get_constraints_class(name)(
            p["features"], p["constraints"]), synth.synth_lcld
    p = synth.synth_botnet_schema(tmp)
    return BotnetConstraints(p["features"], p["constraints"]), domains.get_constraints_class(name)(
        p["features"], p["constraints"]), synth.synth_botnet


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lcld_spec", "botnet_spec"])
def test_spec_backward_against_the_hand_written_one(tmp_path, name, dtype):
    hand, spec, draw = _hand_written(str(tmp_path), name)
    x = draw(16, spec.schema, seed=9)
    x = np.concatenate([x, x * (1.0 + 0.05 * np.random.default_rng(9).standard_normal(x.shape)),
                        spec_edge_rows(spec, x)])
    u = torch.as_tensor(x, dtype=dtype)
    ct = torch.as_tensor(_ct_g(len(x), spec.n_constraints, np.float64, seed=4), dtype=dtype)
    g, got = spec.smooth_vjp(u, ct)
    want_g, want = hand.smooth_vjp(u, ct)
    _bits(g.numpy(), want_g.numpy(), "g")
    got, want = got.numpy(), want.numpy()
    named = list(LCLD_NOT_BIT_EXACT) if name == "lcld_spec" else []
    rest = [k for k in range(got.shape[1]) if k not in named]
    _bits(got[:, rest], want[:, rest], "the bit-exact entries")
    for k in named:
        w, v = want[:, k], got[:, k]
        assert np.array_equal(np.isnan(w), np.isnan(v)) and np.array_equal(np.isinf(w), np.isinf(v)), k
        fin = np.isfinite(w)
        top = np.abs(w[fin]).max()
        bound = 1e-12 if dtype == torch.float64 else 2e-6
        np.testing.assert_allclose(v[fin], w[fin], rtol=bound, atol=bound * top, err_msg=f"feature {k}")
    if named:
        # the named entries are not bit for bit on these rows (else the list is stale)
        assert not np.array_equal(got[:, named], want[:, named], equal_nan=True)


# -- whole runs against JAX's _one_run --------------------------------------------------------

RUN_DOMAINS = ("lcld_spec", "botnet_spec", "phishing", "family3")
RUNS = (
    ("constraints+flip+adaptive_eps_step+repair", "sum", "full"),
    ("flip", "sum", "reduced"),
    ("constraints+flip+alternate", "alt_constraints", "full"),
    ("constraints+flip+constraints+repair", "single_constraints", None),
    ("constraints", "sum", "reduced"),
)


@pytest.fixture(scope="module")
def runs(sets):
    """Per run domain: (JAX set, port set, feasible rows, scaler, JAX
    surrogate, its float64 weights)."""
    out = {}
    for name in RUN_DOMAINS:
        jcons, tcons, x = sets[name]
        x = x[:8]
        x = np.concatenate([x, x * (1.0 + 0.02 * np.random.default_rng(3).standard_normal(x.shape))])
        xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in tcons.get_feature_min_max(x))
        scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
        hidden = (64, 64, 32) if name == "botnet_spec" else (64, 32, 16)
        model = jmlp.MLP(hidden=hidden, n_classes=2)
        params = jmlp.init_params(model, tcons.schema.n_features, seed=1)
        out[name] = (jcons, tcons, x, scaler, jio.Surrogate(model, params), jax.tree.map(np.asarray, params))
    return out


def _attack_pair(runs, name, cls, jcls, **kw):
    jcons, tcons, x, scaler, jsur, tree = runs[name]
    ja = jcls(classifier=jsur, constraints=jcons, scaler=JMinMax(scaler.scale, scaler.min_), dtype=jnp.float64, **kw)
    ta = cls(Surrogate(params_from_numpy(tree, torch.float64)), tcons, scaler, dtype=torch.float64, device="cpu",
             **kw)
    xs = np.clip(scaler.transform(x), 0.0, 1.0)
    return ja, ta, jsur.params, xs, (np.arange(len(x)) % 2)


#: domains whose repair assigns a feature from a month difference
#: (family3's d2 := months(date_a) - months(date_b)): the dates' unscaled
#: values (~2e5) carry the two runs' rounding differences (1 ulp, ~3e-11)
#: into a difference of ~30 months, which the gradient takes back into every
#: feature and the L2 steps amplify. Their runs that repair are compared as
#: the histories are, to 1e-9 of each column's scale; every other run to
#: ``_close``'s bound
MONTH_DIFFERENCES = ("family3",)


def _close_x(got, want, name, repair, what):
    if repair and name in MONTH_DIFFERENCES:
        _close_hist(got[None], want[None], what)
    else:
        _close(got, want, np.float64, what)


def _close_hist(got, want, what):
    """Histories to 1e-9 of each column's scale: the violations cancel."""
    assert got.shape == want.shape, what
    for c in range(want.shape[-1]):
        w, g = want[..., c], got[..., c]
        assert np.array_equal(np.isnan(g), np.isnan(w)), f"{what} column {c}"
        fin = np.isfinite(w)
        if fin.any():
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-9, atol=1e-9 * max(np.abs(w[fin]).max(), 1.0),
                                       err_msg=f"{what} column {c}")


@pytest.mark.parametrize("norm", [2, np.inf])
@pytest.mark.parametrize("loss,optim,record", RUNS)
@pytest.mark.parametrize("name", RUN_DOMAINS)
def test_pgd_run_matches_jax_one_run(runs, name, loss, optim, record, norm):
    ja, ta, params, xs, y = _attack_pair(runs, name, ConstrainedPGD, JPGD, loss_evaluation=loss,
                                         constraints_optim=optim, ctr_id=1, norm=norm, record_loss=record,
                                         record_grad_norm=record == "full", eps=0.2, eps_step=0.1, max_iter=T)
    start = ja._random_start(jax.random.PRNGKey(3), jnp.asarray(xs), jnp.asarray(0.2, jnp.float64))
    want_x, want_h = jax.jit(ja._one_run, static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), start, jnp.asarray(0.2), jnp.asarray(0.1), T
    )
    got_x, pred, got_h = pgd_run_plain(
        ta.tables, ta.constraints, ta.schedule(0.2, 0.1, T), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(np.array(start)), 0.2, ta.clip, norm, "repair" in loss, False, ta.history_layout(),
    )
    _close_x(got_x.numpy(), np.asarray(want_x), name, "repair" in loss, f"{name} x_adv")
    if record is None:
        assert got_h is None
    else:
        assert ta.hist_column_names() == ja.hist_column_names()
        _close_hist(got_h.numpy(), np.asarray(want_h), name)


AUTO_RUNS = (
    ("constraints+flip+repair", "sum", "full", 2),
    ("constraints+flip+alternate", "alt_constraints", "reduced", np.inf),
    ("flip", "single_constraints", None, 2),
)


def _jax_auto_run(ja, params, xs, y, start, eps, eta0):
    """JAX's ``AutoPGD._one_run``: ``(x_best, hist, eta)``, each row's final
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


@pytest.mark.parametrize("loss,optim,record,norm", AUTO_RUNS)
@pytest.mark.parametrize("name", RUN_DOMAINS)
def test_autopgd_run_matches_jax_one_run(runs, name, loss, optim, record, norm):
    t = 14
    ja, ta, params, xs, y = _attack_pair(runs, name, AutoPGD, JAutoPGD, loss_evaluation=loss,
                                         constraints_optim=optim, ctr_id=0, norm=norm, record_loss=record,
                                         eps=0.2, eps_step=0.05, max_iter=t)
    start = np.asarray(ja._random_start(jax.random.PRNGKey(4), jnp.asarray(xs), jnp.asarray(0.2, jnp.float64)))
    want_x, want_h, want_eta = _jax_auto_run(ja, params, xs, y, start, 0.2, 0.05)
    got_x, _, got_h, eta = autopgd_run_plain(
        ta.tables, ta.constraints, ta.schedule(0.2, 0.05, t), torch.as_tensor(xs), torch.as_tensor(y),
        torch.as_tensor(start), 0.2, ta.clip, norm, "repair" in loss, False, ta.history_layout(),
    )
    _close_x(got_x.numpy(), want_x, name, "repair" in loss, f"{name} x_best")
    np.testing.assert_array_equal(eta.numpy(), want_eta)
    if record is not None:
        _close_hist(got_h.numpy(), want_h, name)


@pytest.mark.parametrize("name", ["lcld_spec", "botnet_spec"])
def test_restarts_fed_jax_starts_match(runs, name):
    r, eps = 3, 0.3
    ja, ta, params, xs, y = _attack_pair(runs, name, ConstrainedPGD, JPGD, loss_evaluation="constraints+flip",
                                         norm=2, num_random_init=r, record_loss="reduced", eps=eps, eps_step=0.05,
                                         max_iter=T)
    key = jax.random.PRNGKey(ja.seed)
    best, hist, succ = jax.jit(ja._build(), static_argnums=6)(
        params, jnp.asarray(xs), jnp.asarray(y, jnp.int32), key, jnp.asarray(eps), jnp.asarray(0.05), T
    )
    starts = [torch.as_tensor(np.array(ja._random_start(jax.random.fold_in(key, k), jnp.asarray(xs), eps)))
              for k in range(r)]
    got_x, got_h, got_succ = ta.attack(torch.as_tensor(xs), torch.as_tensor(y), ta.schedule(eps, 0.05, T), eps,
                                       starts)
    np.testing.assert_array_equal(got_succ.numpy(), np.asarray(succ))
    _close(got_x.numpy(), best, np.float64, "best_x")
    _close_hist(got_h.numpy(), np.asarray(hist), "history")


def test_generate_runs_on_every_spec_domain_on_the_cpu(runs):
    """``generate`` through the plain version on the CPU, as the runners
    call it: within the ε-ball, immutable features kept, finite."""
    for name, (_, tcons, x, scaler, _, tree) in runs.items():
        xs = np.clip(scaler.transform(x), 0.0, 1.0).astype(np.float32)
        for cls in (ConstrainedPGD, AutoPGD):
            atk = cls(Surrogate(params_from_numpy(tree, torch.float32)), tcons, scaler, eps=0.1, eps_step=0.02,
                      max_iter=5, norm=np.inf, loss_evaluation="constraints+flip", device="cpu")
            out = atk.generate(xs, np.arange(len(x)) % 2)
            mut = np.asarray(tcons.get_mutable_mask())
            assert np.isfinite(out).all(), name
            assert np.all(np.abs(out - xs) <= 0.1 + 1e-6), name
            np.testing.assert_array_equal(out[:, ~mut], xs[:, ~mut])

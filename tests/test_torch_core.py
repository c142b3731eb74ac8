"""Port parity of the domain core: schema, synthetic LCLD data, codec, norms,
LCLD constraints and scalers, against the JAX package on the same inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.core import codec as jcodec
from moeva2_ijcai22_replication_tpu.core import norms as jnorms
from moeva2_ijcai22_replication_tpu.domains import synth as jsynth
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.domains.lcld import lcld_constraint_terms as j_terms
from moeva2_ijcai22_replication_tpu.models import scalers as jscalers
from moeva2_ijcai22_replication_tpu_torch.core import codec as tcodec
from moeva2_ijcai22_replication_tpu_torch.core import norms as tnorms
from moeva2_ijcai22_replication_tpu_torch.core.constraints import ConstraintViolationError
from moeva2_ijcai22_replication_tpu_torch.domains import synth as tsynth
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints as TLcld
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import lcld_constraint_terms as t_terms
from moeva2_ijcai22_replication_tpu_torch.models import scalers as tscalers

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_schema")
    tdir = tmp_path_factory.mktemp("torch_schema")
    jp = jsynth.synth_lcld_schema(str(jdir))
    tp = tsynth.synth_lcld_schema(str(tdir))
    return jp, tp, JLcld(jp["features"], jp["constraints"]), TLcld(tp["features"], tp["constraints"])


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.mark.parametrize("which", ["features", "constraints"])
def test_schema_csv_bytes_identical(schemas, which):
    jp, tp, _, _ = schemas
    with open(jp[which], "rb") as a, open(tp[which], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("seed", [0, 42, 11])
def test_synth_rows_identical_and_feasible(schemas, seed):
    _, _, jc, tc = schemas
    xj = jsynth.synth_lcld(64, jc.schema, seed=seed)
    xt = tsynth.synth_lcld(64, tc.schema, seed=seed)
    np.testing.assert_array_equal(xj, xt)
    tc.check_constraints_error(xt)


def test_months_matches():
    d = np.array([201203.0, 198001.0, 201812.0, 200007.0])
    np.testing.assert_array_equal(tsynth.months(d), jsynth._months(d))
    np.testing.assert_array_equal(tsynth.months(_t(d)).numpy(), tsynth.months(d))


def test_schema_bounds_and_groups(schemas):
    _, _, jc, tc = schemas
    for a, b in zip(jc.schema.bounds(), tc.schema.bounds()):
        np.testing.assert_array_equal(a, b)
    assert [g.tolist() for g in jc.schema.ohe_groups()] == [g.tolist() for g in tc.schema.ohe_groups()]


def test_codec_tables_match(schemas):
    _, _, jc, tc = schemas
    cj, ct = jcodec.make_codec(jc.schema), tcodec.make_codec(tc.schema)
    assert (cj.gen_length, cj.n_features, cj.n_groups) == (ct.gen_length, ct.n_features, ct.n_groups)
    for name in ("non_ohe_ml_idx", "group_ml_idx", "group_pad_mask", "group_sizes", "int_mask_gen", "mutable_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(cj, name)), getattr(ct, name).numpy())


@pytest.mark.parametrize("seed", [1, 2])
def test_codec_roundtrip_and_outputs_match(schemas, seed):
    _, _, jc, tc = schemas
    cj, ct = jcodec.make_codec(jc.schema), tcodec.make_codec(tc.schema)
    x = tsynth.synth_lcld(32, tc.schema, seed=seed)
    gj = np.asarray(jcodec.ml_to_genetic(cj, jnp.asarray(x)))
    gt = tcodec.ml_to_genetic(ct, _t(x))
    np.testing.assert_array_equal(gj, gt.numpy())
    # round trip, as tests/test_schema_codec.py does
    back = tcodec.genetic_to_ml(ct, gt, _t(x))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-12)
    # perturbed genes (categoricals pushed across their range) decode alike
    rng = np.random.default_rng(seed)
    g2 = gj + rng.normal(size=gj.shape)
    g2[:, -1] = rng.integers(0, 14, len(g2))
    dj = np.asarray(jcodec.genetic_to_ml(cj, jnp.asarray(g2), jnp.asarray(x)))
    dt = tcodec.genetic_to_ml(ct, _t(g2), _t(x)).numpy()
    np.testing.assert_array_equal(dj, dt)
    assert np.array_equal(dt[:, ~tc.schema.mutable], x[:, ~tc.schema.mutable])
    # batched decode against broadcast initial states
    pop = np.stack([g2, gj], axis=1)
    dj = np.asarray(jcodec.genetic_to_ml(cj, jnp.asarray(pop), jnp.asarray(x)[:, None]))
    dt = tcodec.genetic_to_ml(ct, _t(pop), _t(x)[:, None]).numpy()
    np.testing.assert_array_equal(dj, dt)


def test_codec_helpers_match(schemas):
    _, _, jc, tc = schemas
    cj, ct = jcodec.make_codec(jc.schema), tcodec.make_codec(tc.schema)
    x = tsynth.synth_lcld(16, tc.schema, seed=5)
    xl, xu = (np.broadcast_to(a, x.shape) for a in tc.schema.bounds(x))
    for a, b in zip(jcodec.genetic_bounds(cj, jnp.asarray(xl), jnp.asarray(xu)), tcodec.genetic_bounds(ct, _t(xl), _t(xu))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jcodec.minmax_normalize(jnp.asarray(x), jnp.asarray(xl), jnp.asarray(xu))),
        tcodec.minmax_normalize(_t(x), _t(xl), _t(xu)).numpy(),
    )
    y = tcodec.minmax_normalize(_t(x), _t(xl), _t(xu))
    np.testing.assert_allclose(tcodec.minmax_denormalize(y, _t(xl), _t(xu)).numpy(), x, rtol=1e-12)
    g = np.random.default_rng(0).normal(size=(16, ct.gen_length)) * 3.5
    g[:, 0] = 2.5  # a half: both round half to even
    np.testing.assert_array_equal(
        np.asarray(jcodec.round_int_genes(cj, jnp.asarray(g))), tcodec.round_int_genes(ct, _t(g)).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jcodec.clip_genetic(jnp.asarray(g), -1.0, 1.0)),
        tcodec.clip_genetic(_t(g), _t(-1.0), _t(1.0)).numpy(),
    )
    soft = x + np.random.default_rng(1).uniform(-0.4, 0.4, x.shape)
    (ji, jm), (ti, tm) = jcodec.full_ohe_tables(jc.schema), tcodec.full_ohe_tables(tc.schema)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(
        np.asarray(jcodec.harden_onehot(jnp.asarray(soft), ji, jm)), tcodec.harden_onehot(_t(soft), ti, tm).numpy()
    )
    np.testing.assert_allclose(
        np.asarray(jcodec.all_ohe_groups_distance(ji, jm, jnp.asarray(soft))),
        tcodec.all_ohe_groups_distance(ti, tm, _t(soft)).numpy(),
        rtol=0, atol=1e-12,
    )


@pytest.mark.parametrize("norm", [2, np.inf, "inf"])
def test_lp_distance_matches(norm):
    d = np.random.default_rng(3).normal(size=(5, 7, 47))
    np.testing.assert_allclose(
        np.asarray(jnorms.lp_distance(jnp.asarray(d), norm)), tnorms.lp_distance(_t(d), norm).numpy(),
        rtol=1e-15, atol=0,
    )
    assert tnorms.validate_norm(norm) == norm


def _norm_rows(dtype):
    """Rows of every kind the norms see: mixed signs, a zero row, a row with
    one non-zero entry, tiny and large entries."""
    d = np.random.default_rng(4).normal(size=(6, 47))
    d[1] = 0.0
    d[2, 1:] = 0.0
    d[3] *= 1e-20
    d[4] *= 1e6
    return d.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("norm", [1, 2, np.inf, "inf", "2"])
def test_condition_grad_matches(norm, dtype):
    d = _norm_rows(dtype)
    want = np.asarray(jnorms.condition_grad(jnp.asarray(d), norm))
    got = tnorms.condition_grad(torch.as_tensor(d), norm).numpy()
    assert got.dtype == dtype
    # the port sums left to right, JAX's reduction in its own order
    np.testing.assert_allclose(got, want, rtol=1e-15 if dtype == np.float64 else 1e-6, atol=0)
    assert not got[1].any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("norm", [2, np.inf, "linf"])
@pytest.mark.parametrize("eps", [0.2, 1e-3])
def test_project_ball_matches(norm, dtype, eps):
    d = _norm_rows(dtype) * dtype(0.1)
    want = np.asarray(jnorms.project_ball(jnp.asarray(d), eps, norm))
    got = tnorms.project_ball(torch.as_tensor(d), eps, norm).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=1e-15 if dtype == np.float64 else 1e-6, atol=0)
    assert not got[1].any()
    if tnorms.is_l2(norm):
        assert (np.sqrt((got.astype(np.float64) ** 2).sum(-1)) <= eps * (1 + 1e-6)).all()


def test_project_ball_refuses_l1():
    with pytest.raises(NotImplementedError):
        jnorms.project_ball(jnp.zeros((2, 3)), 0.1, 1)
    with pytest.raises(NotImplementedError):
        tnorms.project_ball(torch.zeros((2, 3)), 0.1, 1)


def test_unsupported_norm_raises():
    with pytest.raises(NotImplementedError):
        tnorms.validate_norm(1)
    assert tnorms.is_l2("2") and tnorms.is_inf("linf") and not tnorms.is_l2(np.inf)


@pytest.mark.parametrize("kind", ["feasible", "perturbed"])
def test_lcld_constraints_match(schemas, kind):
    _, _, jc, tc = schemas
    x = tsynth.synth_lcld(128, tc.schema, seed=7)
    if kind == "perturbed":
        rng = np.random.default_rng(8)
        x = x * (1.0 + rng.normal(scale=0.05, size=x.shape))
        x[::7, 11] = 0.0  # zero denominators in the ratio constraint
        x[::5, 22] = 0.0
    np.testing.assert_allclose(
        np.asarray(j_terms(jnp.asarray(x))), t_terms(_t(x)).numpy(), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(jc.evaluate(jnp.asarray(x))), tc.evaluate(_t(x)).numpy(), rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(jc.evaluate_smooth(jnp.asarray(x))), tc.evaluate_smooth(_t(x)).numpy(), rtol=0, atol=1e-9
    )
    g = np.abs(np.random.default_rng(2).normal(size=(4, 10)))
    np.testing.assert_allclose(np.asarray(jc.normalise(jnp.asarray(g))), tc.normalise(_t(g)).numpy(), rtol=1e-15)
    if kind == "perturbed":
        with pytest.raises(ConstraintViolationError):
            tc.check_constraints_error(x)


def test_lcld_repair_matches(schemas):
    _, _, jc, tc = schemas
    x = tsynth.synth_lcld(32, tc.schema, seed=9)
    rng = np.random.default_rng(9)
    x[:, 1] = rng.uniform(30, 66, len(x))
    x[:, 26:47] += rng.uniform(0, 0.5, (len(x), 21))
    np.testing.assert_allclose(
        np.asarray(jc.repair(jnp.asarray(x))), tc.repair(_t(x)).numpy(), rtol=0, atol=1e-9
    )


def test_minmax_matches():
    lo = np.array([0.0, -1.0, 5.0, 2.0])
    hi = np.array([1.0, 3.0, 5.0, 10.0])
    js, ts = jscalers.fit_minmax(lo, hi), tscalers.fit_minmax(lo, hi)
    np.testing.assert_array_equal(js.scale, ts.scale)
    np.testing.assert_array_equal(js.min_, ts.min_)
    x = np.random.default_rng(0).uniform(-1, 10, (6, 4))
    np.testing.assert_array_equal(np.asarray(js.transform(jnp.asarray(x))), ts.transform(_t(x)).numpy())
    np.testing.assert_allclose(ts.inverse(ts.transform(_t(x))).numpy(), x, rtol=1e-12)
    np.testing.assert_array_equal(ts.transform(x), ts.transform(_t(x)).numpy())

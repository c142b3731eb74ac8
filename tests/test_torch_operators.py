"""Port parity of the genetic operators, fed the JAX package's own draws.

The JAX operators draw from threefry keys (``operators.py:105-254``); the
port takes its draws as tensors. :func:`jax_offspring_draws` replays the
JAX key splits of ``make_offspring`` and hands the same numbers to the
port, whose offspring must then equal the JAX offspring exactly in float64,
up to the last-ulp rounding of pow() in the mutation of real genes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import operators as jop
from moeva2_ijcai22_replication_tpu.core import codec as jcodec
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import operators as top
from moeva2_ijcai22_replication_tpu_torch.core import codec as tcodec
from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


def jax_offspring_draws(keys, n_offsprings: int, gen_length: int, pop_size: int, dtype=jnp.float64):
    """The draws ``make_offspring`` consumes under each per-state key, as the
    port's :class:`OffspringDraws` (float64 CPU tensors)."""
    n_mat = (n_offsprings + 1) // 2
    pairs, cut_a, cut_b, coins, sel, u = [], [], [], [], [], []
    for key in keys:
        k_sel, k_cx, k_mut = jax.random.split(key, 3)
        pairs.append(jax.random.randint(k_sel, (n_mat, 2), 0, pop_size))
        k_coin_r, k_coin_i, k_coin_s, k_real, k_int, k_sm = jax.random.split(k_cx, 6)
        a, b, c = [], [], []
        for k_cut, k_coin in ((k_real, k_coin_r), (k_int, k_coin_i), (k_sm, k_coin_s)):
            k1, k2 = jax.random.split(k_cut)
            a.append(jax.random.randint(k1, (n_mat,), 0, 1 << 30))
            b.append(jax.random.randint(k2, (n_mat,), 0, 1 << 30))
            c.append(jax.random.uniform(k_coin, (n_mat,)))
        cut_a.append(a)
        cut_b.append(b)
        coins.append(c)
        k_s, k_u = jax.random.split(k_mut)
        sel.append(jax.random.uniform(k_s, (n_offsprings, gen_length), dtype=dtype))
        u.append(jax.random.uniform(k_u, (n_offsprings, gen_length), dtype=dtype))
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    per_type = lambda a: t(np.swapaxes(np.asarray(a), 0, 1))  # noqa: E731
    return top.OffspringDraws(
        pairs=t(pairs).long(),
        cut_a=per_type(cut_a).long(),
        cut_b=per_type(cut_b).long(),
        coins=per_type(coins),
        mut_select=t(sel),
        mut_u=t(u),
    )


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    paths = synth_lcld_schema(str(tmp_path_factory.mktemp("ops")))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    return cons, jcodec.make_codec(cons.schema), tcodec.make_codec(cons.schema)


def _population(problem, s, p, seed):
    cons, cj, _ = problem
    x = synth_lcld(s, cons.schema, seed=seed)
    xl, xu = (np.broadcast_to(a, x.shape) for a in cons.get_feature_min_max(x))
    xlg, xug = (np.array(a) for a in jcodec.genetic_bounds(cj, jnp.asarray(xl), jnp.asarray(xu)))
    rng = np.random.default_rng(seed)
    g0 = np.asarray(jcodec.ml_to_genetic(cj, jnp.asarray(x)))[:, None, :]
    pop = g0 + rng.normal(size=(s, p, cj.gen_length)) * (xug - xlg)[:, None, :] * 0.2
    pop = np.clip(pop, xlg[:, None], xug[:, None])
    pop = np.where(np.asarray(cj.int_mask_gen), np.round(pop), pop)
    pop[:, 0] = g0[:, 0]  # an unperturbed row: genes sitting on their bounds
    return pop, xlg, xug


def test_operator_tables_match(problem):
    _, cj, ct = problem
    jt, tt = jop.make_operator_tables(cj), top.make_operator_tables(ct)
    np.testing.assert_array_equal(np.asarray(jt.type_id), tt.type_id.numpy())
    np.testing.assert_array_equal(np.asarray(jt.rank_in_type), tt.rank_in_type.numpy())
    assert tuple(np.asarray(jt.type_sizes)) == tt.type_sizes
    np.testing.assert_array_equal(np.asarray(jt.mut_prob), tt.mut_prob.numpy())


@pytest.mark.parametrize("n", [0, 1, 2, 3, 9])
def test_two_cuts_matches(n):
    key = jax.random.PRNGKey(n)
    lo_j, hi_j = jop._two_cuts(key, jnp.int32(n), (200,))
    k1, k2 = jax.random.split(key)
    a = torch.as_tensor(np.array(jax.random.randint(k1, (200,), 0, 1 << 30))).long()
    b = torch.as_tensor(np.array(jax.random.randint(k2, (200,), 0, 1 << 30))).long()
    lo_t, hi_t = top.two_cuts(a, b, n)
    np.testing.assert_array_equal(np.asarray(lo_j), lo_t.numpy())
    np.testing.assert_array_equal(np.asarray(hi_j), hi_t.numpy())


@pytest.mark.parametrize("s,p,n_off,seed", [(4, 12, 9, 0), (6, 43, 20, 1), (3, 103, 100, 2)])
def test_make_offspring_exact_with_jax_draws(problem, s, p, n_off, seed):
    _, cj, ct = problem
    pop, xlg, xug = _population(problem, s, p, seed)
    keys = jax.random.split(jax.random.PRNGKey(100 + seed), s)
    jt = jop.make_operator_tables(cj)
    want = np.stack([
        np.asarray(jop.make_offspring(k, jt, jnp.asarray(pop[i]), jnp.asarray(xlg[i]), jnp.asarray(xug[i]), n_off))
        for i, k in enumerate(keys)
    ])
    draws = jax_offspring_draws(keys, n_off, cj.gen_length, p)
    tt = top.make_operator_tables(ct)
    got = top.make_offspring(
        tt, torch.as_tensor(pop), torch.as_tensor(xlg), torch.as_tensor(xug), n_off, draws
    ).numpy()
    # selection + crossover alone: exact
    rows = np.arange(s)[:, None]
    pt = torch.as_tensor(pop)
    c1, c2 = top.two_point_crossover(
        tt, pt[rows, draws.pairs[..., 0]], pt[rows, draws.pairs[..., 1]],
        draws.cut_a, draws.cut_b, draws.coins,
    )
    children = torch.cat([c1, c2], 1)[:, :n_off].numpy()
    mutated = (draws.mut_select.numpy() < tt.mut_prob.numpy()) & (xug > xlg)[:, None, :]
    # every gene the polynomial mutation did not touch, and every rounded
    # integer gene, is exact; a mutated real gene went through pow(), whose
    # last-ulp rounding differs between XLA and PyTorch (about 1% of
    # arguments), so it is held to 1e-15 relative
    exact = ~mutated | tt.int_mask.numpy()
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_equal(children[~mutated], want[~mutated])
    np.testing.assert_allclose(got[~exact], want[~exact], rtol=1e-15, atol=0)
    assert (~exact).sum() > 0 and (got != children).any()


def test_draw_offspring_shapes_and_ranges():
    d = top.draw_offspring(PhiloxStream(0), 5, 43, 21, 17, dtype=torch.float64)
    assert d.pairs.shape == (5, 11, 2) and int(d.pairs.max()) < 43 and int(d.pairs.min()) >= 0
    assert d.cut_a.shape == (3, 5, 11) and int(d.cut_b.max()) < 1 << 30
    assert d.coins.shape == (3, 5, 11) and d.coins.dtype == torch.float64
    assert d.mut_u.shape == (5, 21, 17) and float(d.mut_u.max()) < 1.0


def test_softmax_genes_are_rejected(tmp_path):
    from moeva2_ijcai22_replication_tpu_torch.core.schema import FeatureSchema

    path = tmp_path / "f.csv"
    path.write_text(
        "feature,type,mutable,min,max\na,softmax,TRUE,0,1\nb,softmax,TRUE,0,1\nc,real,TRUE,0,1\n"
    )
    with pytest.raises(NotImplementedError):
        top.make_operator_tables(tcodec.make_codec(FeatureSchema.from_csv(str(path))))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_offspring_float32_with_jax_draws(problem, seed):
    """float32, with zero-range genes and integer genes at half-integers:
    equal to JAX except a mutated real gene, whose pow() the port takes in
    float64 rounded once while XLA takes it in float32: within 1e-6 of the
    gene's range (measured equal here)."""
    _, cj, ct = problem
    s, p, n_off = 5, 43, 40
    pop, xlg, xug = _population(problem, s, p, seed)
    xug = xug.copy()
    xug[:, ::5] = xlg[:, ::5]  # zero-range genes
    pop = np.clip(pop, xlg[:, None], xug[:, None])
    int_mask = np.asarray(cj.int_mask_gen)
    pop[:, 1::3] = np.where(int_mask, np.floor(pop[:, 1::3]) + 0.5, pop[:, 1::3])  # half-integers
    pop, xlg, xug = (a.astype(np.float32) for a in (pop, xlg, xug))
    keys = jax.random.split(jax.random.PRNGKey(200 + seed), s)
    jt = jop.make_operator_tables(cj)
    want = np.stack([
        np.asarray(jop.make_offspring(k, jt, jnp.asarray(pop[i]), jnp.asarray(xlg[i]), jnp.asarray(xug[i]), n_off))
        for i, k in enumerate(keys)
    ])
    draws = jax_offspring_draws(keys, n_off, cj.gen_length, p, dtype=jnp.float32)
    tt = top.make_operator_tables(ct)
    got = top.make_offspring(tt, *map(torch.as_tensor, (pop, xlg, xug)), n_off, draws).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    mutated = (draws.mut_select.numpy() < tt.mut_prob.numpy().astype(np.float32)) & (xug > xlg)[:, None, :]
    exact = ~mutated | int_mask
    span = np.broadcast_to((xug - xlg)[:, None, :], got.shape)
    err = np.abs(got - want)[~exact] / span[~exact]
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_array_less(err, 1e-6)

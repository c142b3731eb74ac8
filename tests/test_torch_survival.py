"""Port parity of R-NSGA-III survival: niche association against the JAX
``associate_batch`` (one-shot and blocked), ``survive_batch`` against the
JAX ``survive_batch`` given the same gumbels, and ``survive_batch`` against
the jax-free pymoo oracle ``tests/oracles/pymoo_rnsga3.py`` the way
``tests/test_survival_pymoo_diff.py`` holds the JAX survival."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import survival as jsv
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import survival as tsv
from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream
from oracles import pymoo_rnsga3 as oracle

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

N_OBJ = 3
K1 = np.full((1, N_OBJ), 1.0 / N_OBJ)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _objectives(rng, s, m, kind="uniform"):
    f = rng.uniform(size=(s, m, N_OBJ))
    if kind == "scaled":
        f = f * rng.uniform(0.5, 20.0, size=N_OBJ) + rng.uniform(-5.0, 5.0, size=N_OBJ)
    elif kind == "dup":
        k = max(1, m // 3)
        f[:, m - k :] = f[:, :k]
    elif kind == "discrete":
        f = rng.integers(0, 3, size=(s, m, N_OBJ)).astype(float)
    elif kind == "const_col":
        f[..., rng.integers(0, N_OBJ)] = 0.7
    return f


@pytest.mark.parametrize("block", [None, 64])
@pytest.mark.parametrize("kind", ["uniform", "dup", "discrete"])
def test_associate_plain_matches_jax(block, kind):
    rng = np.random.default_rng(len(kind))
    s, m, r = 8, 63, 43
    f = _objectives(rng, s, m, kind)
    dirs = np.concatenate(
        [rng.dirichlet(np.ones(3), (s, r - 3)), np.broadcast_to(np.eye(3), (s, 3, 3))], axis=1
    )
    ideal, nadir = f.min(1), f.max(1)
    nadir[0, 1] = ideal[0, 1]  # a zero range
    nj, dj = jsv.associate_batch(*(jnp.asarray(a) for a in (f, dirs, ideal, nadir)), block=block)
    nt, dt = tsv.associate_plain(*(_t(a) for a in (f, dirs, ideal, nadir)))
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=0, atol=1e-12)
    assert nt.dtype == torch.int64
    # the CPU entry point is the plain version
    nb, db = tsv.associate_batch(*(_t(a) for a in (f, dirs, ideal, nadir)))
    assert torch.equal(nb, nt) and torch.equal(db, dt)


def test_associate_plain_matches_jax_on_inf_objectives():
    """An inf objective under a finite ideal and nadir (a ratio constraint
    whose denominator a mutation set to 0) projects to inf * 0 = NaN on the
    axis directions and to inf on the others: ``jnp.argmax`` and
    ``torch.argmax`` count NaN as the largest value, so the niche is the
    first axis that is not the inf objective's, and dist is NaN."""
    rng = np.random.default_rng(11)
    s, m, r = 6, 40, 23
    f = _objectives(rng, s, m)
    dirs = np.concatenate(
        [rng.dirichlet(np.ones(3), (s, r - 3)), np.broadcast_to(np.eye(3), (s, 3, 3))], axis=1
    )
    ideal, nadir = f.min(1), f.max(1)
    inf_rows = rng.random((s, m)) < 0.2
    k = rng.integers(0, N_OBJ, size=(s, m))
    f[inf_rows, k[inf_rows]] = np.inf
    nj, dj = jsv.associate_batch(*(jnp.asarray(a) for a in (f, dirs, ideal, nadir)))
    nt, dt = tsv.associate_plain(*(_t(a) for a in (f, dirs, ideal, nadir)))
    np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=0, atol=1e-12)
    first_other_axis = r - 3 + np.where(k == 0, 1, 0)
    np.testing.assert_array_equal(nt.numpy()[inf_rows], first_other_axis[inf_rows])
    assert np.isnan(dt.numpy()[inf_rows]).all() and np.isfinite(dt.numpy()[~inf_rows]).all()


#: K3's edge inputs, the kinds chip_smoke.py's K3_EDGES holds the kernel on
#: (float64 here): mixed, one all-NaN state, zero ranges (1e-12
#: denominators) under a column scaled by 1e8, signed zeros and tiny
#: values, a zero direction. M and R around the blocked form's 64 and the
#: kernel's unroll of 4
ASSOC_EDGE_KINDS = ("mixed", "allnan", "degenerate", "tiny", "zerodir")
ASSOC_EDGE_SHAPES = ((1, 1), (31, 3), (40, 4), (63, 33), (64, 103), (7, 203))


def _assoc_edge(kind, s, m, r, seed):
    """(f, dirs, ideal, nadir) float64. Every kind has duplicated rows and
    duplicated directions (d and 2d: exact ties in any summation order) and
    rows with an inf objective."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(size=(s, m, N_OBJ))
    f[:, m - m // 5 :] = f[:, : m // 5]
    f[rng.random((s, m)) < 0.1, rng.integers(0, N_OBJ)] = np.inf
    dirs = rng.dirichlet(np.ones(N_OBJ), (s, r))
    if kind == "allnan":
        f[0] = np.nan
    if kind == "degenerate":
        f[..., 1] *= 1e8
    if kind == "tiny":
        tiny = np.array([-0.0, 0.0, 1e-45, -1e-45, 3e-42, 1e-39, 0.5, 1.0])
        f = rng.choice(tiny, size=(s, m, N_OBJ))
        dirs = np.where(rng.random((s, r, N_OBJ)) < 0.3, rng.choice(tiny, size=(s, r, N_OBJ)), dirs)
    a = min(r, N_OBJ)
    dirs[:, r - a :] = np.eye(N_OBJ)[:a]  # the axes, last as in survival
    k = r // 3
    dirs[:, k : 2 * k] = dirs[:, :k] * 2.0
    if kind == "zerodir":
        dirs[:, r // 2] = 0.0
    finite = np.where(np.isfinite(f), f, 0.0)
    ideal, nadir = finite.min(1), finite.max(1)
    if kind == "degenerate":
        nadir[:, 1] = ideal[:, 1]
        nadir[-1] = ideal[-1]
    if kind == "tiny":
        ideal[:], nadir[:] = 0.0, 1.0
    return f, dirs, ideal, nadir


@pytest.mark.parametrize("block", [None, 64])
@pytest.mark.parametrize("m,r", ASSOC_EDGE_SHAPES)
@pytest.mark.parametrize("kind", ASSOC_EDGE_KINDS)
def test_associate_plain_matches_jax_at_the_kernels_edges(kind, m, r, block):
    """Niche exactly and dist within 1e-12 in units of max(1, |n|) (the
    degenerate states' n reach 1e19; where |n| <= 1 this is the 1e-12 of
    the tests above). The blocked JAX form never takes a NaN projection
    (``p2_blk > best_p2`` is false for NaN), where ``argmax`` and the
    one-shot form take the first: a caveat of the reference, so the blocked
    form is held on the rows without a NaN projection (dist not NaN)."""
    f, dirs, ideal, nadir = _assoc_edge(kind, 3, m, r, seed=1000 * m + r)
    with np.errstate(all="ignore"):
        nj, dj = (np.asarray(a) for a in jsv.associate_batch(*(jnp.asarray(a) for a in (f, dirs, ideal, nadir)),
                                                              block=block))
    nt, dt = (a.numpy() for a in tsv.associate_plain(*(_t(a) for a in (f, dirs, ideal, nadir))))
    denom = np.where(nadir == ideal, 1e-12, nadir - ideal)
    scale = np.maximum(1.0, np.sqrt((((f - ideal[:, None]) / denom[:, None]) ** 2).sum(-1)))
    rows = ~np.isnan(dt) if block else np.ones_like(dt, dtype=bool)
    np.testing.assert_array_equal(nj[rows], nt[rows])
    np.testing.assert_array_equal(np.isnan(dj[rows]), np.isnan(dt[rows]))
    np.testing.assert_array_equal(np.isinf(dj[rows]), np.isinf(dt[rows]))
    fin = rows & np.isfinite(dt)
    assert (np.abs(dj - dt)[fin] <= 1e-12 * scale[fin]).all()
    if kind in ("mixed", "zerodir") and r > 1:
        assert np.isnan(dt).any()  # the NaN projections are there to be held


def test_plain_association_sqrt_is_correctly_rounded():
    # the kernel's sqrtf is correctly rounded, and so is numpy's float32
    # sqrt; the plain version must round the same on every device
    x = np.random.default_rng(5).uniform(0, 10, 1 << 16).astype(np.float32)
    np.testing.assert_array_equal(tsv._sqrt_rn(torch.as_tensor(x)).numpy(), np.sqrt(x))


def test_associate_float32_within_tolerance():
    rng = np.random.default_rng(0)
    f = _objectives(rng, 4, 40)
    dirs = rng.dirichlet(np.ones(3), (4, 23))
    ideal, nadir = f.min(1), f.max(1)
    nj, dj = jsv.associate_batch(*(jnp.asarray(a) for a in (f, dirs, ideal, nadir)))
    nt, dt = tsv.associate_plain(*(torch.as_tensor(a, dtype=torch.float32) for a in (f, dirs, ideal, nadir)))
    assert (np.asarray(nj) == nt.numpy()).mean() > 0.99
    same = np.asarray(nj) == nt.numpy()
    # dist² = |n|² − proj² cancels: with |n|² ≤ 3 its float32 error is a few
    # ulps of 3 (< 2e-6), which the sqrt magnifies near zero distance, so
    # the squared distance is what has a fixed float32 bound
    np.testing.assert_allclose(
        np.asarray(dj)[same] ** 2, dt.numpy()[same].astype(np.float64) ** 2, rtol=0, atol=2e-6
    )


def _jax_state(st: tsv.NormState):
    return jsv.NormState(*(jnp.asarray(a.numpy()) for a in st))


@pytest.mark.parametrize("kind", ["uniform", "scaled", "dup", "discrete", "const_col"])
def test_survive_batch_matches_jax_with_same_gumbels(kind):
    rng = np.random.default_rng(100 + len(kind))
    s, n_survive, a = 6, 23, 20
    m = n_survive + 20
    asp = rng.dirichlet(np.ones(3), a)
    st_t = tsv.NormState.init(s, N_OBJ, torch.float64)
    st_j = jax.vmap(lambda _: jsv.NormState.init(N_OBJ, jnp.float64))(jnp.arange(s))
    key = jax.random.PRNGKey(len(kind))
    for gen in range(4):
        f = _objectives(rng, s, m if gen else n_survive, kind)
        key, k = jax.random.split(key)
        mask_j, st_j, ranks_j = jsv.survive_batch(k, jnp.asarray(f), jnp.asarray(asp), st_j, n_survive)
        gum_cut, gum_mem = jsv._niche_gumbels(k, (s,), a + N_OBJ, f.shape[1])
        mask_t, st_t, ranks_t = tsv.survive_batch(
            _t(f), _t(asp), st_t, n_survive, _t(gum_cut), _t(gum_mem)
        )
        np.testing.assert_array_equal(np.asarray(ranks_j), ranks_t.numpy())
        np.testing.assert_array_equal(np.asarray(mask_j), mask_t.numpy())
        assert (mask_t.sum(1) == n_survive).all()
        for name, want, got in zip(st_t._fields, st_j, st_t):
            np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-12, atol=1e-12, err_msg=name)
        st_j = _jax_state(st_t)  # carry identical state into the next round


@pytest.mark.parametrize("case", range(24))
def test_survive_matches_pymoo_oracle_shared_trace(case):
    """EXACT survivor sets through the random niching paths: the oracle takes
    the same two gumbel fields as priorities (``niche_priority`` /
    ``member_priority``) over a 3-generation sequence."""
    kinds = ["uniform", "scaled", "dup", "discrete", "const_col"]
    shapes = [(18, 11, 8), (12, 6, 5), (28, 14, 12)]
    kind = kinds[case % len(kinds)]
    m, n_survive, a = shapes[case % len(shapes)]
    rng = np.random.default_rng(300_000 + case)
    asp = rng.dirichlet(np.ones(N_OBJ), a)
    st_o = oracle.OracleNormState(N_OBJ)
    st_t = tsv.NormState.init(1, N_OBJ, torch.float64)
    for gen in range(3):
        f = _objectives(rng, 1, n_survive if gen == 0 else m, kind)[0]
        gum_cut = rng.gumbel(size=a + N_OBJ)
        gum_mem = rng.gumbel(size=len(f))
        mask, st_t, ranks = tsv.survive_batch(
            _t(f[None]), _t(asp), st_t, n_survive, _t(gum_cut[None]), _t(gum_mem[None])
        )
        idx_o, dbg = oracle.aspiration_survive(
            f, asp, K1, n_survive, st_o, np.random.RandomState(0),
            nadir_solver="cramer", niche_priority=gum_cut, member_priority=gum_mem,
        )
        np.testing.assert_allclose(st_t.ideal[0].numpy(), dbg["ideal"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(st_t.worst[0].numpy(), dbg["worst"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(st_t.extreme[0].numpy(), dbg["extreme"], rtol=1e-7, atol=1e-9)
        ranked = dbg["rank"] < len(f)
        r = ranks[0].numpy()
        assert ((r != tsv.UNRANKED) == ranked).all()
        assert (r[ranked] == dbg["rank"][ranked]).all()
        assert sorted(np.where(mask[0].numpy())[0].tolist()) == sorted(np.asarray(idx_o).tolist())


def test_draw_gumbels_shapes():
    gc, gm = tsv.draw_gumbels(PhiloxStream(0), 3, 7, 11, torch.float64)
    assert gc.shape == (3, 7) and gm.shape == (3, 11) and torch.isfinite(gm).all()


def _nonfinite(rng, f):
    """NaN, +inf and -inf objective rows, as ratio constraints with 0
    denominators and hand-made sweeps produce them."""
    f = f.copy()
    s, m, _ = f.shape
    f[rng.random((s, m)) < 0.05, 1] = np.nan
    f[rng.random((s, m)) < 0.05, 2] = np.inf
    f[rng.random((s, m)) < 0.02, 0] = -np.inf
    return f


@pytest.mark.parametrize("kind", ["uniform", "dup", "discrete", "nonfinite"])
def test_survive_norm_plain_matches_jax(kind):
    """The normalisation (K4a's semantics) against the JAX ``_survive_pre``
    over 3 rounds, float64, the state carried."""
    rng = np.random.default_rng(200 + len(kind))
    s, n_survive, a = 6, 23, 20
    m = n_survive + 20
    asp = rng.dirichlet(np.ones(3), a)
    st_t = tsv.NormState.init(s, N_OBJ, torch.float64)
    st_j = jax.vmap(lambda _: jsv.NormState.init(N_OBJ, jnp.float64))(jnp.arange(s))
    for _ in range(3):
        f = _objectives(rng, s, m, "uniform" if kind == "nonfinite" else kind)
        if kind == "nonfinite":
            f = _nonfinite(rng, f)
        ranks_j, dirs_j, nadir_j, new_j = jax.vmap(
            lambda f1, st: jsv._survive_pre(f1, jnp.asarray(asp), st, n_survive)
        )(jnp.asarray(f), st_j)
        ranks = tsv.nd_ranks(_t(f), n_survive)
        np.testing.assert_array_equal(np.asarray(ranks_j), ranks.numpy())
        new_t, nadir_t, dirs_t = tsv.survive_norm_plain(_t(f), ranks, _t(asp), st_t)
        for name, want, got in (*zip(new_t._fields, new_j, new_t), ("nadir", nadir_j, nadir_t), ("dirs", dirs_j, dirs_t)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12, err_msg=name)
        st_t, st_j = new_t, _jax_state(new_t)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "dup", "discrete", "nonfinite"])
def test_survive_fill_plain_matches_jax(kind, ties):
    """The fill (K4b's semantics) against the JAX ``_survive_post`` given the
    same ranks, niches, distances and gumbels: equal masks. ``ties`` makes
    every third cutoff priority and every fourth member priority equal."""
    rng = np.random.default_rng(400 + len(kind) + 10 * ties)
    s, n_survive, a = 8, 23, 20
    m = n_survive + 20
    asp = rng.dirichlet(np.ones(3), a)
    f = _objectives(rng, s, m, "uniform" if kind == "nonfinite" else kind)
    if kind == "nonfinite":
        f = _nonfinite(rng, f)
    ranks = tsv.nd_ranks(_t(f), n_survive)
    state, nadir, dirs = tsv.survive_norm_plain(_t(f), ranks, _t(asp), tsv.NormState.init(s, N_OBJ, torch.float64))
    niche, dist = tsv.associate_plain(_t(f), dirs, state.ideal, nadir)
    gum_cut, gum_mem = rng.gumbel(size=(s, a + N_OBJ)), rng.gumbel(size=(s, m))
    if ties:
        gum_cut[:, ::3] = 0.25
        gum_mem[:, ::4] = -0.5
    want = jax.vmap(
        lambda gc, gm, f1, r1, ni, di: jsv._survive_post(gc, gm, f1, r1, ni, di, a + N_OBJ, n_survive)
    )(*(jnp.asarray(np.asarray(v)) for v in (gum_cut, gum_mem, f, ranks, niche, dist)))
    got = tsv.survive_fill_plain(_t(gum_cut), _t(gum_mem), ranks, niche, dist, n_survive)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # equal priorities get equal places, so with ties the fill may take more
    # than n_survive, in the JAX engine as here; continuous gumbels never tie
    assert (got.sum(1) == n_survive).all() if not ties else (got.sum(1) >= n_survive).all()

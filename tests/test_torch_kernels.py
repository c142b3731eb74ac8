"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` build the kernels with nvcc and run them on the card;
without a card they skip (the decision is taken inside the fixture). Run
them on a machine with one NVIDIA card:

    python -m pytest tests/test_torch_kernels.py -m cuda

The CPU-side tests check what the wrappers do without a card: they refuse
CPU tensors rather than fall back, and importing them builds nothing.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import (
    PhiloxDraws, archive_select_plain, evaluate_hist_plain, evaluate_plain, extract_archive_plain,
    final_columns_plain,
    make_objective_tables, mlp_proba_plain, take_carry_plain,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import engine_quality_stats
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import (
    OperatorTables, draw_offspring, make_offspring_plain,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
    NormState, associate_plain, draw_gumbels, survive_fill_plain, survive_norm_plain, survive_stages,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.refdirs import (
    descent_schedule, energy_descent_plain, start_point,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import AutoPGD, ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.autopgd import autopgd_run_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import PgdTables, pgd_run_plain, restart
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream
from moeva2_ijcai22_replication_tpu_torch.kernels import build
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate
from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP, proba1_plain
from moeva2_ijcai22_replication_tpu_torch.models.train import stack_tensors
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.problems import (
    BOTNET_AUGMENTED_EDGE_ROWS, BOTNET_EDGE_ROWS, LCLD_AUGMENTED_EDGE_ROWS, LCLD_IMMUTABLE_TERMS, botnet_augmented_edge_rows,
    botnet_edge_starts, botnet_hard_candidates, lcld_augmented_edge_rows, lcld_immutable_repair_rows,
    lcld_immutable_term_schema, synthetic_botnet_augmented_problem, synthetic_botnet_pgd_problem,
    phishing_problem, spec_candidates, spec_edge_rows, synthetic_botnet_problem, synthetic_botnet_spec_problem,
    synthetic_family_problem, synthetic_lcld_augmented_problem, synthetic_lcld_problem, synthetic_lcld_spec_problem,
)

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _objectives(rng, s, m):
    f = rng.uniform(size=(s, m, 3))
    f[: s // 2] = np.round(f[: s // 2] * 4) / 4  # ties
    k = m // 5
    f[:, m - k :] = f[:, :k]  # duplicate rows
    f[rng.random((s, m)) < 0.02, 1] = np.nan
    f[rng.random((s, m)) < 0.02, 2] = np.inf  # a ratio constraint's 0 denominator
    return f.astype(np.float32)


def _finite_ideal_nadir(f):
    """Ideal and nadir over the finite objectives, as survival keeps them."""
    finite = torch.where(torch.isfinite(f), f, 0.0)
    return finite.amin(1), finite.amax(1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,n_stop", [(64, 203, 103), (537, 203, 103), (16, 303, 203), (8, 1024, 1024), (3, 1, 1),
                                      (9, 256, 128), (9, 1024, 512)])
def test_nd_peel_equals_plain(card, s, m, n_stop):
    f = torch.as_tensor(_objectives(np.random.default_rng(s + m), s, m), device=card)
    before = kernels.launch_counts()["nd_peel"]
    got = kernels.nd_peel(f, n_stop)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["nd_peel"] == before + 1
    assert torch.equal(got, nd_ranks_plain(f, n_stop))


#: K2's edges: one partial word, one full word, a word and one more, two
#: words, even word counts (8 and 32: rows padded to an odd stride), the
#: config's M = 303, and the kernel's limit
ND_PEEL_EDGE_M = (1, 31, 32, 33, 64, 256, 303, 1024)


def _edge_objectives(kind, s, m, seed):
    """(S, M, 3) objectives of K2's edge cases, as tests/test_torch_nds.py
    holds the plain version against JAX on them: mixed with NaN rows and an
    all-NaN first state, all NaN, equal rows (one front), a chain (M
    fronts: the deepest peel), or ties of signed zeros, infinities, float32
    extremes and denormals."""
    rng = np.random.default_rng(seed)
    f = _objectives(rng, s, m)
    f[0] = np.nan
    if kind == "allnan":
        f[:] = np.nan
    elif kind == "equal":
        f[:] = np.nan_to_num(f[:, m - 1 : m], nan=0.5, posinf=2.0)
    elif kind == "chain":
        f = (rng.uniform(0.1, 1.0, (s, m, 1)) * rng.uniform(0.2, 2.0, (s, 1, 3))).astype(np.float32)
    elif kind == "extremes":  # K2 compares by the sign of a difference
        big = np.finfo(np.float32).max
        vals = np.array([-np.inf, -big, -1, -1e-45, -0.0, 0.0, 1e-45, 3e-45, 1, big, np.inf], np.float32)
        f = rng.choice(vals, size=(s, m, 3))
        f[rng.random((s, m)) < 0.05, 1] = np.nan
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("m", ND_PEEL_EDGE_M)
@pytest.mark.parametrize("kind", ["nan", "allnan", "equal", "chain", "extremes"])
def test_nd_peel_equals_plain_at_edges(card, m, kind):
    # n_stop = 0 ranks nothing, M and M + 5 rank everything
    f = torch.as_tensor(_edge_objectives(kind, 3, m, seed=m), device=card)
    for n_stop in (0, m // 2, m, m + 5):
        assert torch.equal(kernels.nd_peel(f, n_stop), nd_ranks_plain(f, n_stop)), (kind, m, n_stop)


@pytest.mark.cuda
def test_survive_norm_rejects_too_many_candidates(card):
    state = NormState.init(1, 3, device=card)
    ranks = torch.zeros((1, 1025), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="at most 1024"):
        kernels.survive_norm(torch.zeros((1, 1025, 3), device=card), ranks, torch.ones((4, 3), device=card), state)
    with pytest.raises(ValueError, match="at most 1024"):
        kernels.survive_norm(torch.zeros((1, 5, 3), device=card), ranks[:, :5], torch.ones((1022, 3), device=card), state)


@pytest.mark.cuda
def test_nd_peel_rejects_too_many_candidates(card):
    with pytest.raises(ValueError):
        kernels.nd_peel(torch.zeros((1, 1025, 3), device=card), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m,r", [(64, 203, 103), (544, 203, 103), (540, 303, 203)])
def test_associate_equals_plain(card, s, m, r):
    rng = np.random.default_rng(s)
    f = torch.as_tensor(_objectives(rng, s, m), device=card)
    # simplex points, then the axes, like survival's directions: an inf
    # objective projects to NaN on two axes and to inf elsewhere
    dirs = np.concatenate([rng.dirichlet(np.ones(3), (s, r - 3)), np.broadcast_to(np.eye(3), (s, 3, 3))], axis=1)
    dirs = torch.as_tensor(dirs.astype(np.float32), device=card)
    ideal, nadir = _finite_ideal_nadir(f)
    niche, dist = kernels.associate(f, dirs, ideal, nadir)
    niche_p, dist_p = associate_plain(f, dirs, ideal, nadir)
    torch.cuda.synchronize()
    assert _same(niche, niche_p)
    assert _same(dist, dist_p)


#: a few of chip_smoke.py's K3_EDGES, (inputs, M, R): R of one direction,
#: below and at the unroll, around a warp, and 4096 (more than 48 KB of
#: staged directions)
ASSOCIATE_EDGES = (("mixed", 1, 1), ("zero direction", 31, 3), ("all NaN", 203, 4), ("nadir == ideal", 303, 33),
                   ("zeros and denormals", 203, 103), ("mixed", 1024, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,r", ASSOCIATE_EDGES)
def test_associate_equals_plain_at_edges(card, kind, m, r):
    import chip_smoke

    for s in (3, 5):
        args = [torch.as_tensor(a, device=card)
                for a in chip_smoke.associate_edge_inputs(np.random.default_rng(m + r), kind, s, m, r)]
        got, want = kernels.associate(*args), associate_plain(*args)
        torch.cuda.synchronize()
        assert _same(got[0], want[0]) and _same(got[1], want[1]), (kind, s, m, r)


@pytest.mark.cuda
def test_associate_rejects_too_many_directions(card):
    f, ideal = torch.zeros((1, 4, 3), device=card), torch.zeros((1, 3), device=card)
    with pytest.raises(ValueError, match="directions per state"):
        kernels.associate(f, torch.ones((1, 14529, 3), device=card), ideal, ideal + 1)


def _same(got, want) -> bool:
    """Equal entry for entry, NaN where NaN."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    return bool(((got == want) | (got.isnan() & want.isnan())).all())


@pytest.fixture(scope="module")
def lcld(tmp_path_factory):
    """The main path's problem: 1000 synthetic LCLD states, a seeded
    surrogate and its scaler."""
    return synthetic_lcld_problem(str(tmp_path_factory.mktemp("kernels")), 1000)


def _engine_state(card, lcld, s, seed, **knobs):
    """An engine on the card, its run inputs for ``s`` states, the carry
    after one generation and the next generation's draws."""
    cons, sur, scaler, x = lcld
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_pop=100, n_offsprings=100,
                 archive_size=24, seed=seed, **knobs)
    run = eng.prepare(x[:s], np.arange(s) % 2)
    gen = PhiloxStream(seed, card)
    carry = eng.init_carry(run, *draw_gumbels(gen, s, eng.n_dirs, eng.pop_size))
    carry = eng.gen_step(run, carry, eng.draw_generation(gen, s))
    return eng, run, carry, eng.draw_generation(gen, s)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [2, -1])
def test_generate_on_the_card_refuses_a_class_outside_the_head(card, lcld, cls):
    # the same ValueError as on the CPU (tests/test_torch_engine.py), raised
    # before K1 could read the class as class 1
    cons, sur, scaler, x = lcld
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_gen=2, n_pop=10, n_offsprings=6)
    with pytest.raises(ValueError, match="minimize_class must be a class of the 2-class head"):
        eng.generate(x[:4], minimize_class=cls)
    assert eng.generate(x[:4], minimize_class=0).f.shape == (4, eng.pop_size, 3)


def _hard_offspring(eng, off):
    """Offspring with the rows the main path makes rarely: categorical genes
    at .5 and zero denominators of the LCLD ratio constraints."""
    off = off.clone()
    off[:, ::7] = torch.where(eng.codec.int_mask_gen, off[:, ::7] + 0.5, off[:, ::7])
    gene = {int(d): i for i, d in enumerate(eng.codec.non_ohe_ml_idx)}
    for k, feat in enumerate(f for f in (6, 14, 11, 22, 0) if f in gene):
        off[:, 3 + k :: 11, gene[feat]] = 0.0
    return off


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 537])
def test_offspring_equals_plain(card, lcld, s):
    eng, run, carry, draws = _engine_state(card, lcld, s, seed=s)
    args = (eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, 100, draws.offspring)
    before = kernels.launch_counts()["offspring"]
    got = kernels.offspring(*args)
    assert kernels.launch_counts()["offspring"] == before + 1
    assert _same(got, make_offspring_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("s,norm", [(64, 2), (540, 2), (64, "inf")])
def test_objective_lcld_equals_plain(card, lcld, s, norm):
    eng, run, carry, draws = _engine_state(card, lcld, s, seed=s, norm=norm)
    off = _hard_offspring(eng, kernels.offspring(eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, 100, draws.offspring))
    got = kernels.objective_lcld(off, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
    want = evaluate_plain(eng._objective, eng.codec, run, off, eng.constraints)
    assert not bool(torch.isfinite(want).all())  # the zero denominators show
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stack", ["main", "global"])
@pytest.mark.parametrize("s,n", [(3, 100), (1, 7), (5, 27)])
def test_objective_lcld_tile_edges(card, lcld, stack, s, n):
    # S * N not a multiple of the tile; tiles that span states whose
    # minimize_class differ (the states alternate 0, 1); the main path's
    # stack, staged at 128-row tiles, and one too large for shared memory,
    # read from global memory at 64-row tiles
    eng, run, carry, draws = _engine_state(card, lcld, s, seed=s)
    obj = eng._objective
    if stack == "global":
        torch.manual_seed(s)
        model = MLP(47, (128, 128, 128), 2).to(card).eval().requires_grad_(False)
        obj = make_objective_tables(eng.codec, model, obj.scaler, 2, eng.constraints.tol)
    cand = _hard_offspring(eng, carry.pop_x[:, :n])
    got = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, obj)
    assert _same(got, evaluate_plain(obj, eng.codec, run, cand, eng.constraints))


@pytest.mark.cuda
@pytest.mark.parametrize("head,norm,scaled", [(1, 2, True), (2, "inf", False), (1, "inf", False)])
def test_objective_lcld_heads_norms_scaler(card, lcld, head, norm, scaled):
    eng, run, carry, draws = _engine_state(card, lcld, 40, seed=head)
    torch.manual_seed(head)
    model = MLP(47, (64, 32, 16), head).to(card).eval().requires_grad_(False)
    obj = make_objective_tables(eng.codec, model, eng._objective.scaler if scaled else None, norm, eng.constraints.tol)
    cand = _hard_offspring(eng, carry.pop_x)
    got = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, obj)
    assert _same(got, evaluate_plain(obj, eng.codec, run, cand, eng.constraints))


def _wide_tables(rng, l):
    """Operator tables of a synthetic schema of ``l`` genes, 40% integer."""
    type_id = (rng.random(l) < 0.4).astype(np.int64)
    rank = np.zeros(l, dtype=np.int64)
    sizes = [0, 0, 0]
    for i, t in enumerate(type_id):
        rank[i] = sizes[t]
        sizes[t] += 1
    return OperatorTables(
        type_id=torch.as_tensor(type_id), rank_in_type=torch.as_tensor(rank), type_sizes=tuple(sizes),
        mut_prob=torch.as_tensor(1.0 / np.maximum(np.array(sizes)[type_id], 1)), int_mask=torch.as_tensor(type_id == 1),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all mutate", "none mutate", "zero range", "odd N", "wide"])
def test_offspring_edges_equal_plain(card, lcld, case):
    # the mutation queue full and empty, genes that cannot mutate, a last
    # mating with one child, and more genes than one chunk of the queue
    cons, sur, scaler, x = lcld
    rng = np.random.default_rng(len(case))
    gen = torch.Generator(device=card).manual_seed(len(case))
    s, p, n = 7, 103, 99 if case == "odd N" else 100
    if case == "wide":
        tables, l, n = _wide_tables(rng, 3000).to(card), 3000, 5
        xl = torch.as_tensor(rng.uniform(-5, 0, (s, l)).astype(np.float32), device=card)
        xu = xl + torch.as_tensor(rng.uniform(0, 5, (s, l)).astype(np.float32), device=card)
    else:
        eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_pop=100, n_offsprings=n, archive_size=24)
        run = eng.prepare(x[:s], np.arange(s) % 2)
        tables, xl, xu = eng.tables, run.xl_gen.clone(), run.xu_gen.clone()
        l = xl.shape[1]
    if case in ("zero range", "wide"):
        xu[:, ::5] = xl[:, ::5]
    pop = xl[:, None] + torch.rand((s, p, l), generator=gen, device=card) * (xu - xl)[:, None]
    pop = torch.where(tables.int_mask, torch.round(pop), pop).clamp(xl[:, None], xu[:, None])
    draws = draw_offspring(PhiloxStream(len(case), card), s, p, n, l)
    if case in ("all mutate", "none mutate"):
        draws = draws._replace(mut_select=torch.full_like(draws.mut_select, 0.0 if case == "all mutate" else 1.0))
    if case == "wide":  # ~7% of the genes mutate, in every chunk of elements
        draws = draws._replace(mut_select=draws.mut_select * 0.01)
    args = (tables, pop, xl, xu, n, draws)
    assert _same(kernels.offspring(*args), make_offspring_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "limits", "NaN column", "equal rows", "warm extremes"])
@pytest.mark.parametrize("s", [3, 5])
def test_survive_norm_edges_equal_plain(card, case, s):
    # four states per block, the last block partial; M = 1024, the peel's
    # limit (32 staged rows per lane); a state whose f column is all NaN;
    # equal rows (det = 0: the nadir fallbacks); a warm state whose previous
    # extreme points win every argmin
    m = 1024 if case == "limits" else 203
    rng = np.random.default_rng(m + s)
    f = torch.as_tensor(_objectives(rng, s, m), device=card)
    asp = torch.as_tensor(rng.dirichlet(np.ones(3), 100).astype(np.float32), device=card)
    state = NormState.init(s, 3, device=card)
    if case == "NaN column":
        f[1, :, 1] = torch.nan
    if case == "equal rows":
        f = f[:, :1].expand(s, m, 3).nan_to_num(nan=0.5, posinf=2.0).contiguous()
    if case == "warm extremes":
        f = f.nan_to_num(nan=0.5, posinf=9.0) + 1.0
        state = state._replace(ideal=torch.zeros((s, 3), device=card),
                               extreme=0.5 * torch.eye(3, device=card).expand(s, 3, 3).contiguous())
    ranks = nd_ranks_plain(f, m // 2)
    for step in range(2):
        got = kernels.survive_norm(f, ranks, asp, state)
        new_state, nadir, dirs = survive_norm_plain(f, ranks, asp, state)
        for g, w in zip(got, (*new_state, nadir, dirs)):
            assert _same(g, w)
        if case == "warm extremes":
            assert torch.equal(new_state.extreme, state.extreme)
        state = new_state


def _fill_inputs(card, s, m, r, seed):
    rng = np.random.default_rng(seed)
    f = torch.as_tensor(_objectives(rng, s, m), device=card)
    ranks = nd_ranks_plain(f, m // 2)
    niche = torch.as_tensor(rng.integers(0, r, (s, m)), device=card)
    dist = torch.as_tensor(rng.uniform(size=(s, m)).astype(np.float32), device=card)
    dist[:, ::9] = torch.nan
    gum_cut = torch.as_tensor(rng.gumbel(size=(s, r)).astype(np.float32), device=card)
    gum_mem = torch.as_tensor(rng.gumbel(size=(s, m)).astype(np.float32), device=card)
    return f, ranks, niche, dist, gum_cut, gum_mem


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one niche", "inf niche", "tied gumbels", "limits"])
@pytest.mark.parametrize("s", [3, 5])
def test_survive_fill_edges_equal_plain(card, case, s):
    # four states per block, the last block partial; at the limits
    # (M = R = 1024) four states' arrays do not fit a block: one per block
    m, r = (1024, 1024) if case == "limits" else (203, 103)
    f, ranks, niche, dist, gum_cut, gum_mem = _fill_inputs(card, s, m, r, seed=m + s)
    if case == "one niche":  # a niche holding every available row
        niche = torch.zeros_like(niche)
    if case == "inf niche":  # every distance in a niche is inf
        dist = torch.where(niche % 3 == 0, torch.inf, dist)
    if case == "tied gumbels":
        gum_cut = torch.zeros_like(gum_cut)
        gum_mem[:, ::2] = 0.5
    p = m // 2
    rows = torch.rand((s, m, 27), device=card)
    extract = (rows[:, :p], rows[:, p:], f[:, :p], f[:, p:])
    mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, p)
    want = (mask, *extract_archive_plain(mask, *extract, rows[:, :24], f[:, :24]))
    got = kernels.survive_fill(gum_cut, gum_mem, ranks, niche, dist, p, extract=extract,
                               archive=(rows[:, :24], f[:, :24], rows[:, p:], f[:, p:], 24))
    for g, w in zip(got, want):
        assert _same(g, w)


def _merged_objectives(carry, off_f):
    """Merged objectives with duplicate, NaN and +inf rows."""
    f = torch.cat([carry.pop_f, off_f], dim=1)
    f[:, 150:170] = f[:, 10:30]
    f[::3, 40, 1] = torch.nan
    f[::2, 41, 2] = torch.inf
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 544])
def test_survive_norm_equals_plain(card, lcld, s):
    eng, run, carry, draws = _engine_state(card, lcld, s, seed=s)
    off = kernels.offspring(eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, 100, draws.offspring)
    f = _merged_objectives(carry, eng._evaluate(run, off))
    ranks = kernels.nd_peel(f, eng.pop_size)
    for state in (carry.norm_state, NormState.init(s, 3, device=card)):
        got = kernels.survive_norm(f, ranks, eng.asp_points, state)
        new_state, nadir, dirs = survive_norm_plain(f, ranks, eng.asp_points, state)
        for g, w in zip(got, (*new_state, nadir, dirs)):
            assert _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 538])
def test_survive_fill_equals_plain(card, lcld, s):
    eng, run, carry, draws = _engine_state(card, lcld, s, seed=s)
    off = kernels.offspring(eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, 100, draws.offspring)
    off_f = eng._evaluate(run, off)
    off_f[:, 5, 2] = torch.inf  # NaN archive score
    f = _merged_objectives(carry, off_f)
    ranks = kernels.nd_peel(f, eng.pop_size)
    state, nadir, dirs = survive_norm_plain(f, ranks, eng.asp_points, carry.norm_state)
    niche, dist = associate_plain(f, dirs, state.ideal, nadir)
    gum_cut, gum_mem = draws.gum_cut.clone(), draws.gum_mem.clone()
    gum_cut[:, ::3] = 0.25  # tied priorities
    gum_mem[:, ::4] = -0.5
    arch_f = carry.arch_f.clone()
    arch_f[:, 3, 2] = torch.inf
    mask = survive_fill_plain(gum_cut, gum_mem, ranks, niche, dist, eng.pop_size)
    assert _same(kernels.survive_fill(gum_cut, gum_mem, ranks, niche, dist, eng.pop_size).mask, mask)
    got = kernels.survive_fill(
        gum_cut, gum_mem, ranks, niche, dist, eng.pop_size,
        extract=(carry.pop_x, off, carry.pop_f, off_f), archive=(carry.arch_x, arch_f, off, off_f, 24),
    )
    want = extract_archive_plain(mask, carry.pop_x, off, carry.pop_f, off_f, carry.arch_x, arch_f)
    assert _same(got.mask, mask)
    for g, w in zip(got[1:], want):
        assert _same(g, w)
    arch = kernels.archive_select(carry.pop_x, carry.pop_f, carry.pop_x[:, :0], carry.pop_f[:, :0], 24)
    for g, w in zip(arch, archive_select_plain(carry.pop_x, carry.pop_f, 24)):
        assert _same(g, w)


def test_wrappers_refuse_cpu_tensors(tmp_path):
    f = torch.zeros((2, 5, 3))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.nd_peel(f, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.associate(f, torch.ones((2, 4, 3)), torch.zeros((2, 3)), torch.ones((2, 3)))
    cons, sur, scaler, x = synthetic_lcld_problem(str(tmp_path), 2)
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", n_pop=10, n_offsprings=6, archive_size=3)
    run = eng.prepare(x, np.ones(2, dtype=np.int64))
    pop = eng.init_carry(run, *draw_gumbels(PhiloxStream(0), 2, eng.n_dirs, eng.pop_size)).pop_x
    draws = eng.draw_generation(PhiloxStream(0), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.offspring(eng.tables, pop, run.xl_gen, run.xu_gen, 6, draws.offspring)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.objective_lcld(pop, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
    state = NormState.init(2, 3)
    ranks = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.survive_norm(f, ranks, eng.asp_points, state)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.survive_fill(torch.zeros((2, 4)), f[..., 0], ranks, ranks.long(), f[..., 0], 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.archive_select(pop, pop[..., :3], pop[:, :0], pop[:, :0, :3], 3)
    assert kernels.launch_counts() == before


def test_gen_step_two_pointer_plain_path_equals_the_concatenation(tmp_path):
    """The survival stages on [population, offspring] through two pointers
    (the CPU path merges once for the plain versions) equal the stages on
    the concatenation the step took before, and so does the whole step."""
    cons, sur, scaler, x = synthetic_lcld_problem(str(tmp_path), 3)
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", n_pop=10, n_offsprings=6, archive_size=3, seed=4)
    run = eng.prepare(x, np.arange(3) % 2)
    gen = PhiloxStream(4)
    carry = eng.init_carry(run, *draw_gumbels(gen, 3, eng.n_dirs, eng.pop_size))
    draws = eng.draw_generation(gen, 3)
    off = eng.offspring(run, carry.pop_x, draws.offspring)
    off_f = eng._evaluate(run, off)
    got = survive_stages(carry.pop_f, eng.asp_points, carry.norm_state, eng.pop_size, off_f)
    want = survive_stages(torch.cat([carry.pop_f, off_f], dim=1), eng.asp_points, carry.norm_state, eng.pop_size)
    for g, w in zip((got[0], *got[1], *got[2:]), (want[0], *want[1], *want[2:])):
        assert _same(g, w)
    step = eng.gen_step(run, carry, draws)
    mask = survive_fill_plain(draws.gum_cut, draws.gum_mem, want[0], want[2], want[3], eng.pop_size)
    ref = extract_archive_plain(mask, carry.pop_x, off, carry.pop_f, off_f, carry.arch_x, carry.arch_f)
    for g, w in zip((*step[:4], *step.norm_state), (*ref, *want[1])):
        assert _same(g, w)


def test_launch_counts_reset():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "offspring": 0, "objective_lcld": 0, "nd_peel": 0,
        "survive_norm": 0, "associate": 0, "survive_fill": 0, "pgd_lcld": 0, "objective_botnet": 0,
        "pgd_botnet": 0, "objective_lcld_aug": 0, "pgd_lcld_aug": 0, "objective_botnet_aug": 0,
        "pgd_lcld_auto": 0, "pgd_lcld_aug_auto": 0, "pgd_botnet_auto": 0, "gate_stats": 0, "take_carry": 0,
        "objective_lcld_hist": 0, "objective_lcld_aug_hist": 0, "objective_botnet_hist": 0,
        "objective_botnet_aug_hist": 0, "objective_spec": 0, "objective_spec_hist": 0, "pgd_spec": 0,
        "pgd_spec_auto": 0, "train_step": 0, "train_loss": 0, "input_grad": 0, "draws": 0, "pgd_start": 0,
        "chunk_prepare": 0, "chunk_decode": 0, "refdirs": 0, "restart": 0, "forward_labels": 0,
        "forward_proba1": 0, "pgd_botnet_aug": 0, "pgd_botnet_aug_auto": 0,
    }


def test_build_fingerprint_follows_sources(tmp_path, monkeypatch):
    # the library name changes with any source or flag, so a stale build is
    # never loaded; computing it needs no compiler
    a = build._fingerprint("/usr/local/cuda/bin/nvcc")
    assert a == build._fingerprint("/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._fingerprint("/usr/local/cuda/bin/nvcc") != a
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert all((build.PACKAGE_DIR / src).exists() for src in build.SOURCES + build.HEADERS)


# -- K7 pgd_lcld -------------------------------------------------------------------


@pytest.fixture(scope="module")
def pgd_problem(tmp_path_factory):
    """64 synthetic LCLD states, the seeded surrogate and its scaler; the
    scaled rows, and starts whose first 7 rows put LCLD's denominators at 0
    (NaN and inf gradients) or features at the clip bounds."""
    cons, sur, scaler, x = synthetic_lcld_problem(str(tmp_path_factory.mktemp("pgd")), 64)
    xs = scaler.transform(x).astype(np.float32)
    rng = np.random.default_rng(2)
    starts = np.clip(xs + rng.normal(scale=0.03, size=xs.shape), 0, 1).astype(np.float32)
    mn = scaler.min_.astype(np.float32)
    for row, feats in enumerate(([6], [0, 6], [14], [10, 14], [22], [11, 16, 22])):
        starts[row, feats] = mn[feats]  # unscales to exactly 0
    starts[6] = np.round(starts[6])
    return cons, sur, scaler, xs, starts


PGD_CASES = (
    dict(loss_evaluation="constraints+flip+adaptive_eps_step+repair", norm=2, record_loss="full",
         record_grad_norm=True),
    dict(loss_evaluation="flip", norm=np.inf, constraints_optim="alt_constraints", record_loss="reduced"),
    dict(loss_evaluation="constraints+flip+alternate", norm=2, targeted=True),
    dict(loss_evaluation="constraints", constraints_optim="single_constraints", ctr_id=4, norm=np.inf,
         record_loss="full"),
    dict(loss_evaluation="flip+repair", norm=np.inf, record_loss="full", record_grad_norm=True),
)


# K7 runs ceil(N / 132) rows per block, at most 32, on an H100's 132 SMs:
# the edges of that layout (chip_smoke.PGD_ROWS's), and the fixture's 64
@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (31, 7), (33, 12), (64, 30), (131, 7), (133, 12), (1000, 7), (4000, 7),
                                 (4223, 7), (4225, 12)])
@pytest.mark.parametrize("case", range(len(PGD_CASES)))
def test_pgd_lcld_equals_plain(card, pgd_problem, case, n, t):
    cons, sur, scaler, xs, starts = pgd_problem
    knobs = PGD_CASES[case]
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, device=card, **knobs)
    sched = atk.schedule(0.2, 0.1, t)
    # row counts above the fixture's states repeat its rows
    xs, starts = (np.resize(v, (n, v.shape[1])) for v in (xs, starts))
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(n) % 2, device=card),
            torch.as_tensor(starts, device=card))
    repair, linf = "repair" in atk.loss_evaluation, knobs["norm"] == np.inf
    before = kernels.launch_counts()["pgd_lcld"]
    got = kernels.pgd_lcld(atk.tables, sched, *args, 0.2, atk.clip, linf, repair, atk.targeted, atk.history_layout())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pgd_lcld"] == before + 1
    want = pgd_run_plain(atk.tables, cons, sched, *args, 0.2, atk.clip, atk.norm, repair, atk.targeted,
                         atk.history_layout())
    for g, w in zip(got, want):
        assert (g is None and w is None) or _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n_classes", [((64, 32, 16), 1), ((128, 128, 128), 2), ((16,), 2)])
def test_pgd_lcld_other_stacks_equal_plain(card, pgd_problem, hidden, n_classes):
    cons, _, scaler, xs, starts = pgd_problem
    model = MLP(47, hidden, n_classes).reset_parameters_seeded(3)
    atk = ConstrainedPGD(Surrogate(model), cons, scaler, eps=0.3, eps_step=0.1, norm=2, device=card,
                         loss_evaluation="constraints+flip+repair", record_loss="full")
    sched = atk.schedule(0.3, 0.1, 9)
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(len(xs)) % 2, device=card),
            torch.as_tensor(starts, device=card))
    got = kernels.pgd_lcld(atk.tables, sched, *args, 0.3, atk.clip, False, True, False, atk.history_layout())
    want = pgd_run_plain(atk.tables, cons, sched, *args, 0.3, atk.clip, 2, True, False, atk.history_layout())
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("feature", [0, 3])
def test_pgd_lcld_repair_with_a_group_on_the_installments_features(card, pgd_problem, feature):
    """A one-hot group that also holds one of features 0-3, which repair's
    installment reads or writes: K7 then repairs one row at a time, in
    LcldConstraints.repair's order, instead of its parts side by side."""
    cons, sur, scaler, xs, starts = pgd_problem
    changed = copy.copy(cons)
    idx, mask = cons._ohe_idx.clone(), cons._ohe_mask.clone()
    assert not mask[0, 4]
    idx[0, 4], mask[0, 4] = feature, True
    changed._ohe_idx, changed._ohe_mask = idx, mask
    atk = ConstrainedPGD(sur, changed, scaler, eps=0.2, eps_step=0.1, norm=2, device=card,
                         loss_evaluation="constraints+flip+repair", record_loss="full")
    tables = atk.tables._replace(ohe=idx.masked_fill(~mask, -1).to(device=card, dtype=torch.int32))
    sched = atk.schedule(0.2, 0.1, 9)
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(len(xs)) % 2, device=card),
            torch.as_tensor(starts, device=card))
    got = kernels.pgd_lcld(tables, sched, *args, 0.2, atk.clip, False, True, False, atk.history_layout())
    want = pgd_run_plain(tables, changed, sched, *args, 0.2, atk.clip, 2, True, False, atk.history_layout())
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.cuda
def test_pgd_lcld_refuses_what_it_does_not_take(card, pgd_problem):
    cons, sur, scaler, xs, _ = pgd_problem
    atk = ConstrainedPGD(sur, cons, scaler, device=card, max_iter=3)
    sched = atk.schedule(0.3, 0.1, 3)
    xi = torch.as_tensor(xs[:8], device=card)
    y = torch.zeros(8, dtype=torch.int64, device=card)
    run = lambda tables, x, yy, st, s=sched: kernels.pgd_lcld(  # noqa: E731
        tables, s, x, yy, st, 0.3, (0.0, 1.0), True, False, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        run(atk.tables, xi.cpu(), y, xi)
    with pytest.raises(TypeError, match="float32"):
        run(atk.tables, xi.double(), y, xi)
    with pytest.raises(ValueError, match="shape"):
        run(atk.tables, xi, y[:4], xi)
    with pytest.raises(ValueError, match="shape"):
        run(atk.tables, xi, y, xi[:, :40])
    with pytest.raises(ValueError, match="47 features"):
        narrow = atk.tables._replace(scale=atk.tables.scale[:40], min_=atk.tables.min_[:40],
                                     mutable=atk.tables.mutable[:40])
        run(narrow, xi[:, :40], y, xi[:, :40])
    three = MLP(47, (8,), 3).to(card)
    layers = tuple((m.weight.detach(), m.bias.detach()) for m in three.layers)
    tables = atk.tables._replace(layers=layers, params=torch.cat([t.reshape(-1) for p in layers for t in p]))
    with pytest.raises(ValueError, match="1 or 2 classes"):
        run(tables, xi, y, xi)
    assert isinstance(atk.tables, PgdTables)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (33, 12), (64, 30), (4000, 7)])
@pytest.mark.parametrize("case", [0, 4])
def test_pgd_lcld_repairing_an_immutable_feature_equals_plain(card, pgd_problem, tmp_path, case, n, t):
    """Term marked immutable, on rows where it is off {36, 60}: each repair
    rewrites it, x keeps it, and the next iteration unscales u from x, as
    ``pgd_run_plain`` does."""
    _, sur, scaler, xs, starts = pgd_problem
    paths = lcld_immutable_term_schema(synth_lcld_schema(str(tmp_path / "base")), str(tmp_path / "immutable"))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    k = len(LCLD_IMMUTABLE_TERMS)
    xs, starts = xs.copy(), starts.copy()
    xs[:k] = lcld_immutable_repair_rows((xs[:k] - scaler.min_) / scaler.scale, scaler)
    starts[:k, 1] = xs[:k, 1]
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, device=card, **PGD_CASES[case])
    assert not bool(atk.tables.mutable[1])
    sched = atk.schedule(0.2, 0.1, t)
    xs, starts = (np.resize(v, (n, v.shape[1])) for v in (xs, starts))
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(n) % 2, device=card),
            torch.as_tensor(starts, device=card))
    linf = PGD_CASES[case]["norm"] == np.inf
    got = kernels.pgd_lcld(atk.tables, sched, *args, 0.2, atk.clip, linf, True, atk.targeted, atk.history_layout())
    want = pgd_run_plain(atk.tables, cons, sched, *args, 0.2, atk.clip, atk.norm, True, atk.targeted,
                         atk.history_layout())
    for g, w in zip(got, want):
        assert (g is None and w is None) or _same(g, w)


@pytest.mark.cuda
def test_pgd_generate_on_the_card(card, pgd_problem):
    cons, sur, scaler, xs, _ = pgd_problem
    y = np.arange(len(xs)) % 2
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, max_iter=20, norm=2, device=card,
                         loss_evaluation="constraints+flip+adaptive_eps_step+repair", num_random_init=2)
    before = kernels.launch_counts()["pgd_lcld"]
    a = atk.generate(xs, y)
    assert kernels.launch_counts()["pgd_lcld"] == before + 2
    np.testing.assert_array_equal(atk.generate(xs, y), a)
    # the same ValueError as on the CPU (tests/test_torch_pgd.py)
    with pytest.raises(ValueError, match="labels must be classes of the 2-class head"):
        atk.generate(xs, np.full(len(xs), 2))
    cpu = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, max_iter=20, norm=2, device="cpu",
                         loss_evaluation="constraints+flip+adaptive_eps_step+repair")
    card_run = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, max_iter=20, norm=2, device=card,
                              loss_evaluation="constraints+flip+adaptive_eps_step+repair")
    got, want = card_run.generate(xs, y), cpu.generate(xs, y)
    assert ((got == want) | (np.isnan(got) & np.isnan(want))).all()


def _autopgd_equals_plain(card, problem, knobs, n, t, counter, kernel=kernels.pgd_lcld, eps=0.2):
    """The AutoPGD instantiation of ``kernel`` (K7 or K7b) against
    ``autopgd_run_plain`` from the problem's starts, bit for bit (x_best,
    the class there, the history, each row's final step), one launch
    counted as ``counter``."""
    cons, sur, scaler, xs, starts = problem
    atk = AutoPGD(sur, cons, scaler, eps=eps, eps_step=eps / 3, max_iter=t, device=card, **knobs)
    sched = atk.schedule(eps, eps / 3, t)
    xs, starts = (np.resize(v, (n, v.shape[1])) for v in (xs, starts))
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(n) % 2, device=card),
            torch.as_tensor(starts, device=card))
    repair, linf = "repair" in atk.loss_evaluation, knobs["norm"] == np.inf
    before = kernels.launch_counts()
    got = kernel(atk.tables, sched.pgd, *args, eps, atk.clip, linf, repair, atk.targeted, atk.history_layout(),
                 auto=sched.auto)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {counter: 1}
    want = autopgd_run_plain(atk.tables, cons, sched, *args, eps, atk.clip, atk.norm, repair, atk.targeted,
                             atk.history_layout())
    for g, w in zip(got, want):
        assert (g is None and w is None) or _same(g, w)
    return got[3]


AUTOPGD_CASES = tuple(
    {**case, "loss_evaluation": "autopgd+" + case["loss_evaluation"]} for case in PGD_CASES
)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (33, 12), (64, 30), (133, 12), (4000, 12), (4225, 12)])
@pytest.mark.parametrize("case", range(len(AUTOPGD_CASES)))
def test_autopgd_lcld_equals_plain(card, pgd_problem, case, n, t):
    eta = _autopgd_equals_plain(card, pgd_problem, AUTOPGD_CASES[case], n, t, "pgd_lcld_auto")
    if t >= 12 and n >= 33:
        assert (eta < np.float32(0.2 / 3)).any()  # a checkpoint halved some rows


@pytest.mark.cuda
def test_autopgd_generate_on_the_card_equals_the_cpu(card, pgd_problem):
    cons, sur, scaler, xs, _ = pgd_problem
    y = np.arange(len(xs)) % 2
    knobs = dict(eps=0.2, eps_step=0.2 / 3, max_iter=20, norm=2, loss_evaluation="autopgd+constraints+flip")
    on_card = AutoPGD(sur, cons, scaler, device=card, **knobs)
    on_cpu = AutoPGD(sur, cons, scaler, device="cpu", **knobs)
    got, want = on_card.generate(xs, y), on_cpu.generate(xs, y)
    assert ((got == want) | (np.isnan(got) & np.isnan(want))).all()
    with pytest.raises(ValueError, match="max_iter=21 differs"):
        on_card.generate(xs, y, max_iter=21)


def test_pgd_wrapper_refuses_cpu_tensors(tmp_path):
    cons, sur, scaler, x = synthetic_lcld_problem(str(tmp_path), 4)
    atk = ConstrainedPGD(sur, cons, scaler, device="cpu", max_iter=2)
    xi = torch.as_tensor(scaler.transform(x), dtype=torch.float32)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pgd_lcld(atk.tables, atk.schedule(0.3, 0.1, 2), xi, torch.zeros(4, dtype=torch.int64), xi, 0.3,
                         (0.0, 1.0), True, False, False)
    assert kernels.launch_counts() == before


# -- K1 and K7 on the augmented LCLD domain (57 features, 10 + 10 terms) ----------


@pytest.fixture(scope="module")
def lcld_aug(tmp_path_factory):
    """The augmented problem: 1000 synthetic states, their important
    features, a seeded 57-input surrogate and its scaler."""
    return synthetic_lcld_augmented_problem(str(tmp_path_factory.mktemp("aug")), 1000)


def _aug_candidates(eng, lcld_aug, cand):
    """``cand`` (S, N, L) with the pair terms' edge rows
    (``lcld_augmented_edge_rows``) as each state's first genes."""
    cons, _, _, x = lcld_aug
    rows = torch.as_tensor(lcld_augmented_edge_rows(x, cons.important_features), device=cand.device)
    genes = codec_lib.ml_to_genetic(eng.codec, rows[:LCLD_AUGMENTED_EDGE_ROWS])
    cand = cand.clone()
    cand[:, :LCLD_AUGMENTED_EDGE_ROWS] = genes
    return cand


@pytest.mark.cuda
@pytest.mark.parametrize("stack", ["main", "global"])
@pytest.mark.parametrize("s,n,norm", [(64, 100, 2), (540, 100, 2), (64, 100, "inf"), (3, 100, 2), (1, 7, 2),
                                      (5, 27, "inf")])
def test_objective_lcld_aug_equals_plain(card, lcld_aug, stack, s, n, norm):
    cons, sur, scaler, x = lcld_aug
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_pop=100, n_offsprings=100, archive_size=24, seed=s,
                 norm=norm)
    run = eng.prepare(x[:s], np.arange(s) % 2)
    gen = PhiloxStream(s, card)
    carry = eng.init_carry(run, *draw_gumbels(gen, s, eng.n_dirs, eng.pop_size))
    draws = eng.draw_generation(gen, s)
    off = kernels.offspring(eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, 100, draws.offspring)
    obj = eng._objective
    if stack == "global":
        torch.manual_seed(s)
        model = MLP(57, (128, 128, 128), 2).to(card).eval().requires_grad_(False)
        obj = make_objective_tables(eng.codec, model, obj.scaler, norm, cons.tol, cons.kernel_tables(card))
    cand = _aug_candidates(eng, lcld_aug, off[:, :n])
    before = kernels.launch_counts()
    got = kernels.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, obj)
    after = kernels.launch_counts()
    assert after["objective_lcld_aug"] == before["objective_lcld_aug"] + 1
    assert after["objective_lcld"] == before["objective_lcld"]
    assert _same(got, evaluate_plain(obj, eng.codec, run, cand, cons))


PGD_AUG_CASES = PGD_CASES + (
    dict(loss_evaluation="constraints", constraints_optim="single_constraints", ctr_id=14, norm=2,
         record_loss="full"),
    dict(loss_evaluation="constraints+flip", constraints_optim="alt_constraints", norm=2, record_loss="full"),
)


@pytest.fixture(scope="module")
def pgd_aug(lcld_aug):
    """64 of the augmented states, scaled, and starts whose first rows hold
    the pair terms' edge cases, the others the scaled rows with noise."""
    cons, sur, scaler, x = lcld_aug
    xs = scaler.transform(x[:64]).astype(np.float32)
    rng = np.random.default_rng(5)
    starts = np.clip(xs + rng.normal(scale=0.03, size=xs.shape), 0, 1).astype(np.float32)
    edges = lcld_augmented_edge_rows(x[:64], cons.important_features, scaler)
    starts[:LCLD_AUGMENTED_EDGE_ROWS] = edges[:LCLD_AUGMENTED_EDGE_ROWS]
    return cons, sur, scaler, xs, starts


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (33, 12), (64, 30), (133, 12), (4000, 7), (4225, 12)])
@pytest.mark.parametrize("case", range(len(PGD_AUG_CASES)))
def test_pgd_lcld_aug_equals_plain(card, pgd_aug, case, n, t):
    cons, sur, scaler, xs, starts = pgd_aug
    knobs = PGD_AUG_CASES[case]
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, eps_step=0.1, device=card, **knobs)
    sched = atk.schedule(0.2, 0.1, t)
    xs, starts = (np.resize(v, (n, v.shape[1])) for v in (xs, starts))
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(n) % 2, device=card),
            torch.as_tensor(starts, device=card))
    repair, linf = "repair" in atk.loss_evaluation, knobs["norm"] == np.inf
    before = kernels.launch_counts()
    got = kernels.pgd_lcld(atk.tables, sched, *args, 0.2, atk.clip, linf, repair, atk.targeted, atk.history_layout())
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["pgd_lcld_aug"] == before["pgd_lcld_aug"] + 1 and after["pgd_lcld"] == before["pgd_lcld"]
    want = pgd_run_plain(atk.tables, cons, sched, *args, 0.2, atk.clip, atk.norm, repair, atk.targeted,
                         atk.history_layout())
    if atk.history_layout() is not None and atk.history_layout()[1]:
        assert got[2].shape[-1] == len(atk.hist_column_names()) == 3 + atk.history_layout()[0] + 20
    for g, w in zip(got, want):
        assert (g is None and w is None) or _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (33, 12), (133, 12), (4000, 12)])
@pytest.mark.parametrize("case", range(len(PGD_AUG_CASES)))
def test_autopgd_lcld_aug_equals_plain(card, pgd_aug, case, n, t):
    knobs = {**PGD_AUG_CASES[case], "loss_evaluation": "autopgd+" + PGD_AUG_CASES[case]["loss_evaluation"]}
    _autopgd_equals_plain(card, pgd_aug, knobs, n, t, "pgd_lcld_aug_auto")


@pytest.mark.cuda
def test_pgd_lcld_aug_serial_repair_equals_plain(card, pgd_aug):
    """A one-hot group holding feature 3: K7 repairs one row at a time, then
    re-derives the pairs."""
    cons, sur, scaler, xs, starts = pgd_aug
    changed = copy.copy(cons)
    idx, mask = cons._ohe_idx.clone(), cons._ohe_mask.clone()
    idx[0, 4], mask[0, 4] = 3, True
    changed._ohe_idx, changed._ohe_mask = idx, mask
    atk = ConstrainedPGD(sur, changed, scaler, eps=0.2, eps_step=0.1, norm=2, device=card,
                         loss_evaluation="constraints+flip+repair", record_loss="full")
    tables = atk.tables._replace(ohe=idx.masked_fill(~mask, -1).to(device=card, dtype=torch.int32))
    sched = atk.schedule(0.2, 0.1, 9)
    args = (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(len(xs)) % 2, device=card),
            torch.as_tensor(starts, device=card))
    got = kernels.pgd_lcld(tables, sched, *args, 0.2, atk.clip, False, True, False, atk.history_layout())
    want = pgd_run_plain(tables, changed, sched, *args, 0.2, atk.clip, 2, True, False, atk.history_layout())
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.cuda
def test_lcld_aug_kernels_refuse_mismatched_pairs(card, pgd_aug):
    cons, sur, scaler, xs, _ = pgd_aug
    atk = ConstrainedPGD(sur, cons, scaler, device=card, max_iter=3)
    sched = atk.schedule(0.3, 0.1, 3)
    xi = torch.as_tensor(xs[:8], device=card)
    y = torch.zeros(8, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="47 \\+ P on the augmented domain"):
        kernels.pgd_lcld(atk.tables._replace(cons=None), sched, xi, y, xi, 0.3, (0.0, 1.0), True, False, False)
    short = atk.tables.cons._replace(idx=atk.tables.cons.idx[:9], thr=atk.tables.cons.thr[:9])
    with pytest.raises(ValueError, match="got 57 features and 9 pairs"):
        kernels.pgd_lcld(atk.tables._replace(cons=short), sched, xi, y, xi, 0.3, (0.0, 1.0), True, False, False)


def test_lcld_aug_wrappers_refuse_cpu_tensors(tmp_path):
    cons, sur, scaler, x = synthetic_lcld_augmented_problem(str(tmp_path), 4)
    atk = ConstrainedPGD(sur, cons, scaler, device="cpu", max_iter=2)
    assert atk.tables.cons.idx.dtype == torch.int32 and atk.tables.cons.thr.dtype == torch.float32
    xi = torch.as_tensor(scaler.transform(x), dtype=torch.float32)
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", n_pop=10, n_offsprings=6)
    run = eng.prepare(x, np.ones(4, dtype=np.int64))
    pop = eng.init_carry(run, *draw_gumbels(PhiloxStream(0), 4, eng.n_dirs, eng.pop_size)).pop_x
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pgd_lcld(atk.tables, atk.schedule(0.3, 0.1, 2), xi, torch.zeros(4, dtype=torch.int64), xi, 0.3,
                         (0.0, 1.0), True, False, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.objective_lcld(pop, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class,
                               eng._objective)
    assert kernels.launch_counts() == before


# -- K8 objective_botnet ---------------------------------------------------------


@pytest.fixture(scope="module")
def botnet(tmp_path_factory):
    """387 synthetic botnet states (rq1.botnet's count), the seeded
    64-64-32-2 surrogate and its scaler."""
    return synthetic_botnet_problem(str(tmp_path_factory.mktemp("botnet")), 387)


def _botnet_case(device, botnet, s, n, seed, **knobs):
    """An engine on ``device`` at config/moeva.yaml's population, its run
    inputs for ``s`` states and (S, N, L) candidates uniform in the genes'
    bounds with the terms' edge cases."""
    cons, sur, scaler, x = botnet
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=device, n_pop=200, n_offsprings=100, **knobs)
    run = eng.prepare(x[:s], np.arange(s) % 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((s, n, eng.codec.gen_length), generator=gen, device=device)
    cand = run.xl_gen[:, None] + u * (run.xu_gen - run.xl_gen)[:, None]
    return eng, run, botnet_hard_candidates(eng.codec, cons.schema.names, cand)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [2, "inf"])
@pytest.mark.parametrize("s,n", [(387, 100), (131, 203), (3, 100), (1, 7), (5, 27), (7, 37), (41, 99), (88, 96)])
def test_objective_botnet_equals_plain(card, botnet, s, n, norm):
    # the offspring's and the population's row counts; partial tiles, a
    # tile of fewer rows than one, and tiles that span states of both
    # classes; 259 rows end in a tile of 3 of its 32 rows, 4059 rows make
    # 127 tiles (fewer than the H100's 132 SMs, the last one partial), and
    # 8448 rows exactly one wave of 264 tiles (2 blocks on each SM)
    eng, run, cand = _botnet_case(card, botnet, s, n, seed=s + n, norm=norm)
    before = kernels.launch_counts()
    got = kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class,
                                   eng._objective)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["objective_botnet"] == before["objective_botnet"] + 1
    assert after["objective_lcld"] == before["objective_lcld"]
    want = evaluate_plain(eng._objective, eng.codec, run, cand, eng.constraints)
    assert not bool(torch.isfinite(want).all())  # the edge cases show
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,head,norm,scaled", [((64, 64, 32), 1, 2, True), ((64, 64, 32), 2, "inf", False),
                                                     ((8,), 1, "inf", False), ((16, 64, 48, 5), 2, 2, True)])
def test_objective_botnet_stacks_heads_norms_scaler(card, botnet, hidden, head, norm, scaled):
    eng, run, cand = _botnet_case(card, botnet, 40, 100, seed=head)
    model = MLP(756, hidden, head).reset_parameters_seeded(head).to(card).eval().requires_grad_(False)
    obj = make_objective_tables(eng.codec, model, eng._objective.scaler if scaled else None, norm,
                                eng.constraints.tol, eng._objective.cons)
    got = kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, obj)
    assert _same(got, evaluate_plain(obj, eng.codec, run, cand, eng.constraints))


@pytest.mark.cuda
def test_objective_botnet_refuses_what_it_does_not_take(card, botnet):
    eng, run, cand = _botnet_case(card, botnet, 4, 10, seed=1)
    args = (run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class)
    for hidden, head in (((128, 32), 2), ((62, 32), 2), ((64, 32), 3)):
        model = MLP(756, hidden, head).to(card)
        obj = make_objective_tables(eng.codec, model, None, 2, 1e-3, eng._objective.cons)
        with pytest.raises(ValueError, match="objective_botnet takes a 756-input stack"):
            kernels.objective_botnet(cand, *args, obj)
    with pytest.raises(ValueError, match="botnet gather tables"):
        kernels.objective_botnet(cand, *args, eng._objective._replace(cons=None))
    with pytest.raises(ValueError, match="xl_ml must have shape"):
        kernels.objective_botnet(cand, args[0], args[1][:, :700], *args[2:], eng._objective)


@pytest.mark.cuda
def test_moeva_runs_botnet_on_k8(card, botnet):
    cons, sur, scaler, x = botnet
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_gen=3, n_pop=12, n_offsprings=10, archive_size=4,
                 max_states_per_call=5)
    kernels.reset_launch_counts()
    res = eng.generate(x[:8], minimize_class=1)
    counts = kernels.launch_counts()
    # two chunks of 5 and 3 states: the init round and 2 steps each
    assert counts["objective_botnet"] == 6 and counts["objective_lcld"] == 0
    assert res.x_ml.shape == (8, eng.pop_size + 4, 756) and np.isfinite(res.x_ml).all()


@pytest.mark.cuda
def test_objective_botnet_max_features_counts_width_and_entries(card, botnet):
    # the wrapper's feature limit is the launcher's shared-memory rule: a
    # wider first layer or longer gather lists leave room for fewer features
    from moeva2_ijcai22_replication_tpu_torch.kernels.build import library

    eng, _, _ = _botnet_case(card, botnet, 1, 1, seed=0)
    lib, n_entries = library(), eng._objective.cons.index.numel()
    top = lib.moeva_objective_botnet_max_features(64, n_entries, 0)
    assert eng.codec.n_features <= top < lib.moeva_objective_botnet_max_features(16, n_entries, 0)
    assert lib.moeva_objective_botnet_max_features(64, n_entries + 2048, 0) < top
    # the augmented domain's pair tables take room too, and 927 features fit
    aug = lib.moeva_objective_botnet_max_features(64, n_entries, 171)
    assert 927 <= aug < top


def test_objective_botnet_refuses_cpu_tensors_and_wrong_widths(tmp_path):
    cons, sur, scaler, x = synthetic_botnet_problem(str(tmp_path), 2)
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", n_pop=10, n_offsprings=6)
    run = eng.prepare(x, np.ones(2, dtype=np.int64))
    cand = run.xl_gen[:, None].expand(2, 6, -1).contiguous()
    args = (run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.objective_botnet(cand, *args, eng._objective)
    for hidden, head in (((128, 32), 2), ((62, 32), 2), ((64, 32), 3), ((), 2)):
        obj = make_objective_tables(eng.codec, MLP(756, hidden, head), None, 2, 1e-3, eng._objective.cons)
        with pytest.raises(ValueError, match="objective_botnet takes a 756-input stack"):
            kernels.objective_botnet(cand, *args, obj)
    with pytest.raises(ValueError, match="botnet gather tables"):
        kernels.objective_botnet(cand, *args, eng._objective._replace(cons=None))
    assert kernels.launch_counts() == before


# -- K8 on the augmented botnet domain (927 features, 360 + 171 terms) -------------


@pytest.fixture(scope="module")
def botnet_aug(tmp_path_factory):
    """The augmented problem: 64 synthetic states, their 19 important
    features, a seeded 927-input surrogate and its scaler."""
    return synthetic_botnet_augmented_problem(str(tmp_path_factory.mktemp("botnet_aug")), 64)


def _botnet_aug_case(device, botnet_aug, s, n, seed, **knobs):
    """``_botnet_case`` on the augmented domain, with the pair terms' edge
    rows (``botnet_augmented_edge_rows``) on every ninth candidate from the
    first."""
    cons, _, _, x = botnet_aug
    eng, run, cand = _botnet_case(device, botnet_aug, s, n, seed, **knobs)
    rows = torch.as_tensor(botnet_augmented_edge_rows(x, cons.important_features), device=device)
    at = list(range(0, n, 9))[:BOTNET_AUGMENTED_EDGE_ROWS]
    cand[:, at] = codec_lib.ml_to_genetic(eng.codec, rows[:len(at)])
    return eng, run, cand


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [2, "inf"])
@pytest.mark.parametrize("s,n", [(64, 100), (64, 203), (3, 100), (1, 7), (5, 27), (41, 99)])
def test_objective_botnet_aug_equals_plain(card, botnet_aug, s, n, norm):
    eng, run, cand = _botnet_aug_case(card, botnet_aug, s, n, seed=s + n, norm=norm)
    before = kernels.launch_counts()
    got = kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class,
                                   eng._objective)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["objective_botnet_aug"] == before["objective_botnet_aug"] + 1
    assert after["objective_botnet"] == before["objective_botnet"]
    assert _same(got, evaluate_plain(eng._objective, eng.codec, run, cand, eng.constraints))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,head,norm,scaled", [((64, 64, 32), 1, 2, True), ((16, 64, 48, 5), 2, 2, True)])
def test_objective_botnet_aug_stacks_heads(card, botnet_aug, hidden, head, norm, scaled):
    eng, run, cand = _botnet_aug_case(card, botnet_aug, 40, 100, seed=head)
    model = MLP(927, hidden, head).reset_parameters_seeded(head).to(card).eval().requires_grad_(False)
    obj = make_objective_tables(eng.codec, model, eng._objective.scaler if scaled else None, norm,
                                eng.constraints.tol, eng._objective.cons)
    got = kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, obj)
    assert _same(got, evaluate_plain(obj, eng.codec, run, cand, eng.constraints))


def test_objective_botnet_aug_refuses_cpu_tensors_and_other_widths(tmp_path):
    cons, sur, scaler, x = synthetic_botnet_augmented_problem(str(tmp_path), 3)
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", n_pop=10, n_offsprings=6)
    assert eng._objective.cons.pair_idx.shape == (171, 2)
    run = eng.prepare(x, np.ones(3, dtype=np.int64))
    cand = run.xl_gen[:, None].expand(3, 6, -1).contiguous()
    args = (run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.objective_botnet(cand, *args, eng._objective)
    # the base tables on augmented rows, and pair tables one pair short
    with pytest.raises(ValueError, match="756 \\+ P on the augmented domain .* got 927 features and 0 pairs"):
        kernels.objective_botnet(cand, *args, eng._objective._replace(
            cons=eng._objective.cons._replace(pair_idx=None, pair_thr=None)))
    short = eng._objective.cons._replace(pair_idx=eng._objective.cons.pair_idx[:170])
    with pytest.raises(ValueError, match="got 927 features and 170 pairs"):
        kernels.objective_botnet(cand, *args, eng._objective._replace(cons=short))
    assert kernels.launch_counts() == before


# -- K7b pgd_botnet ----------------------------------------------------------------


@pytest.fixture(scope="module")
def pgd_botnet_problem(tmp_path_factory):
    """387 synthetic botnet states (rq1.botnet's count), the seeded
    64-64-32-2 surrogate and its scaler; the scaled rows, and starts whose
    first rows hold the terms' edge cases (``problems.botnet_edge_starts``)."""
    cons, sur, scaler, _, xs, _ = synthetic_botnet_pgd_problem(str(tmp_path_factory.mktemp("pgd_botnet")), 387)
    return cons, sur, scaler, xs.astype(np.float32), botnet_edge_starts(cons.schema.names, scaler, xs)


PGD_BOTNET_CASES = (
    dict(loss_evaluation="constraints+flip+adaptive_eps_step+repair", norm=2, record_loss="full",
         record_grad_norm=True),
    dict(loss_evaluation="flip", norm=np.inf, constraints_optim="alt_constraints", record_loss="reduced"),
    dict(loss_evaluation="constraints+flip+alternate", norm=2, targeted=True),
    dict(loss_evaluation="constraints", constraints_optim="single_constraints", ctr_id=200, norm=np.inf,
         record_loss="full"),
    dict(loss_evaluation="flip+repair", norm=2, record_loss="full", record_grad_norm=True),
)


def _pgd_botnet_args(card, xs, starts, n):
    # rows past the problem's repeat them
    xs, starts = np.resize(xs, (n, xs.shape[1])), np.resize(starts, (n, starts.shape[1]))
    return (torch.as_tensor(xs, device=card), torch.as_tensor(np.arange(n) % 2, device=card),
            torch.as_tensor(starts, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (33, 12), (387, 5), (66, 4), (67, 4), (133, 3), (331, 3), (396, 3),
                                 (397, 3)])
@pytest.mark.parametrize("case", range(len(PGD_BOTNET_CASES)))
def test_pgd_botnet_equals_plain(card, pgd_botnet_problem, case, n, t):
    # K7b runs ceil(N / 66) rows, at most 6, on each cluster of two CTAs: a
    # lone row; one row per cluster (33, and 66, the most N that gives it);
    # 67, one past it; partial last clusters (133, 331, 387); 396, 6 rows
    # on every resident cluster, and 397, a cluster past them
    cons, sur, scaler, xs, starts = pgd_botnet_problem
    knobs = PGD_BOTNET_CASES[case]
    eps = 0.3 if knobs["norm"] == 2 else 0.05
    atk = ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, device=card, **knobs)
    sched = atk.schedule(eps, 0.1, t)
    args = _pgd_botnet_args(card, xs, starts, n)
    repair, linf = "repair" in atk.loss_evaluation, knobs["norm"] == np.inf
    before = kernels.launch_counts()
    got = kernels.pgd_botnet(atk.tables, sched, *args, eps, atk.clip, linf, repair, atk.targeted,
                             atk.history_layout())
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["pgd_botnet"] == before["pgd_botnet"] + 1 and after["pgd_lcld"] == before["pgd_lcld"]
    want = pgd_run_plain(atk.tables, cons, sched, *args, eps, atk.clip, atk.norm, repair, atk.targeted,
                         atk.history_layout())
    for g, w in zip(got, want):
        assert (g is None and w is None) or _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n_classes", [((64, 64, 32), 1), ((16, 64, 48, 5), 2), ((8,), 2)])
def test_pgd_botnet_other_stacks_equal_plain(card, pgd_botnet_problem, hidden, n_classes):
    cons, _, scaler, xs, starts = pgd_botnet_problem
    model = MLP(756, hidden, n_classes).reset_parameters_seeded(3)
    atk = ConstrainedPGD(Surrogate(model), cons, scaler, eps=0.3, eps_step=0.1, norm=2, device=card,
                         loss_evaluation="constraints+flip+repair", record_loss="full")
    sched = atk.schedule(0.3, 0.1, 6)
    args = _pgd_botnet_args(card, xs, starts, 40)
    got = kernels.pgd_botnet(atk.tables, sched, *args, 0.3, atk.clip, False, True, False, atk.history_layout())
    want = pgd_run_plain(atk.tables, cons, sched, *args, 0.3, atk.clip, 2, True, False, atk.history_layout())
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.cuda
def test_pgd_botnet_refuses_what_it_does_not_take(card, pgd_botnet_problem):
    cons, sur, scaler, xs, _ = pgd_botnet_problem
    atk = ConstrainedPGD(sur, cons, scaler, device=card, max_iter=3)
    sched = atk.schedule(0.3, 0.1, 3)
    xi = torch.as_tensor(xs[:8], device=card)
    y = torch.zeros(8, dtype=torch.int64, device=card)
    run = lambda tables, x, yy, st: kernels.pgd_botnet(  # noqa: E731
        tables, sched, x, yy, st, 0.3, (0.0, 1.0), False, False, False)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        run(atk.tables, xi.cpu(), y, xi)
    with pytest.raises(TypeError, match="float32"):
        run(atk.tables, xi.double(), y, xi)
    with pytest.raises(ValueError, match="shape"):
        run(atk.tables, xi, y[:4], xi)
    with pytest.raises(ValueError, match="756 features"):
        run(atk.tables, xi[:, :700], y, xi[:, :700])
    for hidden, head in (((128, 32), 2), ((64, 32), 3), ((), 2)):
        wide = MLP(756, hidden, head).to(card)
        layers = tuple((m.weight.detach(), m.bias.detach()) for m in wide.layers)
        tables = atk.tables._replace(layers=layers, params=torch.cat([t.reshape(-1) for p in layers for t in p]),
                                     first_t=layers[0][0].t().contiguous())
        with pytest.raises(ValueError, match="pgd_botnet takes a 756-input stack"):
            run(tables, xi, y, xi)
    with pytest.raises(ValueError, match="botnet gather tables"):
        run(atk.tables._replace(cons=None), xi, y, xi)
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_pgd_generate_on_botnet_is_one_k7b_launch_per_run(card, pgd_botnet_problem):
    cons, sur, scaler, xs, _ = pgd_botnet_problem
    y = np.arange(len(xs)) % 2
    knobs = dict(eps=4.0 - 1e-6, eps_step=0.1, max_iter=20, norm=2,
                 loss_evaluation="constraints+flip+adaptive_eps_step+repair")
    kernels.reset_launch_counts()
    a = ConstrainedPGD(sur, cons, scaler, device=card, **knobs).generate(xs, y)
    assert kernels.launch_counts() == {**{k: 0 for k in kernels.launch_counts()}, "pgd_botnet": 1}
    restarts = ConstrainedPGD(sur, cons, scaler, device=card, num_random_init=2, **knobs)
    restarts.generate(xs, y)
    assert kernels.launch_counts()["pgd_botnet"] == 3
    cpu = ConstrainedPGD(sur, cons, scaler, device="cpu", **knobs).generate(xs, y)
    assert ((a == cpu) | (np.isnan(a) & np.isnan(cpu))).all()


AUTOPGD_BOTNET_CASES = tuple(
    {**case, "loss_evaluation": "autopgd+" + case["loss_evaluation"]} for case in PGD_BOTNET_CASES
)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (33, 12), (66, 12), (67, 30), (387, 12), (397, 12)])
@pytest.mark.parametrize("case", range(len(AUTOPGD_BOTNET_CASES)))
def test_autopgd_botnet_equals_plain(card, pgd_botnet_problem, case, n, t):
    # K7b's AutoPGD instantiation keeps 6 rows a cluster: the row edges of
    # test_pgd_botnet_equals_plain, the first rows holding the terms' edges
    knobs = AUTOPGD_BOTNET_CASES[case]
    eps = 0.3 if knobs["norm"] == 2 else 0.05
    _autopgd_equals_plain(card, pgd_botnet_problem, knobs, n, t, "pgd_botnet_auto", kernels.pgd_botnet, eps)


@pytest.mark.cuda
def test_autopgd_generate_on_botnet_equals_the_cpu(card, pgd_botnet_problem):
    cons, sur, scaler, xs, _ = pgd_botnet_problem
    y = np.arange(len(xs)) % 2
    knobs = dict(eps=4.0 - 1e-6, eps_step=4.0 / 3, max_iter=20, norm=2, loss_evaluation="autopgd+constraints+flip")
    kernels.reset_launch_counts()
    on_card = AutoPGD(sur, cons, scaler, device=card, **knobs)
    got = on_card.generate(xs, y)
    assert kernels.launch_counts() == {**{k: 0 for k in kernels.launch_counts()}, "pgd_botnet_auto": 1}
    want = AutoPGD(sur, cons, scaler, device="cpu", **knobs).generate(xs, y)
    assert ((got == want) | (np.isnan(got) & np.isnan(want))).all()
    assert on_card.last_eta.shape == (len(xs),)
    AutoPGD(sur, cons, scaler, device=card, num_random_init=2, **knobs).generate(xs, y)
    assert kernels.launch_counts()["pgd_botnet_auto"] == 3
    with pytest.raises(ValueError, match="max_iter=21 differs"):
        on_card.generate(xs, y, max_iter=21)


@pytest.mark.cuda
def test_autopgd_botnet_refuses_bad_tables(card, pgd_botnet_problem):
    cons, sur, scaler, xs, _ = pgd_botnet_problem
    atk = AutoPGD(sur, cons, scaler, device=card, max_iter=3)
    sched = atk.schedule(0.3, 0.1, 3)
    xi = torch.as_tensor(xs[:8], device=card)
    y = torch.zeros(8, dtype=torch.int64, device=card)
    run = lambda auto: kernels.pgd_botnet(  # noqa: E731
        atk.tables, sched.pgd, xi, y, xi, 0.3, (0.0, 1.0), False, False, False, auto=auto)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="is_ckpt must have shape"):
        run(sched.auto._replace(is_ckpt=sched.auto.is_ckpt[:-1]))
    with pytest.raises(ValueError, match="tracking constraint 360"):
        run(sched.auto._replace(ctr=360))
    assert kernels.launch_counts() == before


def test_autopgd_botnet_wrapper_refuses_cpu_tensors(tmp_path):
    cons, sur, scaler, x, xs, y = synthetic_botnet_pgd_problem(str(tmp_path), 4)
    atk = AutoPGD(sur, cons, scaler, device="cpu", max_iter=2)
    sched = atk.schedule(0.3, 0.1, 2)
    xi = torch.as_tensor(xs, dtype=torch.float32)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pgd_botnet(atk.tables, sched.pgd, xi, torch.as_tensor(y), xi, 0.3, (0.0, 1.0), False, False, False,
                           auto=sched.auto)
    assert kernels.launch_counts() == before


def test_pgd_botnet_wrapper_refuses_cpu_tensors_and_other_stacks(tmp_path):
    cons, sur, scaler, x, xs, y = synthetic_botnet_pgd_problem(str(tmp_path), 4)
    atk = ConstrainedPGD(sur, cons, scaler, device="cpu", max_iter=2)
    xi = torch.as_tensor(xs, dtype=torch.float32)
    yt = torch.as_tensor(y)
    run = lambda tables, x: kernels.pgd_botnet(  # noqa: E731
        tables, atk.schedule(0.3, 0.1, 2), x, yt, x, 0.3, (0.0, 1.0), True, False, False)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        run(atk.tables, xi)
    with pytest.raises(ValueError, match="756 features"):
        run(atk.tables, xi[:, :47])
    layers = tuple((m.weight.detach(), m.bias.detach()) for m in MLP(756, (128, 32), 2).layers)
    with pytest.raises(ValueError, match="pgd_botnet takes a 756-input stack"):
        run(atk.tables._replace(layers=layers), xi)
    with pytest.raises(ValueError, match="botnet gather tables"):
        run(atk.tables._replace(cons=None), xi)
    assert kernels.launch_counts() == before


# -- K7b at 927: the augmented botnet domain -----------------------------------------


@pytest.fixture(scope="module")
def pgd_botnet_aug_problem(tmp_path_factory):
    """rq2.botnet's 387 synthetic states of the augmented domain (927
    features, 531 terms), its seeded surrogate and scaler; the scaled rows,
    and starts with the base terms' edges in the first rows
    (``problems.botnet_edge_starts``) and the pair terms' after them
    (``problems.botnet_augmented_edge_rows``)."""
    cons, sur, scaler, x = synthetic_botnet_augmented_problem(str(tmp_path_factory.mktemp("pgd_botnet_aug")), 387)
    xs = scaler.transform(x)
    starts = botnet_edge_starts(cons.schema.names, scaler, xs)
    r = BOTNET_EDGE_ROWS
    rows = botnet_augmented_edge_rows(x[r:r + BOTNET_AUGMENTED_EDGE_ROWS], cons.important_features, np.float64)
    starts[r:r + BOTNET_AUGMENTED_EDGE_ROWS] = scaler.transform(rows)
    return cons, sur, scaler, xs.astype(np.float32), starts


PGD_BOTNET_AUG_CASES = (
    dict(loss_evaluation="constraints+flip+adaptive_eps_step", norm=2, record_loss="full", record_grad_norm=True),
    dict(loss_evaluation="constraints", norm=np.inf, constraints_optim="alt_constraints", record_loss="full"),
    dict(loss_evaluation="constraints+flip+constraints", constraints_optim="single_constraints", ctr_id=400, norm=2,
         targeted=True, record_loss="reduced"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("auto", [False, True], ids=["pgd", "autopgd"])
@pytest.mark.parametrize("n,t", [(1, 7), (66, 4), (67, 4), (265, 3), (331, 3), (387, 12)])
@pytest.mark.parametrize("case", range(len(PGD_BOTNET_AUG_CASES)))
def test_pgd_botnet_aug_equals_plain(card, pgd_botnet_aug_problem, case, n, t, auto):
    # 5 rows a cluster fit at 927 features under PGD, 4 under AutoPGD: 330
    # and 264 rows on the 66 resident clusters, 331 and 265 a second wave
    cons, sur, scaler, xs, starts = pgd_botnet_aug_problem
    knobs = dict(PGD_BOTNET_AUG_CASES[case])
    if auto:
        knobs["loss_evaluation"] = "autopgd+" + knobs["loss_evaluation"]
    eps = 0.3 if knobs["norm"] == 2 else 0.05
    step = eps / 3 if auto else 0.1
    atk = (AutoPGD if auto else ConstrainedPGD)(sur, cons, scaler, eps=eps, eps_step=step, device=card, **knobs)
    sched = atk.schedule(eps, step, t)
    args = _pgd_botnet_args(card, xs, starts, n)
    linf = knobs["norm"] == np.inf
    counter = "pgd_botnet_aug_auto" if auto else "pgd_botnet_aug"
    before = kernels.launch_counts()
    extra = {"auto": sched.auto} if auto else {}
    got = kernels.pgd_botnet(atk.tables, sched.pgd if auto else sched, *args, eps, atk.clip, linf, False,
                             atk.targeted, atk.history_layout(), **extra)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[counter] == before[counter] + 1 and after["pgd_botnet"] == before["pgd_botnet"]
    plain = autopgd_run_plain if auto else pgd_run_plain
    want = plain(atk.tables, cons, sched, *args, eps, atk.clip, atk.norm, False, atk.targeted, atk.history_layout())
    for g, w in zip(got, want):
        assert (g is None and w is None) or _same(g, w)


@pytest.mark.cuda
def test_pgd_generate_on_botnet_aug_is_one_launch_per_run(card, pgd_botnet_aug_problem):
    cons, sur, scaler, xs, _ = pgd_botnet_aug_problem
    y = np.arange(len(xs)) % 2
    knobs = dict(eps=4.0 - 1e-6, eps_step=0.1, max_iter=20, norm=2, loss_evaluation="constraints+flip")
    kernels.reset_launch_counts()
    a = ConstrainedPGD(sur, cons, scaler, device=card, **knobs).generate(xs, y)
    assert kernels.launch_counts() == {**{k: 0 for k in kernels.launch_counts()}, "pgd_botnet_aug": 1}
    cpu = ConstrainedPGD(sur, cons, scaler, device="cpu", **knobs).generate(xs, y)
    assert ((a == cpu) | (np.isnan(a) & np.isnan(cpu))).all()


def test_pgd_botnet_aug_wrapper_refuses_repair_other_widths_and_cpu_tensors(tmp_path):
    """On the augmented domain the wrapper refuses repair (the set has
    none), rows of another width than 756 + P, and CPU tensors, before it
    builds anything."""
    cons, sur, scaler, x = synthetic_botnet_augmented_problem(str(tmp_path), 4)
    atk = ConstrainedPGD(sur, cons, scaler, device="cpu", max_iter=2)
    xi = torch.as_tensor(scaler.transform(x), dtype=torch.float32)
    y = torch.zeros(4, dtype=torch.int64)
    run = lambda x_, repair: kernels.pgd_botnet(  # noqa: E731
        atk.tables, atk.schedule(0.3, 0.1, 2), x_, y, x_, 0.3, (0.0, 1.0), False, repair, False)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="no repair on the augmented domain"):
        run(xi, True)
    with pytest.raises(ValueError, match=r"756 \+ P on the augmented domain.*got 756 features and 171 pairs"):
        run(xi[:, :756], False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        run(xi, False)
    assert kernels.launch_counts() == before


# -- K6: the early exit's gate and repack ----------------------------------------


def _gate_objectives(rng, s, m, thr, eps):
    """float32 objectives with the gate's edges: NaN and ±inf entries, an
    all-NaN state, f1 exactly at ``thr``, f2 exactly at ``eps``, violations
    exactly 0 and -0."""
    f = rng.uniform(-0.1, 1.0, size=(s, m, 3)).astype(np.float32)
    f[..., 2] = np.where(rng.random((s, m)) < 0.3, 0.0, np.abs(f[..., 2]))
    f[rng.random((s, m)) < 0.05, 2] = -0.0
    f[rng.random((s, m)) < 0.05, 0] = thr
    f[rng.random((s, m)) < 0.05, 1] = eps
    for col in range(3):
        f[rng.random((s, m)) < 0.03, col] = np.nan
        f[rng.random((s, m)) < 0.02, col] = np.inf
        f[rng.random((s, m)) < 0.01, col] = -np.inf
    f[0] = np.nan
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 8, 33, 131, 1000])
@pytest.mark.parametrize("p,a", [(103, 0), (103, 10), (193, 10), (303, 0)])
def test_gate_stats_equals_plain(card, s, p, a):
    rng = np.random.default_rng(s * 7 + p + a)
    thr, eps = float(np.float32(0.3)), float(np.float32(0.25 / np.sqrt(47)))
    f = torch.as_tensor(_gate_objectives(rng, s, p + a, thr, eps), device=card)
    pop_f, arch_f = f[:, :p].contiguous(), f[:, p:].contiguous()
    got = kernels.gate_stats(pop_f, arch_f, thr, eps)
    assert _same(got, engine_quality_stats(f, thr, eps))
    got = kernels.gate_stats(pop_f, arch_f, thr, float("inf"))
    assert _same(got, engine_quality_stats(f, thr, float("inf")))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [47, 57, 756, 927])
@pytest.mark.parametrize("a", [0, 10])
def test_take_carry_and_final_columns_equal_index_select(card, l, a):
    s, p = 33, 103
    rng = np.random.default_rng(l + a)
    shapes = ((s, p, l), (s, p, 3), (s, a, l), (s, a, 3), (s, 3), (s, 3), (s, 3, 3))
    leaves = [torch.as_tensor(rng.normal(size=sh).astype(np.float32), device=card) for sh in shapes]
    leaves[1][0, 0, 0] = float("nan")
    leaves[0][1, 2, 3] = -0.0
    for sel in (np.array([32, 4, 4, 4, 0]), np.arange(s), np.arange(s)[::-1].copy(), np.full(64, 7)):
        before = kernels.launch_counts()["take_carry"]
        got = kernels.take_carry(sel, leaves)
        want = take_carry_plain(torch.as_tensor(sel, device=card), leaves)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g.view(torch.int32), w.view(torch.int32))
        gx, gf = kernels.final_columns(sel, *leaves[:4])
        wx, wf = final_columns_plain(torch.as_tensor(sel, device=card), *leaves[:4])
        assert torch.equal(gx.view(torch.int32), wx.view(torch.int32))
        assert torch.equal(gf.view(torch.int32), wf.view(torch.int32))
        assert kernels.launch_counts()["take_carry"] == before + 2


@pytest.mark.cuda
def test_take_carry_refuses_indices_out_of_range(card):
    leaves = [torch.zeros((5, 4, 3), device=card), torch.zeros((5, 3), device=card)]
    before = kernels.launch_counts()
    for bad in (np.array([0, 5]), np.array([-1]), torch.tensor([1], device=card), np.array([0.0])):
        with pytest.raises((ValueError, TypeError)):
            kernels.take_carry(bad, leaves)
    with pytest.raises(ValueError, match="lie in"):
        kernels.final_columns(np.array([5]), leaves[0], leaves[0], leaves[0][:, :0], leaves[0][:, :0])
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_early_exit_generate_on_the_card_equals_the_cpu(card, lcld):
    """An early-exit run with repacks on the card equals the same run on
    the CPU fed the same draws (recorded from the CPU's generator)."""
    cons, sur, scaler, x = lcld
    x = x[:64]
    knobs = dict(norm=2, n_gen=21, n_pop=100, n_offsprings=100, archive_size=10, seed=4, early_stop_check_every=4,
                 early_stop_threshold=0.5, compaction_buckets=(8, 16, 32), record_quality=True)
    cpu = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs)
    recorded = []

    class Recording(PhiloxDraws):
        def init(self, n):
            recorded.append(super().init(n))
            return recorded[-1]

        def generation(self, n):
            recorded.append(super().generation(n))
            return recorded[-1]

    class Replay:
        def __init__(self):
            self.items = iter(recorded)

        def init(self, n):
            d = next(self.items)
            return type(d)(*(None if t is None else t.to(card) for t in d))

        def generation(self, n):
            d = next(self.items)
            return type(d)(type(d.offspring)(*(t.to(card) for t in d.offspring)), d.gum_cut.to(card),
                           d.gum_mem.to(card))

    cpu.draw_hook = lambda i: Recording(cpu, cpu.seed)
    want = cpu.generate(x, 1)
    gpu = Moeva2(sur, cons, ml_scaler=scaler, device=card, **knobs)
    gpu.draw_hook = lambda i: Replay()
    kernels.reset_launch_counts()
    got = gpu.generate(x, 1)
    assert want.early_stop["compaction"] and got.early_stop == want.early_stop
    for k in ("x_gen", "f", "x_ml"):
        assert np.array_equal(getattr(got, k), getattr(want, k), equal_nan=True), k
    counts = kernels.launch_counts()
    gates = len([g for g in range(4, knobs["n_gen"] - 1, 4) if g <= got.gens_executed])
    assert counts["gate_stats"] == gates and counts["take_carry"] >= 1


def test_gate_repack_wrappers_refuse_cpu_tensors():
    f = torch.zeros((2, 5, 3))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gate_stats(f, f[:, :0], 0.5, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.take_carry(np.array([1, 0]), [f, f[..., 0]])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.final_columns(np.array([1]), f, f, f[:, :0], f[:, :0])
    assert kernels.launch_counts() == before
    # the host-side range check every K6b launch goes through
    assert kernels._host_rows(np.array([0, 4, 4]), 5).tolist() == [0, 4, 4]
    for bad, err in ((np.array([0, 5]), ValueError), (np.array([-1]), ValueError), (np.array([0.5]), TypeError),
                     (torch.tensor([[0]]), ValueError), (torch.tensor([0], dtype=torch.int32), TypeError)):
        with pytest.raises(err):
            kernels._host_rows(bad, 5)


# -- K1h and K8h: the history instantiations of K1 and K8 -----------------------


def _history_case(card, request, domain, s, n):
    """An engine, its run inputs for ``s`` states, (S, N, L) candidates with
    the domain's edge rows (ratio poles, NaN and infinite terms), the
    kernel and its base and history launch counters."""
    if domain == "lcld":
        eng, run, carry, _ = _engine_state(card, request.getfixturevalue("lcld"), s, seed=s + n)
        return eng, run, _hard_offspring(eng, carry.pop_x[:, :n]), kernels.objective_lcld, "objective_lcld"
    if domain == "lcld_aug":
        lcld_aug = request.getfixturevalue("lcld_aug")
        cons, sur, scaler, x = lcld_aug
        eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_pop=100, n_offsprings=100, seed=s)
        run = eng.prepare(x[:s], np.arange(s) % 2)
        pop = eng.init_carry(run, *draw_gumbels(PhiloxStream(s, card), s, eng.n_dirs, eng.pop_size)).pop_x
        cand = _aug_candidates(eng, lcld_aug, _hard_offspring(eng, pop[:, :n]))
        return eng, run, cand, kernels.objective_lcld, "objective_lcld_aug"
    if domain == "botnet":
        eng, run, cand = _botnet_case(card, request.getfixturevalue("botnet"), s, n, seed=s + n)
        return eng, run, cand, kernels.objective_botnet, "objective_botnet"
    eng, run, cand = _botnet_aug_case(card, request.getfixturevalue("botnet_aug"), s, n, seed=s + n)
    return eng, run, cand, kernels.objective_botnet, "objective_botnet_aug"


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["lcld", "lcld_aug", "botnet", "botnet_aug"])
@pytest.mark.parametrize("s,n", [(64, 100), (3, 100), (1, 7), (5, 27)])
def test_history_instantiations_equal_plain(card, request, domain, s, n):
    """The history instantiation (``record`` of 3 + K columns) writes the
    plain history form's record bit for bit, NaN and inf included, and an
    ``out`` equal to the base kernel's; a (S, N, 3) record is the base
    kernel's output itself."""
    eng, run, cand, kernel, base = _history_case(card, request, domain, s, n)
    args = (cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
    want_out = kernel(*args)
    record = torch.full((s, n, 3 + eng.constraints.get_nb_constraints()), float("nan"), device=card)
    before = kernels.launch_counts()
    out = kernel(*args, record=record)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[base + "_hist"] == before[base + "_hist"] + 1 and after[base] == before[base]
    f, want = evaluate_hist_plain(eng._objective, eng.codec, run, cand, eng.constraints, "full")
    assert not bool(torch.isfinite(want).all())  # the edge rows show
    assert _same(out, want_out) and _same(out, f) and _same(record, want)
    reduced = torch.full((s, n, 3), float("nan"), device=card)
    got = kernel(*args, record=reduced)
    assert got.data_ptr() == reduced.data_ptr() and _same(reduced, want_out)
    assert kernels.launch_counts()[base] == after[base] + 1


@pytest.mark.cuda
def test_history_record_is_checked(card, lcld):
    eng, run, carry, _ = _engine_state(card, lcld, 4, seed=1)
    args = (carry.pop_x, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
    p = carry.pop_x.shape[1]
    for bad, match in ((torch.empty((4, p, 12), device=card), "record must be"),
                       (torch.empty((4, p, 13), device=card, dtype=torch.float64), "float32"),
                       (torch.empty((4, 13, p), device=card).transpose(1, 2), "contiguous"),
                       (torch.empty((4, p, 13)), "CUDA tensor")):
        with pytest.raises((ValueError, TypeError), match=match):
            kernels.objective_lcld(*args, record=bad)


# -- K9 objective_spec: a domain compiled from a constraint spec --------------------------

#: the phishing oracle's config (tests/fixtures/oracle_interior_rates.json)
PHISHING_CONFIG = {"n_states": 16, "pool": 512, "pool_seed": 11, "thresholds": {"f1": 0.5, "f2": 0.5}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lcld_spec", "botnet_spec", "phishing", "family2"])
@pytest.mark.parametrize("norm", [2, "inf"])
def test_objective_spec_equals_plain_on_the_card(card, tmp_path, name, norm):
    if name == "lcld_spec":
        cons, sur, scaler, x = synthetic_lcld_spec_problem(str(tmp_path), 5)
    elif name == "botnet_spec":
        cons, sur, scaler, x = synthetic_botnet_spec_problem(str(tmp_path), 3)
    elif name == "phishing":
        cons, sur, scaler, x = phishing_problem(PHISHING_CONFIG)
    else:
        cons, sur, scaler, x = synthetic_family_problem(str(tmp_path), 2, 5)
    eng = Moeva2(sur, cons, ml_scaler=scaler, norm=norm, n_pop=12, n_offsprings=6, device=card,
                 save_history="full")
    run = eng.prepare(x, np.arange(len(x)) % 2)
    cand = torch.as_tensor(spec_candidates(eng._codec_cpu, cons, x, 37), dtype=torch.float32, device=card)
    args = (cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, eng._objective)
    record = torch.full((*cand.shape[:2], eng.history_columns()), float("nan"), device=card)
    kernels.reset_launch_counts()
    out = kernels.objective_spec(*args)
    hist = kernels.objective_spec(*args, record=record)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["objective_spec"] == 1 and kernels.launch_counts()["objective_spec_hist"] == 1
    f, want = evaluate_hist_plain(eng._objective, eng.codec, run, cand, cons, "full")
    for got, exp in ((out, f), (hist, f), (record, want)):
        np.testing.assert_array_equal(got.cpu().numpy(), exp.cpu().numpy())


# -- K10 pgd_spec: constrained PGD and AutoPGD on a domain compiled from a spec --------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lcld_spec", "botnet_spec", "phishing", "family2"])
@pytest.mark.parametrize("attack", [ConstrainedPGD, AutoPGD])
@pytest.mark.parametrize("loss, norm, record", [("constraints+flip+repair", 2, "full"), ("flip", "inf", None),
                                                ("constraints+flip+alternate", "inf", "reduced")])
def test_pgd_spec_equals_plain_on_the_card(card, tmp_path, name, attack, loss, norm, record):
    if name == "lcld_spec":
        cons, sur, scaler, x = synthetic_lcld_spec_problem(str(tmp_path), 40)
    elif name == "botnet_spec":
        cons, sur, scaler, x = synthetic_botnet_spec_problem(str(tmp_path), 9)
    elif name == "phishing":
        cons, sur, scaler, x = phishing_problem(PHISHING_CONFIG)
    else:
        cons, sur, scaler, x = synthetic_family_problem(str(tmp_path), 2, 40)
    starts = np.concatenate([spec_edge_rows(cons, x), x])
    n = len(starts)
    xi = torch.as_tensor(scaler.transform(np.resize(x, starts.shape)), dtype=torch.float32, device=card)
    st = torch.as_tensor(np.clip(scaler.transform(starts), -1.0, 2.0), dtype=torch.float32, device=card)
    atk = attack(sur, cons, scaler, eps=0.2, eps_step=0.05, max_iter=13, norm=norm, loss_evaluation=loss,
                 record_loss=record, record_grad_norm=record == "full", device=card)
    y = torch.as_tensor(np.arange(n) % 2, device=card)
    sched = atk.schedule(0.2, 0.05, 13)
    kernels.reset_launch_counts()
    got = atk.one_run(xi, y, st, sched, 0.2)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pgd_spec" if attack is ConstrainedPGD else "pgd_spec_auto"] == 1
    plain = pgd_run_plain if attack is ConstrainedPGD else autopgd_run_plain
    want = plain(atk.tables, cons, sched, xi, y, st, 0.2, atk.clip, atk.norm, "repair" in loss, False,
                 atk.history_layout())
    if attack is AutoPGD:
        got = (*got, atk.last_eta)
    for a, b in zip(got, want):
        if a is not None or b is not None:
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


# -- K11 train_step (and its loss-only instantiation) and K12 input_grad -------------

#: (batch, widths): the defense pipelines' four training shapes, a partial
#: tile and a one-row batch
TRAIN_SHAPES = [(512, (47, 64, 32, 16, 2)), (512, (57, 64, 32, 16, 2)), (256, (756, 64, 64, 32, 2)),
                (256, (927, 64, 64, 32, 2)), (37, (9, 5, 2)), (1, (3, 2))]


def _train_inputs(widths, n, seed, device):
    from moeva2_ijcai22_replication_tpu_torch.models.mlp import MLP
    from moeva2_ijcai22_replication_tpu_torch.models.train import flat_params

    rng = np.random.default_rng(seed)
    model = MLP(widths[0], widths[1:-1]).reset_parameters_seeded(seed)
    params = flat_params(model).to(device)
    x = torch.as_tensor(rng.normal(0, 1, (n, widths[0])), dtype=torch.float32, device=device)
    y = torch.as_tensor(rng.integers(0, 2, n), device=device)
    w = np.ones(n, dtype=np.float32)
    w[n - n // 5:] = 0.0  # a weight-0 padded tail
    return params, x, y, torch.as_tensor(w, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n, widths", TRAIN_SHAPES)
@pytest.mark.parametrize("class_weight", [None, {0: 1.0, 1: 4.0}])
def test_train_step_equals_plain_on_the_card(card, n, widths, class_weight):
    """K11 against ``train_step_plain`` on the card over 5 steps, bit for bit
    (parameters, moments, losses), and its loss-only instantiation against
    ``train_loss_plain``."""
    from moeva2_ijcai22_replication_tpu_torch.models.train import (
        adam_scalars, class_weight_vector, train_loss_plain, train_step_plain,
    )

    params, x, y, w = _train_inputs(widths, n, n, card)
    cw = torch.tensor(class_weight_vector(class_weight), dtype=torch.float32, device=card)
    got = [params.clone(), torch.zeros_like(params), torch.zeros_like(params)]
    want = [params.clone(), torch.zeros_like(params), torch.zeros_like(params)]
    kernels.reset_launch_counts()
    for step in range(5):
        adam = adam_scalars(step, 1e-3)
        loss = kernels.train_step(widths, *got, x, y, w, cw, adam)
        loss_p = train_step_plain(widths, *want, x, y, w, cw, adam)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(loss.cpu().numpy(), loss_p.cpu().numpy())
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    part = kernels.train_loss(widths, got[0], x, y, cw)
    np.testing.assert_array_equal(part.cpu().numpy(), train_loss_plain(widths, got[0], x, y, cw).cpu().numpy())
    assert kernels.launch_counts()["train_step"] == 5 and kernels.launch_counts()["train_loss"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n, widths", [(10000, (47, 64, 32, 16, 2)), (600, (756, 64, 64, 32, 2)), (33, (9, 5, 2))])
def test_input_grad_equals_plain_on_the_card(card, n, widths):
    from moeva2_ijcai22_replication_tpu_torch.models.train import input_grad_plain

    params, x, _, _ = _train_inputs(widths, n, 7, card)
    kernels.reset_launch_counts()
    got = kernels.input_grad(widths, params, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["input_grad"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), input_grad_plain(widths, params, x).cpu().numpy())


def test_training_wrappers_refuse_cpu_tensors():
    widths = (9, 5, 2)
    params, x, y, w = _train_inputs(widths, 4, 0, "cpu")
    cw = torch.ones(2)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.train_step(widths, params, params.clone(), params.clone(), x, y, w, cw, (0.1,) * 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.train_loss(widths, params, x, y, cw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.input_grad(widths, params, x)
    assert kernels.launch_counts() == before


# -- K0: the draws; K13: a chunk's prepare and decode ----------------------------------


def _same(got, want):
    return bool(((got == want) | (got.isnan() & want.isnan()) if got.is_floating_point() else got == want).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 31, 33, 1000])
@pytest.mark.parametrize("init", [False, True])
def test_draws_equals_plain(card, lcld, s, init):
    # a generation's seven fields from a stream part-way through, or
    # lp_ratio's initial round (the L2 ball and the gumbels); odd counts
    # leave partial last blocks
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.initialisation import n_perturbed
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import offspring_fields
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import gumbel_fields
    from moeva2_ijcai22_replication_tpu_torch.core.philox import NORMAL, Field, draw_plain

    cons, sur, scaler, x = lcld
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_pop=100, n_offsprings=99, archive_size=24,
                 init="lp_ratio")
    before = kernels.launch_counts()["draws"]
    if init:
        got = PhiloxDraws(eng, s).init(s)._asdict()
        fields = [Field("ball", NORMAL, (s, n_perturbed(eng.pop_size, 0.5), eng.codec.gen_length + 2))]
        fields += gumbel_fields(s, eng.n_dirs, eng.pop_size)
        want = draw_plain(fields, torch.float32, s, 0, card)
    else:
        stream = PhiloxStream(s, card)
        stream.take(12345)
        draws = eng.draw_generation(stream, s)
        got = dict(draws.offspring._asdict(), gum_cut=draws.gum_cut, gum_mem=draws.gum_mem)
        fields = offspring_fields(s, eng.pop_size, eng.n_offsprings, eng.codec.gen_length)
        fields += gumbel_fields(s, eng.n_dirs, eng.pop_size + eng.n_offsprings)
        want = draw_plain(fields, torch.float32, s, 12345, card)
        want["cut_a"], want["cut_b"] = want["cuts"][0], want["cuts"][1]
    assert kernels.launch_counts()["draws"] == before + 1
    for name, t in got.items():
        assert t.is_cuda and t.dtype == want[name].dtype and _same(t, want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [2, "inf"])
@pytest.mark.parametrize("n", [1, 33, 4000])
def test_pgd_start_equals_plain(card, lcld, norm, n):
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_start_plain, start_fields
    from moeva2_ijcai22_replication_tpu_torch.core.philox import layout

    cons, sur, scaler, x = lcld
    atk = ConstrainedPGD(sur, cons, scaler, eps=0.2, norm=norm, device=card)
    xs = torch.as_tensor(scaler.transform(x)[np.arange(n) % len(x)], dtype=torch.float32, device=card)
    stream = PhiloxStream(n, card)
    got = atk.random_start(stream, xs, 0.2)
    fields = start_fields(norm, *xs.shape)
    base = stream.counter - layout(fields, torch.float32)[1]
    want = pgd_start_plain(fields, stream.key, base, xs, atk.tables.mutable, 0.2, atk.clip, norm == "inf")
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 33, 1000])
@pytest.mark.parametrize("init,norm", [("tile", 2), ("lp_ratio", 2), ("lp_ratio", "inf")])
def test_chunk_prepare_and_decode_equal_plain(card, lcld, s, init, norm):
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.chunk_io import (
        chunk_decode_plain, chunk_prepare_plain,
    )

    cons, sur, scaler, x = lcld
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=card, n_pop=100, n_offsprings=100, archive_size=24, init=init,
                 norm=norm, init_eps=0.3)
    xs = x[np.arange(s) % len(x)]
    ball = PhiloxDraws(eng, 3).init(s).ball
    run, got = eng._prepare(xs, np.ones(s, dtype=np.int64), eng.init_spec(ball))
    want = chunk_prepare_plain(eng._chunk, run.x_init_ml, run.xl_ml, run.xu_ml, eng.init_spec(ball))
    for a, b in zip((got.xl_gen, got.xu_gen, got.x_mm, got.pop_x, *got.norm_state),
                    (want.xl_gen, want.xu_gen, want.x_mm, want.pop_x, *want.norm_state)):
        assert _same(a, b)
    carry = eng.init_carry(run, *PhiloxDraws(eng, 4).init(s)[1:], start=got)
    args = (eng._chunk, carry.pop_x, carry.arch_x, carry.pop_f, carry.arch_f, run.x_init_ml)
    for a, b in zip(kernels.chunk_decode(*args), chunk_decode_plain(*args)):
        assert _same(a, b)


# -- K14 refdirs, K15 restart, K16 forward; K2, K4a and K3 through two pointers --


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_iter", [(2, 5), (33, 40), (100, 300), (200, 300)])
def test_refdirs_equals_plain(card, n, n_iter):
    theta = torch.as_tensor(start_point(3, n, n), device=card)
    sched = descent_schedule(n_iter).to(card)
    before = kernels.launch_counts()["refdirs"]
    got = kernels.refdirs(theta, sched, 4.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["refdirs"] == before + 1
    assert _same(got, energy_descent_plain(theta, 4.0, sched))


@pytest.mark.cuda
@pytest.mark.parametrize("n_dim", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [2, 31, 100, 300, 1024])
def test_refdirs_equals_plain_at_every_launch_shape(card, n, n_dim):
    """K14's cluster at its edges: a CTA with no points (2 and 31 points on
    a power-of-two cluster), one weight tile (100, 300) and several with a
    partial last one (1024 points), 1 to 4 dimensions (1: every weight
    pow(0, -2), NaN from the first step on, as in the plain version)."""
    s = float(n_dim + 1)
    theta = torch.as_tensor(start_point(n_dim, n, n + n_dim), device=card)
    sched = descent_schedule(20).to(card)
    got = kernels.refdirs(theta, sched, s)
    torch.cuda.synchronize()
    assert _same(got, energy_descent_plain(theta, s, sched))


@pytest.mark.cuda
@pytest.mark.parametrize("n_starts,targeted,record", [(1, False, False), (3, False, True), (3, True, True)])
def test_restart_equals_plain(card, n_starts, targeted, record):
    rng = np.random.default_rng(n_starts + 2 * targeted)
    n, d, t, c = 1000, 47, 7, 4
    x_init = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 2, n))
    got = (x_init.to(card), None, torch.empty((n_starts, n), dtype=torch.bool, device=card))
    want = (x_init, None, torch.empty((n_starts, n), dtype=torch.bool))
    before = kernels.launch_counts()["restart"]
    for r in range(n_starts):
        x_adv = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
        pred = torch.as_tensor(rng.integers(0, 2, n))
        hist = torch.as_tensor(rng.normal(size=(t, n, c)).astype(np.float32)) if record else None
        got = (*restart(x_adv.to(card), pred.to(card), y.to(card), None if hist is None else hist.to(card),
                        got[0], got[1], got[2], r, targeted), got[2])
        want = (*restart(x_adv, pred, y, hist, want[0], want[1], want[2], r, targeted), want[2])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["restart"] == before + n_starts
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
    assert (got[1] is None) == (not record)
    if record:
        assert torch.equal(got[1].cpu(), want[1])
    assert got[0].data_ptr() != x_init.to(card).data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n", [((47, 64, 32, 16, 2), 1000), ((756, 64, 64, 32, 2), 67), ((57, 16, 1), 9),
                                     ((131, 64, 2), 37), ((300, 256, 256, 1), 45)])
def test_forward_equals_plain(card, widths, n):
    """K16 bit for bit, a NaN row included: LCLD's stack (staged whole),
    botnet's (the first layer in chunks), a 1-unit head, 131 inputs
    (whole in float32; in float64 three chunks of the first layer, the
    last a partial one) and 256-unit layers (chunked hidden layers, four
    units a thread), at row counts that leave a partial tile."""
    model = MLP(widths[0], widths[1:-1], widths[-1]).reset_parameters_seeded(n)
    x = np.random.default_rng(n).uniform(-1.0, 2.0, (n, widths[0]))
    x[1, 0] = np.nan
    w32, p32, layers32 = stack_tensors(model, torch.float32, card)
    x32 = torch.as_tensor(x, dtype=torch.float32, device=card)
    before = kernels.launch_counts()
    labels = kernels.forward_labels(x32, p32, w32)
    _, p64, layers64 = stack_tensors(model, torch.float64, card)
    x64 = torch.as_tensor(x, device=card)
    proba1 = kernels.forward_proba1(x64, p64, w32)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert (after["forward_labels"], after["forward_proba1"]) == (before["forward_labels"] + 1,
                                                                   before["forward_proba1"] + 1)
    assert torch.equal(labels, torch.argmax(mlp_proba_plain(layers32, x32), dim=-1))
    assert _same(proba1, proba1_plain(layers64, x64))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 537])
def test_two_pointer_survival_kernels_equal_the_concatenation(card, lcld, s):
    eng, run, carry, draws = _engine_state(card, lcld, s, seed=s)
    off = kernels.offspring(eng.tables, carry.pop_x, run.xl_gen, run.xu_gen, 100, draws.offspring)
    off_f = eng._evaluate(run, off)
    off_f[::3, 7, 1] = torch.nan
    f = torch.cat([carry.pop_f, off_f], dim=1)
    ranks = kernels.nd_peel(carry.pop_f, eng.pop_size, off_f)
    assert _same(ranks, kernels.nd_peel(f, eng.pop_size)) and _same(ranks, nd_ranks_plain(f, eng.pop_size))
    got = kernels.survive_norm(carry.pop_f, ranks, eng.asp_points, carry.norm_state, off_f)
    state, nadir, dirs = survive_norm_plain(f, ranks, eng.asp_points, carry.norm_state)
    for g, w, p in zip(got, kernels.survive_norm(f, ranks, eng.asp_points, carry.norm_state),
                       (*state, nadir, dirs)):
        assert _same(g, w) and _same(g, p)
    ideal, nadir, dirs = got[0], got[3], got[4]
    niche, dist = kernels.associate(carry.pop_f, dirs, ideal, nadir, off_f)
    for g, w, p in zip((niche, dist), kernels.associate(f, dirs, ideal, nadir), associate_plain(f, dirs, ideal, nadir)):
        assert _same(g, w) and _same(g, p)
    on_card = survive_stages(carry.pop_f, eng.asp_points, carry.norm_state, eng.pop_size, off_f)
    assert _same(on_card[0], ranks) and _same(on_card[2], niche) and _same(on_card[3], dist)

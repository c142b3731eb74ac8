"""The port's draw source (``core/philox.py``, kernel K0's plain version) on
the CPU.

- Philox4x32-10 against Random123's published known-answer vectors;
- every field kind, in both dtypes, against a scalar Python model of the
  stated layout and word maps (integers and uniforms exactly; gumbels and
  normals, which round a float64 ``log``, ``cos`` or ``sin`` of the CPU's
  libraries, within 1e-15 of the model's float64 value before rounding, so
  at most one unit in the last place of the dtype);
- each field of a MoEvA generation, of its initial round and of a PGD start
  against the JAX draw it replaces: shape, kind and range;
- the layout: consecutive calls and their fields take disjoint runs of
  blocks that tile the stream;
- moments of the uniform, gumbel and normal fields and the integer field's
  counts, within 6 standard errors of their laws on 2**20 draws;
- float64 uniforms with 53 random bits;
- ``draw_hook`` still takes the engine's draws; a checkpoint holds the
  stream's (key, counter) and resumes bit for bit, and one written before
  the stream (a ``torch.Generator``'s state) is refused;
- PGD's random starts from the stream: inside the ε-ball, on mutable
  features, clipped, the same on a rerun;
- the kernel wrappers refuse what K0 does not take before anything is
  built. K0 itself is held against these plain versions on the card by
  ``chip_smoke.py`` phase 20 and ``tests/test_torch_kernels.py -m cuda``.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import initialisation as jinit
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import _niche_gumbels
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.checkpoint import AttackCheckpointer, StaleStreamCheckpoint
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.operators import offspring_fields
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import gumbel_fields
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_start_plain, start_fields
from moeva2_ijcai22_replication_tpu_torch.core import philox
from moeva2_ijcai22_replication_tpu_torch.core.philox import (
    CUT, GUMBEL, INTEGER, NORMAL, SYMMETRIC, UNIFORM, Field, PhiloxStream, draw_plain, layout, philox4x32,
)
from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem
from test_torch_operators import jax_offspring_draws

torch.set_num_threads(1)

#: Random123's kat_vectors for philox4x32_10: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
KNOBS = dict(norm=2, n_gen=6, n_pop=12, n_offsprings=8, archive_size=4, seed=5)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    return synthetic_lcld_problem(str(tmp_path_factory.mktemp("draws")), 12)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    got = philox4x32(torch.tensor([ctr], dtype=torch.int64), key)[0]
    assert [int(v) for v in got] == list(want)


# -- a scalar model of the layout and the word maps --------------------------------


def _philox_scalar(n: int, key: int) -> list:
    m = 0xFFFFFFFF
    c = [n & m, n >> 32, 0, 0]
    k0, k1 = key & m, key >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & m, (p0 >> 32) ^ c[3] ^ k1, p0 & m]
    return c


def _model(field: Field, dtype, key: int, base: int, first: int) -> list:
    """Each element of ``field`` as the module's docstring states it, in
    Python integers and floats (float64)."""
    per = philox.per_block(field.kind, dtype)
    f32 = dtype == torch.float32
    out = []
    for i in range(field.numel):
        w = _philox_scalar(base + first + i // per, key)
        slot = i % per
        if field.kind in (UNIFORM, SYMMETRIC, GUMBEL):
            u = (w[slot] >> 8) * 2.0**-24 if f32 else (((w[2 * slot] >> 5) << 26) + (w[2 * slot + 1] >> 6)) * 2.0**-53
        if field.kind == INTEGER:
            out.append((w[slot] * field.n) >> 32)
        elif field.kind == CUT:
            out.append(w[slot] >> 2)
        elif field.kind == UNIFORM:
            out.append(u)
        elif field.kind == SYMMETRIC:
            out.append(2.0 * u - 1.0)
        elif field.kind == GUMBEL:
            out.append(-math.log(-math.log(max(u, torch.finfo(dtype).tiny))))
        else:
            u1 = (((w[0] >> 5) << 26) + (w[1] >> 6)) * 2.0**-53
            u2 = (((w[2] >> 5) << 26) + (w[3] >> 6)) * 2.0**-53
            r = math.sqrt(-2.0 * math.log(1.0 - u1))
            out.append(r * (math.sin if slot else math.cos)(u2 * philox.TWO_PI))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fields_follow_the_stated_layout_and_maps(dtype):
    # odd sizes: partial last blocks of every kind
    fields = [Field("i", INTEGER, (3, 7), 103), Field("c", CUT, (2, 5)), Field("u", UNIFORM, (9,)),
              Field("s", SYMMETRIC, (3, 3)), Field("g", GUMBEL, (2, 7)), Field("n", NORMAL, (11,))]
    key, base = 0x1234_5678_9ABC_DEF0, 2**33 + 5
    got = draw_plain(fields, dtype, key, base, "cpu")
    first, _ = layout(fields, dtype)
    for f, b0 in zip(fields, first):
        want = np.asarray(_model(f, dtype, key, base, b0)).reshape(f.shape)
        g = got[f.name]
        assert g.shape == f.shape and g.dtype == philox.out_dtype(f, dtype)
        if f.kind in (INTEGER, CUT):
            assert np.array_equal(g.numpy(), want)
        elif f.kind in (UNIFORM, SYMMETRIC):
            assert np.array_equal(g.numpy(), want.astype(g.numpy().dtype))
        else:
            # the dtype's value is the float64 value rounded once
            np.testing.assert_allclose(g.numpy().astype(np.float64), want, rtol=torch.finfo(dtype).eps, atol=0)


# -- each field against the JAX draw it replaces ----------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generation_fields_against_jax_draws(problem, dtype):
    cons, sur, scaler, x = problem
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", dtype=dtype, **KNOBS)
    s, l, p, n_off, m = 6, eng.codec.gen_length, eng.pop_size, eng.n_offsprings, eng.pop_size + eng.n_offsprings
    got = eng.draw_generation(PhiloxStream(3), s)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = jax_offspring_draws(jax.random.split(jax.random.PRNGKey(0), s), n_off, l, p, dtype=jdt)
    jcut, jmem = _niche_gumbels(jax.random.PRNGKey(1), (s,), eng.n_dirs, m)
    for name in ("pairs", "cut_a", "cut_b", "coins", "mut_select", "mut_u"):
        g, w = getattr(got.offspring, name), getattr(want, name)
        assert g.shape == w.shape and g.is_floating_point() == w.is_floating_point(), name
    off = got.offspring
    assert off.pairs.dtype == torch.int64 and 0 <= int(off.pairs.min()) and int(off.pairs.max()) < p
    for c in (off.cut_a, off.cut_b):
        assert c.dtype == torch.int64 and 0 <= int(c.min()) and int(c.max()) < 1 << 30
    for u in (off.coins, off.mut_select, off.mut_u):
        assert u.dtype == dtype and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    for g, w in ((got.gum_cut, jcut), (got.gum_mem, jmem)):
        assert tuple(g.shape) == w.shape and g.dtype == dtype and torch.isfinite(g).all()
    # one call: the fields are different draws
    assert not torch.equal(off.mut_select, off.mut_u) and not torch.equal(off.cut_a, off.cut_b)


@pytest.mark.parametrize("norm", [2, "inf"])
def test_init_fields_against_jax_draws(problem, norm):
    cons, sur, scaler, x = problem
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", init="lp_ratio", init_ratio=0.5, **{**KNOBS, "norm": norm})
    s, l = 4, eng.codec.gen_length
    got = PhiloxDraws(eng, 9).init(s)
    n_pert = int(round(0.5 * eng.pop_size))
    want = jinit.ball_sample(jax.random.PRNGKey(0), (s, n_pert, l), 1.0, 2 if norm == 2 else np.inf)
    assert got.ball.shape[:-1] == want.shape[:-1]
    if norm == 2:
        # the L2 ball draws d + 2 normals a row, of which ball_sample keeps d
        assert got.ball.shape[-1] == want.shape[-1] + 2 and torch.isfinite(got.ball).all()
    else:
        assert got.ball.shape == want.shape and float(got.ball.min()) >= -1.0 and float(got.ball.max()) < 1.0
    jcut, jmem = _niche_gumbels(jax.random.PRNGKey(1), (s,), eng.n_dirs, eng.pop_size)
    assert tuple(got.gum_cut.shape) == jcut.shape and tuple(got.gum_mem.shape) == jmem.shape
    tile = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **KNOBS)
    assert PhiloxDraws(tile, 9).init(s).ball is None


def jax_random_start(atk, norm, xs, eps):
    """JAX's ``ConstrainedPGD._random_start`` on the attack's mutable mask
    and clip, in float64."""
    from moeva2_ijcai22_replication_tpu.attacks.pgd.engine import ConstrainedPGD as JPGD

    jatk = JPGD.__new__(JPGD)
    jatk.norm, jatk._mutable, jatk.clip = (2 if norm == 2 else np.inf), jnp.asarray(atk.tables.mutable.numpy()), atk.clip
    return np.asarray(JPGD._random_start(jatk, jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(eps, jnp.float64)))


def _pgd(problem, norm, **knobs):
    cons, sur, scaler, x = problem
    return ConstrainedPGD(sur, cons, scaler, eps=0.3, eps_step=0.1, max_iter=2, norm=norm, device="cpu",
                          dtype=torch.float64, **knobs)


@pytest.mark.parametrize("norm", [2, "inf"])
def test_pgd_start_against_jax_random_start(problem, norm):
    cons, sur, scaler, x = problem
    atk = _pgd(problem, norm)
    xs = torch.as_tensor(scaler.transform(x))
    eps = 0.3
    got = atk.random_start(PhiloxStream(4), xs, eps)
    mutable = atk.tables.mutable.numpy()
    # JAX's start: an (N, D) draw of the attack's dtype in the same ball
    jstart = jax_random_start(atk, norm, xs.numpy(), eps)
    assert got.shape == jstart.shape and got.numpy().dtype == jstart.dtype
    assert torch.equal(got[:, ~mutable], xs[:, ~mutable].clamp(0.0, 1.0))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    delta = (got - xs).numpy()
    reach = np.sqrt((delta**2).sum(1)) if norm == 2 else np.abs(delta).max(1)
    jdelta = jstart - xs.numpy()
    jreach = np.sqrt((jdelta**2).sum(1)) if norm == 2 else np.abs(jdelta).max(1)
    assert reach.max() <= eps * (1 + 1e-12) and reach.max() > 0 and jreach.max() <= eps * (1 + 1e-12)
    # the plain version recomputes it from the same blocks
    stream = PhiloxStream(4)
    fields = start_fields(norm, *xs.shape)
    base = stream.take(layout(fields, xs.dtype)[1])
    again = pgd_start_plain(fields, stream.key, base, xs, atk.tables.mutable, eps, atk.clip, norm == "inf")
    assert torch.equal(got, again)


def test_pgd_restarts_draw_from_one_stream(problem):
    cons, sur, scaler, x = problem
    xs = scaler.transform(x)
    y = np.zeros(len(xs), dtype=np.int64)
    atk = _pgd(problem, 2, num_random_init=2, seed=3)
    starts = []
    real = atk.one_run
    atk.one_run = lambda x_init, y, x_start, *a: starts.append(x_start) or real(x_init, y, x_start, *a)
    first = atk.generate(xs, y)
    assert len(starts) == 2 and not torch.equal(starts[0], starts[1])
    assert np.array_equal(first, atk.generate(xs, y))
    assert torch.equal(starts[0], starts[2]) and torch.equal(starts[1], starts[3])


# -- the layout, the moments, float64 ------------------------------------------------


class _Recording(PhiloxStream):
    def __init__(self, seed):
        super().__init__(seed)
        self.calls = []

    def take(self, n_blocks):
        base = super().take(n_blocks)
        self.calls.append((base, n_blocks))
        return base


def test_no_block_serves_two_fields_or_two_calls(problem):
    cons, sur, scaler, x = problem
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", init="lp_ratio", **KNOBS)
    draws = PhiloxDraws(eng, 0)
    draws.stream = stream = _Recording(0)
    draws.init(5)
    for s in (5, 5, 3):
        draws.generation(s)
    atk = _pgd(problem, 2)
    atk.random_start(stream, torch.zeros((3, 47), dtype=torch.float64), 0.1)
    spans = []
    for base, n in stream.calls:
        spans.append((base, base + n))
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert stream.counter == spans[-1][1] and len(spans) == 5
    # within a call, the fields' runs follow each other and cover the call
    fs = offspring_fields(5, eng.pop_size, eng.n_offsprings, eng.codec.gen_length)
    fs += gumbel_fields(5, eng.n_dirs, eng.pop_size + eng.n_offsprings)
    first, total = layout(fs, torch.float32)
    ends = [b0 + -(-f.numel // philox.per_block(f.kind, torch.float32)) for f, b0 in zip(fs, first)]
    assert first[0] == 0 and list(first[1:]) == ends[:-1] and ends[-1] == total == spans[1][1] - spans[1][0]


N_MOMENT = 1 << 20


@pytest.mark.parametrize("kind,dtype,mean,var", [
    (UNIFORM, torch.float32, 0.5, 1 / 12), (UNIFORM, torch.float64, 0.5, 1 / 12),
    (SYMMETRIC, torch.float32, 0.0, 1 / 3), (GUMBEL, torch.float32, 0.5772156649015329, math.pi**2 / 6),
    (GUMBEL, torch.float64, 0.5772156649015329, math.pi**2 / 6), (NORMAL, torch.float32, 0.0, 1.0),
    (NORMAL, torch.float64, 0.0, 1.0),
])
def test_moments(kind, dtype, mean, var):
    v = PhiloxStream(21).draw([Field("v", kind, (N_MOMENT,))], dtype)["v"].double()
    se_mean = math.sqrt(var / N_MOMENT)
    assert abs(float(v.mean()) - mean) < 6 * se_mean
    # the variance's standard error, from the fourth central moment
    m4 = float(((v - float(v.mean())) ** 4).mean())
    assert abs(float(v.var()) - var) < 6 * math.sqrt(max(m4 - var**2, 0.0) / N_MOMENT)
    if kind == NORMAL:
        # the two normals of a block are uncorrelated
        assert abs(float((v[0::2] * v[1::2]).mean())) < 6 / math.sqrt(N_MOMENT / 2)


def test_integer_counts():
    n = 103
    v = PhiloxStream(22).draw([Field("i", INTEGER, (N_MOMENT,), n)])["i"]
    counts = torch.bincount(v, minlength=n).double().numpy()
    assert counts.shape == (n,)
    expect = N_MOMENT / n
    assert np.abs(counts - expect).max() < 6 * math.sqrt(expect)


def test_float64_uniforms_have_53_bits():
    u = PhiloxStream(5).draw([Field("u", UNIFORM, (4096,))], torch.float64)["u"].numpy()
    k = u * 2.0**53
    assert np.array_equal(k, np.floor(k)) and (k % 2**29 != 0).mean() > 0.99 and u.max() < 1.0


# -- draw_hook, checkpoints ----------------------------------------------------------


def test_draw_hook_is_honoured(problem):
    cons, sur, scaler, x = problem
    knobs = dict(KNOBS, max_states_per_call=8)
    want = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **dict(knobs, seed=17)).generate(x)
    eng = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs)
    seen, shared = [], {}

    def hook(chunk):
        seen.append(chunk)
        return shared.setdefault("src", PhiloxDraws(eng, 17))

    eng.draw_hook = hook
    got = eng.generate(x)
    assert seen == [0, 1]
    for k in ("x_gen", "f", "x_ml"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    default = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs).generate(x)
    assert not np.array_equal(default.x_gen, got.x_gen)


class _Crash(RuntimeError):
    pass


def test_checkpoint_resumes_on_the_stream_and_refuses_a_generator_state(problem, tmp_path, monkeypatch):
    cons, sur, scaler, x = problem
    path = str(tmp_path / "ckpt.npz")
    knobs = dict(KNOBS, n_gen=9, checkpoint_every=3, checkpoint_path=path)
    want = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **KNOBS | {"n_gen": 9}).generate(x)
    real = AttackCheckpointer.save
    saved = []

    def save_then_crash(self, leaves, done, n_hist, extra=None):
        real(self, leaves, done, n_hist, extra)
        saved.append([t.clone() for t in leaves])
        raise _Crash

    monkeypatch.setattr(AttackCheckpointer, "save", save_then_crash)
    with pytest.raises(_Crash):
        Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs).generate(x)
    state = saved[0][-1]
    assert state.dtype == torch.int64 and tuple(state.shape) == (2,) and int(state[0]) == KNOBS["seed"]
    assert int(state[1]) > 0
    monkeypatch.setattr(AttackCheckpointer, "save", real)
    got = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs).generate(x)
    for k in ("x_gen", "f", "x_ml"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))

    # the same file as the code before the stream wrote it: no stream in the
    # meta, the last leaf a torch.Generator's byte state
    monkeypatch.setattr(AttackCheckpointer, "save", save_then_crash)
    saved.clear()
    with pytest.raises(_Crash):
        Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs).generate(x)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["__meta__"]))
    del meta["stream"]
    arrays["__meta__"] = np.asarray(json.dumps(meta))
    arrays[f"leaf_{meta['n_leaves'] - 1}"] = torch.Generator().manual_seed(5).get_state().numpy()
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    monkeypatch.setattr(AttackCheckpointer, "save", real)
    with pytest.raises(StaleStreamCheckpoint, match="Philox"):
        Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs).generate(x)
    with pytest.raises(ValueError, match="torch.Generator"):
        PhiloxStream(0).set_state(torch.Generator().get_state())


# -- the wrappers' refusals ------------------------------------------------------------


def test_kernel_wrappers_refuse_what_k0_does_not_take():
    before = kernels.launch_counts()
    fields = [Field("u", UNIFORM, (4,))]
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.draws(fields, torch.float32, 0, 0, "cpu")
    with pytest.raises(TypeError, match="float32"):
        kernels.draws(fields, torch.float64, 0, 0, "cpu")
    with pytest.raises(ValueError, match="1 to 8 fields"):
        kernels.draws(fields * 9, torch.float32, 0, 0, "cpu")
    with pytest.raises(ValueError, match="integer bound"):
        kernels.draws([Field("i", INTEGER, (4,), 0)], torch.float32, 0, 0, "cpu")
    x = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pgd_start(start_fields("inf", 3, 5), 0, 0, x, torch.ones(5, dtype=torch.bool), 0.1, (0.0, 1.0), True)
    assert kernels.launch_counts() == before
    # the buffer K0 writes: every field 16-byte aligned, its own bytes, its
    # shape and dtype, the int64 fields two words an element
    mixed = [Field("a", INTEGER, (3, 5), 7), Field("b", UNIFORM, (0,)), Field("c", CUT, (1,)),
              Field("d", NORMAL, (5, 3)), Field("e", GUMBEL, (9,))]
    views, offsets, buf = kernels.draw_buffer(mixed, "cpu")
    spans = []
    for f, off in zip(mixed, offsets):
        v = views[f.name]
        assert v.shape == f.shape and v.dtype == philox.out_dtype(f, torch.float32) and off % 16 == 0
        assert v.numel() == 0 or v.data_ptr() == buf.data_ptr() + off
        spans.append((off, off + v.numel() * v.element_size()))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])) and spans[-1][1] <= buf.numel() * 4
    # a CPU stream draws with the plain version and launches nothing
    assert PhiloxStream(0).draw(fields)["u"].shape == (4,) and kernels.launch_counts() == before

"""Port parity of non-dominated sorting: ``nd_ranks_plain`` equals the JAX
``nds.nd_ranks`` exactly over random, tied, duplicate and NaN fronts."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.moeva import nds as jnds
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import nds as tnds

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)


def _fronts(kind: str, s: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.uniform(size=(s, m, 3))
    if kind == "tied":
        f = rng.integers(0, 3, (s, m, 3)).astype(float)
    elif kind == "dup":
        k = m // 3
        f[:, m - k :] = f[:, :k]
    elif kind == "nan":
        f[rng.random((s, m)) < 0.1, rng.integers(0, 3)] = np.nan
        f[0, :] = np.nan  # a state with nothing comparable
    elif kind == "chain":  # totally ordered: one candidate per front
        f = rng.uniform(0.1, 1.0, (s, m, 1)) * rng.uniform(0.2, 2.0, (s, 1, 3))
    elif kind == "allnan":
        f[:] = np.nan
    elif kind == "equal":  # one front
        f[:] = f[:, :1]
    elif kind == "extremes":  # ties of signed zeros, infinities, extremes, denormals
        big = np.finfo(np.float32).max
        vals = np.array([-np.inf, -big, -1, -1e-45, -0.0, 0.0, 1e-45, 3e-45, 1, big, np.inf], np.float32)
        f = rng.choice(vals, size=(s, m, 3)).astype(float)
        f[rng.random((s, m)) < 0.05, 1] = np.nan
    return f


@pytest.mark.parametrize("kind", ["random", "tied", "dup", "nan", "chain"])
@pytest.mark.parametrize("n_stop", [1, 11, 40, None])
def test_nd_ranks_plain_matches_jax(kind, n_stop):
    f = _fronts(kind, 6, 40, seed=len(kind) * 7 + (n_stop or 0))
    want = np.asarray(jnds.nd_ranks(jnp.asarray(f), n_stop=n_stop))
    got = tnds.nd_ranks_plain(torch.as_tensor(f), n_stop)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# the kernel's edges: one partial word, one full word, a word and one more,
# two words; n_stop = 0 (nothing ranked), M and M + 5 (everything)
@pytest.mark.parametrize("m", [1, 31, 32, 33, 64])
@pytest.mark.parametrize("kind", ["nan", "allnan", "equal", "chain", "extremes"])
@pytest.mark.parametrize("extra", [None, 0, 5])
def test_nd_ranks_plain_matches_jax_at_the_kernels_edges(m, kind, extra):
    n_stop = 0 if extra is None else m + extra
    f = _fronts(kind, 3, m, seed=m)
    want = np.asarray(jnds.nd_ranks(jnp.asarray(f), n_stop=n_stop))
    got = tnds.nd_ranks_plain(torch.as_tensor(f), n_stop)
    np.testing.assert_array_equal(got.numpy(), want)
    if n_stop == 0:
        assert (want == tnds.UNRANKED).all()
    elif kind in ("allnan", "equal"):
        assert (want == 0).all()
    elif kind == "chain":
        np.testing.assert_array_equal(np.sort(want, axis=1), np.broadcast_to(np.arange(m), (3, m)))


def test_nd_ranks_cpu_dispatches_to_plain():
    f = torch.as_tensor(_fronts("random", 3, 30, 1))
    assert torch.equal(tnds.nd_ranks(f, 10), tnds.nd_ranks_plain(f, 10))
    assert torch.equal(tnds.nd_ranks(f), tnds.nd_ranks_plain(f, 30))


def test_domination_matrix_matches_jax():
    f = _fronts("tied", 2, 25, 3)
    np.testing.assert_array_equal(
        np.asarray(jnds.domination_matrix(jnp.asarray(f))),
        tnds.domination_matrix(torch.as_tensor(f)).numpy(),
    )


def test_nan_rows_are_front_zero_and_unranked_tail():
    f = torch.tensor([[[np.nan, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]])
    assert tnds.nd_ranks_plain(f, 2).tolist() == [[0, 0, tnds.UNRANKED, tnds.UNRANKED]]
    assert tnds.nd_ranks_plain(f).tolist() == [[0, 0, 1, 2]]
    assert tnds.UNRANKED == int(jnds.UNRANKED)

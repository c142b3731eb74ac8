"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` build the kernels with nvcc and run them on the card;
without a card they skip (the decision is taken inside the fixture). Run
them on a machine with one NVIDIA card:

    python -m pytest tests/test_torch_kernels.py -m cuda

The CPU-side tests check what the wrappers do without a card: they refuse
CPU tensors rather than fall back, and importing them builds nothing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import associate_plain
from moeva2_ijcai22_replication_tpu_torch.kernels import build

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
@pytest.mark.parametrize("s,m,n_stop", [(64, 203, 103), (537, 203, 103), (16, 303, 203), (8, 1024, 1024), (3, 1, 1)])
def test_nd_peel_equals_plain(card, s, m, n_stop):
    f = torch.as_tensor(_objectives(np.random.default_rng(s + m), s, m), device=card)
    before = kernels.launch_counts()["nd_peel"]
    got = kernels.nd_peel(f, n_stop)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["nd_peel"] == before + 1
    assert torch.equal(got, nd_ranks_plain(f, n_stop))


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
    assert torch.equal(niche, niche_p)
    assert torch.equal(torch.isnan(dist), torch.isnan(dist_p))
    ok = ~torch.isnan(dist)
    assert float((dist[ok] - dist_p[ok]).abs().max()) <= 1e-5


def test_wrappers_refuse_cpu_tensors():
    f = torch.zeros((2, 5, 3))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.nd_peel(f, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.associate(f, torch.ones((2, 4, 3)), torch.zeros((2, 3)), torch.ones((2, 3)))
    assert kernels.launch_counts() == before


def test_launch_counts_reset():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"nd_peel": 0, "associate": 0}


def test_build_fingerprint_follows_sources(tmp_path, monkeypatch):
    # the library name changes with any source or flag, so a stale build is
    # never loaded; computing it needs no compiler
    a = build._fingerprint("/usr/local/cuda/bin/nvcc")
    assert a == build._fingerprint("/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._fingerprint("/usr/local/cuda/bin/nvcc") != a
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert all((build.PACKAGE_DIR / src).exists() for src in build.SOURCES + build.HEADERS)

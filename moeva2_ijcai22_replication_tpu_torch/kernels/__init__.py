"""Hand-written Hopper kernels of the port and their launch counts.

- ``nd_peel`` (K2, ``csrc/nd_peel.cu``): non-dominated front peeling; its
  plain version is ``attacks.moeva.nds.nd_ranks_plain``.
- ``associate`` (K3, ``csrc/associate.cu``): niche association; its plain
  version is ``attacks.moeva.survival.associate_plain``.

The wrappers take CUDA tensors only and raise on anything the kernel does
not take, or when a build or launch fails; callers route CPU tensors to the
plain versions. Importing this module builds nothing: the library is built
and loaded at the first launch (``build.library``).

Each wrapper adds one to its entry of the launch count where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import torch

_LAUNCHES = {"nd_peel": 0, "associate": 0}


def launch_counts() -> dict:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.moeva_error_string(err).decode()}")


def nd_peel(f: torch.Tensor, n_stop: int) -> torch.Tensor:
    """Kernel K2: front ranks (S, M) int32 of ``f`` (S, M, 3) float32."""
    from .build import library

    if f.dim() != 3:
        raise ValueError(f"f must be (S, M, 3), got {tuple(f.shape)}")
    s, m, _ = f.shape
    _check(f, "f", (s, m, 3))
    lib = library()
    if m > lib.moeva_nd_peel_max_candidates():
        raise ValueError(
            f"nd_peel takes at most {lib.moeva_nd_peel_max_candidates()} "
            f"candidates per state, got {m}"
        )
    f = f.contiguous()
    ranks = torch.empty((s, m), dtype=torch.int32, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.moeva_nd_peel_f32(f.data_ptr(), ranks.data_ptr(), s, m, int(n_stop), stream)
    _raise_on_error(lib, err, "nd_peel")
    _LAUNCHES["nd_peel"] += 1
    return ranks


def associate(f, dirs, ideal, nadir):
    """Kernel K3: ``(niche (S, M) int64, dist (S, M) float32)`` from
    ``f`` (S, M, 3), ``dirs`` (S, R, 3), ``ideal``/``nadir`` (S, 3), all
    float32 on one card."""
    from .build import library

    if f.dim() != 3 or dirs.dim() != 3:
        raise ValueError("f and dirs must be (S, M, 3) and (S, R, 3)")
    s, m, _ = f.shape
    r = dirs.shape[1]
    _check(f, "f", (s, m, 3))
    _check(dirs, "dirs", (s, r, 3))
    _check(ideal, "ideal", (s, 3))
    _check(nadir, "nadir", (s, 3))
    if len({t.device for t in (f, dirs, ideal, nadir)}) != 1:
        raise ValueError("associate's inputs must lie on one device")
    f, dirs, ideal, nadir = (t.contiguous() for t in (f, dirs, ideal, nadir))
    lib = library()
    niche = torch.empty((s, m), dtype=torch.int64, device=f.device)
    dist = torch.empty((s, m), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.moeva_associate_f32(
            f.data_ptr(), dirs.data_ptr(), ideal.data_ptr(), nadir.data_ptr(),
            niche.data_ptr(), dist.data_ptr(), s, m, r, stream,
        )
    _raise_on_error(lib, err, "associate")
    _LAUNCHES["associate"] += 1
    return niche, dist

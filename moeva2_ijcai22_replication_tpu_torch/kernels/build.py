"""Build the port's CUDA kernels on first use and load them with ctypes.

Every source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` at ``-O3``; the objects are linked into one shared library
with a plain C interface (``bindings.cpp``). Nothing includes PyTorch's
headers, so a cold build takes seconds. The library lands in
``.torch_ext_build/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing library; the compilers' report (``ptxas -v``) is kept beside it
and read back with it. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent.parent / ".torch_ext_build"
SOURCES = (
    "csrc/offspring.cu",
    "csrc/objective_lcld.cu",
    "csrc/objective_botnet.cu",
    "csrc/nd_peel.cu",
    "csrc/survive_norm.cu",
    "csrc/associate.cu",
    "csrc/survive_fill.cu",
    "csrc/pgd_lcld.cu",
    "csrc/pgd_botnet.cu",
    "csrc/gate_repack.cu",
    "csrc/objective_spec.cu",
    "csrc/pgd_spec.cu",
    "csrc/train_step.cu",
    "csrc/input_grad.cu",
    "csrc/draws.cu",
    "csrc/chunk_io.cu",
    "csrc/refdirs.cu",
    "csrc/restart.cu",
    "csrc/mlp_forward.cu",
    "bindings.cpp",
)
HEADERS = ("csrc/kernels.h", "csrc/pgd_common.cuh", "csrc/mlp_tile.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing library was reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills), also when reused


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _fingerprint(nvcc: str) -> str:
    h = hashlib.sha256()
    for rel in SOURCES + HEADERS:
        h.update(rel.encode())
        h.update((PACKAGE_DIR / rel).read_bytes())
    h.update(repr((nvcc, NVCC_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile and link the kernels unless the library for these sources
    exists already."""
    nvcc = nvcc_path()
    lib = BUILD_DIR / f"libmoeva_kernels_{_fingerprint(nvcc)}.so"
    report = lib.with_suffix(".log")
    if lib.exists():
        return BuildInfo(lib, 0.0, report.read_text() if report.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(src).name + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(PACKAGE_DIR / src), "-o", str(obj)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", NVCC_FLAGS[0], *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        log = "\n".join(logs)
        staged_report = Path(tmp) / report.name
        staged_report.write_text(log)
        # atomic, the report first: a concurrent build loses nothing, and
        # whoever finds the library finds its report
        os.replace(staged_report, report)
        os.replace(staged, lib)
    return BuildInfo(lib, time.perf_counter() - t0, log)


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process, with every C
    function's argument and return types declared."""
    lib = ctypes.CDLL(str(build().path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moeva_nd_peel_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.moeva_nd_peel_f32.restype = i32
    lib.moeva_associate_f32.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.moeva_associate_f32.restype = i32
    i64, f32, f64 = ctypes.c_longlong, ctypes.c_float, ctypes.c_double
    lib.moeva_offspring_f32.argtypes = (
        [ptr] * 13 + [i64] * 3 + [ptr] + [i32] * 5 + [f32, f64, f64, ptr]
    )
    lib.moeva_offspring_f32.restype = i32
    lib.moeva_objective_lcld_f32.argtypes = (
        [ptr] * 9 + [ctypes.POINTER(i32), i32, ptr, ptr, f32, i32, f32, ptr, ptr] + [i32] * 4 + [ptr, ptr, i32, ptr]
    )
    lib.moeva_objective_lcld_f32.restype = i32
    lib.moeva_survive_norm_f32.argtypes = [ptr] * 12 + [i32] * 4 + [ptr]
    lib.moeva_survive_norm_f32.restype = i32
    lib.moeva_survive_fill_f32.argtypes = (
        [ptr] * 6 + [i32] + [ptr] * 6 + [i32] + [ptr] * 6 + [i32] * 8 + [ptr]
    )
    lib.moeva_survive_fill_f32.restype = i32
    lib.moeva_pgd_lcld_f32.argtypes = (
        [ptr] * 5 + [ctypes.POINTER(i32), i32] + [ptr] * 3 + [i32] * 2 + [ptr] * 7 + [i32] * 3
        + [f32] * 4 + [i32, i32, ptr, ptr, i32] + [ptr] * 2 + [f32] * 2 + [i32] + [f32] * 2 + [ptr] * 2
    )
    lib.moeva_pgd_lcld_f32.restype = i32
    lib.moeva_objective_botnet_f32.argtypes = (
        [ptr] * 13 + [ctypes.POINTER(i32), ctypes.POINTER(i32), i32, f32, i32, f32, ptr, ptr] + [i32] * 4
        + [ptr, ptr, i32, ptr]
    )
    lib.moeva_objective_botnet_f32.restype = i32
    lib.moeva_pgd_botnet_f32.argtypes = (
        [ptr] * 6 + [ctypes.POINTER(i32), i32] + [ptr] * 3 + [ctypes.POINTER(i32), ptr, i32] + [ptr] * 7
        + [i32] * 3 + [f32] * 4 + [i32] + [ptr] * 2 + [f32] * 2 + [i32] + [f32] * 2 + [ptr] * 3 + [i32, ptr]
    )
    lib.moeva_pgd_botnet_f32.restype = i32
    lib.moeva_gate_stats_f32.argtypes = [ptr] * 3 + [i32] * 3 + [f32] * 2 + [ptr]
    lib.moeva_gate_stats_f32.restype = i32
    lib.moeva_take_f32.argtypes = [ptr] * 5 + [i32, ptr, i32, i64, ptr]
    lib.moeva_take_f32.restype = i32
    lib.moeva_objective_spec_f32.argtypes = (
        [ptr] * 13 + [i32] * 3 + [ctypes.POINTER(i32), i32, f32, i32, f32, ptr, ptr] + [i32] * 4 + [ptr]
    )
    lib.moeva_objective_spec_f32.restype = i32
    lib.moeva_objective_spec_tile_rows.argtypes = [i32] * 4
    lib.moeva_objective_spec_tile_rows.restype = i32
    lib.moeva_pgd_spec_f32.argtypes = (
        [ptr] * 6 + [ctypes.POINTER(i32), i32] + [ptr] * 3 + [i32] * 2 + [ptr] * 5 + [i32] * 2 + [ptr] * 3
        + [i32, ptr, i32] + [ptr] * 3 + [i32] * 3 + [f32] * 4 + [i32] * 2 + [ptr] * 2 + [f32] * 2 + [i32] + [f32] * 2 + [ptr] * 2
    )
    lib.moeva_pgd_spec_f32.restype = i32
    lib.moeva_pgd_spec_block_rows.argtypes = [i32, ctypes.POINTER(i32)] + [i32] * 4
    lib.moeva_pgd_spec_block_rows.restype = i32
    lib.moeva_train_step_f32.argtypes = (
        [ptr] * 7 + [ctypes.POINTER(i32), i32, i32] + [f32] * 8 + [ptr] * 4
    )
    lib.moeva_train_step_f32.restype = i32
    lib.moeva_train_loss_f32.argtypes = [ptr] * 4 + [ctypes.POINTER(i32), i32, i32, ptr, ptr]
    lib.moeva_train_loss_f32.restype = i32
    lib.moeva_input_grad_f32.argtypes = [ptr, ptr, ctypes.POINTER(i32), i32, i32, ptr, ptr]
    lib.moeva_input_grad_f32.restype = i32
    lib.moeva_train_smem_bytes.argtypes = [ctypes.POINTER(i32), i32]
    lib.moeva_train_smem_bytes.restype = i64
    u32p, i64p = ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(i64)
    u64 = ctypes.c_ulonglong
    lib.moeva_draws_f32.argtypes = [ctypes.POINTER(ptr), i64p, i64p, ctypes.POINTER(i32), u32p, i32, u64, u64, i64, ptr]
    lib.moeva_draws_f32.restype = i32
    lib.moeva_pgd_start_f32.argtypes = (
        [i64p, i64p, ctypes.POINTER(i32), u32p, i32, u64, u64, i64] + [ptr] * 3 + [f32] * 3 + [f64] + [i32] * 3 + [ptr]
    )
    lib.moeva_pgd_start_f32.restype = i32
    lib.moeva_chunk_prepare_f32.argtypes = [ptr] * 14 + [i32] * 10 + [f32, ptr]
    lib.moeva_chunk_prepare_f32.restype = i32
    lib.moeva_chunk_decode_f32.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.moeva_chunk_decode_f32.restype = i32
    lib.moeva_refdirs_f64.argtypes = [ptr] * 3 + [i32] * 3 + [f64] * 6 + [ptr]
    lib.moeva_refdirs_f64.restype = i32
    lib.moeva_refdirs_shape.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.moeva_refdirs_shape.restype = i32
    lib.moeva_restart_f32.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.moeva_restart_f32.restype = i32
    for name in ("moeva_forward_labels_f32", "moeva_forward_proba1_f64"):
        getattr(lib, name).argtypes = [ptr, ptr, ctypes.POINTER(i32), i32, i32, ptr, ptr]
        getattr(lib, name).restype = i32
    for name in (
        "moeva_train_tile_rows", "moeva_train_max_layers",
        "moeva_nd_peel_max_candidates", "moeva_associate_max_directions", "moeva_survive_max_candidates",
        "moeva_objective_max_params", "moeva_objective_max_width",
        "moeva_objective_max_layers", "moeva_lcld_max_pairs", "moeva_pgd_max_ohe_slots",
        "moeva_pgd_botnet_max_degree", "moeva_pgd_botnet_aug_pairs", "moeva_botnet_max_pairs", "moeva_take_max_segments",
        "moeva_spec_max_instructions", "moeva_spec_max_slots", "moeva_spec_max_terms", "moeva_spec_max_features",
        "moeva_spec_max_width", "moeva_spec_vjp_max_instructions", "moeva_spec_vjp_max_slots",
        "moeva_draws_max_fields", "moeva_refdirs_max_points", "moeva_refdirs_max_dim",
        "moeva_forward_max_width", "moeva_forward_max_layers",
    ):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.moeva_objective_botnet_max_features.argtypes = [i32, i32, i32]
    lib.moeva_objective_botnet_max_features.restype = i32
    lib.moeva_error_string.argtypes = [i32]
    lib.moeva_error_string.restype = ctypes.c_char_p
    return lib

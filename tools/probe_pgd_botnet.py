#!/usr/bin/env python3
"""Time designs of the port's constrained-PGD kernel on botnet (K7b) side
by side on one NVIDIA card.

Each variant is a ``csrc`` directory holding ``pgd_botnet.cu``,
``pgd_common.cuh`` and ``kernels.h`` (the port's own, one unpacked from
another commit, or an edited copy). Every variant is compiled with ``nvcc``
into a small library beside the port's ``bindings.cpp`` (the other
kernels' launchers stubbed), driven through the port's own wrapper
``kernels.pgd_botnet``, held against ``pgd_run_plain`` bit for bit at
rq1.botnet's 387 states x 7 iterations (with the full history), and timed
in turns (all variants, twice) with CUDA events around the replay of a
CUDA graph of 2 launches, on ``chip_smoke.py``'s phase-9 problem: at 387 x
1000 under L2 (``constraints+flip+adaptive_eps_step+repair``, rq1.botnet's
run), at 387 x 1000 under L-inf (no L2 sums: their serial chains' share),
and at 0 iterations (staging and the final forward alone). A variant whose
source has the ``K7B_STAMPS`` hook is built once more with it, and one run
at 387 x 1000 under each norm gives its breakdown: per phase, the cycles
per iteration block 0's thread 0 sees between the barriers (``clock64()``).
Prints one JSON line per variant with its ptxas registers, stack and spill,
and writes the records to ``<out>/probe_k7b.json`` (``--out DIR``, by
default ``.torch_ext_build/probe``).

Run from the root of a checkout:

    python3 tools/probe_pgd_botnet.py [--out DIR] \\
        change=moeva2_ijcai22_replication_tpu_torch/kernels/csrc \\
        parent=<unpacked parent>/moeva2_ijcai22_replication_tpu_torch/kernels/csrc
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: K7b's phases as its K7B_STAMPS hook numbers them
PHASES = ("terms and first layer", "hidden forward", "cross-entropy", "hidden backward",
          "input backward and gradient", "gradient norm", "step", "projection factor", "projection and repair")
#: the launchers of the other kernels, which a variant's library does not hold
STUBS = r"""
#include "csrc/kernels.h"
cudaError_t launch_nd_peel(const float*, int32_t*, int, int, int, cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_associate(const float*, const float*, const float*, const float*, int64_t*, float*, int, int, int,
                             cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_offspring(const float*, const float*, const float*, const int64_t*, const int64_t*,
                             const int64_t*, const float*, const float*, const float*, const int64_t*,
                             const int64_t*, const double*, const bool*, const int64_t*, float*, int, int, int, int,
                             int, float, double, double, cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_objective_lcld(const float*, const float*, const float*, const float*, const float*,
                                  const int64_t*, const int32_t*, const int32_t*, const float*, const int*, int,
                                  const float*, const float*, float, int, float, float*, int, int, int, int,
                                  cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_survive_norm(const float*, const int32_t*, const float*, const float*, const float*,
                                const float*, float*, float*, float*, float*, float*, int, int, int,
                                cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_survive_fill(const SurviveFillArgs&, cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_pgd_lcld(const PgdArgs&, cudaStream_t) { return cudaErrorNotSupported; }
cudaError_t launch_objective_botnet(BotnetObjectiveArgs, cudaStream_t) { return cudaErrorNotSupported; }
int objective_botnet_max_features() { return 0; }
"""


def build_variant(name: str, csrc: Path, work: Path, flags: tuple = ()):
    """The variant's library and its ptxas entry for pgd_botnet_kernel."""
    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    src = work / name
    (src / "csrc").mkdir(parents=True)
    for f in ("pgd_botnet.cu", "pgd_common.cuh", "kernels.h"):
        shutil.copy(csrc / f, src / "csrc" / f)
    shutil.copy(build.PACKAGE_DIR / "bindings.cpp", src / "bindings.cpp")
    (src / "stubs.cu").write_text(STUBS)
    nvcc = build.nvcc_path()
    objs, log = [], []
    for f in ("csrc/pgd_botnet.cu", "stubs.cu", "bindings.cpp"):
        obj = src / (Path(f).name + ".o")
        out = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-c", str(src / f), "-o", str(obj)],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{f}:\n{out.stdout}{out.stderr}")
        log.append(f"== {f}\n{out.stdout}{out.stderr}")
        objs.append(str(obj))
    lib = src / f"libprobe_{name}.so"
    out = subprocess.run([nvcc, "-shared", build.NVCC_FLAGS[0], *objs, "-o", str(lib)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"linking {name} failed:\n{out.stdout}{out.stderr}")
    entry = [k for k in cs.ptxas_resources("\n".join(log)) if k["kernel"].startswith("pgd_botnet_kernel")]
    return lib, entry[0] if entry else None


def use(lib: Path) -> None:
    """Route ``kernels.pgd_botnet`` to ``lib``."""
    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    build.build = lambda: build.BuildInfo(lib, 0.0, "")
    build.library.cache_clear()
    build.library()


def main() -> int:
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.kernels import build
    from moeva2_ijcai22_replication_tpu_torch.problems import botnet_edge_starts

    if not torch.cuda.is_available():
        print("probe_pgd_botnet: CUDA is not available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    out_dir = ROOT / ".torch_ext_build" / "probe"
    if args[:1] == ["--out"]:
        out_dir, args = Path(args[1]), args[2:]
    variants = [a.split("=", 1) for a in args]
    if not variants:
        print(__doc__, file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    cons, sur, scaler, _, xs, y = cs.pgd_botnet_problem()
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, device=device)
    eps = cs.PGD_BOTNET_EPS - 1e-6
    engines = {norm: ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, norm=norm, loss_evaluation=cs.PGD_LOSS,
                                    record_loss="full", record_grad_norm=True, device=device)
               for norm in (2, np.inf)}
    cases = {"l2": (2, cs.PGD_BUDGET), "linf": (np.inf, cs.PGD_BUDGET), "t0": (2, 0)}

    def call(case):
        norm, t = cases[case]
        atk = engines[norm]
        sched = atk.schedule(eps, 0.1, t)
        return lambda: kernels.pgd_botnet(atk.tables, sched, xi, yt, xi, eps, atk.clip, norm != 2, True, False)

    records = {}
    (ROOT / ".torch_ext_build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / ".torch_ext_build") as tmp:
        libs = {}
        for name, csrc in variants:
            libs[name], entry = build_variant(name, Path(csrc), Path(tmp))
            use(libs[name])
            atk = engines[2]
            sched = atk.schedule(eps, 0.1, 7)
            st = torch.as_tensor(botnet_edge_starts(cons.schema.names, scaler, xs), device=device)
            got = kernels.pgd_botnet(atk.tables, sched, xi, yt, st, eps, atk.clip, False, True, False,
                                     atk.history_layout())
            want = pgd_run_plain(atk.tables, cons, sched, xi, yt, st, eps, atk.clip, 2, True, False,
                                 atk.history_layout())
            for what, g, w in zip(("x_adv", "pred", "hist"), got, want):
                cs.hold_equal(g, w, f"{name} {what}")
            records[name] = {"variant": name, "csrc": csrc, "ptxas": entry, "ms": {c: [] for c in cases}}
        for _ in range(2):
            for name in libs:
                use(libs[name])
                for case in cases:
                    records[name]["ms"][case].append(cs.graph_ms(call(case), launches=2, repeats=3))
        for name, csrc in variants:
            if "K7B_STAMPS" not in (Path(csrc) / "pgd_botnet.cu").read_text():
                continue
            lib, _ = build_variant(name + "_stamps", Path(csrc), Path(tmp), ("-DK7B_STAMPS",))
            use(lib)
            take = build.library().k7b_take_cycles
            take.argtypes = [ctypes.c_void_p]
            cycles = (ctypes.c_ulonglong * len(PHASES))()
            records[name]["cycles_per_iteration"] = {}
            for case in ("l2", "linf"):
                call(case)()
                torch.cuda.synchronize()
                take(cycles)
                call(case)()
                torch.cuda.synchronize()
                if take(cycles):
                    raise RuntimeError("reading K7b's stamps failed")
                records[name]["cycles_per_iteration"][case] = {
                    p: c / cases[case][1] for p, c in zip(PHASES, cycles)}
    out_dir.mkdir(parents=True, exist_ok=True)
    for rec in records.values():
        rec["card"] = smi
        print(json.dumps(rec))
    (out_dir / "probe_k7b.json").write_text(json.dumps(list(records.values()), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

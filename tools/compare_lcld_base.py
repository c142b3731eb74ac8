"""Time the base LCLD domain's K1 and K7 of two trees of the port side by
side on one NVIDIA card, and hold their outputs equal.

    python3 tools/compare_lcld_base.py [--out DIR] parent=<root> change=<root>

Each ``<root>`` is the root of a checkout (a parent commit unpacked with
``git archive`` into a gitignored directory, or this repo). Its port package
is imported under a name of its own and builds its kernels into its own
``.torch_ext_build/``. The inputs are the change's, made from seeds: phase
3's timed shape for K1 (``chip_smoke.N_STATES`` synthetic LCLD states x 100
offspring of the main path's engine) and phase 7's for K7 (4000 states x
1000 iterations of rq1's last loss, L2, from x_init); each tree builds its
own engine over the same surrogate and scaler. The first tree's outputs are
the reference: every other tree's must equal them entry for entry. The
kernels are timed in turns (first to last, then last to first, twice) with
CUDA events around the replay of a CUDA graph (``chip_smoke.graph_ms``).
Prints each tree's ptxas lines of the two kernels' base instantiations and
one JSON line per tree, with each kernel's median device ms and its ratio
to the first tree's, and writes the lines to
``<out>/compare_lcld_base.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PACKAGE = "moeva2_ijcai22_replication_tpu_torch"
#: the base K1's and K7's entries: templates over the history, pair and
#: AutoPGD flags, or a parent's with fewer of them
BASE_ENTRIES = (
    "objective_lcld_kernel<128,1,0,0>", "objective_lcld_kernel<64,0,0,0>", "objective_lcld_kernel<128,1,0>",
    "objective_lcld_kernel<64,0,0>", "objective_lcld_kernel<128,1>", "objective_lcld_kernel<64,0>",
    "pgd_lcld_kernel<0,0>", "pgd_lcld_kernel<0>", "pgd_lcld_kernel",
)


def load_tree(name: str, root: Path, links: Path):
    """The port package of the checkout at ``root``, imported as
    ``port_<name>``, with its kernel library built."""
    (links / f"port_{name}").symlink_to((root / PACKAGE).resolve(), target_is_directory=True)
    pkg = importlib.import_module(f"port_{name}")
    for sub in ("kernels", "kernels.build", "problems", "attacks.moeva", "attacks.pgd"):
        importlib.import_module(f"port_{name}.{sub}")
    pkg.kernels.build.library()
    for k in cs.ptxas_resources(pkg.kernels.build.build().log):
        if k["kernel"] in BASE_ENTRIES:
            print(f"[ptxas] {name}: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
                  f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    return pkg


def kernel_calls(pkg, device, inputs):
    """``{kernel: call}`` of ``pkg``'s K1 and K7 on ``inputs``, each call
    through the tree's own engine tables."""
    cons, sur, scaler, x = inputs["problem"]
    eng = pkg.attacks.moeva.Moeva2(sur, cons, ml_scaler=scaler, device=device, n_pop=100, n_offsprings=100,
                                   archive_size=24, seed=42)
    run, cand = inputs["run"], inputs["cand"]
    atk = pkg.attacks.pgd.ConstrainedPGD(sur, cons, scaler, eps=cs.PGD_EPS, eps_step=0.1, norm=2,
                                         loss_evaluation=cs.PGD_LOSS, device=device)
    sched = atk.schedule(cs.PGD_EPS - 1e-6, 0.1, cs.PGD_BUDGET)
    xi, yt = inputs["xi"], inputs["y"]
    k = pkg.kernels
    return {
        "objective_lcld": lambda: k.objective_lcld(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                                   run.minimize_class, eng._objective),
        "pgd_lcld": lambda: k.pgd_lcld(atk.tables, sched, xi, yt, xi, cs.PGD_EPS - 1e-6, atk.clip, False, True,
                                       False),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / ".torch_ext_build" / "probe"))
    parser.add_argument("trees", nargs="+", help="name=<root of a checkout>")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_lcld_base: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    links = Path(tempfile.mkdtemp())
    sys.path.insert(0, str(links))
    trees = {}
    for spec in args.trees:
        name, root = spec.split("=", 1)
        trees[name] = load_tree(name, Path(root), links)

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import draw_gumbels
    from moeva2_ijcai22_replication_tpu_torch.core.philox import PhiloxStream
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

    with tempfile.TemporaryDirectory() as tmp:
        problem = synthetic_lcld_problem(tmp, cs.PGD_STATES)
    cons, sur, scaler, x = problem
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=device, n_pop=100, n_offsprings=100, archive_size=24, seed=42)
    run = eng.prepare(x[:cs.N_STATES], np.ones(cs.N_STATES, dtype=np.int64))
    gen = PhiloxStream(0, device)
    carry = eng.init_carry(run, *draw_gumbels(gen, cs.N_STATES, eng.n_dirs, eng.pop_size))
    cand = eng.offspring(run, carry.pop_x, eng.draw_generation(gen, cs.N_STATES).offspring)
    xs = scaler.transform(x)
    inputs = {"problem": problem, "run": run, "cand": cand,
              "xi": torch.as_tensor(xs, dtype=torch.float32, device=device),
              "y": torch.as_tensor(cs.surrogate_labels(sur, xs), device=device)}
    calls = {name: kernel_calls(pkg, device, inputs) for name, pkg in trees.items()}
    first = next(iter(calls))
    want = {kernel: calls[first][kernel]() for kernel in ("objective_lcld", "pgd_lcld")}
    for name, c in calls.items():
        for kernel, w in want.items():
            got = c[kernel]()
            for g, ww in zip(got if isinstance(got, tuple) else (got,), w if isinstance(w, tuple) else (w,)):
                if g is not None:
                    cs.hold_equal(g, ww, f"{name} {kernel} against {first}")
    times = {name: {"objective_lcld": [], "pgd_lcld": []} for name in calls}
    order = list(calls)
    for turn in range(2):
        for name in order + order[::-1]:
            times[name]["objective_lcld"].append(cs.graph_ms(calls[name]["objective_lcld"]))
            times[name]["pgd_lcld"].append(cs.graph_ms(calls[name]["pgd_lcld"], launches=2, repeats=3))
    records = []
    for name in order:
        rec = {"tree": name, "card": smi, "equal_to": first}
        for kernel, ts in times[name].items():
            rec[kernel] = {"ms": statistics.median(ts), "runs": ts,
                           "ratio": statistics.median(ts) / statistics.median(times[first][kernel])}
        records.append(rec)
        print(json.dumps(rec))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "compare_lcld_base.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

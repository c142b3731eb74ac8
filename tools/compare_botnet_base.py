"""Time the base botnet domain's K8 of two trees of the port side by side on
one NVIDIA card, and hold their outputs equal.

    python3 tools/compare_botnet_base.py [--out DIR] parent=<root> change=<root>

Each ``<root>`` is the root of a checkout (a parent commit unpacked with
``git archive`` into a gitignored directory, or this repo). Its port package
is imported under a name of its own and builds its kernels into its own
``.torch_ext_build/``. The inputs are the change's, made from seeds: phase
8's timed shape (``chip_smoke.BOTNET_STATES`` synthetic botnet states x 100
candidates of rq1.botnet's engine, with the terms' edge cases,
``chip_smoke.botnet_candidates``) and the generate path's chunks (256 and
131 states x 100); each tree builds its own engine over the same surrogate,
scaler and constraint set. The first tree's outputs are the reference: every
other tree's must equal them entry for entry. The kernel is timed in turns
(first to last, then last to first, twice) with CUDA events around the
replay of a CUDA graph (``chip_smoke.graph_ms``). Prints each tree's ptxas
line of K8's base instantiation and one JSON line per tree, with each
shape's median device ms and its ratio to the first tree's, and writes the
lines to ``<out>/compare_botnet_base.json``.
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
#: K8's base entry: a template over its pair and history flags, over its pair
#: flag alone (a parent's), or a parent's plain kernel
BASE_ENTRIES = ("objective_botnet_kernel<0,0>", "objective_botnet_kernel<0>", "objective_botnet_kernel")


def load_tree(name: str, root: Path, links: Path):
    """The port package of the checkout at ``root``, imported as
    ``port_<name>``, with its kernel library built; prints the ptxas line of
    K8's base instantiation."""
    (links / f"port_{name}").symlink_to((root / PACKAGE).resolve(), target_is_directory=True)
    pkg = importlib.import_module(f"port_{name}")
    for sub in ("kernels", "kernels.build", "attacks.moeva"):
        importlib.import_module(f"port_{name}.{sub}")
    pkg.kernels.build.library()
    for k in cs.ptxas_resources(pkg.kernels.build.build().log):
        if k["kernel"] in BASE_ENTRIES:
            print(f"[ptxas] {name}: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
                  f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    return pkg


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / ".torch_ext_build" / "probe"))
    parser.add_argument("trees", nargs="+", help="name=<root of a checkout>")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_botnet_base: CUDA is not available", file=sys.stderr)
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

    cons, sur, scaler, x, _ = cs.botnet_problem()
    eng = Moeva2(sur, cons, ml_scaler=scaler, device=device, **cs.BOTNET_KNOBS)
    gen = torch.Generator(device=device).manual_seed(8)
    inputs = {}
    for s in (cs.BOTNET_STATES, *cs.BOTNET_PATH_STATES):
        run = eng.prepare(x[:s], np.ones(s, dtype=np.int64))
        inputs[f"{s}x{eng.n_offsprings}"] = (run, cs.botnet_candidates(gen, eng, run, eng.n_offsprings))

    def calls(pkg):
        tree_eng = pkg.attacks.moeva.Moeva2(sur, cons, ml_scaler=scaler, device=device, **cs.BOTNET_KNOBS)
        return {shape: (lambda run=run, cand=cand: pkg.kernels.objective_botnet(
            cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm, run.minimize_class, tree_eng._objective))
            for shape, (run, cand) in inputs.items()}

    fns = {name: calls(pkg) for name, pkg in trees.items()}
    first = next(iter(fns))
    want = {shape: fn() for shape, fn in fns[first].items()}
    for name, by_shape in fns.items():
        for shape, fn in by_shape.items():
            cs.hold_equal(fn(), want[shape], f"{name} objective_botnet {shape} against {first}")
    times = {name: {shape: [] for shape in inputs} for name in fns}
    order = list(fns)
    for _ in range(2):
        for name in order + order[::-1]:
            for shape, fn in fns[name].items():
                times[name][shape].append(cs.graph_ms(fn))
    records = []
    for name in order:
        rec = {"tree": name, "card": smi, "equal_to": first, "kernel": "objective_botnet"}
        for shape, ts in times[name].items():
            rec[shape] = {"ms": statistics.median(ts), "runs": ts,
                          "ratio": statistics.median(ts) / statistics.median(times[first][shape])}
        records.append(rec)
        print(json.dumps(rec))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "compare_botnet_base.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

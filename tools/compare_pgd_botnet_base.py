"""Time the base botnet PGD kernel K7b of two trees of the port side by side
on one NVIDIA card, and hold their outputs and ptxas lines equal.

    python3 tools/compare_pgd_botnet_base.py [--out DIR] parent=<root> change=<root>

Each ``<root>`` is the root of a checkout (a parent commit unpacked with
``git archive`` into a gitignored directory, or this repo). Its port package
is imported under a name of its own and builds its kernels into its own
``.torch_ext_build/``. The inputs are the change's, made from seeds: phase
9's timed shape (``chip_smoke.PGD_BOTNET_STATES`` synthetic botnet states x
1000 iterations of rq1.botnet's last loss, L2, ε 4 - 1e-6, from x_init,
labels from the surrogate); each tree builds its own engine over the same
surrogate and scaler. The first tree's outputs are the reference: every
other tree's must equal them entry for entry, and its ptxas line of the
base instantiation (registers, stack frame, spill) the first's. The kernel
is timed in turns (first to last, then last to first, twice) with CUDA
events around the replay of a CUDA graph of 2 launches
(``chip_smoke.graph_ms``). Prints each tree's ptxas line of K7b's base
(``pgd_botnet_kernel`` in trees before its AutoPGD instantiation,
``pgd_botnet_kernel<0>`` since) and one JSON line per tree, with the median
device ms and its ratio to the first tree's, and writes the lines to
``<out>/compare_pgd_botnet_base.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PACKAGE = "moeva2_ijcai22_replication_tpu_torch"
#: K7b's base instantiation's name in the ptxas report, before and since
#: its AutoPGD instantiation
BASE_NAMES = ("pgd_botnet_kernel", "pgd_botnet_kernel<0>")


def load_tree(name: str, root: Path, links: Path):
    """The port package of the checkout at ``root``, imported as
    ``port_<name>``, with its kernel library built, and its ptxas line of
    K7b's base as ``(registers, stack, spill stores, spill loads)``."""
    (links / f"port_{name}").symlink_to((root / PACKAGE).resolve(), target_is_directory=True)
    pkg = importlib.import_module(f"port_{name}")
    for sub in ("kernels", "kernels.build", "attacks.pgd"):
        importlib.import_module(f"port_{name}.{sub}")
    pkg.kernels.build.library()
    lines = [k for k in cs.ptxas_resources(pkg.kernels.build.build().log) if k["kernel"] in BASE_NAMES]
    if len(lines) != 1:
        raise AssertionError(f"{name}: the ptxas report has {len(lines)} entries for K7b's base")
    k = lines[0]
    print(f"[ptxas] {name}: {k['kernel']}: {k['registers']} registers, {k['stack']} bytes stack frame, "
          f"{k['spill_stores']} + {k['spill_loads']} bytes spill stores + loads")
    return pkg, (k["registers"], k["stack"], k["spill_stores"], k["spill_loads"])


def kernel_call(pkg, device, inputs):
    """A call of ``pkg``'s K7b on ``inputs`` through the tree's own engine
    tables."""
    cons, sur, scaler = inputs["problem"]
    eps = cs.PGD_BOTNET_EPS - 1e-6
    atk = pkg.attacks.pgd.ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, norm=2,
                                         loss_evaluation=cs.PGD_LOSS, device=device)
    sched = atk.schedule(eps, 0.1, cs.PGD_BUDGET)
    xi, yt = inputs["xi"], inputs["y"]
    return lambda: pkg.kernels.pgd_botnet(atk.tables, sched, xi, yt, xi, eps, atk.clip, False, True, False)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / ".torch_ext_build" / "probe"))
    parser.add_argument("trees", nargs="+", help="name=<root of a checkout>")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_pgd_botnet_base: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    links = Path(tempfile.mkdtemp())
    sys.path.insert(0, str(links))
    trees, ptxas = {}, {}
    for spec in args.trees:
        name, root = spec.split("=", 1)
        trees[name], ptxas[name] = load_tree(name, Path(root), links)
    first = next(iter(trees))
    for name, line in ptxas.items():
        if line != ptxas[first]:
            raise AssertionError(f"{name}'s K7b base ptxas line {line} differs from {first}'s {ptxas[first]}")

    cons, sur, scaler, _, xs, y = cs.pgd_botnet_problem()
    inputs = {"problem": (cons, sur, scaler), "xi": torch.as_tensor(xs, dtype=torch.float32, device=device),
              "y": torch.as_tensor(y, device=device)}
    calls = {name: kernel_call(pkg, device, inputs) for name, pkg in trees.items()}
    want = calls[first]()
    for name, call in calls.items():
        for g, w in zip(call(), want):
            if g is not None:
                cs.hold_equal(g, w, f"{name} pgd_botnet against {first}")
    times = {name: [] for name in calls}
    order = list(calls)
    for _ in range(2):
        for name in order + order[::-1]:
            times[name].append(cs.graph_ms(calls[name], launches=2, repeats=3))
    records = []
    for name in order:
        rec = {"tree": name, "card": smi, "equal_to": first, "ptxas": ptxas[name],
               "pgd_botnet": {"ms": statistics.median(times[name]), "runs": times[name],
                              "ratio": statistics.median(times[name]) / statistics.median(times[first])}}
        records.append(rec)
        print(json.dumps(rec))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "compare_pgd_botnet_base.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

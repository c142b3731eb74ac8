#!/usr/bin/env python3
"""Time the main path of two trees of the port in turns on one card.

    python3 tools/compare_main_path.py parent=<root> change=. [--runs 6] [--botnet-runs 3] [--descent parent]
        [--n-pop 200]

Each ``name=root`` is the root of a checkout (a ``git archive`` of the
parent unpacked under ``.torch_ext_build/``, or ``.``). The trees run in the
order parent, change, change, parent, each in a fresh process that builds
its own kernels: the fresh process's ``chip_smoke.main_path_engine`` (the
synthetic problem and the engine, whose reference directions that tree
computes: on the host, or on the card) and its first ``generate``, then
``Moeva2.generate`` on its 1000 LCLD states x 100 generations (the first
call cold, then the steady median), that tree's ``chip_smoke.profile_generation`` (traced ms and
launches a generation, busy share), and botnet's 387 states x 1000
generations (``chip_smoke.BOTNET_KNOBS``). With ``--descent NAME`` the
trees of that name first time ``energy_ref_dirs(3, n)`` at 100, 200 and
300 points from a seed no engine uses (the reference directions as that
tree's host computes them, one fresh call each). With ``--n-pop N`` every
engine of the main path is built with N points (its reference directions,
so K14's launch, at N; 100 without it, as ``main_path_engine`` builds it);
``--botnet-runs 0`` leaves botnet out. Every line names its tree;
the last line is the card's name and power limit. Run it through the chip
tool; it needs one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

CODE = r'''
import sys, time, statistics
name, root, runs, botnet_runs, descent = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
n_pop = int(sys.argv[6])
sys.path.insert(0, root)
import torch
import chip_smoke as s
import moeva2_ijcai22_replication_tpu_torch.attacks.moeva as attacks_moeva
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.kernels import build

if n_pop:
    class Sized(Moeva2):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "n_pop": n_pop})

    attacks_moeva.Moeva2 = Sized  # main_path_engine imports it at its call

build.build()
build.library()
dev = torch.device("cuda", 0)


def walls(eng, x, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(x, 1)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


if descent == "1":
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.refdirs import energy_ref_dirs

    for n in (100, 200, 300):
        t0 = time.perf_counter()
        energy_ref_dirs(3, n, seed=2)
        print(f"[compare] {name} host energy_ref_dirs(3, {n}): {time.perf_counter() - t0:.3f} s", flush=True)
torch.cuda.synchronize()
t0 = time.perf_counter()
moeva, x, _ = s.main_path_engine(dev)
torch.cuda.synchronize()
built = time.perf_counter() - t0
w = walls(moeva, x, runs)
print(f"[compare] {name} fresh process: main_path_engine (problem and engine, n_pop {moeva.n_pop}) {built:.4f} s, "
      f"then the first generate {w[0]:.4f} s, together {built + w[0]:.4f} s", flush=True)
print(f"[compare] {name} lcld {len(x)} x {moeva.n_gen}: cold {w[0]:.4f} s, steady median "
      f"{statistics.median(w[1:]):.4f} s, all {[round(v, 4) for v in w]}", flush=True)
s.profile_generation(moeva, x, tag=f"[compare] {name} profile")
if botnet_runs:
    cons, sur, scaler, xb, _ = s.botnet_problem()
    bot = Moeva2(sur, cons, ml_scaler=scaler, device=dev, **s.BOTNET_KNOBS)
    w = walls(bot, xb, botnet_runs)
    print(f"[compare] {name} botnet {len(xb)} x {bot.n_gen}: cold {w[0]:.4f} s, steady {[round(v, 4) for v in w[1:]]}",
          flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, help="parent=<root> change=<root>")
    ap.add_argument("--runs", type=int, default=6, help="generate calls on the main path, the first cold")
    ap.add_argument("--botnet-runs", type=int, default=3, help="generate calls on botnet, the first cold")
    ap.add_argument("--descent", default="", help="the tree name whose processes time the host descent first")
    ap.add_argument("--n-pop", type=int, default=0, help="the main path engine's points (0: main_path_engine's 100)")
    args = ap.parse_args()
    (a, root_a), (b, root_b) = (t.split("=", 1) for t in args.trees)
    rc = 0
    for name, root in ((a, root_a), (b, root_b), (b, root_b), (a, root_a)):
        r = subprocess.run([sys.executable, "-c", CODE, name, root, str(args.runs), str(args.botnet_runs),
                            str(int(name == args.descent)), str(args.n_pop)], capture_output=True, text=True)
        keep = [line for line in r.stdout.splitlines() if line.startswith("[compare]")]
        head = [line for line in keep if " host " in line or " fresh process" in line or " lcld " in line]
        print("\n".join(head + [line for line in keep if " profile " in line][:1]
                        + [line for line in keep if " botnet " in line]), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            rc = 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())

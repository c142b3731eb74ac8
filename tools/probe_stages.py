#!/usr/bin/env python3
"""Time designs of K14 (``refdirs``) and K16 (``forward_labels``,
``forward_proba1``) side by side on one card.

    python3 tools/probe_stages.py change=. other=<root> [diag-x=<root> ...] [--points 100,200,300] [--steps 3000]

Each ``name=root`` is the root of a checkout of the port, or of a copy of
its package with an edited ``kernels/csrc`` (``cp -r`` the package under
``.torch_ext_build/``). The trees run in turns, in the order given and then
reversed, each in a fresh process that builds its own kernels: K14 at each
of ``--points`` points of 3 dimensions x ``--steps`` steps (a CUDA graph of
one launch, three repeats; held over the first 300 steps), and K16 at
LCLD's stack (labels 4000 x 47, proba1 2000 x 47) and botnet's and
augmented botnet's (labels 387 x 756 and x 927, proba1 1000 x 756 and x
927) as ``chip_smoke.check_forward`` makes them (a CUDA graph of 20). A tree whose name starts with ``diag-`` is an ablation (work
dropped to see its cost): it is timed, not held; every other tree's results
are held bit for bit against the plain versions first. Prints one line per
tree and turn, then the card's name and power limit. It needs one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CODE = r'''
import sys
name, root, smoke_root, points, steps = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5])
sys.path.insert(0, smoke_root)
sys.path.insert(0, root)
import copy
import numpy as np
import torch
import chip_smoke as s
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import refdirs
from moeva2_ijcai22_replication_tpu_torch.kernels import build
from moeva2_ijcai22_replication_tpu_torch.models.mlp import botnet_mlp, lcld_mlp, mlp_proba_plain, proba1_plain
from moeva2_ijcai22_replication_tpu_torch.models.train import stack_tensors

build.build()
build.library()
dev = torch.device("cuda", 0)
held = not name.startswith("diag-")
sched = refdirs.descent_schedule(steps).to(dev)
out = []
for pts in (int(p) for p in points.split(",")):
    theta = torch.as_tensor(refdirs.start_point(3, pts, 1), device=dev)
    first = sched[:300]
    if held and not s.same_bits(kernels.refdirs(theta, first, 4.0), refdirs.energy_descent_plain(theta, 4.0, first)):
        raise AssertionError(f"{name}: refdirs differs from energy_descent_plain at {pts} points")
    out.append(f"refdirs {pts} {s.graph_ms(lambda: kernels.refdirs(theta, sched, 4.0), launches=1, repeats=3):.3f}")
for stack, (n_lab, n_p1) in s.FORWARD_SHAPES.items():
    model = {"lcld": lambda: lcld_mlp(seed=11), "botnet": lambda: botnet_mlp(seed=12),
             "botnet_augmented": lambda: botnet_mlp(927, seed=13)}[stack]()
    rng = np.random.default_rng(len(stack))
    w, p32, layers32 = stack_tensors(model, torch.float32, dev)
    _, p64, layers64 = stack_tensors(model, torch.float64, dev)
    x32 = torch.as_tensor(rng.uniform(0.0, 1.0, (n_lab, w[0])).astype(np.float32), device=dev)
    x64 = torch.as_tensor(rng.uniform(0.0, 1.0, (n_p1, w[0])), device=dev)
    if held:
        s.hold_equal(kernels.forward_labels(x32, p32, w), torch.argmax(mlp_proba_plain(layers32, x32), dim=-1), name)
        s.hold_equal(kernels.forward_proba1(x64, p64, w), proba1_plain(layers64, x64), name)
    out.append(f"labels {n_lab}x{w[0]} {s.graph_ms(lambda: kernels.forward_labels(x32, p32, w)):.4f}")
    out.append(f"proba1 {n_p1}x{w[0]} {s.graph_ms(lambda: kernels.forward_proba1(x64, p64, w)):.4f}")
print(f"[probe] {name}: " + "; ".join(out) + " ms", flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="name=<root>")
    ap.add_argument("--points", default="100,200,300", help="K14's point counts")
    ap.add_argument("--steps", type=int, default=3000, help="K14's steps")
    args = ap.parse_args()
    trees = [t.split("=", 1) for t in args.trees]
    rc = 0
    for name, root in trees + trees[::-1]:
        r = subprocess.run([sys.executable, "-c", CODE, name, root, str(ROOT), args.points, str(args.steps)],
                           capture_output=True, text=True)
        print("\n".join(line for line in r.stdout.splitlines() if line.startswith("[probe]")), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
            rc = 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())

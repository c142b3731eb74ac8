#!/usr/bin/env python3
"""Time designs of the port's constrained-PGD kernel on botnet (K7b) side
by side on one NVIDIA card, with ``tools/kernel_probe.py``'s loop.

Each variant is a ``csrc`` directory holding ``pgd_botnet.cu``,
``pgd_common.cuh`` and ``kernels.h``. It is driven through
``kernels.pgd_botnet`` on ``chip_smoke.py``'s phase-9 problem, held against
``pgd_run_plain`` bit for bit at rq1.botnet's 387 states x 7 iterations
from the edge starts (with the full history), and timed with a CUDA graph
of 2 launches at 387 x 1000 under L2 (``constraints+flip+adaptive_eps_step
+repair``, rq1.botnet's run), at 387 x 1000 under L-inf (no L2 sums: their
serial chains' share), and at 0 iterations (staging and the final forward
alone). The ``K7B_STAMPS`` breakdown is one run at 387 x 1000 under each
norm, in cycles per iteration: per phase, thread 0 of each CTA of cluster
0, rank 0's then rank 1's (``each``; ``w0`` is rank 0's). A phase named
for one rank is that rank's work; the other rank stamps nothing there, or
waits. A ``wait:`` phase is the time a CTA waits for its peer's hand-off
(a source from before the cluster design stamps block 0's thread 0 alone).
Writes ``<out>/probe_k7b.json``.

Run from the root of a checkout:

    python3 tools/probe_pgd_botnet.py [--out DIR] \\
        change=moeva2_ijcai22_replication_tpu_torch/kernels/csrc \\
        parent=<unpacked parent>/moeva2_ijcai22_replication_tpu_torch/kernels/csrc
"""

from __future__ import annotations

import sys

import numpy as np

import kernel_probe as kp


def make_spec(device) -> kp.ProbeSpec:
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain
    from moeva2_ijcai22_replication_tpu_torch.problems import botnet_edge_starts

    cs = kp.cs
    cons, sur, scaler, _, xs, y = cs.pgd_botnet_problem()
    xi = torch.as_tensor(xs, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, device=device)
    eps = cs.PGD_BOTNET_EPS - 1e-6
    engines = {norm: ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, norm=norm, loss_evaluation=cs.PGD_LOSS,
                                    record_loss="full", record_grad_norm=True, device=device)
               for norm in (2, np.inf)}
    runs = {"l2": (2, cs.PGD_BUDGET), "linf": (np.inf, cs.PGD_BUDGET), "t0": (2, 0)}

    def launch(case):
        norm, t = runs[case]
        atk = engines[norm]
        sched = atk.schedule(eps, 0.1, t)
        return lambda: kernels.pgd_botnet(atk.tables, sched, xi, yt, xi, eps, atk.clip, norm != 2, True, False)

    def hold(name):
        atk = engines[2]
        sched = atk.schedule(eps, 0.1, 7)
        st = torch.as_tensor(botnet_edge_starts(cons.schema.names, scaler, xs), device=device)
        got = kernels.pgd_botnet(atk.tables, sched, xi, yt, st, eps, atk.clip, False, True, False,
                                 atk.history_layout())
        want = pgd_run_plain(atk.tables, cons, sched, xi, yt, st, eps, atk.clip, 2, True, False,
                             atk.history_layout())
        for what, g, w in zip(("x_adv", "pred", "hist"), got, want):
            cs.hold_equal(g, w, f"{name} {what}")

    return kp.ProbeSpec(
        tag="k7b", files=("pgd_botnet.cu", "pgd_common.cuh", "kernels.h"), kernel="pgd_botnet_kernel",
        cases={case: launch(case) for case in runs}, hold=hold,
        stamp_cases={case: runs[case][1] for case in ("l2", "linf")}, time_kw={"launches": 2, "repeats": 3})


if __name__ == "__main__":
    sys.exit(kp.main(make_spec, __doc__))

#!/usr/bin/env python3
"""Time designs of the port's constrained-PGD kernel on LCLD (K7) side by
side on one NVIDIA card, with ``tools/kernel_probe.py``'s loop.

Each variant is a ``csrc`` directory holding ``pgd_lcld.cu``,
``pgd_common.cuh`` and ``kernels.h``. It is driven through
``kernels.pgd_lcld`` on ``chip_smoke.py``'s phase-7 problem (4000
synthetic LCLD states, the seeded 47-64-32-16-2 surrogate), held against
``pgd_run_plain`` bit for bit from the edge starts with the full history
(the loss columns, the gradient norm and the ten violations) at
``chip_smoke.PGD_ROWS`` x 7 iterations under L2 and rq1's loss, and at
4000 x 7 under L-inf with repair; and timed with a CUDA graph of 2
launches at 4000 x 1000 under L2 (``constraints+flip+adaptive_eps_step
+repair``, config/rq1.lcld.yaml's run), at 4000 x 1000 under L-inf (no L2
sums), and at 0 iterations (staging and the final forward alone). The
``K7_STAMPS`` breakdown is one run at 4000 x 1000 under each norm, in
cycles per iteration. Writes ``<out>/probe_k7.json``.

Run from the root of a checkout:

    python3 tools/probe_pgd_lcld.py [--out DIR] \\
        change=moeva2_ijcai22_replication_tpu_torch/kernels/csrc \\
        parent=<unpacked parent>/moeva2_ijcai22_replication_tpu_torch/kernels/csrc
"""

from __future__ import annotations

import sys

import numpy as np

import kernel_probe as kp

#: the hold's iterations
HOLD_ITERS = 7


def make_spec(device) -> kp.ProbeSpec:
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
    from moeva2_ijcai22_replication_tpu_torch.attacks.pgd.engine import pgd_run_plain

    cs = kp.cs
    cons, sur, scaler, x = cs.pgd_problem()
    xs = scaler.transform(x).astype(np.float32)
    y = cs.surrogate_labels(sur, xs)
    starts = cs.pgd_edge_starts(np.random.default_rng(5), xs, scaler)
    xi = torch.as_tensor(xs, device=device)
    yt = torch.as_tensor(y, device=device)
    # the hold's row counts above the problem's states repeat its rows
    n_hold = max(cs.PGD_ROWS)
    hold_rows = [torch.as_tensor(np.resize(v, (n_hold, *v.shape[1:])), device=device) for v in (xs, y, starts)]
    eps = cs.PGD_EPS - 1e-6
    engines = {norm: ConstrainedPGD(sur, cons, scaler, eps=eps, eps_step=0.1, norm=norm, loss_evaluation=cs.PGD_LOSS,
                                    record_loss="full", record_grad_norm=True, device=device)
               for norm in (2, np.inf)}
    runs = {"l2": (2, cs.PGD_BUDGET), "linf": (np.inf, cs.PGD_BUDGET), "t0": (2, 0)}

    def launch(case):
        norm, t = runs[case]
        atk = engines[norm]
        sched = atk.schedule(eps, 0.1, t)
        return lambda: kernels.pgd_lcld(atk.tables, sched, xi, yt, xi, eps, atk.clip, norm != 2, True, False)

    def hold_one(name, norm, n):
        atk = engines[norm]
        sched = atk.schedule(eps, 0.1, HOLD_ITERS)
        args = tuple(v[:n] for v in hold_rows)
        got = kernels.pgd_lcld(atk.tables, sched, *args, eps, atk.clip, norm != 2, True, False,
                               atk.history_layout())
        want = pgd_run_plain(atk.tables, cons, sched, *args, eps, atk.clip, norm, True, False,
                             atk.history_layout())
        for what, g, w in zip(("x_adv", "pred", "hist"), got, want):
            cs.hold_equal(g, w, f"{name} norm={norm} N={n} {what}")

    def hold(name):
        for n in cs.PGD_ROWS:
            hold_one(name, 2, n)
        hold_one(name, np.inf, cs.PGD_STATES)

    return kp.ProbeSpec(
        tag="k7", files=("pgd_lcld.cu", "pgd_common.cuh", "kernels.h"), kernel="pgd_lcld_kernel",
        cases={case: launch(case) for case in runs}, hold=hold,
        stamp_cases={case: runs[case][1] for case in ("l2", "linf")}, time_kw={"launches": 2, "repeats": 3})


if __name__ == "__main__":
    sys.exit(kp.main(make_spec, __doc__))

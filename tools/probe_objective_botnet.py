#!/usr/bin/env python3
"""Time designs of the port's botnet objective kernel (K8) side by side on
one NVIDIA card, with ``tools/kernel_probe.py``'s loop.

Each variant is a ``csrc`` directory holding ``objective_botnet.cu`` and
``kernels.h``. It is driven through ``kernels.objective_botnet`` on
``chip_smoke.py``'s phase-8 problem (387 botnet states, the seeded
756-64-64-32-2 surrogate, candidates with the terms' edge cases), held
against ``evaluate_plain`` bit for bit at every shape of ``SHAPES``, and
timed with a CUDA graph of 20 launches at each: rq1.botnet's 387 states x
100 offspring, the two chunks ``max_states_per_call: 256`` makes of them
(256 x 100 and 131 x 100, the shapes the ``generate`` path launches), and
the init round's population (387 x 203). The ``K8_STAMPS`` breakdown is
one launch at each shape of ``STAMP_SHAPES``. Writes ``<out>/probe_k8.json``.

Run from the root of a checkout:

    python3 tools/probe_objective_botnet.py [--out DIR] \\
        change=moeva2_ijcai22_replication_tpu_torch/kernels/csrc \\
        parent=<unpacked parent>/moeva2_ijcai22_replication_tpu_torch/kernels/csrc
"""

from __future__ import annotations

import sys

import numpy as np

import kernel_probe as kp

#: (states, rows per state): rq1.botnet's offspring, its two chunks, and the
#: population of the init round
SHAPES = ((387, 100), (256, 100), (131, 100), (387, 203))
STAMP_SHAPES = ((387, 100), (131, 100))


def make_spec(device) -> kp.ProbeSpec:
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import evaluate_plain

    cs = kp.cs
    cons, sur, scaler, x, _ = cs.botnet_problem()
    moeva = Moeva2(sur, cons, ml_scaler=scaler, device=device, **cs.BOTNET_KNOBS)
    obj = moeva._objective
    gen = torch.Generator(device=device).manual_seed(8)
    inputs = {}
    for s, n in SHAPES:
        run = moeva.prepare(x[:s], np.arange(s) % 2)
        inputs[f"{s}x{n}"] = (run, cs.botnet_candidates(gen, moeva, run, n))

    def launch(shape):
        run, cand = inputs[shape]
        return lambda: kernels.objective_botnet(cand, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                                                run.minimize_class, obj)

    def hold(name):
        for shape, (run, cand) in inputs.items():
            cs.hold_equal(launch(shape)(), evaluate_plain(obj, moeva.codec, run, cand, cons), f"{name} {shape}")

    return kp.ProbeSpec(
        tag="k8", files=("objective_botnet.cu", "kernels.h"), kernel="objective_botnet_kernel",
        cases={shape: launch(shape) for shape in inputs}, hold=hold,
        stamp_cases={f"{s}x{n}": 1 for s, n in STAMP_SHAPES})


if __name__ == "__main__":
    sys.exit(kp.main(make_spec, __doc__))

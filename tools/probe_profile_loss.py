"""Count how often ``torch.profiler``'s device trace loses kernel events in
the smoke's profile phase, with and without the settle before the kept
window's first launch.

    python3 tools/probe_profile_loss.py [--out DIR] [--traces N] [--settle S]

Builds the smoke's two profiled engines on one NVIDIA card: the main path's
(1000 synthetic LCLD states, ``chip_smoke.main_path_engine``) and phase 8's
(387 synthetic botnet states, ``chip_smoke.botnet_problem`` with
``chip_smoke.BOTNET_KNOBS``). For each engine it takes ``N`` traces of
``chip_smoke.PROFILE_GENS`` generations with each settle in turn (0 s, then
``S`` s, then 0 s again, ...) through ``chip_smoke.trace_generations``, and
counts the traces that ``chip_smoke.lost_events`` finds lacking, with what
they lacked. Prints one JSON line per engine and settle, and writes them to
``<out>/probe_profile_loss.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def probe(name: str, moeva, x, n_traces: int, settles: tuple) -> list:
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.engine import PhiloxDraws

    gen = PhiloxDraws(moeva, 0)
    with torch.inference_mode():
        init = gen.init(len(x))
        run, start = moeva._prepare(x, np.ones(len(x), dtype=np.int64), moeva.init_spec(init.ball))
        carry = moeva.init_carry(run, init.gum_cut, init.gum_mem, start=start)
        carry, port, ops = cs.launches_per_generation(moeva, run, carry, gen, len(x))
    expected = sum(port.values()) + sum(ops.values())
    tally = {s: {"engine": name, "settle_s": s, "traces": 0, "lost": 0, "what": []} for s in settles}
    for i in range(n_traces * len(settles)):
        settle = settles[i % len(settles)]
        carry, events, _ = cs.trace_generations(moeva, run, carry, gen, len(x), settle_s=settle)
        kernels, _ = cs.traced_kernels(events)
        lost = cs.lost_events(kernels, port, expected)
        rec = tally[settle]
        rec["traces"] += 1
        if lost:
            rec["lost"] += 1
            rec["what"].append(f"trace {rec['traces']}: " + "; ".join(lost))
    return list(tally.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--traces", type=int, default=30)
    ap.add_argument("--settle", type=float, default=cs.PROFILE_SETTLE_S)
    args = ap.parse_args()

    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    build.build()
    build.library()
    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    settles = (0.0, args.settle)
    lines = []
    moeva, x, _ = cs.main_path_engine(device)
    lines += probe("lcld", moeva, x, args.traces, settles)
    cons, sur, scaler, x, _ = cs.botnet_problem()
    moeva = Moeva2(sur, cons, ml_scaler=scaler, device=device, **cs.BOTNET_KNOBS)
    lines += probe("botnet", moeva, x, args.traces, settles)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "probe_profile_loss.json", "w") as f:
        for rec in lines:
            rec["card"] = smi
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

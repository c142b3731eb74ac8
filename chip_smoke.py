#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. versions: torch, CUDA, and the card's name and power limit (nvidia-smi);
2. build the port's CUDA kernels from the sources in the checkout;
3. hold each kernel against its plain PyTorch version on the card over a
   sweep of state counts (nd_peel exactly; associate with niche equal
   wherever the top two squared projections differ by more than 1e-6
   relative, dist within 1e-5 absolute), including NaN, +inf and duplicate
   rows, and time both with CUDA events at the main path's shape;
4. drive the main path, ``Moeva2.generate`` on 1000 synthetic LCLD states
   at population 103 with 100 offspring, with every launch count set to 0
   just before and read just after; check the result's shape, finiteness
   and that only mutable features moved; hold the engine's stages on the
   card against the CPU path, stage by stage on the same inputs;
5. judge the result with ``ObjectiveCalculator.success_rate_3d`` (o1..o7);
6. profile a few generation steps: ms per generation, device-busy share,
   launches, kernels and stages by device time.

The last three lines are the per-kernel JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Nothing is printed as a
result when CUDA is missing or the port's package is not beside this script.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

#: generations of the main-path attack (the headline bench runs 1000)
N_GEN = 100
N_STATES = 1000
#: state counts of the kernel sweep: those at which the removed TPU
#: association kernel faulted (537-544) or ran clean
SWEEP_STATES = (64, 387, 512, 520, 537, 538, 540, 544, 1000)
#: (M candidates, R directions, n_stop): the main path's shape and the
#: shape the TPU fault was bisected at
SWEEP_SHAPES = ((203, 103, 103), (303, 203, 203))
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 ops/s
#: outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
ASSOC_TIE_REL = 1e-6
ASSOC_DIST_ATOL = 1e-5
#: engine stages on the same inputs: the card's float32 error against the
#: float64 CPU path may be at most this many times the CPU's float32 error
STEP_ERR_RATIO = 4.0
#: generations traced by the profile phase, after 3 untraced ones
PROFILE_GENS = 10


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``launches`` calls,
    measured with CUDA events after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# -- kernel inputs --------------------------------------------------------------


def sweep_objectives(rng, s: int, m: int) -> np.ndarray:
    """(S, M, 3) float32 objectives shaped like the engine's: a misclassification
    probability, a small distance and a violation sum, with per-state mixes of
    continuous values, coarse discrete values (ties), duplicated rows, a few
    NaN rows and a few rows whose violation sum is +inf (a ratio constraint
    whose denominator a mutation set to 0)."""
    f = np.stack(
        [rng.uniform(0, 1, (s, m)), rng.uniform(0, 0.3, (s, m)), rng.exponential(1.0, (s, m))],
        axis=-1,
    )
    coarse = rng.random(s) < 0.3
    f[coarse] = np.round(f[coarse] * 4) / 4
    k = m // 5
    f[:, m - k :] = f[:, :k]  # duplicate rows
    nan_rows = rng.random((s, m)) < 0.01
    f[nan_rows, rng.integers(0, 3)] = np.nan
    f[rng.random((s, m)) < 0.01, 2] = np.inf
    return f.astype(np.float32)


def finite_ideal_nadir(f):
    """Ideal and nadir over the finite objectives, as survival keeps them
    (an inf objective under a finite nadir projects to NaN on the axes)."""
    import torch

    finite = torch.where(torch.isfinite(f), f, 0.0)
    return finite.amin(1), finite.amax(1)


def sweep_directions(rng, s: int, r: int) -> np.ndarray:
    """(S, R, 3) directions like ``_unit_ref_dirs``: simplex points + axes."""
    pts = rng.dirichlet(np.ones(3), (s, r - 3))
    return np.concatenate([pts, np.broadcast_to(np.eye(3), (s, 3, 3))], axis=1).astype(np.float32)


def nd_peel_ops(ranks: np.ndarray, m: int) -> int:
    """Operations the peel needs on these inputs: 6 comparisons per ordered
    pair for the relation, then per front one AND of ceil(M/32) words for
    every candidate still remaining."""
    words = -(-m // 32)
    ops = 6 * ranks.shape[0] * m * m
    for row in ranks:
        ranked = np.sort(row[row != 2**31 - 1])
        for r in range(int(ranked.max()) + 1 if ranked.size else 0):
            ops += (m - int(np.searchsorted(ranked, r))) * words
    return ops


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ---------------------------------------------------------------------


def check_kernels(device):
    """Phase 3: parity sweep and timing of K2 and K3 against their plain
    versions on the card. Returns the per-kernel records (launches filled
    in later)."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.nds import nd_ranks_plain
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import associate_plain

    rng = np.random.default_rng(0)
    assoc_err = 0.0
    tie_mismatch = 0
    inf_rows = 0
    for m, r, n_stop in SWEEP_SHAPES:
        for s in SWEEP_STATES:
            f = torch.as_tensor(sweep_objectives(rng, s, m), device=device)
            inf_rows += int((torch.isinf(f).any(-1) & ~torch.isnan(f).any(-1)).sum())
            for stop in (n_stop, m):
                got = kernels.nd_peel(f, stop)
                want = nd_ranks_plain(f, stop)
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise AssertionError(f"nd_peel != plain at S={s} M={m} n_stop={stop}: {bad} ranks differ")
            dirs = torch.as_tensor(sweep_directions(rng, s, r), device=device)
            ideal, nadir = finite_ideal_nadir(f)
            niche, dist = kernels.associate(f, dirs, ideal, nadir)
            niche_p, dist_p = associate_plain(f, dirs, ideal, nadir)
            # rows where the top two squared projections are within the tie
            # band may legitimately pick either direction
            n = ((f - ideal[:, None]) / torch.where(nadir == ideal, 1e-12, nadir - ideal)[:, None]).double()
            d = dirs.double() / torch.linalg.vector_norm(dirs.double(), dim=-1, keepdim=True)
            top2 = torch.topk(torch.einsum("smk,srk->smr", n, d) ** 2, 2, dim=-1).values
            gap = (top2[..., 0] - top2[..., 1]) / top2[..., 0].abs().clamp_min(1e-30)
            differ = niche != niche_p
            if bool((differ & ~(gap <= ASSOC_TIE_REL)).any()):
                raise AssertionError(f"associate niche != plain outside the tie band at S={s} M={m}")
            tie_mismatch += int(differ.sum())
            both_nan = torch.isnan(dist) & torch.isnan(dist_p)
            if bool((torch.isnan(dist) != torch.isnan(dist_p)).any()):
                raise AssertionError(f"associate dist NaN pattern != plain at S={s} M={m}")
            same = niche == niche_p
            err = (dist - dist_p).abs()[same & ~both_nan]
            assoc_err = max(assoc_err, float(err.max()) if err.numel() else 0.0)
            if assoc_err > ASSOC_DIST_ATOL:
                raise AssertionError(f"associate dist off by {assoc_err} at S={s} M={m}")
        log(f"[kernels] parity ok at M={m} R={r}: S in {SWEEP_STATES}")
    log(f"[kernels] associate: max |dist - plain| = {assoc_err:.3e}, "
        f"niche picks differing inside the {ASSOC_TIE_REL:g} tie band: {tie_mismatch}; "
        f"{inf_rows} swept rows with an inf and no NaN objective (NaN and inf projections)")

    # timing at the main path's shape
    m, r, n_stop = SWEEP_SHAPES[0]
    f = torch.as_tensor(sweep_objectives(rng, N_STATES, m), device=device)
    dirs = torch.as_tensor(sweep_directions(rng, N_STATES, r), device=device)
    ideal, nadir = finite_ideal_nadir(f)
    ranks = kernels.nd_peel(f, n_stop).cpu().numpy()
    peel_bytes = 4 * N_STATES * m * 3 + 4 * N_STATES * m
    assoc_bytes = 4 * (N_STATES * m * 3 + N_STATES * r * 3 + 2 * N_STATES * 3) + 12 * N_STATES * m
    assoc_ops = 6 * N_STATES * m * r + 9 * N_STATES * r + 12 * N_STATES * m
    records = []
    for name, source, replaces, kfn, pfn, n_bytes, n_ops, err in (
        (
            "nd_peel",
            "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/nd_peel.cu",
            "moeva2_ijcai22_replication_tpu/attacks/moeva/nds.py:39",
            lambda: kernels.nd_peel(f, n_stop),
            lambda: nd_ranks_plain(f, n_stop),
            peel_bytes,
            nd_peel_ops(ranks, m),
            0.0,
        ),
        (
            "associate",
            "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/associate.cu",
            "moeva2_ijcai22_replication_tpu/attacks/moeva/survival.py:225",
            lambda: kernels.associate(f, dirs, ideal, nadir),
            lambda: associate_plain(f, dirs, ideal, nadir),
            assoc_bytes,
            assoc_ops,
            assoc_err,
        ),
    ):
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rec = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": cuda_ms(kfn),
            "plain_ms": cuda_ms(pfn, launches=5, repeats=3),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        log(f"[kernels] {name} at S={N_STATES} M={m} R={r}: kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        records.append(rec)
    return records


def max_err(got, want, scale=None) -> float:
    """Largest |got - want| (over ``scale`` where given) over the entries
    finite in ``want``; inf where the two differ in which entries are
    finite, or in a non-finite value."""
    import torch

    got, want = got.cpu().double(), want.cpu().double()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin].nan_to_num(), want[~fin].nan_to_num()):
        return math.inf
    d = (got - want).abs()
    if scale is not None:
        d = d / scale.cpu().double()
    d = d[fin]
    return float(d.max()) if d.numel() else 0.0


def check_step_against_cpu(moeva_gpu, moeva_cpu, moeva_ref, x, device):
    """Three generation steps on 8 states, on the card and on the CPU path
    (both float32), fed the same draws, made on the CPU. Each step starts both
    from the CPU's carry and compares the stages in order, on the same inputs:

    - offspring (K5) and the objectives (K1) of the CPU's offspring: each
      device's error against the float64 CPU path (``moeva_ref``) on the same
      inputs, offspring over each gene's range, objectives per component;
      the card's must be at most ``STEP_ERR_RATIO`` times the CPU's;
    - survival of the CPU's merged objectives: ranks (K2), directions,
      nadir, niche and dist (K3), the survivor mask and the normalisation
      state must be bit for bit equal.

    The same three steps run free on each device are reported, not held:
    there the objectives' float32 rounding, which differs between the
    devices, can flip a survival decision."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import (
        _survive_post, _survive_pre, associate_batch, draw_gumbels,
    )

    def to(t, dev, dtype=None):
        if isinstance(t, tuple):
            items = [to(u, dev, dtype) for u in t]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return t.to(dev, dtype if dtype is not None and t.is_floating_point() else t.dtype)

    def survive_stages(moeva, f, state, gum_cut, gum_mem):
        ranks, dirs, nadir, new_state = _survive_pre(f, moeva.asp_points, state, moeva.pop_size)
        niche, dist = associate_batch(f, dirs, new_state.ideal, nadir)
        mask = _survive_post(gum_cut, gum_mem, ranks, niche, dist, dirs.shape[1], moeva.pop_size)
        return dict(ranks=ranks, directions=dirs, nadir=nadir, niche=niche, dist=dist, mask=mask,
                    **{f"state.{k}": v for k, v in new_state._asdict().items()})

    def same_entries(a, b):
        a = a.cpu()
        return (a == b) | (a.isnan() & b.isnan())

    xs = x[:8]
    mc = np.ones(len(xs), dtype=np.int64)
    gen = torch.Generator().manual_seed(3)
    err = {k: [0.0, 0.0] for k in ("offspring", "f1", "f2", "f3")}  # [card, CPU]
    differ = {"offspring": 0, "objectives": 0}  # entries, card != CPU
    with torch.inference_mode():
        run_c, run_g, run_r = (m.prepare(xs, mc) for m in (moeva_cpu, moeva_gpu, moeva_ref))
        span = run_r.xu_gen - run_r.xl_gen
        span = torch.where(span > 0, span, 1.0)[:, None, :]
        gums = draw_gumbels(gen, len(xs), moeva_cpu.n_dirs, moeva_cpu.pop_size)
        carry_c = moeva_cpu.init_carry(run_c, *gums)
        free_g = moeva_gpu.init_carry(run_g, *to(gums, device))
        for step in range(3):
            dr = moeva_cpu.draw_generation(gen, len(xs))
            dr_g = to(dr, device)
            pop_x = carry_c.pop_x
            off_c = moeva_cpu.offspring(run_c, pop_x, dr.offspring)
            off_g = moeva_gpu.offspring(run_g, pop_x.to(device), dr_g.offspring)
            off_r = moeva_ref.offspring(run_r, pop_x.double(), to(dr.offspring, "cpu", torch.float64))
            for i, off in enumerate((off_g, off_c)):
                err["offspring"][i] = max(err["offspring"][i], max_err(off, off_r, span))
            f_c = moeva_cpu._evaluate(run_c, off_c)
            f_g = moeva_gpu._evaluate(run_g, off_c.to(device))
            f_r = moeva_ref._evaluate(run_r, off_c.double())
            differ["offspring"] += int((off_g.cpu() != off_c).sum())
            differ["objectives"] += int((~same_entries(f_g, f_c)).sum())
            for k in range(3):
                for i, f in enumerate((f_g, f_c)):
                    err[f"f{k + 1}"][i] = max(err[f"f{k + 1}"][i], max_err(f[..., k], f_r[..., k]))
            merged = torch.cat([carry_c.pop_f, f_c], dim=1)
            want = survive_stages(moeva_cpu, merged, carry_c.norm_state, dr.gum_cut, dr.gum_mem)
            got = survive_stages(moeva_gpu, merged.to(device), to(carry_c.norm_state, device), dr_g.gum_cut, dr_g.gum_mem)
            for name in want:
                if not bool(same_entries(got[name], want[name]).all()):
                    raise AssertionError(f"step {step}: survival {name} on the card != CPU on the same objectives "
                                         f"(max |difference| {max_err(got[name], want[name]):.3e})")
            carry_c = moeva_cpu.gen_step(run_c, carry_c, dr)
            free_g = moeva_gpu.gen_step(run_g, free_g, dr_g)
    log("[main] engine stages on the same inputs over 3 steps, float32 error against the float64 CPU path "
        "(card, CPU): " + ", ".join(f"{k} {g:.3e} {c:.3e}" for k, (g, c) in err.items())
        + f" (offspring over each gene's range); entries that differ between the devices: offspring "
        f"{differ['offspring']} of {3 * off_c.numel()}, objectives {differ['objectives']} of {3 * f_c.numel()}")
    log("[main] survival of the same objectives, card vs CPU: " + ", ".join(want) + " equal")
    for k, (g, c) in err.items():
        if g > STEP_ERR_RATIO * c:
            raise AssertionError(f"{k} on the card is off the float64 path by {g:.3e}, on the CPU by {c:.3e}")
    rows_equal = (free_g.pop_x.cpu() == carry_c.pop_x).all(-1).float().mean().item()
    log(f"[main] the same 3 steps run free on each device: {rows_equal:.4f} of population rows equal")


def profile_generation(moeva, x):
    """Phase 6: where a generation's time goes at the main path's shape.
    Traces ``PROFILE_GENS`` generation steps with ``torch.profiler`` after 3
    untraced ones and prints the traced ms per generation, the device-busy
    share (summed kernel time over the traced wall time), the kernels ranked
    by device time with their launches per generation, and the device span
    of each ``moeva.*`` stage range of ``gen_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import draw_gumbels

    gen = torch.Generator(device=moeva.device).manual_seed(0)
    with torch.inference_mode():
        run = moeva.prepare(x, np.ones(len(x), dtype=np.int64))
        carry = moeva.init_carry(run, *draw_gumbels(gen, len(x), moeva.n_dirs, moeva.pop_size))
        for _ in range(3):
            carry = moeva.gen_step(run, carry, moeva.draw_generation(gen, len(x)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_GENS):
                with record_function("moeva.draws"):
                    draws = moeva.draw_generation(gen, len(x))
                carry = moeva.gen_step(run, carry, draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and dev(e) > 0]
    # the stage ranges also appear on the device timeline, as spans from
    # their first to their last kernel: keep them out of the kernel list
    kernels = [e for e in on_card if not e.key.startswith("moeva.")]
    busy_us = sum(dev(e) for e in kernels)
    per_gen = lambda us: us / 1e3 / PROFILE_GENS  # noqa: E731
    log(f"[profile] {len(x)} states: {wall / PROFILE_GENS * 1e3:.3f} ms per generation traced, device busy "
        f"{busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms = share {busy_us / 1e6 / wall:.3f}, "
        f"{sum(e.count for e in kernels) / PROFILE_GENS:.1f} launches per generation")
    for e in sorted(kernels, key=dev, reverse=True)[:12]:
        log(f"[profile] {per_gen(dev(e)):9.4f} ms/gen {e.count / PROFILE_GENS:6.1f} launches/gen  {e.key[:100]}")
    for e in sorted((e for e in on_card if e.key.startswith("moeva.")), key=dev, reverse=True):
        log(f"[profile] stage {e.key}: device span {per_gen(dev(e)):.4f} ms/gen (idle gaps included)")


def run_main_path(device, smi: str):
    """Phases 4 to 6."""
    import torch

    from moeva2_ijcai22_replication_tpu_torch import kernels
    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
    from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
    from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

    with tempfile.TemporaryDirectory() as tmp:
        cons, sur, scaler, x = synthetic_lcld_problem(tmp, N_STATES)
    knobs = dict(norm=2, n_gen=N_GEN, n_pop=100, n_offsprings=100, archive_size=24, seed=42)
    moeva = Moeva2(sur, cons, ml_scaler=scaler, device=device, **knobs)
    log(f"[main] Moeva2 on {N_STATES} LCLD states: pop {moeva.pop_size}, "
        f"{moeva.n_offsprings} offspring (M={moeva.pop_size + moeva.n_offsprings}, "
        f"R={moeva.n_dirs}), archive 24, {N_GEN} generations")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    moeva.generate(x, minimize_class=1)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    log(f"[main] launches on the main path: {launches}")
    log(f"[main] generate: cold {cold_s:.3f} s, steady {steady_s:.3f} s for {N_STATES} states "
        f"x {N_GEN} generations on {smi}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    p = moeva.pop_size + 24
    if res.x_ml.shape != (N_STATES, p, cons.schema.n_features):
        raise AssertionError(f"x_ml has shape {res.x_ml.shape}")
    if not np.isfinite(res.x_ml).all():
        raise AssertionError("non-finite values in x_ml")
    # an objective may legitimately be inf or NaN (a ratio constraint whose
    # denominator a mutation drove to 0); count them, as the reference does
    nonfinite = int((~np.isfinite(res.f)).any(-1).sum())
    log(f"[main] candidates with a non-finite objective: {nonfinite} of {res.f.shape[0] * res.f.shape[1]}")
    frozen = ~cons.schema.mutable
    if not np.array_equal(res.x_ml[:, :, frozen], np.broadcast_to(x[:, None, frozen].astype(np.float32), res.x_ml[:, :, frozen].shape)):
        raise AssertionError("immutable features moved")
    moved = float((res.x_ml != x[:, None, :].astype(np.float32)).any(-1).mean())
    log(f"[main] x_ml {res.x_ml.shape}, finite, immutables unchanged, {moved:.3f} of candidates moved")

    moeva_cpu = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", **knobs)
    moeva_ref = Moeva2(sur, cons, ml_scaler=scaler, device="cpu", dtype=torch.float64, **knobs)
    check_step_against_cpu(moeva, moeva_cpu, moeva_ref, x, device)

    # the thresholds of the lcld_synth config in
    # tests/fixtures/oracle_interior_rates.json. The surrogate is seeded and
    # untrained, so the rates show that the judgement runs on the result,
    # not how well the attack works
    calc = ObjectiveCalculator(
        classifier=sur, constraints=cons, thresholds={"f1": 0.5, "f2": 0.5},
        min_max_scaler=scaler, minimize_class=1, norm=2, ml_scaler=scaler,
    )
    rates = calc.success_rate_3d(x, res.x_ml)
    if rates.shape != (7,) or not np.isfinite(rates).all():
        raise AssertionError(f"bad success rates {rates}")
    log("[main] success rates o1..o7 (plumbing check, not an attack result): " + " ".join(f"{v:.4f}" for v in rates))
    profile_generation(moeva, x)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from moeva2_ijcai22_replication_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, card: {smi}")

    t0 = time.perf_counter()
    info = build.build()
    build.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s ({info.path.name})")
    for line in info.log.splitlines():
        if "registers" in line or "==" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    records = check_kernels(device)
    launches = run_main_path(device, smi)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if not all(math.isfinite(rec[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing in {rec}")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Convergence-quality samples of a MoEvA run (port of the parts of
``observability/quality.py`` that ``MoevaResult.quality`` needs).

The engine computes per-state statistics at every gate
(``attacks.objective.QUALITY_STAT_COLUMNS``); this module turns them into
samples (:func:`sample_from_per_state`), merges the samples of sequential
state chunks (:func:`merge_chunk_quality`) and drops pad rows
(:func:`trim_quality`). Samples keep full float precision. The exported
``telemetry.quality`` block (``quality_block``) comes with ROADMAP A14.
"""

from __future__ import annotations

import numpy as np


def sample_from_per_state(gen: int, per_state, **extra) -> dict:
    """One sample from a (S, 9) per-state stats array: the o1..o7 rates
    (fraction of states holding at least one qualifying candidate), the
    best and mean summed violation and the best distance, over the states
    with stats (NaN rows have none yet), and the array itself under
    ``per_state`` (a copy) for chunk merging."""
    ps = np.array(per_state, np.float64)
    known = ~np.isnan(ps[:, 0])
    kp = ps[known] if known.any() else np.zeros((0, ps.shape[1]))
    bd = kp[:, 8] if len(kp) else np.zeros(0)
    finite = np.isfinite(bd)

    def _f(v):
        return float(v) if len(kp) else None

    return {
        "gen": int(gen),
        "o_rates": [_f(v) for v in kp[:, :7].mean(axis=0)] if len(kp) else [None] * 7,
        "success_frac": _f(kp[:, 6].mean()) if len(kp) else None,
        "best_cv": _f(kp[:, 7].min()) if len(kp) else None,
        "mean_cv": _f(kp[:, 7].mean()) if len(kp) else None,
        "best_dist": float(bd[finite].min()) if finite.any() else None,
        "mean_best_dist": float(bd[finite].mean()) if finite.any() else None,
        "states_known": int(known.sum()),
        "per_state": ps,
        **extra,
    }


def merge_chunk_quality(parts: list, n_reals: list) -> dict | None:
    """One history over the whole states axis from the histories of
    sequential state chunks of one attack: per gate, the chunks' per-state
    rows (trimmed to each chunk's real rows) are concatenated and the
    aggregates recomputed. A chunk that exited early stops sampling; its
    last stats carry forward (all its states are solved)."""
    if not parts or parts[0] is None:
        return None
    per_chunk: list = []
    finals: list = []
    gens: set = set()
    for part, n_real in zip(parts, n_reals):
        by_gen: dict = {}
        final = None
        for s in part["samples"]:
            ps = np.asarray(s["per_state"])[:n_real]
            if s.get("final"):
                final = ps
            else:
                by_gen[s["gen"]] = ps
                gens.add(s["gen"])
        per_chunk.append(by_gen)
        finals.append(final)
    samples = []
    last: list = [None] * len(per_chunk)
    for g in sorted(gens):
        rows = []
        for i, by_gen in enumerate(per_chunk):
            ps = by_gen.get(g)
            if ps is None:  # an early-exited chunk: carry its last stats
                ps = last[i] if last[i] is not None else finals[i]
            else:
                last[i] = ps
            if ps is not None:
                rows.append(ps)
        if rows:
            samples.append(sample_from_per_state(g, np.concatenate(rows, axis=0)))
    if all(f is not None for f in finals):
        gen_final = max(p["samples"][-1]["gen"] for p in parts)
        samples.append(sample_from_per_state(gen_final, np.concatenate(finals, axis=0), final=True))
    # the header (cadence, thresholds, judged) is chunk 0's: the chunks run
    # one attack's config
    return dict(parts[0], samples=samples)


def trim_quality(quality: dict | None, n_real: int) -> dict | None:
    """``quality`` with every sample's per-state rows cut to the first
    ``n_real`` and the aggregates recomputed (pad rows duplicate real ones
    and would count a state twice)."""
    if quality is None:
        return None
    out = dict(quality)
    out["samples"] = [
        sample_from_per_state(
            s["gen"], np.asarray(s["per_state"])[:n_real], **{k: s[k] for k in ("final",) if k in s}
        )
        for s in quality["samples"]
    ]
    return out

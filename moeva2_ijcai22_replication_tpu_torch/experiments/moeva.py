"""MoEvA2 experiment runner: a config in, ``metrics_moeva_{hash}.json`` out.

Port of ``experiments/moeva.py::run``, in its order: skip when the config's
hash already has metrics, set up (constraints, candidates, scaler,
surrogate), ``check_constraints_error`` on the candidates, the timed
``Moeva2.generate``, the populations written to ``x_attacks_*.npy`` before
the evaluation, the success rates per ε (the objectives evaluated once and
re-thresholded per ε), the event stream, the config snapshot and the
metrics JSON last, so that "metrics exists" implies its siblings exist.
With ``save_history`` ("reduced" or "full") the engine records every
evaluation, in segments of ``history_chunk`` generations, and the runner
writes the generation steps' records as ``x_history_{attack}_{hash}.npy``,
(n_gen - 1, S, n_offsprings, C), beside the populations. On the card the
attack runs the MoEvA kernels (K5, K1 or K8, K2, K4a, K3, K4b, at the gates
of an early exit K6, and under "full" the history instantiations of K1 or
K8).

``device`` and ``dtype`` are arguments, never config keys: the config hash
stays the JAX package's. The metrics carry the JAX runner's top-level keys
except ``telemetry`` (the tracing layer, ROADMAP A14). Knobs that the port
does not run yet raise ``NotImplementedError`` before any device work:
``system.trace_log`` and ``system.profile_dir`` (A14), and a device mesh. The engine's extras are
set per point as the JAX runner sets them: the early exit
(``early_stop_check_every``, ``early_stop_threshold`` defaulting to
``misclassification_threshold``, ``early_stop_eps``,
``compaction_buckets``), ``record_quality`` (default on) and
``quality_every``, ``checkpoint_every`` with the checkpoint at
``{results}/checkpoint_{attack}_{hash}.npz``; ``init``, ``init_eps`` and
``init_ratio`` build the engine. ``execution`` records the early exit's
knob and the generation steps run. ``reconstruction: true`` strips the
augmented columns of the populations and re-derives them from the attacked
base features (:func:`common.reconstruct`). ``assoc_block`` is accepted:
the JAX package's blocked association is bit-identical to the one-shot
form, which kernel K3 runs.
The JAX package's compilation-cache and telemetry switches
(``system.jax_cache_dir``, ``aot_cache``, ``cost_ledger``,
``mesh_telemetry``, ``gap_telemetry``) have nothing to switch in the port.

Grid scale (the JAX runner's): the engine comes from ``common.ENGINES``,
keyed by its static config, so the points of a grid that differ only in
seed or budget share it (:func:`_cached_engine`); with a grid's
``pipeline`` the run splits into the attack, on the calling thread, and a
``finalize`` closure (save, evaluate per ε, stream, metrics last) that the
grid's background writer runs while the card attacks the next point.

Run one config from the command line (``-c`` file, ``-j`` inline JSON,
``-p`` dotted overrides; ``--device`` and ``--dtype``, default ``cuda`` and
``float32``)::

    python3 -m moeva2_ijcai22_replication_tpu_torch.experiments.moeva -j '<json>' [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..attacks.moeva import Moeva2
from ..attacks.objective import ObjectiveCalculator
from ..utils.config import get_dict_hash, parse_run_args, save_config
from ..utils.in_out import json_to_file, save_to_file
from ..utils.observability import PhaseTimer
from ..utils.streaming import stream_for
from . import common


def _cached_engine(config, surrogate, constraints, scaler, device, dtype) -> Moeva2:
    """The engine shared by the grid points with the same static config,
    under the JAX runner's key fields (``_cached_engine``) and the engine's
    device and dtype. ``n_gen``, ``seed``, ``history_chunk`` and the early
    exit's, quality's and checkpoint's knobs only steer the host loop of
    ``generate``, which seeds its generator from ``seed`` on every call:
    they are set per point, not keyed."""
    fields = (
        "engine", "surrogate", "constraints", "scaler", "norm", "n_pop",
        "n_offsprings", "init", "init_eps", "init_ratio", "archive_size",
        "assoc_block", "max_states_per_call", "save_history", "mesh_devices",
        "device", "dtype",
    )
    key = (
        "moeva",
        id(surrogate),
        id(constraints),
        id(scaler),
        str(config["norm"]),
        config["n_pop"],
        config["n_offsprings"],
        config.get("init", "tile"),
        config.get("init_eps", 0.1),
        config.get("init_ratio", 0.5),
        config.get("archive_size", 0),
        config.get("assoc_block") or None,
        config.get("max_states_per_call") or None,
        config.get("save_history") or None,
        int(config.get("system", {}).get("mesh_devices", 0) or 0),
        str(device),
        str(dtype),
    )

    def build():
        return Moeva2(
            classifier=surrogate,
            constraints=constraints,
            ml_scaler=scaler,
            norm=config["norm"],
            n_gen=config["budget"],
            n_pop=config["n_pop"],
            n_offsprings=config["n_offsprings"],
            seed=config["seed"],
            init=config.get("init", "tile"),
            init_eps=config.get("init_eps", 0.1),
            init_ratio=config.get("init_ratio", 0.5),
            archive_size=config.get("archive_size", 0),
            max_states_per_call=config.get("max_states_per_call") or None,
            save_history=config.get("save_history") or None,
            dtype=dtype,
            device=device,
        )

    return common.ENGINES.get(key, build, fields=fields)


def run(config: dict, pipeline=None, device="cuda", dtype=torch.float32):
    """Run one MoEvA2 experiment; the metrics dict, or None when the config
    hash already has results, or when ``pipeline`` (a grid's
    :class:`.pipeline.GridPipeline`) is given: the evaluation and the
    writes then run on the grid's background writer, which the grid drains
    before it returns."""
    common.refuse_knobs(config, {})
    device = resolve_device(device)
    out_dir = config["dirs"]["results"]
    config_hash = get_dict_hash(config)
    mid_fix = f"{config['attack_name']}"
    metrics_path = common.metrics_path_for(config, mid_fix)
    if common.should_skip(config, mid_fix, pipeline):
        if pipeline is not None:
            pipeline.point(mid_fix, config_hash, None, skipped=True)
        return None

    os.makedirs(out_dir, exist_ok=True)
    print(config)
    timer = PhaseTimer()

    with timer.phase("setup"):
        constraints = common.load_constraints(config)
        x_initial_states = common.load_candidates(config)
        scaler = common.load_scaler(config)
        surrogate = common.load_surrogate(config)
        constraints.check_constraints_error(x_initial_states)
        moeva = _cached_engine(config, surrogate, constraints, scaler, device, dtype)
        # the point's own knobs on the cached engine, each set at every
        # point: a grid's earlier point may have set them otherwise
        moeva.n_gen = config["budget"]
        moeva.seed = config["seed"]
        moeva.early_stop_check_every = int(config.get("early_stop_check_every", 0) or 0)
        moeva.early_stop_threshold = float(
            config.get("early_stop_threshold", config.get("misclassification_threshold", 0.5))
        )
        moeva.early_stop_eps = float(config.get("early_stop_eps", np.inf))
        buckets = config.get("compaction_buckets")
        moeva.compaction_buckets = tuple(buckets) if buckets else None
        moeva.history_chunk = int(config.get("history_chunk", 50))
        moeva.record_quality = bool(config.get("record_quality", True))
        moeva.quality_every = int(config.get("quality_every", 0) or 0)
        # a rerun of this config hash resumes mid-attack from the last
        # checkpoint (the hash skip covers completed runs only)
        moeva.checkpoint_every = int(config.get("checkpoint_every", 0) or 0)
        moeva.checkpoint_path = f"{out_dir}/checkpoint_{mid_fix}_{config_hash}.npz"

    start_time = time.time()
    with timer.attack():
        result = moeva.generate(x_initial_states, 1)
    consumed_time = time.time() - start_time
    # host arrays only from here: generate returned numpy after the device
    # finished, so the writer thread never touches the card
    x_attacks = result.x_ml
    if config.get("reconstruction"):
        x_attacks = common.reconstruct(x_attacks, constraints)
    execution = {
        "max_states_per_call": moeva.max_states_per_call,
        "mesh": None,
        "early_stop_check_every": moeva.early_stop_check_every,
        "gens_executed": int(result.gens_executed),
    }

    def finalize():
        with timer.phase("write"):
            save_to_file(x_attacks, f"{out_dir}/x_attacks_{mid_fix}_{config_hash}.npy")
            if config.get("save_history") and len(result.history) > 1:
                # (n_gen - 1, S, n_offsprings, C): the generation steps'
                # records, the JAX runner's file
                np.save(f"{out_dir}/x_history_{mid_fix}_{config_hash}.npy", np.stack(result.history[1:]))

        with timer.phase("evaluate"):
            calc = ObjectiveCalculator(
                classifier=surrogate,
                constraints=common.evaluation_constraints(config, constraints),
                thresholds={"f1": config["misclassification_threshold"], "f2": 0.0},
                min_max_scaler=scaler,
                ml_scaler=scaler,
                minimize_class=1,
                norm=config["norm"],
            )
            # [cv, f1, f2] does not depend on ε: evaluate once, threshold per ε
            vals = calc.objectives(x_initial_states, x_attacks)
            objective_lists = []
            for eps in config["eps_list"]:
                calc.thresholds = {"f1": config["misclassification_threshold"], "f2": eps}
                objective_lists.append(calc.success_rate_3d_record(x_initial_states, x_attacks, vals))

        with timer.phase("write"):
            with stream_for(config, mid_fix, config_hash) as stream:
                stream.log_parameters(config)
                stream.log_metric("time", consumed_time)
                for eps, objectives in zip(config["eps_list"], objective_lists):
                    for k, v in objectives.items():
                        stream.log_metric(f"eps{eps}_{k}", v)

        # assembled after the write phase, so that 'timings' holds its spans;
        # the metrics JSON still lands last
        metrics = {
            "objectives_list": objective_lists,
            "time": consumed_time,
            # the attack's span includes building or loading the kernel
            # library when this call was the process's first
            "includes_compile": "attack_compile" in timer.spans,
            "execution": execution,
            "timings": timer.spans,
            "counters": timer.counters,
            "config": config,
            "config_hash": config_hash,
        }
        save_config(config, f"{out_dir}/config_{mid_fix}_")
        json_to_file(metrics, metrics_path)
        return metrics

    if pipeline is not None:
        pipeline.point(mid_fix, config_hash, timer)
        pipeline.submit(mid_fix, metrics_path, finalize)
        return None
    return finalize()


if __name__ == "__main__":
    _config, _args = parse_run_args()
    run(_config, **_args)

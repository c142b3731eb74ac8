"""Constrained PGD, AutoPGD and SAT experiment runner: a config in,
``metrics_{attack}_{loss}_{hash}.json`` out.

Port of ``experiments/pgd.py::run``, in its order: the ``mid_fix``
``{attack_name}_{loss_evaluation}``, skip when the config's hash already has
metrics, set up and ``check_constraints_error``, then, timed: half ε when a
SAT pass follows (``flip+sat``), ε − 1e-6, labels from the surrogate, the
engine's ``generate`` in the scaler's space, the inverse scaling,
:func:`round_ints_toward_initial` and, with SAT, the MILP repair
(``attacks.sat.SatAttack``, hot-started from the PGD output, on the host);
then the success rates, ``x_attacks_*.npy``, the loss history
(``x_history_{hash}.npy``, with ``save_history``), the event stream, the
success-rate CSV, the config snapshot and the metrics JSON last.

A loss containing ``autopgd`` selects :class:`AutoPGD` (one random start
unless ``nb_random`` says otherwise, first step ``per_attack_eps / 3`` from
the un-shifted ε; the AutoPGD instantiation of K7 on LCLD and of K7b on
botnet and augmented botnet), any other loss :class:`ConstrainedPGD` (step
0.1; K7 on LCLD, K7b on botnet and augmented botnet): one launch per run on
the card, where a set with no PGD kernel is refused. On the augmented
botnet domain a ``+repair`` loss raises JAX's ``NotImplementedError``
before the attack runs (the set has no repair).

``device`` and ``dtype`` are arguments, never config keys: the config hash
stays the JAX package's. The metrics carry the JAX runner's top-level keys
except ``telemetry`` (the tracing layer, ROADMAP A14). Refused before any
device work, each with a ``NotImplementedError``: ``system.trace_log`` and
``system.profile_dir`` (A14) and a device mesh. ``reconstruction: true``
re-derives the augmented columns of the attacked rows after the rounding
and the MILP repair, before the attack's time is taken
(:func:`common.reconstruct`).

Grid scale (the JAX runner's): the engine comes from ``common.ENGINES``,
keyed by its static config, so an ε sweep at one loss shares it, and a
budget sweep too unless the engine is AutoPGD or records a history
(:func:`_cached_attack`); with a grid's ``pipeline`` the run splits into
the attack (with the MILP repair), on the calling thread, and a
``finalize`` closure (evaluate, save, stream, CSV, metrics last) that the
grid's background writer runs while the card attacks the next point.

Run one config from the command line (``-c`` file, ``-j`` inline JSON,
``-p`` dotted overrides; ``--device`` and ``--dtype``, default ``cuda`` and
``float32``)::

    python3 -m moeva2_ijcai22_replication_tpu_torch.experiments.pgd -j '<json>' [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..attacks.objective import ObjectiveCalculator, write_success_rate_csv
from ..attacks.pgd import AutoPGD, ConstrainedPGD, round_ints_toward_initial
from ..attacks.sat import SatAttack
from ..models.io import Surrogate
from ..models.mlp import mlp_proba_plain
from ..models.train import stack_tensors
from ..utils.config import get_dict_hash, parse_run_args, save_config
from ..utils.in_out import json_to_file
from ..utils.observability import PhaseTimer
from ..utils.streaming import stream_for
from . import common


def surrogate_labels(surrogate: Surrogate, x_scaled: np.ndarray, device, dtype) -> np.ndarray:
    """The surrogate's own classes of the scaled rows (the first largest
    probability), on ``device`` in ``dtype``: ART's labels when none are
    given, as the reference's label-free ``generate(x)`` takes them.
    Kernel K16 on the card (float32), ``predict_plain``'s semantics
    (``attacks.pgd.engine``); on the CPU that plain version."""
    widths, params, layers = stack_tensors(surrogate.model, dtype, device)
    with torch.inference_mode():
        x = torch.as_tensor(x_scaled, dtype=dtype, device=device)
        if x.is_cuda:
            from ..kernels import forward_labels

            return forward_labels(x, params, widths).cpu().numpy()
        return torch.argmax(mlp_proba_plain(layers, x), dim=-1).numpy()


def _cached_attack(config, surrogate, constraints, scaler, device, dtype) -> ConstrainedPGD:
    """The engine shared by the grid points with the same static config,
    under the JAX runner's key fields (``_cached_attack``, the engine's
    class first) and the engine's device and dtype. ε and the step are
    arguments of ``generate``, and ``seed`` seeds the random starts'
    generator on every call, so neither is keyed; the budget is, as in JAX,
    where the engine is AutoPGD (its checkpoint tables are the budget's) or
    records a loss history."""
    cls = AutoPGD if "autopgd" in config["loss_evaluation"] else ConstrainedPGD
    num_random_init = config.get("nb_random", 1 if cls is AutoPGD else 0)
    record_loss = config.get("save_history") or None
    fields = (
        "engine", "surrogate", "constraints", "scaler", "budget", "norm",
        "loss_evaluation", "constraints_optim", "num_random_init",
        "record_loss", "record_grad_norm", "mesh_devices", "device", "dtype",
    )
    key = (
        cls.__name__,
        id(surrogate),
        id(constraints),
        id(scaler),
        int(config["budget"]) if cls is AutoPGD or record_loss else None,
        str(config["norm"]),
        config["loss_evaluation"],
        config.get("constraints_optim", "sum"),
        num_random_init,
        record_loss,
        bool(config.get("save_grad_norm")),
        int(config.get("system", {}).get("mesh_devices", 0) or 0),
        str(device),
        str(dtype),
    )

    def build():
        return cls(
            classifier=surrogate,
            constraints=constraints,
            scaler=scaler,
            max_iter=int(config["budget"]),
            norm=config["norm"],
            loss_evaluation=config["loss_evaluation"],
            constraints_optim=config.get("constraints_optim", "sum"),
            num_random_init=num_random_init,
            record_loss=record_loss,
            record_grad_norm=bool(config.get("save_grad_norm")),
            seed=config["seed"],
            dtype=dtype,
            device=device,
        )

    return common.ENGINES.get(key, build, fields=fields)


def run(config: dict, pipeline=None, device="cuda", dtype=torch.float32):
    """Run one gradient-attack experiment; the metrics dict, or None when
    the config hash already has results, or when ``pipeline`` (a grid's
    :class:`.pipeline.GridPipeline`) is given: the evaluation and the
    writes then run on the grid's background writer, which the grid drains
    before it returns."""
    common.refuse_knobs(config, {})
    device = resolve_device(device)
    out_dir = config["dirs"]["results"]
    config_hash = get_dict_hash(config)
    mid_fix = f"{config['attack_name']}_{config['loss_evaluation']}"
    metrics_path = common.metrics_path_for(config, mid_fix)
    if common.should_skip(config, mid_fix, pipeline):
        if pipeline is not None:
            pipeline.point(mid_fix, config_hash, None, skipped=True)
        return None

    os.makedirs(out_dir, exist_ok=True)
    print(config)
    timer = PhaseTimer()
    apply_sat = "sat" in config["loss_evaluation"]

    with timer.phase("setup"):
        constraints = common.load_constraints(config)
        if "repair" in config["loss_evaluation"] and constraints.repair_undefined:
            # the engine raises it too; here before the labels' launch
            raise NotImplementedError(constraints.repair_undefined)
        x_initial = common.load_candidates(config)
        scaler = common.load_scaler(config)
        surrogate = common.load_surrogate(config)
        constraints.check_constraints_error(x_initial)
        attack = _cached_attack(config, surrogate, constraints, scaler, device, dtype)
        attack.seed = config["seed"]

    start_time = time.time()
    # only half ε when SAT runs after (01_pgd_united.py:97)
    per_attack_eps = config["eps"] / 2 if apply_sat else config["eps"]
    eps_run = per_attack_eps - 0.000001
    # AutoPGD's first step (01_pgd_united.py:99-111); PGD's is fixed
    eps_step_run = per_attack_eps / 3 if isinstance(attack, AutoPGD) else 0.1

    with timer.attack():
        x_scaled = scaler.transform(np.asarray(x_initial))
        y = surrogate_labels(surrogate, x_scaled, device, dtype)
        x_adv_scaled = attack.generate(x_scaled, y, eps=eps_run, eps_step=eps_step_run, max_iter=int(config["budget"]))
        # the run's own outputs, taken now: a cached engine attacks the next
        # point while the writer still finalizes this one
        loss_history = attack.loss_history
        hist_names = attack.hist_column_names()
        x_attacks = np.asarray(scaler.inverse(x_adv_scaled))
        # directional integer rounding (01_pgd_united.py:130-137)
        x_attacks = round_ints_toward_initial(x_attacks, x_initial, constraints.get_feature_type())
        if apply_sat:
            sat = SatAttack(
                constraints,
                common.get_sat_builder(config["project_name"], constraints),
                scaler,
                per_attack_eps,
                np.inf,
                n_sample=1,
                n_jobs=config.get("system", {}).get("n_jobs", 1),
                refine_rounds=int(config.get("sat_refine_rounds", 2)),
            )
            x_attacks = sat.generate(x_initial, x_attacks)[:, 0, :]
    if config.get("reconstruction"):
        x_attacks = common.reconstruct(x_attacks, constraints)
    consumed_time = time.time() - start_time

    if x_attacks.ndim == 2:
        x_attacks = x_attacks[:, np.newaxis, :]

    def finalize():
        with timer.phase("evaluate"):
            calc = ObjectiveCalculator(
                classifier=surrogate,
                constraints=common.evaluation_constraints(config, constraints),
                thresholds={"f1": config["misclassification_threshold"], "f2": config["eps"]},
                min_max_scaler=scaler,
                ml_scaler=scaler,
                minimize_class=1,
                norm=config["norm"],
            )
            objectives = calc.success_rate_3d_record(x_initial, x_attacks)
        print(objectives)

        with timer.phase("write"):
            np.save(f"{out_dir}/x_attacks_{mid_fix}_{config_hash}.npy", x_attacks)
            if config.get("save_history") and loss_history is not None:
                # (N, max_iter, 1, C) loss-component curves (01_pgd_united.py:196-199)
                np.save(f"{out_dir}/x_history_{config_hash}.npy", loss_history[:, :, np.newaxis, :])
            with stream_for(config, mid_fix, config_hash) as stream:
                stream.log_parameters(config)
                stream.log_metric("time", consumed_time)
                for k, v in objectives.items():
                    stream.log_metric(k, v)
                if loss_history is not None:
                    mean_curves = loss_history.mean(axis=0)  # (max_iter, C)
                    scalar = {"loss", "loss_class", "cons_sum", "grad_norm"}
                    for j, name in enumerate(hist_names):
                        if name in scalar:  # not the per-constraint g1..gK columns
                            stream.log_series(f"mean_{name}", mean_curves[:, j])
            write_success_rate_csv(objectives, f"{out_dir}/success_rate_{mid_fix}_{config_hash}.csv")

        # assembled after the write phase, so that 'timings' holds its span;
        # the metrics JSON still lands last
        metrics = {
            "objectives": objectives,
            "time": consumed_time,
            # the attack's span includes building or loading the kernel
            # library when this call was the process's first
            "includes_compile": "attack_compile" in timer.spans,
            "execution": {"max_states_per_call": None, "mesh": None},  # PGD runs one batch
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

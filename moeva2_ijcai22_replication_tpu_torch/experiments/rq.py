"""Research-question grid runner: a grid file in, one experiment per point.

Port of ``experiments/rq.py``: the loops over seeds x projects x budgets x
(``scenari`` | ``models`` | one empty point), then MoEvA over the whole
``eps_list`` and PGD per ε x loss, each point's config composed as
{``config_dir``/attack yaml} <- {``config_dir``/project static yaml} <-
the point's overrides (:func:`_compose`).

Launch modes, as in the JAX package: in process (the default: the runners
are called directly, and a failed point is logged as "grid point failed"
and the sweep goes on), or ``use_subprocess=True``, one
``python -m moeva2_ijcai22_replication_tpu_torch.experiments.<attack> -j
<config>`` per point with the device and dtype as command-line arguments
of the runner, never config keys. In process, a grid runs through a
:class:`.pipeline.GridPipeline` unless it sets ``pipeline: false``:
artifacts and engines are shared across points (``common.ARTIFACTS``,
``common.ENGINES``), and each point's judgement and writes run on a
background writer while the card attacks the next point; the writer is
drained before :meth:`GridRunner.run` returns, and
``grid_report_{hash}.json`` lands beside the points' results.

The device is resolved when the runner is built, before any point: a grid
asked to run on a missing card raises once instead of logging a failure per
point. A grid config that sets ``system.trace_log`` (the JAX grid's shared
recorder) is refused by name there too (ROADMAP A14).

Run a grid file (``-c``; ``--device`` and ``--dtype``, default ``cuda`` and
``float32``)::

    python3 -m moeva2_ijcai22_replication_tpu_torch.experiments.rq -c config/rq1.lcld.yaml
"""

from __future__ import annotations

import copy
import json
import logging
import os
import subprocess
import sys

import torch

from .. import resolve_device
from ..utils.config import load_config_file, merge_config, parse_run_args
from . import common

TABULATOR = ">>>"
logger = logging.getLogger(__name__)
#: the runners' package, for the subprocess launches' ``-m``
RUNNERS = "moeva2_ijcai22_replication_tpu_torch.experiments"


def _compose(config_dir: str, base_name: str, project: str, overrides: list[dict]) -> dict:
    """Layered config: {base attack yaml} <- {project static yaml} <- overrides
    (the reference's ``-c attack.yaml -c project.yaml -p/-j ...`` stack)."""
    cfg: dict = {}
    merge_config(cfg, load_config_file(os.path.join(config_dir, f"{base_name}.yaml")))
    merge_config(cfg, load_config_file(os.path.join(config_dir, f"{project}.yaml")))
    for o in overrides:
        merge_config(cfg, copy.deepcopy(o))
    return cfg


class GridRunner:
    """Expand the grid and launch one experiment per point."""

    def __init__(self, config: dict, use_subprocess: bool = False, device="cuda", dtype=torch.float32):
        common.refuse_knobs(config, {})
        self.device = resolve_device(device)
        self.dtype = dtype
        self.config = config
        self.use_subprocess = use_subprocess
        self.launch_counter = 0
        self.pipeline = None
        if not use_subprocess and config.get("pipeline", True):
            from .pipeline import GridPipeline

            self.pipeline = GridPipeline()
        self._out_dirs: list[str] = []
        self.report: dict | None = None

    # -- launching ----------------------------------------------------------
    def _launch(self, module: str, cfg: dict) -> None:
        self.launch_counter += 1
        out_dir = cfg.get("dirs", {}).get("results")
        if out_dir and out_dir not in self._out_dirs:
            self._out_dirs.append(out_dir)
        if self.use_subprocess:
            blob = json.dumps(cfg, separators=(",", ":"))
            script = [sys.executable, "-m", module, "-j", blob, "--device", str(self.device),
                      "--dtype", str(self.dtype).removeprefix("torch.")]
            logger.info(script)
            # the child imports this same package, whatever its working directory
            root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
            proc = subprocess.run(script, env={**os.environ, "PYTHONPATH": path})
            if proc.returncode != 0:
                logger.error("grid point failed (rc=%d): %s", proc.returncode, script)
            return
        logger.info("in-process %s %s", module, cfg.get("attack_name"))
        if module.endswith(".moeva"):
            from . import moeva as runner
        else:
            from . import pgd as runner
        # one bad grid point is logged and the sweep goes on, as a failed
        # subprocess is
        try:
            runner.run(cfg, pipeline=self.pipeline, device=self.device, dtype=self.dtype)
        except Exception:
            logger.exception("grid point failed in-process: %s", module)

    def _launch_moeva(self, project: str, overrides: list[dict]) -> None:
        cfg = _compose(self.config["config_dir"], "moeva", project,
                       overrides + [{"eps_list": self.config["eps_list"]}])
        self._launch(f"{RUNNERS}.moeva", cfg)

    def _launch_pgd(self, project: str, overrides: list[dict]) -> None:
        for eps in self.config["eps_list"]:
            logger.info(f"{TABULATOR * 5} Running eps {eps} ...")
            for loss_evaluation in self.config["loss_evaluations"]:
                logger.info(f"{TABULATOR * 6} Running loss_evaluation {loss_evaluation} ...")
                cfg = _compose(self.config["config_dir"], "pgd", project,
                               overrides + [{"eps": eps, "loss_evaluation": loss_evaluation}])
                self._launch(f"{RUNNERS}.pgd", cfg)

    # -- grid ---------------------------------------------------------------
    def _extra_axis(self) -> list[list[dict]]:
        """RQ2's scenari (config fragments) or RQ3's models (model paths);
        RQ1 has the one empty point."""
        if "scenari" in self.config:
            return [[scenario] for scenario in self.config["scenari"]]
        if "models" in self.config:
            return [[{"paths": {"model": model}}] for model in self.config["models"]]
        return [[]]

    def run(self) -> int:
        config = self.config
        try:
            for seed in config["seeds"]:
                logger.info(f"{TABULATOR} Running seed {seed} ...")
                for project in config["projects"]:
                    logger.info(f"{TABULATOR * 2} Running project {project} ...")
                    for budget in config["budgets"]:
                        logger.info(f"{TABULATOR * 3} Running budget {budget} ...")
                        for extra in self._extra_axis():
                            overrides = [{"seed": seed, "budget": budget}] + extra
                            if "moeva" in config["attacks"]:
                                logger.info(f"{TABULATOR * 4} Running MoEvA ...")
                                self._launch_moeva(project, overrides)
                            if "pgd" in config["attacks"]:
                                logger.info(f"{TABULATOR * 4} Running pgd ...")
                                self._launch_pgd(project, overrides)
        finally:
            if self.pipeline is not None:
                # every queued point lands on disk before the grid returns
                self.report = self.pipeline.finish(config, self._out_dirs)
                logger.info(
                    "grid report: %d points (%d launched), %d library loads, compile %.1fs / run %.1fs, "
                    "artifact cache %s, engine cache %s -> %s",
                    self.report["points_total"], self.report["points_launched"], self.report["library_loads"],
                    self.report["attack_compile_s"], self.report["attack_run_s"], self.report["artifact_cache"],
                    self.report["engine_cache"], self.report.get("report_path", "<unwritten>"),
                )
        return self.launch_counter


def run(config: dict, use_subprocess: bool = False, device="cuda", dtype=torch.float32) -> int:
    runner = GridRunner(config, use_subprocess=use_subprocess, device=device, dtype=dtype)
    n = runner.run()
    logger.info(f"{n} run executed.")
    return n


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    _config, _args = parse_run_args()
    run(_config, **_args)

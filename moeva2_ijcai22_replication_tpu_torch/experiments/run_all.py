"""The full experiment suite: RQ1-RQ4 and SM1 (parity: ``run_all.sh``).

Port of ``experiments/run_all.py``: the same grid files in the same order,
rq4's two configs through the MoEvA runner, and one closing line with the
process's artifact- and engine-cache counters (the grids share both
caches). Every run skips a config hash that already has results, so
running the suite again after a crash goes on where it stopped.

rq4's configs name a Keras model and candidates that the repo does not
hold: their runs fail on the missing files, named, as the JAX package's
do, and that failure ends the suite before the SM1 grids, as it does there.

Usage (``--device``, default ``cuda``)::

    python3 -m moeva2_ijcai22_replication_tpu_torch.experiments.run_all [config_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..utils.config import load_config_file
from . import common, moeva, rq

logger = logging.getLogger(__name__)

RQ_GRIDS = [
    "rq1.lcld.yaml",
    "rq1.botnet.yaml",
    "rq2.lcld.yaml",
    "rq2.botnet.yaml",
    "rq3.lcld.yaml",
    "rq3.botnet.yaml",
]
RQ4_CONFIGS = ["rq4.lcld.moeva.yaml", "rq4.lcld.moeva_augmented.yaml"]
SM1_GRIDS = [
    "sm1.1.lcld.yaml",
    "sm1.2.lcld.yaml",
    "sm1.1.botnet.yaml",
    "sm1.2.botnet.yaml",
]


def run(config_dir: str = "./config", device="cuda", dtype=torch.float32) -> None:
    for grid in RQ_GRIDS:
        logger.info("=== grid %s", grid)
        rq.run(load_config_file(f"{config_dir}/{grid}"), device=device, dtype=dtype)
    for cfg in RQ4_CONFIGS:
        logger.info("=== rq4 %s", cfg)
        moeva.run(load_config_file(f"{config_dir}/{cfg}"), device=device, dtype=dtype)
    for grid in SM1_GRIDS:
        logger.info("=== grid %s", grid)
        rq.run(load_config_file(f"{config_dir}/{grid}"), device=device, dtype=dtype)
    logger.info("suite caches: artifacts %s, engines %s", common.ARTIFACTS.stats(), common.ENGINES.stats())


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("config_dir", nargs="?", default="./config")
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: the card)")
    args = parser.parse_args()
    run(args.config_dir, device=args.device)

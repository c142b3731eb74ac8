"""Experiment runners of the port: a config in, ``metrics_*.json`` out.

- :mod:`.moeva`    — the MoEvA2 runner (``experiments/moeva.py``)
- :mod:`.pgd`      — the constrained PGD and SAT runner (``experiments/pgd.py``)
- :mod:`.common`   — artifact loading, the artifact and engine caches, skip-if-done
- :mod:`.rq`       — the research-question grid runner (``experiments/rq.py``)
- :mod:`.pipeline` — the grid's background writer and report (``experiments/pipeline.py``)
- :mod:`.run_all`  — the full suite of grid files (``experiments/run_all.py``)
- :mod:`.defense`  — the defense pipeline's artifact family (``experiments/defense.py``)
- :mod:`.rq4`      — RQ4's retraining on the best adversarials (``experiments/rq4.py``)
- :mod:`.preprocess` — the raw LendingClub CSV to the LCLD dataset (``experiments/preprocess.py``)

Each runner is a function ``run(config, ..., device="cuda", dtype=...)``
and has a command line (``python3 -m
moeva2_ijcai22_replication_tpu_torch.experiments.rq -c <grid.yaml>``).
"""

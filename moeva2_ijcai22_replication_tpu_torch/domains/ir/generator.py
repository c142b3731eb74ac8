"""Seeded synthetic domain-family generator (numpy).

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/generator.py``: for the
same seed it draws the same schema, the same spec (same
:func:`~.spec.spec_hash`) and the same rows. It draws random-but-feasible
constraint specs from the IR's operator inventory: ordering chains, linear
definitions, guarded ratios, YYYYMM month arithmetic, memberships.

Feasibility is by construction: base features are sampled uniformly in
bounds, ordering columns are sorted into place, and the compiled repair
projection (:mod:`.repair_backend`) snaps memberships and re-derives the
defined features, so the sampler needs no rejection loop.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ...core.schema import FeatureSchema
from .spec import ConstraintSpec, resolve_spec
from .expr import parse_constraint


def generate_family(seed: int, n_base: int = 8):
    """-> (feature_rows, constraint_rows, ConstraintSpec).

    ``feature_rows`` / ``constraint_rows`` are ready for
    ``features.csv`` / ``constraints.csv`` (the CSV spec front, ``expr``
    column included), so a generated family round-trips through the same
    loader path as a committed domain.
    """
    rng = np.random.default_rng(seed)
    n_base = max(int(n_base), 6)

    feats = []  # (name, lo, hi)
    for i in range(n_base):
        hi = float(rng.choice([10.0, 100.0, 1000.0]))
        feats.append((f"f{i}", 0.0, hi))
    # two YYYYMM date features feeding the month-arithmetic operator
    feats.append(("date_a", 200001.0, 202012.0))
    feats.append(("date_b", 200001.0, 202012.0))
    date_a, date_b = n_base, n_base + 1

    constraints = []

    # ordering chain over a random base subset (sampler sorts these columns)
    chain_len = int(rng.integers(3, min(5, n_base) + 1))
    chain = sorted(rng.choice(n_base, size=chain_len, replace=False).tolist())
    for a, b in zip(chain, chain[1:]):
        constraints.append((f"ord_{a}_{b}", f"f{a} <= f{b}"))

    # membership on one non-chain base feature
    pool = [i for i in range(n_base) if i not in chain]
    if pool:
        m = int(rng.choice(pool))
        hi = feats[m][2]
        k = int(rng.integers(2, 4))
        values = sorted(
            float(v) for v in rng.choice(int(hi), size=k, replace=False)
        )
        constraints.append(
            (f"member_{m}", f"f{m} in {{{', '.join(repr(v) for v in values)}}}")
        )

    # derived features: linear definition, guarded ratio, month difference
    d0 = len(feats)
    i, j = (int(v) for v in rng.choice(n_base, size=2, replace=False))
    c = float(np.round(rng.uniform(0.5, 3.0), 2))
    feats.append((f"d{0}", 0.0, feats[i][2] + c * feats[j][2]))
    constraints.append((f"def_lin", f"d0 == f{i} + {c!r}*f{j}"))

    i, j = (int(v) for v in rng.choice(n_base, size=2, replace=False))
    feats.append((f"d{1}", 0.0, feats[i][2]))
    constraints.append((f"def_ratio", f"d1 == safe_div(f{i}, f{j}, 0.0)"))

    feats.append((f"d{2}", -260.0, 260.0))
    constraints.append(
        (f"def_months", "d2 == months(date_a) - months(date_b)")
    )
    derived = [d0, d0 + 1, d0 + 2]

    feature_rows = [
        {
            "feature": name,
            "type": "real",
            "mutable": "TRUE",
            "min": repr(lo),
            "max": repr(hi),
            "augmentation": "",
        }
        for name, lo, hi in feats
    ]
    constraint_rows = [
        {"constraint": name, "min": "0", "max": "1", "expr": expr}
        for name, expr in constraints
    ]
    spec = ConstraintSpec(
        name=f"family{seed}",
        constraints=tuple(
            parse_constraint(name, expr) for name, expr in constraints
        ),
    )
    return feature_rows, constraint_rows, spec, {
        "chain": chain,
        "derived": derived,
    }


def write_family(out_dir: str, seed: int, n_base: int = 8) -> str:
    """Materialize a generated family as ``features.csv``/``constraints.csv``
    under ``out_dir`` (created); returns ``out_dir``."""
    feature_rows, constraint_rows, _, _ = generate_family(seed, n_base)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "features.csv"), "w", newline="") as f:
        w = csv.DictWriter(
            f,
            fieldnames=["feature", "type", "mutable", "min", "max", "augmentation"],
        )
        w.writeheader()
        w.writerows(feature_rows)
    with open(os.path.join(out_dir, "constraints.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["constraint", "min", "max", "expr"])
        w.writeheader()
        w.writerows(constraint_rows)
    return out_dir


def sample_family(
    n: int, seed: int, n_base: int = 8
) -> tuple:
    """-> (x, schema, spec): ``n`` feasible rows of the seeded family.

    Uniform in bounds -> ordering columns sorted into place -> compiled
    repair snaps memberships and re-derives defined features. No rejection
    loop needed.
    """
    from ...core.codec import full_ohe_tables
    from .repair_backend import compile_repair

    feature_rows, _, spec, meta = generate_family(seed, n_base)
    nf = len(feature_rows)
    schema = FeatureSchema(
        names=tuple(r["feature"] for r in feature_rows),
        types=np.array([r["type"] for r in feature_rows], dtype=object),
        mutable=np.ones(nf, dtype=bool),
        raw_min=np.array([float(r["min"]) for r in feature_rows], dtype=object),
        raw_max=np.array([float(r["max"]) for r in feature_rows], dtype=object),
        augmentation=np.zeros(nf, dtype=bool),
    )
    rng = np.random.default_rng(seed + 1)
    xl, xu = schema.bounds()
    xl = np.asarray(xl, dtype=float).reshape(-1)
    xu = np.asarray(xu, dtype=float).reshape(-1)
    x = rng.uniform(xl, xu, size=(n, len(xl)))
    chain = meta["chain"]
    x[:, chain] = np.sort(x[:, chain], axis=1)
    resolved = resolve_spec(spec, schema)
    ohe_idx, ohe_mask = full_ohe_tables(schema)
    repair = compile_repair(resolved, schema, ohe_idx, ohe_mask)
    x = repair(torch.as_tensor(x)).numpy().astype(float)
    return x, schema, spec

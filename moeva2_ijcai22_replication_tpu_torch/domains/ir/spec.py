"""Declarative constraint specs: data model, loaders, hashing, resolution.

A copy of ``moeva2_ijcai22_replication_tpu/domains/ir/spec.py`` (the JAX
package's ``domains/__init__.py`` imports JAX, so the port keeps its own).
A :class:`ConstraintSpec` is the IR root: named constraints (parsed
expressions, :mod:`.expr`) plus optional column-group definitions. Two
loader fronts produce it:

- **CSV front** (:func:`load_spec_csv`): a ``constraints.csv`` that grows an
  ``expr`` column next to the reference's ``constraint,min,max``;
- **YAML front** (:func:`load_spec_yaml`): inline specs with group
  definitions: groups concatenate parts that name either schema features
  or keys of a ``feat_idx.pickle`` (the botnet port-group tables), each
  part optionally sliced (``take``), in the hand-written kernels' gather
  order.

The **spec hash** (:func:`spec_hash`) is a sha256 over the canonical
serialization, equal to the JAX package's for the same spec: expressions
are re-printed from the AST, so formatting never changes the identity,
while any semantic edit does. It is the identity of a compiled domain
(``spec:<name>:<hash12>``) and of its provenance (``domain_origin``).
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import pickle
from dataclasses import dataclass

import numpy as np

from .expr import (
    Constraint,
    Env,
    SpecError,
    canon_constraint,
    constraint_features,
    groups_of,
    parse_constraint,
)


@dataclass(frozen=True)
class GroupPart:
    """One segment of a concatenated column group: either schema feature
    names or a ``feat_idx.pickle`` key, optionally sliced to ``take``
    leading entries (the botnet ratio family's first-17-ports quirk)."""

    key: str | None = None
    features: tuple = ()
    take: int | None = None


@dataclass(frozen=True)
class GroupDef:
    name: str
    parts: tuple


@dataclass(frozen=True)
class ConstraintSpec:
    name: str
    constraints: tuple
    groups: tuple = ()
    feat_idx_file: str | None = None

    def canonical(self) -> dict:
        """Formatting-independent normal form (the hashed identity)."""
        return {
            "name": self.name,
            "constraints": [
                [c.name, c.kind, canon_constraint(c)] for c in self.constraints
            ],
            "groups": [
                [
                    g.name,
                    [
                        {
                            "key": p.key,
                            "features": list(p.features),
                            "take": p.take,
                        }
                        for p in g.parts
                    ],
                ]
                for g in self.groups
            ],
            "feat_idx_file": self.feat_idx_file,
        }


def spec_hash(spec: ConstraintSpec) -> str:
    blob = json.dumps(spec.canonical(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


# -- loaders -----------------------------------------------------------------


def _parse_group_part(raw) -> GroupPart:
    if isinstance(raw, str):
        return GroupPart(key=raw)
    take = raw.get("take")
    if take is not None:
        take = int(take)
    features = raw.get("features") or ()
    return GroupPart(
        key=raw.get("key"), features=tuple(features), take=take
    )


def load_spec_yaml(path: str) -> ConstraintSpec:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    name = doc.get("name") or os.path.splitext(os.path.basename(path))[0]
    constraints = tuple(
        parse_constraint(row["name"], row["expr"]) for row in doc["constraints"]
    )
    groups = tuple(
        GroupDef(gname, tuple(_parse_group_part(p) for p in parts))
        for gname, parts in (doc.get("groups") or {}).items()
    )
    return ConstraintSpec(
        name=name,
        constraints=constraints,
        groups=groups,
        feat_idx_file=doc.get("feat_idx"),
    )


def load_spec_csv(path: str, name: str | None = None) -> ConstraintSpec:
    """CSV front: ``constraint,min,max,expr`` rows (``min``/``max`` belong to
    :class:`ConstraintBounds`; only ``constraint`` + ``expr`` matter here)."""
    constraints = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            expr = (row.get("expr") or "").strip()
            if not expr:
                raise SpecError(
                    f"{path}: row {row.get('constraint')!r} has no expr column "
                    "(a spec-front constraints.csv must carry one per row)"
                )
            constraints.append(parse_constraint(row["constraint"], expr))
    if name is None:
        name = os.path.basename(os.path.dirname(os.path.abspath(path))) or "spec"
    return ConstraintSpec(name=name, constraints=tuple(constraints))


def load_spec(path: str, name: str | None = None) -> ConstraintSpec:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".yaml", ".yml"):
        spec = load_spec_yaml(path)
    elif ext == ".csv":
        spec = load_spec_csv(path, name=name)
    else:
        raise SpecError(f"unknown spec extension {ext!r} for {path}")
    if name:
        spec = ConstraintSpec(
            name=name,
            constraints=spec.constraints,
            groups=spec.groups,
            feat_idx_file=spec.feat_idx_file,
        )
    return spec


# -- resolution --------------------------------------------------------------


@dataclass
class ResolvedSpec:
    """A spec bound to one schema/data-dir: name resolution done, group
    index arrays materialized, per-constraint term widths known."""

    spec: ConstraintSpec
    env: Env
    widths: tuple  # per-constraint term counts
    n_terms: int
    hash: str


def _resolve_groups(spec: ConstraintSpec, columns: dict, data_dir: str | None):
    feat_idx = None
    if spec.feat_idx_file:
        if data_dir is None:
            raise SpecError(
                f"spec {spec.name!r} needs feat_idx {spec.feat_idx_file!r} "
                "but no data dir was given"
            )
        with open(os.path.join(data_dir, spec.feat_idx_file), "rb") as f:
            feat_idx = {k: np.asarray(v) for k, v in pickle.load(f).items()}
    groups = {}
    for g in spec.groups:
        segs = []
        for p in g.parts:
            if p.key is not None:
                if feat_idx is None:
                    raise SpecError(
                        f"group {g.name!r} references feat_idx key {p.key!r} "
                        f"but spec {spec.name!r} declares no feat_idx file"
                    )
                if p.key not in feat_idx:
                    raise SpecError(
                        f"group {g.name!r}: unknown feat_idx key {p.key!r}"
                    )
                seg = feat_idx[p.key]
            else:
                missing = [f for f in p.features if f not in columns]
                if missing:
                    raise SpecError(
                        f"group {g.name!r}: undefined feature(s) {missing}"
                    )
                seg = np.array([columns[f] for f in p.features])
            if p.take is not None:
                seg = seg[: p.take]
            segs.append(np.asarray(seg))
        groups[g.name] = np.concatenate(segs) if segs else np.array([], int)
    return groups


def _width_of(node, env: Env) -> int:
    from . import expr as E

    if isinstance(node, E.Num):
        return 0
    if isinstance(node, E.Feat):
        env.col(node.name)  # raises on undefined features
        return 1
    if isinstance(node, E.Group):
        return len(env.group(node.name))
    if isinstance(node, E.Neg):
        return _width_of(node.arg, env)
    if isinstance(node, E.Bin):
        return _combine(_width_of(node.lhs, env), _width_of(node.rhs, env))
    if isinstance(node, E.Call):
        if node.fn == "sum":
            w = _width_of(node.args[0], env)
            if w < 2:
                raise SpecError("sum() takes a @group argument")
            return 1
        if node.fn in ("safe_div", "finite_div"):
            return _combine(
                _width_of(node.args[0], env), _width_of(node.args[1], env)
            )
        return _width_of(node.args[0], env)
    raise SpecError(f"cannot type {node!r}")


def _combine(wa: int, wb: int) -> int:
    if wa == wb or wa == 0 or wb == 0 or wa == 1 or wb == 1:
        return max(wa, wb)
    raise SpecError(f"group width mismatch: {wa} vs {wb}")


def _constraint_width(c: Constraint, env: Env) -> int:
    if c.kind == "member":
        w = _width_of(c.lhs, env)
    else:
        w = _combine(_width_of(c.lhs, env), _width_of(c.rhs, env))
    return max(w, 1)  # a literal-only constraint still emits one term


def resolve_spec(
    spec: ConstraintSpec, schema, data_dir: str | None = None
) -> ResolvedSpec:
    columns = {name: i for i, name in enumerate(schema.names)}
    if len(columns) != len(schema.names):
        raise SpecError(f"spec {spec.name!r}: schema has duplicate feature names")
    groups = _resolve_groups(spec, columns, data_dir)
    env = Env(columns, groups)
    widths = tuple(_constraint_width(c, env) for c in spec.constraints)
    return ResolvedSpec(
        spec=spec,
        env=env,
        widths=widths,
        n_terms=int(sum(widths)),
        hash=spec_hash(spec),
    )


def validate_spec(spec: ConstraintSpec, schema) -> list:
    """Static lint findings (strings). Empty = clean. Checks: undefined
    features, non-guarded ``/`` denominators that can reach zero under the
    schema bounds, membership values outside feature bounds, and duplicate
    constraint names."""
    from . import expr as E

    findings = []
    columns = {name: i for i, name in enumerate(schema.names)}
    seen = set()
    for c in spec.constraints:
        if c.name in seen:
            findings.append(f"{c.name}: duplicate constraint name")
        seen.add(c.name)
        for feat in sorted(constraint_features(c)):
            if feat not in columns:
                findings.append(f"{c.name}: undefined feature {feat!r}")
        nodes = list(E.walk(c.lhs))
        if c.kind != "member":
            nodes += list(E.walk(c.rhs))
        for node in nodes:
            if isinstance(node, E.Bin) and node.op == "/":
                den = node.rhs
                if isinstance(den, E.Feat) and den.name in columns:
                    i = columns[den.name]
                    lo, hi = schema.raw_min[i], schema.raw_max[i]
                    spans_zero = (
                        str(lo) == "dynamic"
                        or str(hi) == "dynamic"
                        or float(lo) <= 0.0 <= float(hi)
                    )
                    if spans_zero:
                        findings.append(
                            f"{c.name}: non-guarded denominator {den.name!r} "
                            "can reach 0 under its bounds — use "
                            "safe_div/finite_div"
                        )
        if c.kind == "member" and isinstance(c.lhs, E.Feat):
            i = columns.get(c.lhs.name)
            if i is not None:
                lo, hi = schema.raw_min[i], schema.raw_max[i]
                if str(lo) != "dynamic" and str(hi) != "dynamic":
                    bad = [
                        v for v in c.rhs if not float(lo) <= v <= float(hi)
                    ]
                    if bad:
                        findings.append(
                            f"{c.name}: membership value(s) {bad} outside "
                            f"bounds [{lo}, {hi}] of {c.lhs.name!r}"
                        )
    return findings

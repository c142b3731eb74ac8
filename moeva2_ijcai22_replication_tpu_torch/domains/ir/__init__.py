"""Constraint-expression IR and domain compiler: domain-as-data.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/``. One declarative spec
(YAML, or a ``constraints.csv`` grown an ``expr`` column) compiles into:

- a constraint set whose terms keep the port's order of operations
  (:func:`compile_spec` -> :class:`SpecConstraintSet`), bit for bit equal
  to the hand-written domains it re-expresses;
- the constraint program of kernel K9 (:mod:`.program`), which computes
  MoEvA's objectives for the domain on the card;
- a constructive repair projection derived from the defining equalities
  (:mod:`.repair_backend`).

The MILP row builder of the JAX package (``make_spec_sat_builder``,
``SpecMilpError``) and constrained PGD on spec domains come with ROADMAP
A11b; until then they refuse a spec set by name.
"""

from .expr import Constraint, Env, SpecError, parse_constraint, parse_expr
from .generator import generate_family, sample_family, write_family
from .ops import finite_div, months, safe_div
from .program import SpecProgram, lower_spec, run_program_plain
from .spec import (
    ConstraintSpec,
    ResolvedSpec,
    load_spec,
    load_spec_csv,
    load_spec_yaml,
    resolve_spec,
    spec_hash,
    validate_spec,
)
from .torch_backend import SpecConstraintSet, compile_spec, compile_spec_path

__all__ = [
    "Constraint",
    "ConstraintSpec",
    "Env",
    "ResolvedSpec",
    "SpecConstraintSet",
    "SpecError",
    "SpecProgram",
    "compile_spec",
    "compile_spec_path",
    "finite_div",
    "generate_family",
    "load_spec",
    "load_spec_csv",
    "load_spec_yaml",
    "lower_spec",
    "months",
    "parse_constraint",
    "parse_expr",
    "resolve_spec",
    "run_program_plain",
    "safe_div",
    "sample_family",
    "spec_hash",
    "validate_spec",
    "write_family",
]

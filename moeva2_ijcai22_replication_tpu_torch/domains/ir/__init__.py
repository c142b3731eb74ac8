"""Constraint-expression IR and domain compiler: domain-as-data.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/``. One declarative spec
(YAML, or a ``constraints.csv`` grown an ``expr`` column) compiles into:

- a constraint set whose terms keep the port's order of operations
  (:func:`compile_spec` -> :class:`SpecConstraintSet`), bit for bit equal
  to the hand-written domains it re-expresses;
- the constraint program of kernel K9 (:mod:`.program`), which computes
  MoEvA's objectives for the domain on the card;
- the backward of its smooth violations with ``jax.grad``'s conventions,
  walked over the AST (:mod:`.vjp`) and lowered to the reverse program of
  kernel K10, which runs constrained PGD and AutoPGD on the card;
- a constructive repair projection derived from the defining equalities
  (:mod:`.repair_backend`), and its program for K10;
- HiGHS ``LinearRows`` for the ``flip+sat`` attack (:mod:`.milp_backend`).
"""

from .expr import Constraint, Env, SpecError, parse_constraint, parse_expr
from .generator import generate_family, sample_family, write_family
from .milp_backend import SpecMilpError, make_spec_sat_builder
from .ops import finite_div, months, safe_div
from .program import (
    SpecProgram, lower_spec, lower_spec_repair, lower_spec_vjp, run_program_plain, run_program_vjp_plain,
    run_repair_plain,
)
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
from .torch_backend import SpecConstraintSet, SpecPgdTables, compile_spec, compile_spec_path
from .vjp import smooth_vjp_ast

__all__ = [
    "Constraint",
    "ConstraintSpec",
    "Env",
    "ResolvedSpec",
    "SpecConstraintSet",
    "SpecError",
    "SpecMilpError",
    "SpecPgdTables",
    "SpecProgram",
    "compile_spec",
    "compile_spec_path",
    "finite_div",
    "generate_family",
    "load_spec",
    "load_spec_csv",
    "load_spec_yaml",
    "lower_spec",
    "lower_spec_repair",
    "lower_spec_vjp",
    "make_spec_sat_builder",
    "months",
    "parse_constraint",
    "parse_expr",
    "resolve_spec",
    "run_program_plain",
    "run_program_vjp_plain",
    "run_repair_plain",
    "safe_div",
    "sample_family",
    "smooth_vjp_ast",
    "spec_hash",
    "validate_spec",
    "write_family",
]

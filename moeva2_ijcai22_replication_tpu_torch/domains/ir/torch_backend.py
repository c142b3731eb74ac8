"""torch compiler backend: spec -> constraint set, with kernel K9's program.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/jnp_backend.py``.
:func:`compile_spec` turns a :class:`~.spec.ConstraintSpec` into a
:class:`~...core.constraints.ConstraintSet` subclass whose ``_raw``
(:func:`raw_terms`) keeps the evaluator's order of operations (:mod:`.expr`),
so a committed spec reproduces ``lcld_constraint_terms`` and
``BotnetConstraints._raw`` bit for bit on the same inputs, in float32 and in
float64.

On the card the set's terms are computed inside MoEvA's objectives by
kernel K9 (``kernels/csrc/objective_spec.cu``), from the program that
:func:`.program.lower_spec` emits (``kernel_tables``). Constrained PGD and
AutoPGD differentiate the terms by hand (``smooth_vjp``, ``jax.grad``'s
conventions): on the card kernel K10 (``kernels/csrc/pgd_spec.cu``) runs
the reverse and the repair programs that :func:`.program.lower_spec_vjp`
and :func:`.program.lower_spec_repair` emit (``pgd_kernel_tables``), and
on the CPU :func:`.program.run_program_vjp_plain` and
:func:`.program.run_repair_plain` interpret them.

Identity: every compiled class is a distinct Python type, and an instance's
``ledger_tag`` is ``spec:<name>:<hash12>``, so a spec edit is a new
identity, never a stale one.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ...core.codec import full_ohe_tables, harden_onehot
from ...core.constraints import ConstraintSet
from ...core.schema import ConstraintBounds, FeatureSchema
from . import ops
from .expr import eval_term
from .program import (
    SpecProgram, contribution_tables, lower_spec, lower_spec_repair, lower_spec_vjp, run_program_vjp_plain, run_repair_plain,
)
from .spec import ConstraintSpec, ResolvedSpec, load_spec, resolve_spec


class SpecPgdTables(NamedTuple):
    """What kernel K10 reads of a spec domain: the reverse program (each
    term's forward, its head and its backward), where each term starts in it
    and which contributions each feature sums (``contribution_tables``), and
    the repair program."""

    vjp: SpecProgram
    repair: SpecProgram
    term_start: torch.Tensor  # (n_terms + 1,) int32
    acc_ptr: torch.Tensor  # (D + 1,) int32: each feature's contributions in acc_idx
    acc_idx: torch.Tensor  # (n_acc,) int32: their indices, in program order

    @classmethod
    def build(cls, vjp: SpecProgram, repair: SpecProgram) -> "SpecPgdTables":
        return cls(vjp, repair, *(torch.as_tensor(a) for a in contribution_tables(vjp)))

    def to(self, device) -> "SpecPgdTables":
        return SpecPgdTables(self.vjp.to(device), self.repair.to(device),
                             *(t.to(device) for t in (self.term_start, self.acc_ptr, self.acc_idx)))


def raw_terms(x: torch.Tensor, resolved: ResolvedSpec) -> torch.Tensor:
    """Unthresholded violation magnitudes ``(..., n_terms)``.

    All-scalar specs stack (the lcld shape); mixed scalar/group specs
    concatenate with scalars expanded ``[..., None]`` (the botnet shape);
    either way the per-element values are untouched. A literal-only term is
    broadcast per row as ``v + 0.0 * x[..., 0]`` (a NaN in feature 0 reaches
    it)."""
    vals = []
    for c in resolved.spec.constraints:
        v, vw = eval_term(c, x, resolved.env)
        if vw == 0:
            v = ops.literal(x, v) + ops.literal(x, 0.0) * x[..., 0]
        vals.append((v, max(vw, 1)))
    if all(w == 1 for _, w in vals):
        return torch.stack([v for v, _ in vals], dim=-1)
    return torch.cat([v[..., None] if w == 1 else v for v, w in vals], dim=-1)


class SpecConstraintSet(ConstraintSet):
    """A constraint set compiled from a declarative spec.

    Constructor signature matches the hand-written domain classes
    (``(features_path, constraints_path)``), so the registry and
    ``load_constraints`` treat compiled and hand-written domains alike.
    ``constraints_path`` may be None or "" for spec families without
    violation-normalisation bounds.
    """

    #: the compiled spec, set per subclass by :func:`compile_spec`
    spec: ConstraintSpec = None
    origin = "spec"
    #: kernel K9 (``kernels/csrc/objective_spec.cu``) computes the terms
    #: inside the objectives on the card, from ``kernel_tables``' program
    objective_kernel = "spec"
    #: kernel K10 (``kernels/csrc/pgd_spec.cu``) runs constrained PGD and
    #: AutoPGD on the card, from ``pgd_kernel_tables``' programs
    pgd_kernel = "spec"

    def __init__(
        self,
        features_path: str,
        constraints_path: str | None = None,
        important_features_path: str | None = None,
    ):
        if self.spec is None:
            raise TypeError("SpecConstraintSet is abstract; build a subclass with compile_spec(spec)")
        schema = FeatureSchema.from_csv(features_path)
        bounds = ConstraintBounds.from_csv(constraints_path) if constraints_path else None
        data_dir = os.path.dirname(os.path.abspath(features_path))
        resolved = resolve_spec(self.spec, schema, data_dir)
        # an instance attribute before ConstraintSet.__init__ checks the
        # bounds' row count: it depends on the groups' resolution
        self.n_constraints = resolved.n_terms
        super().__init__(schema, bounds)
        self.resolved = resolved
        self.ledger_tag = f"spec:{self.spec.name}:{resolved.hash[:12]}"
        self.important_features = (
            np.load(important_features_path)
            if important_features_path and os.path.exists(important_features_path)
            else None
        )
        self._ohe_idx, self._ohe_mask = full_ohe_tables(schema)
        self.program = lower_spec(resolved, schema.n_features)
        self.pgd_program = SpecPgdTables.build(lower_spec_vjp(resolved, schema.n_features),
                                               lower_spec_repair(resolved, schema))
        self._on_device: dict = {}
        self._pgd_on_device: dict = {}

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        return raw_terms(x, self.resolved)

    def raw_numpy(self, x: np.ndarray) -> np.ndarray:
        """``_raw`` of host rows, on the CPU in their dtype."""
        return raw_terms(torch.as_tensor(np.asarray(x)), self.resolved).numpy()

    def repair(self, x: torch.Tensor) -> torch.Tensor:
        """The repair program's snaps and assignments
        (:func:`.program.run_repair_plain`), then every one-hot group
        hardened to its argmax: ``compile_repair``'s projection."""
        x = run_repair_plain(self.pgd_program.repair, x)
        return harden_onehot(x, self._ohe_idx.to(x.device), self._ohe_mask.to(x.device))

    def smooth_vjp(self, u: torch.Tensor, ct_g: torch.Tensor):
        """``(g, ct_u)``: the smooth violations ``clip(raw_terms(u) - tol, 0,
        inf)`` (..., K) of the unscaled rows ``u`` and the cotangent of ``u``
        from ``ct_g`` (..., K), with ``jax.grad``'s conventions: the reverse
        program interpreted (:func:`.program.run_program_vjp_plain`), equal to
        the AST walk :func:`.vjp.smooth_vjp_ast` bit for bit."""
        return run_program_vjp_plain(self.pgd_program.vjp, u, ct_g, self.tol)

    def kernel_tables(self, device) -> SpecProgram:
        """Kernel K9's program on ``device``, made once per device."""
        key = torch.device(device)
        if key not in self._on_device:
            self._on_device[key] = self.program.to(key)
        return self._on_device[key]

    def pgd_kernel_tables(self, device) -> SpecPgdTables:
        """Kernel K10's reverse and repair programs on ``device``, made once
        per device."""
        key = torch.device(device)
        if key not in self._pgd_on_device:
            self._pgd_on_device[key] = self.pgd_program.to(key)
        return self._pgd_on_device[key]


def compile_spec(spec: ConstraintSpec) -> type:
    """Spec -> ConstraintSet subclass (instantiate with the usual
    ``(features_path, constraints_path)``)."""
    return type(f"Spec_{spec.name}", (SpecConstraintSet,), {"spec": spec, "__module__": __name__})


def compile_spec_path(path: str, name: str | None = None) -> type:
    return compile_spec(load_spec(path, name=name))

"""Lowering of a resolved spec to the constraint program of kernel K9.

Kernel K9 (``kernels/csrc/objective_spec.cu``) computes MoEvA's objectives
for any domain compiled from a spec; its constraint terms come from a flat
list of fixed-width instructions that :func:`lower_spec` emits from the
spec's AST, and that the kernel stages in shared memory and runs, one
thread per row.

An instruction is four int32 words ``(code, dst, a, b)``: ``code`` holds the
op in its low byte and the kinds of the operands ``a`` and ``b`` in bits 8-11
and 12-15; an operand is a feature column of the row (``FEAT``), a scratch
slot (``SLOT``) or a float32 immediate (``IMM``, its bits in the word). The
ops are those of :mod:`.expr`'s evaluator, one rounded float32 operation
each: ``MOV``, ``ADD``, ``SUB``, ``MUL``, ``DIV`` (a true division), ``POW``
(in float64, rounded once), ``NEG``, ``ABS``, ``MONTHS`` (K1's
``lcld_months``), ``SAFE_DIV``/``FINITE_DIV`` (``dst`` holds the sentinel
and becomes ``a / b`` where ``b != 0``; ``FINITE_DIV`` keeps the sentinel
where the quotient is not finite too), and ``TERM`` (term ``dst`` of the
row is operand ``a``).

The lowering keeps the evaluator's order of operations, so the program's
terms equal :func:`.torch_backend.raw_terms` bit for bit
(:func:`run_program_plain`, the same table interpreted by torch ops one at a
time, is the check): group terms are unrolled into their elements in
``raw_terms``'s term order, a group sum is a left-to-right chain of adds, a
literal-only subtree is folded in Python double and emitted as one float32
immediate, and a literal-only term is ``v + 0.0 * x[..., 0]``.

The program's limits are kernel K9's (``kernels/csrc/kernels.h``): a spec
that exceeds one is refused here, by name.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import expr as E
from . import ops
from .expr import SpecError, eval_expr, eval_term, sentinel_value
from .spec import ResolvedSpec, _width_of

# K9's limits, as kernels/csrc/kernels.h defines them
SPEC_MAX_INSTRUCTIONS = 2048  # kSpecMaxInstructions
SPEC_MAX_SLOTS = 32  # kSpecMaxSlots
SPEC_MAX_TERMS = 1024  # kSpecMaxTerms
SPEC_MAX_FEATURES = 1024  # kSpecMaxFeatures

# op codes (kernels/csrc/objective_spec.cu's SpecOp)
MOV, ADD, SUB, MUL, DIV, POW, NEG, ABS, MONTHS, SAFE_DIV, FINITE_DIV, TERM = range(12)
OP_NAMES = ("MOV", "ADD", "SUB", "MUL", "DIV", "POW", "NEG", "ABS", "MONTHS", "SAFE_DIV", "FINITE_DIV", "TERM")
_BINARY = {"+": ADD, "-": SUB, "*": MUL, "/": DIV, "^": POW}
_UNARY = {"abs": ABS, "months": MONTHS}
# operand kinds
FEAT, SLOT, IMM = range(3)


class SpecProgram(NamedTuple):
    """What kernel K9 reads of a spec domain: its constraint program."""

    code: torch.Tensor  # (n_instructions, 4) int32: code, dst, a, b
    n_slots: int  # scratch slots a row needs
    n_terms: int  # TERM instructions, in term order
    n_features: int  # the rows' features

    def to(self, device) -> "SpecProgram":
        return self._replace(code=self.code.to(device))


def _imm_bits(v: float) -> int:
    """The int32 word holding ``v`` rounded once to float32."""
    return int(np.float32(v).view(np.int32))


def _imm_value(word: int) -> float:
    return float(np.int32(word).view(np.float32))


class _Lowering:
    """Emits one spec's instructions; operands are ``(FEAT, col)``,
    ``(SLOT, slot)`` or a Python float (a literal, rounded when emitted)."""

    def __init__(self, resolved: ResolvedSpec):
        self.env = resolved.env
        self.rows: list = []
        self.free: list = []
        self.n_slots = 0
        self.n_terms = 0

    def new_slot(self) -> tuple:
        if self.free:
            self.free.sort()
            return (SLOT, self.free.pop(0))
        self.n_slots += 1
        return (SLOT, self.n_slots - 1)

    def release(self, *operands) -> None:
        for o in operands:
            if isinstance(o, tuple) and o[0] == SLOT:
                self.free.append(o[1])

    def dst(self, *operands) -> tuple:
        """A slot for a result computed from ``operands``, which die here (the
        kernel reads every operand before it writes the destination)."""
        self.release(*operands)
        return self.new_slot()

    def emit(self, op: int, dst: int, a=None, b=None) -> None:
        words, kinds = [], []
        for o in (a, b):
            if o is None:
                kinds.append(FEAT)
                words.append(0)
            elif isinstance(o, tuple):
                kinds.append(o[0])
                words.append(int(o[1]))
            else:
                kinds.append(IMM)
                words.append(_imm_bits(o))
        self.rows.append((op | kinds[0] << 8 | kinds[1] << 12, dst, *words))

    def lower(self, node, j: int):
        """Operand of ``node``'s element ``j`` (a width-1 node ignores j)."""
        if _width_of(node, self.env) == 0:
            return float(eval_expr(node, None, self.env)[0])
        if isinstance(node, E.Feat):
            return (FEAT, self.env.col(node.name))
        if isinstance(node, E.Group):
            return (FEAT, int(self.env.group(node.name)[j]))
        if isinstance(node, E.Neg):
            a = self.lower(node.arg, j)
            d = self.dst(a)
            self.emit(NEG, d[1], a)
            return d
        if isinstance(node, E.Bin):
            a = self.lower(node.lhs, j)
            b = self.lower(node.rhs, j)
            d = self.dst(a, b)
            self.emit(_BINARY[node.op], d[1], a, b)
            return d
        if isinstance(node, E.Call):
            if node.fn == "sum":
                width = _width_of(node.args[0], self.env)
                if width < 2:
                    raise SpecError("sum() takes a @group argument")
                acc = self.lower(node.args[0], 0)
                for k in range(1, width):
                    e = self.lower(node.args[0], k)
                    d = self.dst(acc, e)
                    self.emit(ADD, d[1], acc, e)
                    acc = d
                return acc
            if node.fn in _UNARY:
                a = self.lower(node.args[0], j)
                d = self.dst(a)
                self.emit(_UNARY[node.fn], d[1], a)
                return d
            if node.fn in ("safe_div", "finite_div"):
                n = self.lower(node.args[0], j)
                den = self.lower(node.args[1], j)
                d = self.new_slot()
                self.emit(MOV, d[1], sentinel_value(node))
                self.emit(SAFE_DIV if node.fn == "safe_div" else FINITE_DIV, d[1], n, den)
                self.release(n, den)
                return d
        raise SpecError(f"cannot lower {node!r}")

    def term(self, value) -> None:
        self.emit(TERM, self.n_terms, value)
        self.release(value)
        self.n_terms += 1

    def constraint(self, c: E.Constraint, width: int) -> None:
        literal = (_width_of(c.lhs, self.env) == 0 if c.kind == "member" else
                   _width_of(c.lhs, self.env) == 0 and _width_of(c.rhs, self.env) == 0)
        if literal:
            # raw_terms' broadcast of a literal-only term: v + 0.0 * x[..., 0]
            v = float(eval_term(c, None, self.env)[0])
            d = self.new_slot()
            self.emit(MUL, d[1], 0.0, (FEAT, 0))
            self.emit(ADD, d[1], v, d)
            self.term(d)
            return
        for j in range(width):
            if c.kind == "member":
                v = self.lower(c.lhs, j)
                prod = self.new_slot()
                self.emit(SUB, prod[1], c.rhs[0], v)
                for val in c.rhs[1:]:
                    t = self.new_slot()
                    self.emit(SUB, t[1], val, v)
                    self.release(t)
                    self.emit(MUL, prod[1], prod, t)
                self.release(v)
                self.emit(ABS, prod[1], prod)
                self.term(prod)
                continue
            a = self.lower(c.lhs, j)
            b = self.lower(c.rhs, j)
            d = self.dst(a, b)
            self.emit(SUB, d[1], a, b)
            if c.kind == "eq":
                self.emit(ABS, d[1], d)
            self.term(d)


def lower_spec(resolved: ResolvedSpec, n_features: int) -> SpecProgram:
    """The K9 program of ``resolved`` over rows of ``n_features``; raises
    :class:`SpecError` naming the limit a spec exceeds."""
    low = _Lowering(resolved)
    for c, width in zip(resolved.spec.constraints, resolved.widths):
        low.constraint(c, width)
    name = resolved.spec.name
    for what, count, limit, const in (
        ("features", n_features, SPEC_MAX_FEATURES, "kSpecMaxFeatures"),
        ("terms", low.n_terms, SPEC_MAX_TERMS, "kSpecMaxTerms"),
        ("instructions", len(low.rows), SPEC_MAX_INSTRUCTIONS, "kSpecMaxInstructions"),
        ("scratch slots", low.n_slots, SPEC_MAX_SLOTS, "kSpecMaxSlots"),
    ):
        if count > limit:
            raise SpecError(
                f"spec {name!r} needs {count} {what}, more than kernel K9 takes ({const} = {limit} in "
                "kernels/csrc/kernels.h)"
            )
    code = torch.as_tensor(np.asarray(low.rows, dtype=np.int64).astype(np.int32).reshape(-1, 4))
    return SpecProgram(code=code, n_slots=max(low.n_slots, 1), n_terms=low.n_terms, n_features=n_features)


def decode(code) -> list:
    """The instructions of a program's ``code`` as ``(op, dst, a, b)`` with
    each operand ``(kind, value)`` (a float for an immediate)."""
    out = []
    for word, dst, a, b in np.asarray(torch.as_tensor(code).cpu()).tolist():
        op, kinds = word & 0xFF, ((word >> 8) & 0xF, (word >> 12) & 0xF)
        operands = tuple((k, _imm_value(v) if k == IMM else v) for k, v in zip(kinds, (a, b)))
        out.append((op, dst, *operands))
    return out


def run_program_plain(tables: SpecProgram, x: torch.Tensor) -> torch.Tensor:
    """The unthresholded terms ``(..., n_terms)`` of the rows ``x`` (...,
    n_features) float32, the program interpreted by torch ops one at a time:
    the semantics of kernel K9's constraint stage."""
    if x.dtype != torch.float32:
        raise TypeError(f"a K9 program runs on float32 rows (its immediates are float32), got {x.dtype}")
    if x.shape[-1] != tables.n_features:
        raise ValueError(f"the program takes rows of {tables.n_features} features, got {x.shape[-1]}")
    shape = x.shape[:-1]
    slots: list = [None] * tables.n_slots
    terms: list = [None] * tables.n_terms

    def operand(o):
        kind, v = o
        if kind == FEAT:
            return x[..., v]
        if kind == SLOT:
            return slots[v]
        return ops.literal(x, v)

    for op, d, a, b in decode(tables.code):
        if op == TERM:
            terms[d] = operand(a).expand(shape)
            continue
        va = operand(a)
        if op == MOV:
            r = va.expand(shape)
        elif op in (ADD, SUB, MUL, DIV):
            vb = operand(b)
            r = va + vb if op == ADD else va - vb if op == SUB else va * vb if op == MUL else va / vb
        elif op == POW:
            r = ops.pow_rn(va, operand(b))
        elif op == NEG:
            r = -va
        elif op == ABS:
            r = torch.abs(va)
        elif op == MONTHS:
            r = ops.months(va)
        elif op in (SAFE_DIV, FINITE_DIV):
            fn = ops.safe_div if op == SAFE_DIV else ops.finite_div
            r = fn(va, operand(b), slots[d])
        else:
            raise ValueError(f"unknown op code {op}")
        slots[d] = r.expand(shape)
    return torch.stack(terms, dim=-1)

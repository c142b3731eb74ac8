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

from ...core.vjp import abs_vjp, clip_vjp, pow_base_jac, pow_exp_jac
from . import expr as E
from . import ops
from .expr import SpecError, eval_expr, eval_term, sentinel_value
from .spec import ResolvedSpec, _width_of

# K9's limits, as kernels/csrc/kernels.h defines them
SPEC_MAX_INSTRUCTIONS = 2048  # kSpecMaxInstructions
SPEC_MAX_SLOTS = 32  # kSpecMaxSlots
SPEC_MAX_TERMS = 1024  # kSpecMaxTerms
SPEC_MAX_FEATURES = 1024  # kSpecMaxFeatures

# K10's limits (kernels/csrc/kernels.h): its reverse and repair programs
# are read from global memory, their slots are a thread's local array
SPEC_VJP_MAX_INSTRUCTIONS = 16384  # kSpecVjpMaxInstructions
SPEC_VJP_MAX_SLOTS = 64  # kSpecVjpMaxSlots

# op codes (kernels/csrc/objective_spec.cu's SpecOp; 12 and up are K10's,
# kernels/csrc/pgd_spec.cu's)
MOV, ADD, SUB, MUL, DIV, POW, NEG, ABS, MONTHS, SAFE_DIV, FINITE_DIV, TERM = range(12)
(HEAD, ACC, ACCN, ABS_VJP, DIV_DEN, POW_DB, POW_DE, SEL_NZ, SEL_FIN, DEN1, LT, SEL, STORE) = range(12, 25)
OP_NAMES = ("MOV", "ADD", "SUB", "MUL", "DIV", "POW", "NEG", "ABS", "MONTHS", "SAFE_DIV", "FINITE_DIV", "TERM",
            "HEAD", "ACC", "ACCN", "ABS_VJP", "DIV_DEN", "POW_DB", "POW_DE", "SEL_NZ", "SEL_FIN", "DEN1", "LT",
            "SEL", "STORE")
_BINARY = {"+": ADD, "-": SUB, "*": MUL, "/": DIV, "^": POW}
_UNARY = {"abs": ABS, "months": MONTHS}
# operand kinds
FEAT, SLOT, IMM = range(3)


class SpecProgram(NamedTuple):
    """What kernel K9 reads of a spec domain: its constraint program (and,
    in the same format, what kernel K10 reads: the reverse and the repair
    programs)."""

    code: torch.Tensor  # (n_instructions, 4) int32: code, dst, a, b
    n_slots: int  # scratch slots a row needs
    n_terms: int  # TERM (HEAD) instructions, in term order
    n_features: int  # the rows' features
    #: (n_instructions, 2) float64: each operand's immediate before its
    #: rounding to float32 (0 where the operand is not one), which the plain
    #: interpreters round to the rows' dtype
    imm: np.ndarray | None = None
    #: a reverse program's (n_terms + 1,) int32 first instruction of each
    #: term, then the program's length; None for the others
    term_start: np.ndarray | None = None

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
        self.imms: list = []
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
        words, kinds, imms = [], [], []
        for o in (a, b):
            if o is None:
                kinds.append(FEAT)
                words.append(0)
                imms.append(0.0)
            elif isinstance(o, tuple):
                kinds.append(o[0])
                words.append(int(o[1]))
                imms.append(0.0)
            else:
                kinds.append(IMM)
                words.append(_imm_bits(o))
                imms.append(float(o))
        self.rows.append((op | kinds[0] << 8 | kinds[1] << 12, dst, *words))
        self.imms.append(imms)

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

    def program(self, n_features: int) -> SpecProgram:
        code = torch.as_tensor(np.asarray(self.rows, dtype=np.int64).astype(np.int32).reshape(-1, 4))
        return SpecProgram(code=code, n_slots=max(self.n_slots, 1), n_terms=self.n_terms, n_features=n_features,
                           imm=np.asarray(self.imms, dtype=np.float64).reshape(-1, 2))

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
    return low.program(n_features)


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
    return torch.stack(_interpret(tables, x)[1], dim=-1)


# -- kernel K10: the reverse program and the repair program -----------------
#
# Beside K9's ops, in the same four-word format (``a``/``b`` operands,
# ``dst`` a slot unless said otherwise; "ct" a cotangent):
# - ``HEAD dst, a, t``: term ``t`` (the raw ``b`` word) of the row is ``a``:
#   ``pre = a - tol``, its smooth violation ``clip(pre, 0, inf)`` is
#   recorded, and ``dst = clip_vjp(pre, ct_g[t])``;
# - ``ACC f, a, k`` / ``ACCN f, a, k``: feature ``f``'s cotangent += ``a`` /
#   ``-a``, the program's k-th contribution (``k`` the raw ``b`` word: K10
#   stores each contribution apart and sums a feature's in ``k``'s order,
#   :func:`contribution_tables`);
# - ``ABS_VJP dst, v, ct``: ``ct`` where ``v >= 0``, ``-ct`` elsewhere;
# - ``DIV_DEN dst, ct, den``: ``-((ct * (1 / (den * den))) * dst)``, ``dst``
#   holding the numerator on entry (the denominator's cotangent);
# - ``POW_DB dst, base, t`` / ``POW_DE dst, base, t``: ``dst * jac``, ``dst``
#   holding the cotangent, the jacobian ``t * base ** (t - 1)`` / ``log(base)
#   * base ** t`` (a 0 base's log at 1) in float64 rounded once;
# - ``SEL_NZ dst, den``: ``dst`` where ``den != 0``, else 0; ``SEL_FIN dst,
#   num, den``: ``dst`` where ``den != 0`` and ``num / den`` is finite, else
#   0; ``DEN1 dst, den``: ``den`` where ``den != 0``, else 1;
# - ``LT dst, a, b``: 1 where ``a < b``, else 0; ``SEL dst, m, b``: ``dst``
#   where ``m != 0``, else ``b``;
# - ``STORE f, a``: feature ``f`` of the row becomes ``a`` (the repair's
#   writes, read by the instructions after it).


class _Rec(NamedTuple):
    """A lowered node: its operand (a slot, a feature or a float literal) and
    its children's records."""

    op: object
    kids: tuple = ()

    @property
    def literal(self) -> bool:
        return not isinstance(self.op, tuple)


def _leaf(node) -> bool:
    return isinstance(node, (E.Feat, E.Group))


class _VjpLowering(_Lowering):
    """Emits a spec's reverse program: per term its forward into slots, the
    HEAD and the reverse, depth first (:mod:`.vjp`'s order). A forward value
    that the reverse reads stays in its slot until the term ends."""

    def __init__(self, resolved: ResolvedSpec):
        super().__init__(resolved)
        self.kept: list = []
        self.n_acc = 0
        self.starts: list = []

    def emit(self, op: int, dst: int, a=None, b=None) -> None:
        if op in (ACC, ACCN):
            b = (FEAT, self.n_acc)
            self.n_acc += 1
        super().emit(op, dst, a, b)

    def release(self, *operands) -> None:
        # a slot may be named twice among a term's operands
        for o in operands:
            if isinstance(o, tuple) and o[0] == SLOT and o[1] not in self.free:
                self.free.append(o[1])

    def keep(self, *recs) -> None:
        self.kept += [r.op for r in recs]

    def result(self, op: int, a=None, b=None, frees=()) -> tuple:
        """A new slot holding ``op(a, b)``; the operands in ``frees`` die."""
        self.release(*frees)
        d = self.new_slot()
        self.emit(op, d[1], a, b)
        return d

    # -- forward -------------------------------------------------------------
    def fwd(self, node, j: int) -> _Rec:
        if _width_of(node, self.env) == 0:
            return _Rec(float(eval_expr(node, None, self.env)[0]))
        if isinstance(node, E.Feat):
            return _Rec((FEAT, self.env.col(node.name)))
        if isinstance(node, E.Group):
            return _Rec((FEAT, int(self.env.group(node.name)[j])))
        if isinstance(node, E.Neg):
            a = self.fwd(node.arg, j)
            return _Rec(self.result(NEG, a.op, frees=(a.op,)), (a,))
        if isinstance(node, E.Bin):
            a, b = self.fwd(node.lhs, j), self.fwd(node.rhs, j)
            if node.op in "+-":
                return _Rec(self.result(_BINARY[node.op], a.op, b.op, frees=(a.op, b.op)), (a, b))
            self.keep(a, b)
            return _Rec(self.result(_BINARY[node.op], a.op, b.op), (a, b))
        if isinstance(node, E.Call):
            if node.fn == "sum":
                width = _width_of(node.args[0], self.env)
                if width < 2:
                    raise SpecError("sum() takes a @group argument")
                kids = [self.fwd(node.args[0], 0)]
                acc = kids[0].op
                for k in range(1, width):
                    kids.append(self.fwd(node.args[0], k))
                    acc = self.result(ADD, acc, kids[-1].op, frees=(acc, kids[-1].op))
                return _Rec(acc, tuple(kids))
            if node.fn in _UNARY:
                a = self.fwd(node.args[0], j)
                if node.fn == "abs":
                    self.keep(a)
                    return _Rec(self.result(ABS, a.op), (a,))
                return _Rec(self.result(MONTHS, a.op, frees=(a.op,)), (a,))
            if node.fn in ("safe_div", "finite_div"):
                n, den = self.fwd(node.args[0], j), self.fwd(node.args[1], j)
                self.keep(n, den)
                d = self.new_slot()
                self.emit(MOV, d[1], sentinel_value(node))
                self.emit(SAFE_DIV if node.fn == "safe_div" else FINITE_DIV, d[1], n.op, den.op)
                return _Rec(d, (n, den))
        raise SpecError(f"cannot lower {node!r}")

    # -- reverse -------------------------------------------------------------
    def bwd(self, node, j: int, rec: _Rec, c: tuple) -> None:
        """Send the cotangent in slot ``c`` to the features under ``node``;
        ``c`` stays the caller's."""
        if rec.literal:
            return
        if _leaf(node):
            self.emit(ACC, rec.op[1], c)
            return
        if isinstance(node, E.Neg):
            self.sub_bwd(node.arg, j, rec.kids[0], c)
            return
        if isinstance(node, E.Bin):
            a, b = rec.kids
            if node.op == "+":
                self.bwd(node.lhs, j, a, c)
                self.bwd(node.rhs, j, b, c)
            elif node.op == "-":
                self.bwd(node.lhs, j, a, c)
                self.sub_bwd(node.rhs, j, b, c)
            elif node.op == "*":
                self.owned(node.lhs, j, a, lambda: self.result(MUL, c, b.op))
                self.owned(node.rhs, j, b, lambda: self.result(MUL, a.op, c))
            elif node.op == "/":
                self.owned(node.lhs, j, a, lambda: self.result(DIV, c, b.op))
                self.owned(node.rhs, j, b, lambda: self.into(a.op, DIV_DEN, c, b.op))
            else:  # ^
                self.owned(node.lhs, j, a, lambda: self.into(c, POW_DB, a.op, b.op))
                self.owned(node.rhs, j, b, lambda: self.into(c, POW_DE, a.op, b.op))
            return
        if node.fn == "sum":
            for k, r in enumerate(rec.kids):
                self.bwd(node.args[0], k, r, c)
        elif node.fn == "abs":
            self.owned(node.args[0], j, rec.kids[0], lambda: self.result(ABS_VJP, rec.kids[0].op, c))
        elif node.fn == "months":
            self.bwd(node.args[0], j, rec.kids[0], c)
        else:  # safe_div, finite_div
            n, den = rec.kids
            cq = self.new_slot()
            self.emit(MOV, cq[1], c)
            if node.fn == "finite_div":
                self.emit(SEL_FIN, cq[1], n.op, den.op)
            else:
                self.emit(SEL_NZ, cq[1], den.op)
            d1 = self.result(DEN1, den.op)
            self.owned(node.args[0], j, n, lambda: self.result(DIV, cq, d1))

            def c_den():
                t = self.into(n.op, DIV_DEN, cq, d1)
                self.emit(SEL_NZ, t[1], den.op)
                return t

            self.owned(node.args[1], j, den, c_den)
            self.release(cq, d1)

    def into(self, init, op: int, a, b) -> tuple:
        """A new slot set to ``init``, then ``op``'s in-place form applied."""
        t = self.new_slot()
        self.emit(MOV, t[1], init)
        self.emit(op, t[1], a, b)
        return t

    def owned(self, node, j: int, rec: _Rec, make) -> None:
        """The reverse of ``node`` from a cotangent that ``make`` emits into a
        new slot, released after it (nothing for a literal)."""
        if rec.literal:
            return
        t = make()
        self.bwd(node, j, rec, t)
        self.release(t)

    def sub_bwd(self, node, j: int, rec: _Rec, c: tuple) -> None:
        """The reverse of ``node`` from ``-c``: a leaf takes ``ACCN``."""
        if rec.literal:
            return
        if _leaf(node):
            self.emit(ACCN, rec.op[1], c)
            return
        self.owned(node, j, rec, lambda: self.result(NEG, c))

    # -- terms ---------------------------------------------------------------
    def begin_term(self) -> None:
        """A term's instructions start here; it takes none of the previous
        term's slots (a term runs apart from the others in K10)."""
        self.starts.append(len(self.rows))

    def head(self, value) -> tuple:
        c = self.new_slot()
        self.emit(HEAD, c[1], value, (FEAT, self.n_terms))
        self.n_terms += 1
        return c

    def end_term(self, *slots) -> None:
        self.release(*self.kept, *slots)
        self.kept = []

    def constraint(self, c: E.Constraint, width: int) -> None:
        from .vjp import literal_constraint

        if literal_constraint(c, self.env):
            self.begin_term()
            v = float(eval_term(c, None, self.env)[0])
            d = self.new_slot()
            self.emit(MUL, d[1], 0.0, (FEAT, 0))
            self.emit(ADD, d[1], v, d)
            ct = self.head(d)
            t = self.result(MUL, 0.0, ct)
            self.emit(ACC, 0, t)
            self.end_term(d, ct, t)
            return
        for j in range(width):
            self.begin_term()
            if c.kind == "member":
                self.member(c, j)
                continue
            a, b = self.fwd(c.lhs, j), self.fwd(c.rhs, j)
            diff = self.result(SUB, a.op, b.op, frees=(a.op, b.op))
            value = self.result(ABS, diff) if c.kind == "eq" else diff
            ct = self.head(value)
            top = self.result(ABS_VJP, diff, ct) if c.kind == "eq" else ct
            self.bwd(c.lhs, j, a, top)
            self.sub_bwd(c.rhs, j, b, top)
            self.end_term(diff, value, ct, top)

    def member(self, c: E.Constraint, j: int) -> None:
        v = self.fwd(c.lhs, j)
        factors = [self.result(SUB, val, v.op) for val in c.rhs]
        partial = [factors[0]]
        for f in factors[1:]:
            partial.append(self.result(MUL, partial[-1], f))
        value = self.result(ABS, partial[-1])
        ct = self.head(value)
        top = self.result(ABS_VJP, partial[-1], ct)
        c_f = [None] * len(factors)
        for k in range(len(factors) - 1, 0, -1):
            c_f[k] = self.result(MUL, partial[k - 1], top)
            top = self.result(MUL, top, factors[k])
        c_f[0] = top
        if _leaf(c.lhs):
            for cf in c_f:
                self.emit(ACCN, v.op[1], cf)
        else:
            cv = self.result(NEG, c_f[0])
            for cf in c_f[1:]:
                self.emit(SUB, cv[1], cv, cf)
            self.bwd(c.lhs, j, v, cv)
            self.release(cv)
        self.kept.append(v.op)
        self.end_term(*factors, *partial[1:], value, ct, *c_f, top)


def _check_vjp_limits(name: str, what: str, low: _Lowering, n_features: int) -> None:
    for kind, count, limit, const in (
        ("features", n_features, SPEC_MAX_FEATURES, "kSpecMaxFeatures"),
        ("terms", low.n_terms, SPEC_MAX_TERMS, "kSpecMaxTerms"),
        ("instructions", len(low.rows), SPEC_VJP_MAX_INSTRUCTIONS, "kSpecVjpMaxInstructions"),
        ("scratch slots", low.n_slots, SPEC_VJP_MAX_SLOTS, "kSpecVjpMaxSlots"),
    ):
        if count > limit:
            raise SpecError(
                f"spec {name!r}'s {what} needs {count} {kind}, more than kernel K10 takes ({const} = {limit} in "
                "kernels/csrc/kernels.h)"
            )


def lower_spec_vjp(resolved: ResolvedSpec, n_features: int) -> SpecProgram:
    """The reverse program of ``resolved`` over rows of ``n_features``: each
    term's forward, its HEAD and its reverse (the order of
    :func:`.vjp.smooth_vjp_ast`); raises :class:`SpecError` naming the limit
    of kernel K10 a spec exceeds."""
    low = _VjpLowering(resolved)
    for c, width in zip(resolved.spec.constraints, resolved.widths):
        low.constraint(c, width)
    _check_vjp_limits(resolved.spec.name, "reverse program", low, n_features)
    return low.program(n_features)._replace(term_start=np.asarray(low.starts + [len(low.rows)], np.int32))


def lower_spec_repair(resolved: ResolvedSpec, schema) -> SpecProgram:
    """The repair program of ``resolved``: each membership snap as
    ``compile_repair``'s midpoint chain (``LT``/``SEL``, then ``+ 0.0 * v``),
    then each assignment in ``_topo_assignments``' order, each ``STORE``-d
    to its feature (the one-hot hardening that follows is kernel K10's, from
    ``PgdTables.ohe``)."""
    from .repair_backend import repair_plan

    low = _Lowering(resolved)
    snaps, order, assignments = repair_plan(resolved, schema)
    for col, values in snaps:
        s = low.new_slot()
        low.emit(MOV, s[1], values[0])
        for k in range(1, len(values)):
            m = low.new_slot()
            low.emit(LT, m[1], (FEAT, col), (values[k - 1] + values[k]) / 2.0)
            low.emit(SEL, s[1], m, values[k])
            low.release(m)
        z = low.new_slot()
        low.emit(MUL, z[1], 0.0, (FEAT, col))
        low.emit(ADD, s[1], s, z)
        low.emit(STORE, col, s)
        low.release(s, z)
    for name in order:
        value = low.lower(assignments[name], 0)
        low.emit(STORE, low.env.col(name), value)
        low.release(value)
    _check_vjp_limits(resolved.spec.name, "repair program", low, schema.n_features)
    return low.program(schema.n_features)


def _decoded(prog: SpecProgram) -> list:
    """``decode(prog.code)`` with each immediate as its float64 value."""
    out = decode(prog.code)
    if prog.imm is None:
        return out
    return [(op, dst, *((k, w) if k != IMM else (k, float(v)) for (k, w), v in zip((a, b), imm)))
            for (op, dst, a, b), imm in zip(out, prog.imm.tolist())]


def _interpret(prog: SpecProgram, x: torch.Tensor, tol: float = 0.0, ct_g=None):
    """Runs ``prog`` over the rows ``x`` (..., D) one torch op at a time, in
    the rows' dtype (an immediate rounded once to it): returns ``(x, terms,
    ct)``, the rows after the program's stores, its terms (K9's TERMs, or the
    HEADs' smooth violations) and the features' cotangents."""
    if x.shape[-1] != prog.n_features:
        raise ValueError(f"the program takes rows of {prog.n_features} features, got {x.shape[-1]}")
    shape = x.shape[:-1]
    slots: list = [None] * prog.n_slots
    g: list = [None] * prog.n_terms
    ct = torch.zeros_like(x)
    x = x.clone()
    one = ops.literal(x, 1.0)
    zero = ops.literal(x, 0.0)

    def operand(o):
        kind, v = o
        if kind == FEAT:
            return x[..., v]
        if kind == SLOT:
            return slots[v]
        return ops.literal(x, v)

    for op, d, a, b in _decoded(prog):
        va = operand(a)
        if op == TERM:
            g[d] = va.expand(shape)
            continue
        if op == HEAD:
            pre = va - tol
            g[b[1]] = torch.clamp(pre, min=0.0).expand(shape)
            r = clip_vjp(pre, ct_g[..., b[1]])
        elif op in (ACC, ACCN):
            ct[..., d] = ct[..., d] + (va if op == ACC else -va)
            continue
        elif op == STORE:
            x[..., d] = va.expand(shape)
            continue
        elif op == MOV:
            r = va
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
        elif op == ABS_VJP:
            r = abs_vjp(va, operand(b))
        elif op == DIV_DEN:
            vb = operand(b)
            r = -((va * (one / (vb * vb))) * slots[d])
        elif op == POW_DB:
            r = slots[d] * pow_base_jac(va, operand(b)).expand(shape)
        elif op == POW_DE:
            r = slots[d] * pow_exp_jac(va, operand(b)).expand(shape)
        elif op == SEL_NZ:
            r = torch.where(va != 0, slots[d], zero)
        elif op == SEL_FIN:
            vb = operand(b)
            r = torch.where((vb != 0) & torch.isfinite(va / vb), slots[d], zero)
        elif op == DEN1:
            r = torch.where(va != 0, va, one)
        elif op == LT:
            r = torch.where(va < operand(b), one, zero)
        elif op == SEL:
            r = torch.where(va != 0, slots[d], operand(b))
        else:
            raise ValueError(f"op code {op} ({OP_NAMES[op] if op < len(OP_NAMES) else '?'}) has no meaning here")
        slots[d] = r.expand(shape)
    return x, g, ct


def contribution_tables(prog: SpecProgram) -> tuple:
    """``(term_start, acc_ptr, acc_idx)`` int32 arrays of a reverse program,
    for kernel K10, which runs its terms side by side: the first instruction
    of each term (and the program's end), and per feature (CSR over the
    features) the indices ``k`` of its ``ACC``/``ACCN`` contributions in
    program order, the order in which they are summed from 0."""
    code = np.asarray(torch.as_tensor(prog.code).cpu())
    ops_ = code[:, 0] & 0xFF
    acc = np.nonzero((ops_ == ACC) | (ops_ == ACCN))[0]
    feats = code[acc, 1]
    order = np.lexsort((np.arange(len(acc)), feats))
    acc_ptr = np.zeros(prog.n_features + 1, np.int32)
    np.add.at(acc_ptr, feats + 1, 1)
    return prog.term_start, np.cumsum(acc_ptr).astype(np.int32), code[acc, 3][order].astype(np.int32)


def run_program_vjp_plain(prog: SpecProgram, u: torch.Tensor, ct_g: torch.Tensor, tol: float):
    """``(g, ct_u)`` of the reverse program ``prog`` on the unscaled rows
    ``u`` (..., D), float32 or float64: the smooth violations (..., K) and
    the cotangent of ``u`` from ``ct_g`` (..., K), the program interpreted
    by torch ops one at a time: the semantics of kernel K10's constraint
    stage, equal to :func:`.vjp.smooth_vjp_ast` bit for bit."""
    _, g, ct = _interpret(prog, u, tol, ct_g)
    return torch.stack(g, dim=-1), ct


def run_repair_plain(prog: SpecProgram, u: torch.Tensor) -> torch.Tensor:
    """The unscaled rows ``u`` (..., D) after the repair program ``prog``'s
    snaps and assignments (before the one-hot hardening), interpreted by
    torch ops one at a time: the semantics of kernel K10's repair stage."""
    return _interpret(prog, u)[0]

"""Constraint-expression AST, parser, canonical form and evaluators.

Port of ``moeva2_ijcai22_replication_tpu/domains/ir/expr.py``: the AST, the
parser, :func:`canon_constraint` and the structural queries are copied as
they are (the spec hash is computed over their output, so it equals the JAX
package's); the evaluators run on torch tensors.

The language covers the reference's operator inventory: arithmetic
``+ - * / ^``, ``abs``, guarded ratios (``safe_div``/``finite_div``), YYYYMM
date arithmetic (``months``), feature aggregates (``sum(@group)``) and
elementwise column-group terms (``@group``), with comparisons ``<=``/``==``
and membership ``in {v1, v2, ...}`` at the constraint level.

Order of operations (the one kernels K1, K8 and K9 keep, one rounded
operation at a time): ``a <= b`` becomes ``a - b``, ``a == b`` becomes
``|a - b|``, ``x in {v1..vk}`` becomes ``|(v1-x)·...·(vk-x)|``
(left-associated); a literal-only subtree folds in Python double and is
rounded once, to the rows' dtype, where it meets a row (a 0-d tensor, so a
division by it is a true division on every device); ``^`` is ``pow`` in
float64, rounded once; ``sum(@g)`` adds left to right; the guarded
divisions keep their mask semantics at a NaN or infinite denominator. So a
compiled spec reproduces ``domains/lcld.py::lcld_constraint_terms`` and
``domains/botnet.py::BotnetConstraints._raw`` bit for bit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from ...core.norms import sum_last
from . import ops


class SpecError(ValueError):
    """A spec failed to parse, resolve, or type-check."""


# -- AST ---------------------------------------------------------------------


@dataclass(frozen=True)
class Num:
    value: float


@dataclass(frozen=True)
class Feat:
    name: str


@dataclass(frozen=True)
class Group:
    name: str


@dataclass(frozen=True)
class Neg:
    arg: object


@dataclass(frozen=True)
class Bin:
    op: str  # + - * / ^
    lhs: object
    rhs: object


@dataclass(frozen=True)
class Call:
    fn: str  # abs | months | safe_div | finite_div | sum
    args: tuple


#: function name -> arity
FUNCTIONS = {"abs": 1, "months": 1, "safe_div": 3, "finite_div": 3, "sum": 1}


@dataclass(frozen=True)
class Constraint:
    """One named constraint: ``le``/``eq`` relate two expressions,
    ``member`` restricts a feature expression to a finite value set."""

    name: str
    kind: str  # le | eq | member
    lhs: object
    rhs: object  # expr for le/eq; tuple[float, ...] for member


# -- parser ------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<group>@[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<op><=|==|[-+*/^(),{}]))"
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise SpecError(f"cannot tokenize {text[pos:]!r} in {text!r}")
        pos = m.end()
        for kind in ("num", "name", "group", "op"):
            val = m.group(kind)
            if val is not None:
                tokens.append((kind, val))
                break
    tokens.append(("end", ""))
    return tokens


class _Parser:
    """Recursive descent over the token list. Precedence (loose to tight):
    comparison, ``+ -``, ``* /`` (left-assoc), unary ``-``, ``^``
    (right-assoc), atoms."""

    def __init__(self, text: str):
        self.text = text
        self.tokens = _tokenize(text)
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, value: str):
        kind, val = self.next()
        if val != value:
            raise SpecError(f"expected {value!r}, got {val!r} in {self.text!r}")

    def parse_constraint(self, name: str) -> Constraint:
        lhs = self.parse_expr()
        kind, val = self.next()
        if val == "<=":
            rhs = self.parse_expr()
            out = Constraint(name, "le", lhs, rhs)
        elif val == "==":
            rhs = self.parse_expr()
            out = Constraint(name, "eq", lhs, rhs)
        elif kind == "name" and val == "in":
            self.expect("{")
            values = [self._member_value()]
            while self.peek()[1] == ",":
                self.next()
                values.append(self._member_value())
            self.expect("}")
            out = Constraint(name, "member", lhs, tuple(values))
        else:
            raise SpecError(
                f"expected <=, == or 'in' after expression in {self.text!r}"
            )
        if self.peek()[0] != "end":
            raise SpecError(f"trailing tokens after constraint in {self.text!r}")
        return out

    def _member_value(self) -> float:
        neg = False
        if self.peek()[1] == "-":
            self.next()
            neg = True
        kind, val = self.next()
        if kind != "num":
            raise SpecError(f"membership sets are numeric literals: {self.text!r}")
        v = float(val)
        return -v if neg else v

    def parse_expr(self):
        node = self.parse_term()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = Bin(op, node, self.parse_term())
        return node

    def parse_term(self):
        node = self.parse_unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = Bin(op, node, self.parse_unary())
        return node

    def parse_unary(self):
        if self.peek()[1] == "-":
            self.next()
            return Neg(self.parse_unary())
        return self.parse_power()

    def parse_power(self):
        base = self.parse_atom()
        if self.peek()[1] == "^":
            self.next()
            return Bin("^", base, self.parse_unary())
        return base

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return Num(float(val))
        if kind == "group":
            return Group(val[1:])
        if kind == "name":
            if self.peek()[1] == "(":
                if val not in FUNCTIONS:
                    raise SpecError(f"unknown function {val!r} in {self.text!r}")
                self.next()
                args = [self.parse_expr()]
                while self.peek()[1] == ",":
                    self.next()
                    args.append(self.parse_expr())
                self.expect(")")
                if len(args) != FUNCTIONS[val]:
                    raise SpecError(
                        f"{val}() takes {FUNCTIONS[val]} args, got {len(args)} "
                        f"in {self.text!r}"
                    )
                return Call(val, tuple(args))
            return Feat(val)
        if val == "(":
            node = self.parse_expr()
            self.expect(")")
            return node
        raise SpecError(f"unexpected token {val!r} in {self.text!r}")


def parse_expr(text: str):
    p = _Parser(text)
    node = p.parse_expr()
    if p.peek()[0] != "end":
        raise SpecError(f"trailing tokens in expression {text!r}")
    return node


def parse_constraint(name: str, text: str) -> Constraint:
    return _Parser(text).parse_constraint(name)


# -- canonical serialization -------------------------------------------------

_PREC = {"+": 1, "-": 1, "*": 2, "/": 2, "neg": 3, "^": 4}


def _canon(node, parent_prec: int = 0, right_of_same: bool = False) -> str:
    if isinstance(node, Num):
        return repr(node.value)
    if isinstance(node, Feat):
        return node.name
    if isinstance(node, Group):
        return f"@{node.name}"
    if isinstance(node, Call):
        return f"{node.fn}({', '.join(_canon(a) for a in node.args)})"
    if isinstance(node, Neg):
        inner = _canon(node.arg, _PREC["neg"])
        text = f"-{inner}"
        return f"({text})" if parent_prec > _PREC["neg"] or right_of_same else text
    if isinstance(node, Bin):
        prec = _PREC[node.op]
        if node.op == "^":  # right-assoc: parenthesize a binop base
            lhs = _canon(node.lhs, prec + 1)
            rhs = _canon(node.rhs, prec)
            text = f"{lhs}{node.op}{rhs}"
        else:
            lhs = _canon(node.lhs, prec)
            rhs = _canon(node.rhs, prec, right_of_same=True)
            text = f"{lhs} {node.op} {rhs}"
        if prec < parent_prec or (right_of_same and prec == parent_prec):
            return f"({text})"
        return text
    raise SpecError(f"cannot serialize {node!r}")


def canon_expr(node) -> str:
    return _canon(node)


def canon_constraint(c: Constraint) -> str:
    if c.kind == "le":
        return f"{_canon(c.lhs)} <= {_canon(c.rhs)}"
    if c.kind == "eq":
        return f"{_canon(c.lhs)} == {_canon(c.rhs)}"
    if c.kind == "member":
        return f"{_canon(c.lhs)} in {{{', '.join(repr(v) for v in c.rhs)}}}"
    raise SpecError(f"unknown constraint kind {c.kind!r}")


# -- structural queries ------------------------------------------------------


def walk(node):
    yield node
    if isinstance(node, Bin):
        yield from walk(node.lhs)
        yield from walk(node.rhs)
    elif isinstance(node, Neg):
        yield from walk(node.arg)
    elif isinstance(node, Call):
        for a in node.args:
            yield from walk(a)


def features_of(node) -> set:
    return {n.name for n in walk(node) if isinstance(n, Feat)}


def groups_of(node) -> set:
    return {n.name for n in walk(node) if isinstance(n, Group)}


def constraint_features(c: Constraint) -> set:
    out = features_of(c.lhs)
    if c.kind != "member":
        out |= features_of(c.rhs)
    return out


# -- numeric evaluation ------------------------------------------------------


class Env:
    """Name resolution for evaluation: feature name -> column index, group
    name -> concatenated numpy index array."""

    def __init__(self, columns: dict, groups: dict):
        self.columns = dict(columns)
        self.groups = dict(groups)

    def col(self, name: str) -> int:
        try:
            return self.columns[name]
        except KeyError:
            raise SpecError(f"undefined feature {name!r}") from None

    def group(self, name: str):
        try:
            return self.groups[name]
        except KeyError:
            raise SpecError(f"undefined group {name!r}") from None


def fold_binary(op: str, a: float, b: float) -> float:
    """A binary operator on two literals, in Python double (the JAX
    evaluator's width-0 arithmetic; ``^`` is numpy's ``power``)."""
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "^":
        return float(np.power(a, b))
    raise SpecError(f"unknown operator {op!r}")


def apply_binary(op: str, a, b):
    """A binary operator where at least one operand is a tensor; a literal
    operand is rounded once to the other's dtype, as a 0-d tensor."""
    like = a if torch.is_tensor(a) else b
    a = a if torch.is_tensor(a) else ops.literal(like, a)
    b = b if torch.is_tensor(b) else ops.literal(like, b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "^":
        return ops.pow_rn(a, b)
    raise SpecError(f"unknown operator {op!r}")


def sentinel_value(node) -> float:
    """The literal sentinel of a ``safe_div``/``finite_div`` call (a number
    or a negated number)."""
    s = node.args[2]
    if not isinstance(s, (Num, Neg)) or (isinstance(s, Neg) and not isinstance(s.arg, Num)):
        raise SpecError(f"{node.fn}() sentinel must be a literal")
    return s.value if isinstance(s, Num) else -s.arg.value


def eval_expr(node, x, env: Env):
    """Evaluate to ``(value, width)``: width 0 = a Python float (a literal,
    folded in double), 1 = per-row tensor ``(...)``, k>1 = per-row vector
    ``(..., k)``. A width-1 operand meets a width-k one through
    ``[..., None]`` (:func:`_align`); a literal meets a row as a 0-d tensor
    of the rows' dtype."""
    if isinstance(node, Num):
        return node.value, 0
    if isinstance(node, Feat):
        return x[..., env.col(node.name)], 1
    if isinstance(node, Group):
        idx = env.group(node.name)
        return x[..., torch.as_tensor(idx, device=x.device)], len(idx)
    if isinstance(node, Neg):
        v, w = eval_expr(node.arg, x, env)
        return -v, w
    if isinstance(node, Bin):
        a, wa = eval_expr(node.lhs, x, env)
        b, wb = eval_expr(node.rhs, x, env)
        a, b, w = _align(a, wa, b, wb)
        if w == 0:
            return fold_binary(node.op, a, b), 0
        return apply_binary(node.op, a, b), w
    if isinstance(node, Call):
        if node.fn == "sum":
            v, w = eval_expr(node.args[0], x, env)
            if w < 2:
                raise SpecError("sum() takes a @group argument")
            return sum_last(v), 1
        if node.fn == "abs":
            v, w = eval_expr(node.args[0], x, env)
            return (torch.abs(v) if w else abs(v)), w
        if node.fn == "months":
            v, w = eval_expr(node.args[0], x, env)
            return (ops.months(v) if w else float(ops.months(v))), w
        if node.fn in ("safe_div", "finite_div"):
            n, wn = eval_expr(node.args[0], x, env)
            d, wd = eval_expr(node.args[1], x, env)
            sval = sentinel_value(node)
            n, d, w = _align(n, wn, d, wd)
            fn = ops.safe_div if node.fn == "safe_div" else ops.finite_div
            if w == 0:
                with np.errstate(divide="ignore", invalid="ignore"):
                    return float(fn(n, d, sval)), 0
            like = n if torch.is_tensor(n) else d
            n = n if torch.is_tensor(n) else ops.literal(like, n)
            d = d if torch.is_tensor(d) else ops.literal(like, d)
            return fn(n, d, sval), w
        raise SpecError(f"unknown function {node.fn!r}")
    raise SpecError(f"cannot evaluate {node!r}")


def _align(a, wa, b, wb):
    """Broadcast a width-1 scalar array against a width-k vector."""
    if wa == wb or wa == 0 or wb == 0:
        return a, b, max(wa, wb)
    if wa == 1:
        return a[..., None], b, wb
    if wb == 1:
        return a, b[..., None], wa
    raise SpecError(f"group width mismatch: {wa} vs {wb}")


def eval_term(c: Constraint, x, env: Env):
    """One constraint's unthresholded violation term ``(value, width)``."""
    if c.kind in ("le", "eq"):
        a, wa = eval_expr(c.lhs, x, env)
        b, wb = eval_expr(c.rhs, x, env)
        a, b, w = _align(a, wa, b, wb)
        v = fold_binary("-", a, b) if w == 0 else apply_binary("-", a, b)
        if c.kind == "eq":
            v = abs(v) if w == 0 else torch.abs(v)
        return v, w
    if c.kind == "member":
        v, w = eval_expr(c.lhs, x, env)
        if w == 0:
            prod = c.rhs[0] - v
            for val in c.rhs[1:]:
                prod = prod * (val - v)
            return abs(prod), 0
        prod = apply_binary("-", c.rhs[0], v)
        for val in c.rhs[1:]:
            prod = prod * apply_binary("-", val, v)
        return torch.abs(prod), w
    raise SpecError(f"unknown constraint kind {c.kind!r}")

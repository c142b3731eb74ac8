"""The backward of a spec's smooth violations, walked over its AST.

Constrained PGD differentiates ``evaluate_smooth = clip(raw_terms(u) - tol,
0, inf)`` by hand, with ``jax.grad``'s conventions (``core/vjp.py``).
:func:`smooth_vjp_ast` is the semantic twin of the reverse program that
:func:`.program.lower_spec_vjp` emits for kernel K10 and that
:func:`.program.run_program_vjp_plain` interprets: the two agree bit for
bit, in float32 and in float64.

Order of operations, one rounded operation at a time:

- the terms in ``raw_terms``' order, a group term element by element (a
  width-1 operand of it is evaluated again for each element), each term's
  forward in :func:`.expr.eval_term`'s operations;
- each term's head: ``pre = raw - tol``, ``g = clip(pre, 0, inf)`` and the
  cotangent ``clip_vjp(pre, ct_g)``;
- then its reverse, depth first, the left operand's subtree before the
  right one's, so that the features' contributions come in the order the
  leaves are read; each leaf's contribution is added at once to its
  feature's cotangent, which starts at 0: every feature sums its
  contributions term by term, in term order (``lcld_smooth_vjp``'s and
  ``BotnetConstraints.smooth_vjp``'s order). A member constraint on a bare
  feature adds one contribution per factor, in factor order; on a compound
  expression the factors' contributions are summed in factor order first.
"""

from __future__ import annotations

import torch

from ...core.vjp import (
    abs_vjp, clip_vjp, div_vjp, guarded_div_vjp, literal_term_vjp, member_vjp, months_vjp, neg_vjp,
    pow_base_jac, pow_exp_jac,
)
from . import expr as E
from . import ops
from .expr import SpecError, apply_binary, eval_expr, sentinel_value
from .spec import ResolvedSpec, _width_of


class _Rec:
    """A node's forward value (a Python float for a literal subtree) and its
    children's records."""

    __slots__ = ("value", "kids")

    def __init__(self, value, kids=()):
        self.value = value
        self.kids = kids

    @property
    def literal(self) -> bool:
        return not torch.is_tensor(self.value)


def _tensor(value, like):
    return value if torch.is_tensor(value) else ops.literal(like, value)


class _Walk:
    """One term's forward and reverse over rows ``x`` (..., D), adding into
    ``ct`` (..., D)."""

    def __init__(self, x, env, ct):
        self.x = x
        self.env = env
        self.ct = ct

    # -- forward -------------------------------------------------------------
    def fwd(self, node, j: int) -> _Rec:
        if _width_of(node, self.env) == 0:
            return _Rec(float(eval_expr(node, None, self.env)[0]))
        if isinstance(node, E.Feat):
            return _Rec(self.x[..., self.env.col(node.name)])
        if isinstance(node, E.Group):
            return _Rec(self.x[..., int(self.env.group(node.name)[j])])
        if isinstance(node, E.Neg):
            a = self.fwd(node.arg, j)
            return _Rec(-a.value, (a,))
        if isinstance(node, E.Bin):
            a, b = self.fwd(node.lhs, j), self.fwd(node.rhs, j)
            return _Rec(apply_binary(node.op, a.value, b.value), (a, b))
        if isinstance(node, E.Call):
            if node.fn == "sum":
                width = _width_of(node.args[0], self.env)
                if width < 2:
                    raise SpecError("sum() takes a @group argument")
                kids = tuple(self.fwd(node.args[0], k) for k in range(width))
                acc = kids[0].value
                for k in kids[1:]:
                    acc = apply_binary("+", acc, k.value)
                return _Rec(acc, kids)
            if node.fn in ("abs", "months"):
                a = self.fwd(node.args[0], j)
                return _Rec(torch.abs(a.value) if node.fn == "abs" else ops.months(a.value), (a,))
            if node.fn in ("safe_div", "finite_div"):
                n, d = self.fwd(node.args[0], j), self.fwd(node.args[1], j)
                like = n.value if torch.is_tensor(n.value) else d.value
                fn = ops.safe_div if node.fn == "safe_div" else ops.finite_div
                return _Rec(fn(_tensor(n.value, like), _tensor(d.value, like), sentinel_value(node)), (n, d))
        raise SpecError(f"cannot differentiate {node!r}")

    # -- reverse -------------------------------------------------------------
    def leaf(self, col: int, c) -> None:
        self.ct[..., col] = self.ct[..., col] + c

    def bwd(self, node, j: int, rec: _Rec, c) -> None:
        """Send ``c``, ``node``'s cotangent, to the features under it."""
        if rec.literal:
            return
        if isinstance(node, E.Feat):
            self.leaf(self.env.col(node.name), c)
        elif isinstance(node, E.Group):
            self.leaf(int(self.env.group(node.name)[j]), c)
        elif isinstance(node, E.Neg):
            self.bwd(node.arg, j, rec.kids[0], neg_vjp(c))
        elif isinstance(node, E.Bin):
            a, b = rec.kids
            kids = (node.lhs, node.rhs)
            if node.op == "+":
                cts = (c, c)
            elif node.op == "-":
                cts = (c, None if b.literal else neg_vjp(c))
            elif node.op == "*":
                cts = (None if a.literal else c * _tensor(b.value, c), None if b.literal else _tensor(a.value, c) * c)
            elif node.op == "/":
                num, den = _tensor(a.value, c), _tensor(b.value, c)
                c_num, c_den = div_vjp(c, num, den)
                cts = (c_num, c_den)
            else:  # ^
                base, t = _tensor(a.value, c), _tensor(b.value, c)
                cts = (None if a.literal else c * pow_base_jac(base, t).expand(c.shape),
                       None if b.literal else c * pow_exp_jac(base, t).expand(c.shape))
            for kid, r, ct in zip(kids, rec.kids, cts):
                if ct is not None:
                    self.bwd(kid, j, r, ct)
        elif node.fn == "sum":
            for k, r in enumerate(rec.kids):
                self.bwd(node.args[0], k, r, c)
        elif node.fn == "abs":
            self.bwd(node.args[0], j, rec.kids[0], abs_vjp(rec.kids[0].value, c))
        elif node.fn == "months":
            self.bwd(node.args[0], j, rec.kids[0], months_vjp(c))
        else:  # safe_div, finite_div
            n, d = rec.kids
            c_num, c_den = guarded_div_vjp(c, _tensor(n.value, c), _tensor(d.value, c), node.fn == "finite_div")
            self.bwd(node.args[0], j, n, c_num)
            self.bwd(node.args[1], j, d, c_den)

    # -- a term --------------------------------------------------------------
    def term(self, c_con: E.Constraint, j: int, tol: float, ct_g):
        """Term element ``j`` of constraint ``c_con``: its smooth violation,
        its reverse added into ``ct``."""
        x = self.x
        if c_con.kind == "member":
            v = self.fwd(c_con.lhs, j)
            factors = [apply_binary("-", val, v.value) for val in c_con.rhs]
            prod = factors[0]
            for f in factors[1:]:
                prod = prod * f
            raw = torch.abs(prod)
        else:
            a, b = self.fwd(c_con.lhs, j), self.fwd(c_con.rhs, j)
            raw = diff = apply_binary("-", a.value, b.value)
            if c_con.kind == "eq":
                raw = torch.abs(diff)
        pre = raw - tol
        c = clip_vjp(pre, ct_g)
        if c_con.kind == "member":
            c_f = member_vjp(abs_vjp(prod, c), factors)
            if isinstance(c_con.lhs, (E.Feat, E.Group)):
                for cf in c_f:
                    self.bwd(c_con.lhs, j, v, neg_vjp(cf))
            else:
                c_v = neg_vjp(c_f[0])
                for cf in c_f[1:]:
                    c_v = c_v - cf
                self.bwd(c_con.lhs, j, v, c_v)
        else:
            if c_con.kind == "eq":
                c = abs_vjp(diff, c)
            self.bwd(c_con.lhs, j, a, c)
            if not b.literal:
                self.bwd(c_con.rhs, j, b, neg_vjp(c))
        return torch.clamp(pre, min=0.0).expand(x.shape[:-1])


def literal_constraint(c: E.Constraint, env) -> bool:
    """A constraint whose expressions hold no feature: ``raw_terms``
    broadcasts it per row as ``v + 0.0 * x[..., 0]``."""
    if c.kind == "member":
        return _width_of(c.lhs, env) == 0
    return _width_of(c.lhs, env) == 0 and _width_of(c.rhs, env) == 0


def smooth_vjp_ast(resolved: ResolvedSpec, u: torch.Tensor, ct_g: torch.Tensor, tol: float):
    """``(g, ct_u)``: the smooth violations ``clip(raw_terms(u) - tol, 0,
    inf)`` (..., K) of the unscaled rows ``u`` (..., D) and the cotangent of
    ``u`` from ``ct_g`` (..., K), walked over the spec's AST (the module's
    order of operations)."""
    env = resolved.env
    ct = torch.zeros_like(u)
    walk = _Walk(u, env, ct)
    g, t = [], 0
    for c_con, width in zip(resolved.spec.constraints, resolved.widths):
        if literal_constraint(c_con, env):
            v = float(E.eval_term(c_con, None, env)[0])
            pre = (ops.literal(u, v) + ops.literal(u, 0.0) * u[..., 0]) - tol
            walk.leaf(0, literal_term_vjp(clip_vjp(pre, ct_g[..., t])))
            g.append(torch.clamp(pre, min=0.0))
            t += 1
            continue
        for j in range(max(width, 1)):
            g.append(walk.term(c_con, j, tol, ct_g[..., t]))
            t += 1
    return torch.stack(g, dim=-1), ct

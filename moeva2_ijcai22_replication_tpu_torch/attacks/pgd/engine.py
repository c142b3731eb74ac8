"""Constrained PGD: the gradient attack with the constraint set in the loss.

Port of ``moeva2_ijcai22_replication_tpu/attacks/pgd/engine.py``:
:class:`ConstrainedPGD` with every ``loss_evaluation`` (flip, constraints,
constraints+flip and its +alternate, +constraints and +manual schedules,
``adaptive_eps_step``, ``repair``), every ``constraints_optim`` (the sum,
``alt_constraints``, ``single_constraints``), targeted attacks, norms 2 and
inf, random restarts with JAX's arbitration (a row that never succeeds
returns ``x_init``), the recorded loss history and the per-restart quality
history; and :func:`round_ints_toward_initial`.

Left out, because they exist for JAX's compiler and devices only: the
device mesh, the cost ledger and ``LedgeredJit`` (with ``trace_count``,
``last_run_executables`` and the rule that a program recording history bakes
its budget: here any budget runs, with or without history) and the
dispatch-gap tracker.

One run (:func:`pgd_run_plain`, JAX's ``_one_run``) repeats, ``max_iter``
times: the gradient of the iteration's weighted loss and its terms
(:func:`grad_and_terms_plain`, JAX's ``jax.grad`` of ``_grad_and_terms``),
NaN entries zeroed, immutable features masked, norm conditioning, the
step, the clip, the ε-ball projection, the clip again and, with
``repair``, the constraint repair. Two rules keep it exact and its kernel
simple:

- what depends on the iteration alone (the loss weights, the step size
  and the constraint that ``constraints_optim`` picks) is a table of
  ``max_iter`` rows built once on the host in the run's dtype
  (:func:`make_schedule`), read by the plain version and the kernel alike;
- random starts are inputs: :meth:`ConstrainedPGD.attack` takes them, and
  :meth:`ConstrainedPGD.generate` draws them from the attack's Philox
  stream (``core.philox``, keyed by ``seed``): on the card one launch of
  kernel K0's PGD instantiation (``pgd_start``) a start, which also writes
  it, on the CPU :func:`pgd_start_plain` (JAX's threefry draws cannot be
  reproduced, so tests feed JAX's starts).

The gradient is hand-written with ``jax.grad``'s conventions (abs, clip and
relu at their edges; NaN kept through every product, then zeroed): the
MLP's backward is :func:`..models.mlp.mlp_input_grad_plain`, the
constraints' the set's ``smooth_vjp``. On CUDA tensors a run is one launch
of the set's PGD kernel (``pgd_kernel``): K7 (``kernels/csrc/pgd_lcld.cu``)
on LCLD, K7b (``kernels/csrc/pgd_botnet.cu``) on botnet and its
augmented variant, K10 (``kernels/csrc/pgd_spec.cu``) on a domain compiled
from a spec, each repeating this plain version's operations in its order;
on CPU tensors :func:`pgd_run_plain` runs. Nothing on the card's path
calls the plain version. A ``+repair`` loss on a set without repair (the
augmented botnet domain, as in JAX) raises before anything runs.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ... import resolve_device
from ...core.codec import full_ohe_tables
from ...core.constraints import ConstraintSet
from ...core.norms import condition_grad, is_inf, project_ball, sqrt_rn, sum_last, validate_norm
from ...core.philox import NORMAL, SYMMETRIC, UNIFORM, Field, PhiloxStream, draw_plain, layout
from ...models.io import Surrogate
from ...models.mlp import exp_rn as _exp_rn
from ...models.mlp import mlp_forward_plain, mlp_input_grad_plain, mlp_proba_plain
from ...models.scalers import MinMaxParams


class PgdSchedule(NamedTuple):
    """What each iteration of a run reads, one row per iteration."""

    w_class: torch.Tensor  # (T,) weight of the classification loss
    w_cons: torch.Tensor  # (T,) weight of the constraint loss
    step: torch.Tensor  # (T,) step size
    ctr: torch.Tensor  # (T,) int32: the constraint optimised, -1 = their sum


class PgdTables(NamedTuple):
    """What a run needs besides its rows, on the attack's device and in its
    dtype."""

    layers: tuple  # ((weight (out, in), bias (out,)), ...) of the relu stack
    params: torch.Tensor  # the same weights flat, each layer's weight then its bias
    first_t: torch.Tensor  # (D, widths[1]) the first layer's weight transposed
    scale: torch.Tensor  # (D,) the classifier's scaler: x_scaled = x * scale + min_
    min_: torch.Tensor  # (D,)
    mutable: torch.Tensor  # (D,) bool
    ohe: torch.Tensor  # (G, K) int32 feature of each one-hot slot, -1 = padding
    tol: float  # constraint tolerance
    cons: Any  # the set's kernel tables (``kernel_tables``), None where the kernel hard-codes the terms


def make_schedule(
    loss_evaluation: str, constraints_optim: str, ctr_id: int, alternate_frequency: int,
    n_constraints: int, eps: float, eps_step: float, max_iter: int, dtype, device,
) -> PgdSchedule:
    """The iteration tables of one run, as JAX's ``_loss_weights``,
    ``_step_size`` and ``_loss_terms`` give them per iteration. The adaptive
    step ``eps * 10 ** -p`` is numpy's ``pow`` in the run's dtype, which
    can differ from XLA's in the last ulp (at p = 5 in float32 on the CPU)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    i = np.arange(max_iter)
    le = loss_evaluation
    if "constraints+flip+manual" in le:
        w_class = i < 100
    elif "constraints+flip+constraints" in le:
        w_class = i < max_iter // 2
    elif "constraints+flip+alternate" in le:
        w_class = (i // alternate_frequency) % 2 == 1
    else:
        w_class = None
    if w_class is not None:
        w_class = w_class.astype(np_dt)
        w_cons = np_dt(1.0) - w_class
    elif "constraints+flip" in le:
        w_class, w_cons = np.ones(max_iter, np_dt), np.ones(max_iter, np_dt)
    elif "constraints" in le:
        w_class, w_cons = np.zeros(max_iter, np_dt), np.ones(max_iter, np_dt)
    else:  # flip
        w_class, w_cons = np.ones(max_iter, np_dt), np.zeros(max_iter, np_dt)
    if "adaptive_eps_step" in le:
        power = (i // max(max_iter // 7, 1) + 1).astype(np_dt)
        step = np_dt(eps) * np.power(np_dt(10.0), -power)
    else:
        step = np.full(max_iter, np_dt(eps_step))
    if "alt_constraints" in constraints_optim:
        ctr = i % n_constraints
    elif "single_constraints" in constraints_optim:
        ctr = np.full(max_iter, ctr_id)
    else:
        ctr = np.full(max_iter, -1)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return PgdSchedule(as_t(w_class), as_t(w_cons), as_t(step), as_t(ctr.astype(np.int32)))


def grad_and_terms_plain(tables: PgdTables, constraints, x, y, w_class, w_cons, ctr: int, targeted: bool):
    """``(grad, per, loss_class, cons, g)`` of JAX's ``_grad_and_terms``:
    the gradient of ``per = w_class * loss_class - w_cons * cons`` summed
    over the rows of ``x`` (N, D) scaled, and its terms per row.
    ``loss_class`` is the cross-entropy ``-Σ onehot(y) * log_softmax``
    (negated when ``targeted``; 0 for a 1-column head), ``g`` the smooth
    violations of the unscaled rows and ``cons`` their sum (``ctr`` < 0) or
    the one of index ``ctr``. ``w_class``/``w_cons`` are 0-d tensors.

    In float32 every operation is rounded once, in the order kernels K7
    and K7b keep: the MLP as :func:`mlp_forward_plain` and
    :func:`mlp_input_grad_plain`; ``exp`` and ``log`` in float64 rounded
    once; log_softmax's backward as JAX transposes it (``ct_ls + (Σ -ct_ls /
    Σ e) * e``); the constraint branch through ``constraints.smooth_vjp``
    and the scaler's true division; the two cotangents of x added last."""
    scale, min_ = tables.scale, tables.min_
    acts = mlp_forward_plain(tables.layers, x)
    logits = acts[-1]
    y1h = (y[:, None] == torch.arange(logits.shape[-1], device=y.device)).to(x.dtype)
    s = logits - logits.amax(-1, keepdim=True)
    e = _exp_rn(s)
    total = sum_last(e, keepdim=True)
    ls = s - torch.log(total.double()).to(x.dtype)
    ce = -sum_last(y1h * ls)
    loss_class = -ce if targeted else ce

    ct_cons = -w_cons
    n_cons = constraints.n_constraints
    if ctr < 0:
        ct_g = ct_cons.expand(x.shape[0], n_cons)
    else:
        ct_g = torch.zeros((x.shape[0], n_cons), dtype=x.dtype, device=x.device)
        ct_g[:, ctr] = ct_cons
    g, ct_u = constraints.smooth_vjp((x - min_) / scale, ct_g)
    cons = sum_last(g) if ctr < 0 else g[:, ctr]
    per = w_class * loss_class + w_cons * (-cons)

    ct_ls = (w_class if targeted else -w_class) * y1h
    ct_logits = ct_ls + (sum_last(-ct_ls, keepdim=True) / total) * e
    grad = mlp_input_grad_plain(tables.layers, acts, ct_logits) + ct_u / scale
    return grad, per, loss_class, cons, g


def predict_plain(tables: PgdTables, x) -> torch.Tensor:
    """(N,) int64 class of each row: the first largest probability of
    ``mlp_proba_plain`` (a NaN counts as the largest)."""
    return torch.argmax(mlp_proba_plain(tables.layers, x), dim=-1)


def pgd_run_plain(
    tables: PgdTables, constraints, sched: PgdSchedule, x_init, y, x_start, eps: float, clip: tuple,
    norm, repair: bool, targeted: bool, record=None,
):
    """One run of JAX's ``_one_run`` from ``x_start`` (N, D): ``(x_adv,
    pred, hist)``, with ``pred`` the class :func:`predict_plain` gives at
    ``x_adv`` and ``hist`` (T, N, C) the recorded columns [per,
    loss_class, cons] (+ the L2 norm of the finite entries of the raw
    gradient when ``record[0]``, + the set's K violations when
    ``record[1]``), or None when ``record`` is None. The semantics of
    kernels K7 and K7b, one rounded operation at a time in their order."""
    lo, hi = clip
    x = x_start
    hist = []
    ctrs = sched.ctr.tolist()
    for i in range(len(ctrs)):
        grad, per, loss_class, cons, g = grad_and_terms_plain(
            tables, constraints, x, y, sched.w_class[i], sched.w_cons[i], ctrs[i], targeted
        )
        if record is not None:
            hist.append(hist_row(record, per, loss_class, cons, g, grad))
        grad = conditioned_grad(tables, grad, norm)
        x = torch.clamp(x + sched.step[i] * grad, lo, hi)
        x = torch.clamp(x_init + project_ball(x - x_init, eps, norm), lo, hi)
        if repair:
            x = repair_plain(tables, constraints, x)
    return x, predict_plain(tables, x), stack_hist(hist, record, constraints, x)


def hist_row(record, per, loss_class, cons, g, grad):
    """(N, C) recorded columns of one iteration: [per, loss_class, cons]
    (+ the L2 norm of the raw gradient's finite entries when ``record[0]``,
    + the violations ``g`` when ``record[1]``)."""
    cols = [per, loss_class, cons]
    if record[0]:
        finite = torch.nan_to_num(grad, nan=0.0, posinf=0.0, neginf=0.0)
        cols.append(sqrt_rn(sum_last(finite * finite)))
    if record[1]:
        cols += list(g.unbind(-1))
    return torch.stack(cols, dim=-1)


def stack_hist(hist: list, record, constraints, x):
    """The run's history (T, N, C) from its rows, None when ``record`` is."""
    if record is None:
        return None
    n_cols = 3 + bool(record[0]) + (constraints.n_constraints if record[1] else 0)
    return torch.stack(hist) if hist else x.new_zeros((0, x.shape[0], n_cols))


def conditioned_grad(tables: PgdTables, grad, norm):
    """The ascent direction: NaN entries zeroed, immutable features masked,
    then ``condition_grad``."""
    grad = torch.where(torch.isnan(grad), 0.0, grad)
    grad = torch.where(tables.mutable, grad, 0.0)
    return condition_grad(grad, norm)


def repair_plain(tables: PgdTables, constraints, x):
    """The constraint repair of the scaled rows ``x``, kept on the mutable
    features (an immutable one keeps its x)."""
    fixed = constraints.repair((x - tables.min_) / tables.scale) * tables.scale + tables.min_
    return torch.where(tables.mutable, fixed, x)


def start_fields(norm, n: int, d: int) -> list:
    """The Philox fields of one random start of ``n`` rows of ``d``
    features: uniforms on [-1, 1) under L∞; under L2 a normal direction and
    a uniform for the radius."""
    if is_inf(norm):
        return [Field("dir", SYMMETRIC, (n, d))]
    return [Field("dir", NORMAL, (n, d)), Field("radius", UNIFORM, (n, 1))]


def _scalar(like: torch.Tensor, v: float) -> torch.Tensor:
    # a 0-d tensor: dividing by it is a true division on the card too
    return torch.full((), v, dtype=like.dtype, device=like.device)


def pgd_start_plain(fields, key: int, base: int, x_init, mutable, eps: float, clip: tuple, norm_inf: bool):
    """A random start in the ε-ball around ``x_init`` (JAX's
    ``_random_start`` on the Philox call ``fields`` whose first block is
    ``base``), the semantics of K0's ``pgd_start``: ``eps * u`` per feature
    of the uniforms on [-1, 1) under L∞; under L2 the row's normals over
    their norm (a left-to-right sum, a correctly rounded sqrt, + 1e-12),
    times ``eps * U ** (1 / D)`` (the pow in float64, rounded once); on
    mutable features only, clipped to ``clip``."""
    out = draw_plain(fields, x_init.dtype, key, base, x_init.device)
    if norm_inf:
        pert = _scalar(x_init, eps) * out["dir"]
    else:
        d = out["dir"]
        d = d / (sqrt_rn(sum_last(d * d, keepdim=True)) + _scalar(d, 1e-12))
        radius = _scalar(d, eps) * (out["radius"].double() ** (1.0 / x_init.shape[-1])).to(d.dtype)
        pert = d * radius
    return torch.clamp(x_init + torch.where(mutable, pert, 0.0), *clip)


def card_refusal(constraints) -> str | None:
    """Why constrained PGD on ``constraints`` cannot run on the card (the
    set has no PGD kernel, ``pgd_kernel``), or None."""
    if constraints.pgd_kernel is not None:
        return None
    return f"{type(constraints).__name__} has no PGD kernel (pgd_kernel): its runs cannot go on the card"


@dataclass
class ConstrainedPGD:
    """PGD in the classifier's scaled feature space with the domain's
    constraints folded into the loss; the knobs are the JAX engine's.
    ``device`` defaults to the card."""

    classifier: Surrogate
    constraints: ConstraintSet
    scaler: MinMaxParams  # classifier input scaler (attack space = scaled)
    eps: float = 0.3
    eps_step: float = 0.1
    max_iter: int = 100
    norm: Any = np.inf
    loss_evaluation: str = "flip"
    constraints_optim: str = "sum"
    ctr_id: int = 0
    alternate_frequency: int = 5
    targeted: bool = False
    num_random_init: int = 0
    clip: tuple = (0.0, 1.0)
    seed: int = 0
    dtype: torch.dtype = torch.float32
    #: "reduced" records [loss, loss_class, cons_sum] per iteration, "full"
    #: appends the per-constraint violations; ``loss_history`` (N, T, C)
    #: after ``generate``
    record_loss: str | None = None
    #: with ``record_loss``, also the L2 norm of the raw loss gradient's
    #: finite entries, after cons_sum
    record_grad_norm: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        validate_norm(self.norm)
        name = type(self.constraints).__name__
        if type(self.constraints).smooth_vjp is ConstraintSet.smooth_vjp:
            raise NotImplementedError(f"{name} has no hand-written constraint backward (smooth_vjp): PGD cannot "
                                      "differentiate its terms")
        if self.device.type == "cuda" and (why := card_refusal(self.constraints)):
            raise NotImplementedError(why)
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise NotImplementedError(f"the card's kernels take float32, not {self.dtype}")
        if "single_constraints" in self.constraints_optim and not 0 <= self.ctr_id < self.constraints.n_constraints:
            raise ValueError(f"ctr_id={self.ctr_id} is not a constraint of {name}")
        # a private, frozen copy in the attack's dtype on its device
        self._model = copy.deepcopy(self.classifier.model).to(
            device=self.device, dtype=self.dtype
        ).eval().requires_grad_(False)
        layers = tuple((layer.weight, layer.bias) for layer in self._model.layers)
        scale, min_ = self.scaler.tensors(torch.empty((), dtype=self.dtype, device=self.device))
        ohe_idx, ohe_mask = full_ohe_tables(self.constraints.schema)
        self.tables = PgdTables(
            layers=layers,
            params=torch.cat([t.reshape(-1) for pair in layers for t in pair]),
            first_t=layers[0][0].t().contiguous(),
            scale=scale,
            min_=min_,
            mutable=torch.as_tensor(np.asarray(self.constraints.get_mutable_mask(), bool), device=self.device),
            ohe=ohe_idx.masked_fill(~ohe_mask, -1).to(device=self.device, dtype=torch.int32),
            tol=float(self.constraints.tol),
            cons=self.constraints.pgd_kernel_tables(self.device),
        )
        self.loss_history: np.ndarray | None = None
        #: without restarts None; else ``restart_success`` (R, N), the
        #: cumulative per-row success after each restart, and
        #: ``restart_flip_frac``, its per-restart mean
        self.quality_history: dict | None = None

    # -- history layout --------------------------------------------------------
    def hist_column_names(self) -> list[str]:
        """[loss, loss_class, cons_sum] (+ grad_norm) (+ g1..gK for "full")."""
        if not self.record_loss:
            return []
        names = ["loss", "loss_class", "cons_sum"]
        if self.record_grad_norm:
            names.append("grad_norm")
        if "full" in self.record_loss:
            names += [f"g{i + 1}" for i in range(self.constraints.n_constraints)]
        return names

    def history_layout(self):
        """``(grad_norm, full)`` of the recorded history, None without one:
        the ``record`` argument of :func:`pgd_run_plain`, K7 and K7b."""
        if not self.record_loss:
            return None
        return (bool(self.record_grad_norm), "full" in self.record_loss)

    # -- the attack ------------------------------------------------------------
    def schedule(self, eps: float, eps_step: float, max_iter: int) -> PgdSchedule:
        return make_schedule(
            self.loss_evaluation, self.constraints_optim, self.ctr_id, self.alternate_frequency,
            self.constraints.n_constraints, eps, eps_step, max_iter, self.dtype, self.device,
        )

    def random_start(self, stream: PhiloxStream, x_init: torch.Tensor, eps: float) -> torch.Tensor:
        """A random start in the ε-ball around ``x_init``, on mutable
        features only, clipped (JAX's ``_random_start`` on the Philox
        ``stream``'s next call of :func:`start_fields`): K0's ``pgd_start``
        on the card, :func:`pgd_start_plain` on the CPU."""
        fields = start_fields(self.norm, *x_init.shape)
        base = stream.take(layout(fields, x_init.dtype)[1])
        args = (fields, stream.key, base, x_init, self.tables.mutable, eps, self.clip, is_inf(self.norm))
        if x_init.is_cuda:
            from ...kernels import pgd_start

            return pgd_start(*args)
        return pgd_start_plain(*args)

    def one_run(self, x_init, y, x_start, sched: PgdSchedule, eps: float):
        """``(x_adv, pred, hist)`` of one run: the set's kernel (K7, K7b or
        K10) on the card, :func:`pgd_run_plain` on the CPU."""
        repair = "repair" in self.loss_evaluation
        if x_init.is_cuda:
            from ... import kernels

            launch = {"lcld": kernels.pgd_lcld, "botnet": kernels.pgd_botnet, "spec": kernels.pgd_spec}[
                self.constraints.pgd_kernel]
            return launch(
                self.tables, sched, x_init, y, x_start, eps, self.clip, is_inf(self.norm), repair,
                self.targeted, self.history_layout(),
            )
        return pgd_run_plain(
            self.tables, self.constraints, sched, x_init, y, x_start, eps, self.clip, self.norm, repair,
            self.targeted, self.history_layout(),
        )

    def attack(self, x_init, y, sched: PgdSchedule, eps: float, starts=None, n_starts: int | None = None):
        """``(x_adv, hist, restart_success)`` for tensors on the attack's
        device. Without ``starts`` one run from ``x_init`` whose result is
        returned as it is; else one run per start (a sequence of (N, D)
        tensors, or any iterable of ``n_starts`` of them, drawn one at a
        time), a row keeping the first run that flips it (that hits the
        target when ``targeted``) and ``x_init`` when none does, its history
        following the kept run (an unsuccessful row's the latest run), and
        ``restart_success`` (R, N) the cumulative success after each run.
        A ``+repair`` loss on a set without repair (``repair_undefined``)
        raises its ``NotImplementedError`` before anything runs."""
        n = x_init.shape[0]
        if "repair" in self.loss_evaluation and self.constraints.repair_undefined:
            # JAX raises it while it traces the run, before anything runs on
            # its device; here before any random start or run launches
            raise NotImplementedError(self.constraints.repair_undefined)
        if starts is None:
            x_adv, _, hist = self.one_run(x_init, y, x_init, sched, eps)
            return x_adv, hist, torch.zeros((0, n), dtype=torch.bool, device=x_init.device)
        n_starts = len(starts) if n_starts is None else n_starts
        best_x, best_hist = x_init, None
        curve = torch.empty((n_starts, n), dtype=torch.bool, device=x_init.device)
        ran = 0
        for r, x_start in enumerate(starts):
            x_adv, pred, hist = self.one_run(x_init, y, x_start, sched, eps)
            best_x, best_hist = restart(x_adv, pred, y, hist, best_x, best_hist, curve, r, self.targeted)
            ran = r + 1
        if ran != n_starts:
            raise ValueError(f"{ran} starts given, {n_starts} announced")
        return best_x, best_hist, curve

    @torch.inference_mode()
    def generate(self, x_scaled: np.ndarray, y: np.ndarray, *, eps: float | None = None,
                 eps_step: float | None = None, max_iter: int | None = None) -> np.ndarray:
        """Attack scaled candidates ``x_scaled`` (N, D) with true labels
        ``y`` (N,); ``eps``, ``eps_step`` and ``max_iter`` default to the
        constructor's values."""
        eps = self.eps if eps is None else eps
        eps_step = self.eps_step if eps_step is None else eps_step
        max_iter = self.max_iter if max_iter is None else int(max_iter)
        x = np.asarray(x_scaled)
        y = np.asarray(y)
        n_features = self.tables.scale.shape[0]
        if x.ndim != 2 or x.shape[1] != n_features:
            raise ValueError(f"x_scaled must be (n, {n_features}), got {x.shape}")
        if y.shape != (x.shape[0],):
            raise ValueError(f"y must be ({x.shape[0]},), got {y.shape}")
        # a 1-column (sigmoid) head reads as [1 - p, p]: classes 0 and 1
        n_classes = max(2, self._model.n_classes)
        bad = y[~np.isin(y, np.arange(n_classes))]
        if bad.size:
            raise ValueError(
                f"labels must be classes of the {n_classes}-class head, in [0, {n_classes}), "
                f"got {sorted(set(bad.tolist()))}"
            )
        x_init = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        y_t = torch.as_tensor(y, dtype=torch.int64, device=self.device)
        sched = self.schedule(eps, eps_step, max_iter)
        starts = None
        if self.num_random_init:
            stream = PhiloxStream(self.seed, self.device)
            starts = (self.random_start(stream, x_init, eps) for _ in range(self.num_random_init))
        x_adv, hist, curve = self.attack(x_init, y_t, sched, eps, starts, self.num_random_init)
        self.loss_history = None if hist is None else hist.transpose(0, 1).cpu().numpy()
        if self.num_random_init:
            succ = curve.cpu().numpy()
            self.quality_history = {
                "restart_success": succ,
                "restart_flip_frac": succ.mean(axis=1).tolist(),
            }
        else:
            self.quality_history = None
        return x_adv.cpu().numpy()


def restart_plain(x_adv, pred, y, hist, best_x, best_hist, best_success, targeted: bool):
    """JAX's restart arbitration after one start's run (``restart``, JAX
    ``attacks/pgd/engine.py``): a row keeps the first run that succeeds on
    it (flips it, or hits the target when ``targeted``), its history
    follows the kept run and an unsuccessful row's the latest run. Returns
    ``(best_x, best_hist, best_success)``; ``best_hist`` None takes the
    run's history. The semantics of kernel K15, selections only."""
    success = pred == y if targeted else pred != y
    take = success & ~best_success
    best_x = torch.where(take[:, None], x_adv, best_x)
    if hist is not None:
        upd = take | ~(best_success | success)
        best_hist = hist if best_hist is None else torch.where(upd[None, :, None], hist, best_hist)
    return best_x, best_hist, best_success | success


def restart(x_adv, pred, y, hist, best_x, best_hist, curve, r: int, targeted: bool):
    """:func:`restart_plain` after start ``r``, its cumulative success
    written into row ``r`` of ``curve`` (R, N) from row r - 1 (none before
    the first start); returns ``(best_x, best_hist)``. Kernel K15 on CUDA
    tensors, which updates them in place from the second start on."""
    if x_adv.is_cuda:
        from ...kernels import restart as kernel

        return kernel(x_adv, pred, y, hist, best_x, best_hist, curve, r, targeted)
    prev = curve[r - 1] if r else torch.zeros_like(curve[0])
    best_x, best_hist, curve[r] = restart_plain(x_adv, pred, y, hist, best_x, best_hist, prev, targeted)
    return best_x, best_hist


def round_ints_toward_initial(
    x_adv_unscaled: np.ndarray, x_init_unscaled: np.ndarray, feature_types
) -> np.ndarray:
    """Directional integer rounding (``united/01_pgd_united.py:130-137``):
    int features moved up are floored, moved down are ceiled — never
    overshooting past the original value. Softmax (simplex) features are
    continuous and stay untouched."""
    int_mask = np.array(
        [str(t) not in ("real", "softmax") for t in feature_types]
    )
    x = x_adv_unscaled.copy()
    up = x > x_init_unscaled
    vals = np.where(up, np.floor(x), np.ceil(x))
    x[..., int_mask] = vals[..., int_mask]
    return x

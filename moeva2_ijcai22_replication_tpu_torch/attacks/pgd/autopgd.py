"""Auto-PGD (Croce & Hein 2020) over the constrained loss of :class:`ConstrainedPGD`.

Port of ``moeva2_ijcai22_replication_tpu/attacks/pgd/autopgd.py``: the
checkpoint schedule p₀ = 0, p₁ = 0.22, p_{j+1} = p_j + max(p_j − p_{j−1} −
0.03, 0.06) (:func:`checkpoint_schedule`), a per-row step η that starts at
the run's ``eps_step`` and halves at a checkpoint where the tracking loss
stalled, a restart from the best point at each halving, momentum iterates
with α = 0.75 (1 at the first iteration) and the best point as the result.
The loss, its schedules, the history and the random restarts are
:class:`ConstrainedPGD`'s.

What depends on the budget alone is a table built once on the host
(:func:`make_autopgd_tables`, as ``make_schedule`` builds PGD's): which
iterations end at a checkpoint, the halving threshold ρ · (the checkpoint's
interval), the tracking loss's static weights and constraint. The best
point is tracked with ``tracking_w_class · loss_class − tracking_w_cons ·
cons``, its weights JAX's ``_static_loss_weights`` and its constraint the
one ``constraints_optim`` picks at iteration 0 (constraint 0 under
``alt_constraints``, ``ctr_id`` under ``single_constraints``, else their
sum), so that phase-switching losses stay comparable across iterations. The
step η replaces the schedule's step: ``adaptive_eps_step`` changes nothing.

One run (:func:`autopgd_run_plain`, JAX's ``AutoPGD._one_run``) is the
AutoPGD instantiation (``kAuto``) of the set's PGD kernel on the card, K7
on LCLD (``kernels.pgd_lcld`` with the tables, ``kernels/csrc/pgd_lcld.cu``),
K7b on botnet (``kernels.pgd_botnet``, ``kernels/csrc/pgd_botnet.cu``) and
K10 on a domain compiled from a spec (``kernels.pgd_spec``,
``kernels/csrc/pgd_spec.cu``), and this plain version on the CPU, one
rounded operation at a time in the kernels' order. K7b's covers the
augmented botnet domain too, in its 927-feature instantiation. On the card
a set with no PGD kernel (``pgd_kernel``) is refused before anything
launches, as :class:`ConstrainedPGD` refuses it; on the CPU every set runs.
A ``+repair`` loss on a set without repair raises before anything runs,
as in :class:`ConstrainedPGD`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ...core.norms import is_inf, project_ball
from .engine import (
    ConstrainedPGD, PgdSchedule, PgdTables, conditioned_grad, grad_and_terms_plain, hist_row,
    predict_plain, repair_plain, stack_hist,
)


def checkpoint_schedule(max_iter: int) -> np.ndarray:
    """Checkpoint iteration indices (AutoPGD paper / ART ``auto_pgd.py:447-457``)."""
    p = [0.0, 0.22]
    while p[-1] < 1.0:
        p.append(p[-1] + max(p[-1] - p[-2] - 0.03, 0.06))
    w = sorted({int(np.ceil(pj * max_iter)) for pj in p if pj <= 1.0})
    return np.array(w, dtype=np.int64)


class AutoPgdTables(NamedTuple):
    """What an AutoPGD run reads besides PGD's schedule."""

    is_ckpt: torch.Tensor  # (T + 1,) bool: iteration i ends at a checkpoint when is_ckpt[i + 1]
    thr: torch.Tensor  # (T + 1,) the halving threshold rho * interval, rounded to float32, in the run's dtype
    w_class: float  # the tracking loss's static weights
    w_cons: float
    ctr: int  # the tracking loss's constraint, -1 = their sum
    eta0: float  # every row's first step, the run's eps_step
    alpha: float  # the momentum


class AutoPgdSchedule(NamedTuple):
    """An AutoPGD run's tables: PGD's schedule (its loss weights and
    constraints; its step is not read) and :class:`AutoPgdTables`."""

    pgd: PgdSchedule
    auto: AutoPgdTables


def static_loss_weights(loss_evaluation: str) -> tuple:
    """JAX's ``_static_loss_weights``: phase-switching strategies collapse to
    the combined loss."""
    if "constraints+flip" in loss_evaluation:
        return 1.0, 1.0
    if "constraints" in loss_evaluation:
        return 0.0, 1.0
    return 1.0, 0.0


def make_autopgd_tables(
    loss_evaluation: str, constraints_optim: str, ctr_id: int, eps_step: float, max_iter: int, rho: float,
    alpha: float, dtype, device,
) -> AutoPgdTables:
    """The budget's tables, as JAX's ``AutoPGD._one_run`` builds them from
    ``max_iter`` (``is_ckpt``, and the threshold ``rho * interval`` with
    interval the float32 distance from the previous checkpoint, 1 off the
    checkpoints), in the run's dtype on ``device``."""
    ckpts = checkpoint_schedule(max_iter)
    is_ckpt = np.zeros(max_iter + 1, dtype=bool)
    is_ckpt[ckpts[ckpts <= max_iter]] = True
    interval = np.ones(max_iter + 1, dtype=np.float32)
    prev = 0
    for c in ckpts:
        if c <= max_iter:
            interval[c] = max(c - prev, 1)
            prev = c
    thr = np.float32(rho) * interval
    if "alt_constraints" in constraints_optim:
        ctr = 0
    elif "single_constraints" in constraints_optim:
        ctr = int(ctr_id)
    else:
        ctr = -1
    w_class, w_cons = static_loss_weights(loss_evaluation)
    return AutoPgdTables(
        is_ckpt=torch.as_tensor(is_ckpt, device=device),
        thr=torch.as_tensor(thr, device=device).to(dtype),
        w_class=w_class, w_cons=w_cons, ctr=ctr, eta0=float(eps_step), alpha=float(alpha),
    )


def tracking_loss_plain(tables: PgdTables, constraints, auto: AutoPgdTables, x, y, targeted: bool):
    """(N,) ``w_class * loss_class + w_cons * (-cons)`` at the rows ``x``
    with the tracking weights and constraint (the terms of
    :func:`grad_and_terms_plain`, its gradient unused)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    _, _, loss_class, cons, _ = grad_and_terms_plain(tables, constraints, x, y, zero, zero, auto.ctr, targeted)
    return auto.w_class * loss_class + auto.w_cons * (-cons)


def autopgd_run_plain(
    tables: PgdTables, constraints, sched: AutoPgdSchedule, x_init, y, x_start, eps: float, clip: tuple, norm,
    repair: bool, targeted: bool, record=None,
):
    """One run of JAX's ``AutoPGD._one_run`` from ``x_start`` (N, D):
    ``(x_best, pred, hist, eta)``, with ``pred`` the class at ``x_best``,
    ``hist`` as :func:`pgd_run_plain` records it (at x before each step)
    and ``eta`` (N,) each row's step after the last iteration. The
    semantics of kernel K7's AutoPGD instantiation, one rounded operation at
    a time in its order: per iteration the gradient and terms of the
    iteration's loss, NaN zeroing, the mask and ``condition_grad``; z = x +
    η · grad clipped, projected and clipped; the momentum ``x + α(z − x) +
    (1 − α)(x − x_prev)`` added left to right (α = 1 at iteration 0, where
    ``0 · (x − x_prev)`` still turns a NaN x NaN) clipped, projected and
    clipped; repair; the tracking loss at x_new; the best point where the
    loss rose above the best (a NaN never does); and at a checkpoint η
    halved, and x restarted from the best point, where the count of rises
    since the last checkpoint is below the threshold or η and the best loss
    both stayed as they were at the last checkpoint."""
    pgd, auto = sched
    lo, hi = clip
    n, dt = x_init.shape[0], x_init.dtype
    alpha = torch.full((), auto.alpha, dtype=dt, device=x_init.device)
    one = torch.ones((), dtype=dt, device=x_init.device)
    x = x_prev = x_best = x_start
    f_best = f_prev = fbest_ckpt = tracking_loss_plain(tables, constraints, auto, x_start, y, targeted)
    eta = eta_ckpt = torch.full((n,), auto.eta0, dtype=dt, device=x_init.device)
    improved = torch.zeros(n, dtype=torch.float32, device=x_init.device)
    is_ckpt = auto.is_ckpt.tolist()
    hist = []
    ctrs = pgd.ctr.tolist()
    for i in range(len(ctrs)):
        grad, per, loss_class, cons, g = grad_and_terms_plain(
            tables, constraints, x, y, pgd.w_class[i], pgd.w_cons[i], ctrs[i], targeted
        )
        if record is not None:
            hist.append(hist_row(record, per, loss_class, cons, g, grad))
        grad = conditioned_grad(tables, grad, norm)
        z = torch.clamp(x + eta[:, None] * grad, lo, hi)
        z = torch.clamp(x_init + project_ball(z - x_init, eps, norm), lo, hi)
        a = one if i == 0 else alpha
        x_new = torch.clamp(x + a * (z - x) + (one - a) * (x - x_prev), lo, hi)
        x_new = torch.clamp(x_init + project_ball(x_new - x_init, eps, norm), lo, hi)
        if repair:
            x_new = repair_plain(tables, constraints, x_new)
        f_new = tracking_loss_plain(tables, constraints, auto, x_new, y, targeted)
        improved = improved + (f_new > f_prev).to(improved.dtype)
        better = f_new > f_best
        x_best = torch.where(better[:, None], x_new, x_best)
        f_best = torch.where(better, f_new, f_best)
        halve = (improved < auto.thr[i + 1]) | ((eta_ckpt == eta) & (fbest_ckpt == f_best))
        halve = halve & is_ckpt[i + 1]
        x_prev = x
        x = torch.where(halve[:, None], x_best, x_new)
        eta = torch.where(halve, eta / 2.0, eta)
        if is_ckpt[i + 1]:
            eta_ckpt, fbest_ckpt = eta, f_best
            improved = torch.zeros_like(improved)
        f_prev = f_new
    return x_best, predict_plain(tables, x_best), stack_hist(hist, record, constraints, x_best), eta


@dataclass
class AutoPGD(ConstrainedPGD):
    """AutoPGD over the same constrained loss as :class:`ConstrainedPGD`,
    with its knobs and JAX's ``alpha_momentum`` and ``rho``.

    The budget rule is JAX's: the checkpoint tables are built from
    ``max_iter``, and :meth:`generate` raises ``ValueError`` for another
    budget (build an engine per budget). The port's plain PGD keeps its own
    rule, any budget on one engine. On the card a set with no PGD kernel
    (``card_refusal``) is refused by name before anything launches, in
    :meth:`ConstrainedPGD.__post_init__`; every set of the repo's domains
    has one."""

    alpha_momentum: float = 0.75
    rho: float = 0.75

    def __post_init__(self):
        super().__post_init__()
        #: (N,) each row's step after the last run, None before one
        self.last_eta: torch.Tensor | None = None

    def schedule(self, eps: float, eps_step: float, max_iter: int) -> AutoPgdSchedule:
        auto = make_autopgd_tables(
            self.loss_evaluation, self.constraints_optim, self.ctr_id, eps_step, max_iter, self.rho,
            self.alpha_momentum, self.dtype, self.device,
        )
        return AutoPgdSchedule(super().schedule(eps, eps_step, max_iter), auto)

    def one_run(self, x_init, y, x_start, sched: AutoPgdSchedule, eps: float):
        """``(x_best, pred, hist)`` of one run: the AutoPGD instantiation of
        the set's kernel (K7, K7b or K10) on the card, :func:`autopgd_run_plain`
        on the CPU; each row's final step lands in ``last_eta``."""
        repair = "repair" in self.loss_evaluation
        if x_init.is_cuda:
            from ... import kernels

            launch = {"lcld": kernels.pgd_lcld, "botnet": kernels.pgd_botnet, "spec": kernels.pgd_spec}[
                self.constraints.pgd_kernel]
            x_best, pred, hist, eta = launch(
                self.tables, sched.pgd, x_init, y, x_start, eps, self.clip, is_inf(self.norm), repair,
                self.targeted, self.history_layout(), auto=sched.auto,
            )
        else:
            x_best, pred, hist, eta = autopgd_run_plain(
                self.tables, self.constraints, sched, x_init, y, x_start, eps, self.clip, self.norm, repair,
                self.targeted, self.history_layout(),
            )
        self.last_eta = eta
        return x_best, pred, hist

    def generate(self, x_scaled: np.ndarray, y: np.ndarray, *, eps: float | None = None,
                 eps_step: float | None = None, max_iter: int | None = None) -> np.ndarray:
        if max_iter is not None and int(max_iter) != self.max_iter:
            raise ValueError(
                f"max_iter={max_iter} differs from the engine's budget {self.max_iter}: AutoPGD's checkpoint "
                "tables are built from the budget; build an engine per budget"
            )
        return super().generate(x_scaled, y, eps=eps, eps_step=eps_step, max_iter=max_iter)

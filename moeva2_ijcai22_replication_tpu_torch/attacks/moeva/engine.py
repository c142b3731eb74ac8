"""MoEvA2, the multi-objective evolutionary attack, batched over states.

Port of the strict mode of ``attacks/moeva/engine.py``: ``init`` (tiled
initial population, objectives, the normalisation warm-up round and the
archive seed) and the generation step ``gen_step`` (offspring, objectives,
merge, R-NSGA-III survival, stable survivors-first extraction, elite
archive update), chained for ``n_gen - 1`` generations over all states at
once, with optional ``max_states_per_call`` chunking.

Every random number a generation consumes comes from one
``torch.Generator`` on the engine's device through :meth:`draw_generation`;
:meth:`gen_step` takes those draws as an argument, so a test can feed it
the JAX package's draws instead.

On the card a generation is the draws, then six hand-written kernels: K5
offspring, the objectives (K1 on LCLD, K8 on botnet), K2 front peel, K4a
normalisation, K3 niche association and K4b fill, extraction and archive.
The one other device op of a step is the ``torch.cat`` of the population's
and the offspring's objectives that K2, K4a and K3 read. On the CPU every
stage runs its plain PyTorch version (:func:`evaluate_plain`,
:func:`extract_archive_plain` and those of ``operators`` and ``survival``),
which spells out its kernel's arithmetic one rounded operation at a time.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ... import resolve_device
from ...core import codec as codec_lib
from ...core.constraints import ConstraintSet
from ...core.norms import is_inf, is_l2, validate_norm
from ...models.io import Surrogate
from ...models.mlp import MLP, mlp_forward_plain
from ...models.scalers import MinMaxParams
from .initialisation import tile_init
from .operators import OffspringDraws, draw_offspring, make_offspring, make_operator_tables
from .refdirs import energy_ref_dirs, rnsga3_geometry
from .survival import (
    NormState, _sqrt_rn, _sum_last, draw_gumbels, survive_batch, survive_fill_plain,
    survive_stages,
)


@dataclass
class MoevaResult:
    """Final populations for every initial state; with an archive, P below is
    pop_size + archive_size (population columns first, then the archive)."""

    x_gen: np.ndarray  # (S, P, L) genetic populations
    f: np.ndarray  # (S, P, 3) objectives
    x_ml: np.ndarray  # (S, P, D) decoded ML-space populations
    x_initial: np.ndarray  # (S, D)
    n_gen: int
    time: float
    #: generation steps run, summed over the state chunks ((n_gen - 1) per
    #: chunk: the port has no early exit), as the JAX engine counts them
    gens_executed: int = 0


class GenerationDraws(NamedTuple):
    """Every random number one generation step consumes."""

    offspring: OffspringDraws
    gum_cut: torch.Tensor  # (S, R) niching cutoff priorities
    gum_mem: torch.Tensor  # (S, M) niching member priorities


class Carry(NamedTuple):
    """The evolution state of a batch of states between generations."""

    pop_x: torch.Tensor  # (S, P, L)
    pop_f: torch.Tensor  # (S, P, 3)
    arch_x: torch.Tensor  # (S, A, L)
    arch_f: torch.Tensor  # (S, A, 3)
    norm_state: NormState


class RunInputs(NamedTuple):
    """Per-call tensors on the engine's device."""

    x_init_ml: torch.Tensor  # (S, D)
    x_init_mm: torch.Tensor  # (S, D) min-max normalised
    xl_ml: torch.Tensor  # (S, D)
    xu_ml: torch.Tensor  # (S, D)
    xl_gen: torch.Tensor  # (S, L)
    xu_gen: torch.Tensor  # (S, L)
    minimize_class: torch.Tensor  # (S,) int64


class ObjectiveTables(NamedTuple):
    """What the objectives (K1, K8) need besides a run's inputs, on the
    engine's device and in its dtype."""

    feat_gene: torch.Tensor  # (D,) int32 — gene that feeds feature d; -1 = immutable
    feat_onehot: torch.Tensor  # (D,) int32 — d's slot in its one-hot group; -1 = the gene itself
    layers: tuple  # ((weight (out, in), bias (out,)), ...) of the relu stack
    params: torch.Tensor  # the same weights flat, each layer's weight then its bias
    first_t: torch.Tensor  # (in, out) the first layer's weight transposed, as K8 streams it
    scaler: tuple | None  # (scale (D,), min_ (D,)): x * scale + min_
    f2_scale: float  # √D under L2, 1 under L∞
    norm_inf: bool
    tol: float  # violations up to tol count as 0
    #: the constraint set's tables for its objective kernel
    #: (``ConstraintSet.kernel_tables``); None where the kernel hard-codes
    #: its terms (LCLD's K1)
    cons: Any = None


def make_objective_tables(codec, model: MLP, scaler, norm, tol: float, cons=None) -> ObjectiveTables:
    """The objective kernel's tables for ``codec`` and ``model``, on the
    model's device and in its dtype; ``scaler`` is ``(scale, min_)``
    tensors or None, ``cons`` the constraint set's kernel tables."""
    w0 = model.layers[0].weight
    feat_gene = np.full(codec.n_features, -1, dtype=np.int32)
    feat_onehot = np.full(codec.n_features, -1, dtype=np.int32)
    feat_gene[codec.non_ohe_ml_idx.cpu().numpy()] = np.arange(codec.n_non_ohe)
    group_idx = codec.group_ml_idx.cpu().numpy()
    for g, (idx, real) in enumerate(zip(group_idx, codec.group_pad_mask.cpu().numpy())):
        feat_gene[idx[real]] = codec.n_non_ohe + g
        feat_onehot[idx[real]] = np.arange(real.sum())
    layers = tuple((layer.weight, layer.bias) for layer in model.layers)
    as_t = lambda a: torch.as_tensor(a, device=w0.device)  # noqa: E731
    return ObjectiveTables(
        feat_gene=as_t(feat_gene),
        feat_onehot=as_t(feat_onehot),
        layers=layers,
        params=torch.cat([t.reshape(-1) for pair in layers for t in pair]),
        first_t=w0.t().contiguous(),
        scaler=scaler,
        f2_scale=float(np.sqrt(codec.n_features)) if is_l2(norm) else 1.0,
        norm_inf=is_inf(norm),
        tol=float(tol),
        cons=cons,
    )


#: a constraint set's ``objective_kernel`` -> the wrapper in ``kernels`` that
#: computes the objectives with its terms on the card
OBJECTIVE_KERNELS = {"lcld": "objective_lcld", "botnet": "objective_botnet"}


def _scalar(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``like``'s device. Dividing by it is a true
    division on every device, while PyTorch on CUDA turns a division by a
    Python number into a product with its rounded reciprocal."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _exp_rn(t: torch.Tensor) -> torch.Tensor:
    """``exp`` in float64, rounded once to ``t``'s dtype: the same bits on
    the card, on the CPU and in kernel K1."""
    return torch.exp(t.double()).to(t.dtype)


def mlp_proba_plain(layers, x: torch.Tensor) -> torch.Tensor:
    """Class probabilities of the relu stack ``layers`` in K1's order: in
    float32 each unit starts from its bias and adds ``weight[k] * x[k]`` for
    k = 0, 1, … one rounded operation at a time (float64, which no kernel
    computes, takes one matmul per layer); softmax as ``exp(l - max)`` over
    the left-to-right sum, a 1-column (sigmoid) head as ``[1 - p, p]``."""
    a = mlp_forward_plain(layers, x)[-1]
    if a.shape[-1] == 1:
        p = 1.0 / (1.0 + _exp_rn(-a))
        return torch.cat([1.0 - p, p], dim=-1)
    e = _exp_rn(a - a.amax(-1, keepdim=True))
    return e / _sum_last(e, keepdim=True)


def evaluate_plain(obj: ObjectiveTables, codec, run: "RunInputs", x_gen, constraints) -> torch.Tensor:
    """(S, N, L) genetic candidates -> (S, N, 3) objectives
    ``[P(minimize_class), Lp distance / f2_scale, Σ violations]``, the
    semantics of kernels K1 and K8. The violations are
    ``constraints.evaluate``, which runs K1's order of operations for LCLD
    and K8's for botnet."""
    x_f = codec_lib.genetic_to_ml(codec, x_gen, run.x_init_ml[:, None, :])
    x_mm = codec_lib.minmax_normalize(x_f, run.xl_ml[:, None, :], run.xu_ml[:, None, :])
    x_in = x_f if obj.scaler is None else x_f * obj.scaler[0] + obj.scaler[1]
    probs = mlp_proba_plain(obj.layers, x_in)
    f1 = torch.gather(probs, -1, run.minimize_class[:, None, None].expand(*probs.shape[:-1], 1))[..., 0]
    diff = x_mm - run.x_init_mm[:, None, :]
    dist = torch.abs(diff).amax(-1) if obj.norm_inf else _sqrt_rn(_sum_last(diff * diff))
    f2 = dist / _scalar(dist, obj.f2_scale)
    return torch.stack([f1, f2, _sum_last(constraints.evaluate(x_f))], dim=-1)


def archive_score(f: torch.Tensor) -> torch.Tensor:
    """Feasible-first elite ranking: feasible candidates score in [0, ~1]
    by misclassification prob + distance tiebreak, infeasible ones in
    (2, 3) by squashed violation mass (NaN for an infinite one)."""
    g = f[..., 2]
    return torch.where(g > 0, 2.0 + g / (1.0 + g), f[..., 0] + 1e-3 * f[..., 1])


def archive_select_plain(cand_x, cand_f, size: int):
    """The ``size`` best candidates by :func:`archive_score`; a stable sort
    keeps the earlier candidate on ties and puts NaN scores last."""
    elite = torch.argsort(archive_score(cand_f), dim=1, stable=True)[:, :size]
    return (
        torch.gather(cand_x, 1, elite[..., None].expand(-1, -1, cand_x.shape[-1])),
        torch.gather(cand_f, 1, elite[..., None].expand(-1, -1, cand_f.shape[-1])),
    )


def extract_archive_plain(mask, pop_x, off, pop_f, off_f, arch_x, arch_f):
    """The tail of a generation, the semantics of kernel K4b after the fill:
    the survivors of ``mask`` (S, P + N) over [population, offspring], first
    and in their original order, as the next (S, P) population; and the
    archive's A best of [archive, offspring]."""
    n_true = mask.sum(1, keepdim=True)
    dest = torch.where(mask, torch.cumsum(mask, 1) - 1, n_true + torch.cumsum(~mask, 1) - 1)
    src = torch.arange(mask.shape[1], device=mask.device).expand_as(dest)
    order = torch.zeros_like(dest).scatter_(1, dest, src)[:, : pop_x.shape[1]]
    merged_x = torch.cat([pop_x, off], dim=1)
    merged_f = torch.cat([pop_f, off_f], dim=1)
    new_x = torch.gather(merged_x, 1, order[..., None].expand(-1, -1, merged_x.shape[-1]))
    new_f = torch.gather(merged_f, 1, order[..., None].expand(-1, -1, 3))
    if arch_x.shape[1]:
        arch_x, arch_f = archive_select_plain(
            torch.cat([arch_x, off], dim=1), torch.cat([arch_f, off_f], dim=1), arch_x.shape[1]
        )
    return new_x, new_f, arch_x, arch_f


@dataclass
class Moeva2:
    """MoEvA2 with R-NSGA-III survival; the knobs mirror the JAX engine's
    strict mode. ``device`` defaults to the card."""

    classifier: Surrogate
    constraints: ConstraintSet
    ml_scaler: MinMaxParams | None = None
    norm: Any = 2
    n_gen: int = 100
    n_pop: int = 200
    n_offsprings: int = 100
    crossover_prob: float = 0.9
    eta_mutation: float = 20.0
    seed: int = 0
    #: only "tile" is ported
    init: str = "tile"
    #: per-state elite archive of the best candidates seen in any generation,
    #: feasible first, appended to the returned populations; 0 = none
    archive_size: int = 0
    #: attack the states in sequential chunks of at most this many
    max_states_per_call: int | None = None
    dtype: torch.dtype = torch.float32
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda" and self.constraints.objective_kernel not in OBJECTIVE_KERNELS:
            raise NotImplementedError(
                f"{type(self.constraints).__name__} has no objective kernel: "
                f"only {' and '.join(OBJECTIVE_KERNELS)} run on the card"
            )
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise NotImplementedError(f"the card's kernels take float32, not {self.dtype}")
        if self.init != "tile":
            raise NotImplementedError(f"init={self.init!r} is not ported (only 'tile')")
        codec = codec_lib.make_codec(self.constraints.schema)
        self.tables = make_operator_tables(codec).to(self.device)
        self.codec = codec.to(self.device)
        # survival consumes the raw aspiration (energy) points; the full
        # RNSGA3 geometry only fixes the population size
        _, self.pop_size = rnsga3_geometry(3, self.n_pop, seed=1)
        self.asp_points = torch.as_tensor(
            energy_ref_dirs(3, self.n_pop, seed=1), dtype=self.dtype, device=self.device
        )
        validate_norm(self.norm)
        if not 0 <= self.archive_size <= self.pop_size:
            raise ValueError(
                f"archive_size={self.archive_size} must be in [0, pop_size={self.pop_size}]"
            )
        # a private, frozen copy in the engine's dtype on its device
        self._model = copy.deepcopy(self.classifier.model).to(
            device=self.device, dtype=self.dtype
        ).eval().requires_grad_(False)
        scaler = None
        if self.ml_scaler is not None:
            scaler = self.ml_scaler.tensors(torch.empty((), dtype=self.dtype, device=self.device))
        self._objective = make_objective_tables(
            self.codec, self._model, scaler, self.norm, self.constraints.tol,
            self.constraints.kernel_tables(self.device),
        )

    @property
    def n_dirs(self) -> int:
        """Survival directions: the aspiration points plus the 3 axes."""
        return self.asp_points.shape[0] + 3

    # -- objectives (K1, K8) and archive (K4b) -------------------------------
    def _evaluate(self, run: RunInputs, x_gen: torch.Tensor) -> torch.Tensor:
        """(S, N, L) genetic candidates -> (S, N, 3) objectives; the
        constraint set's objective kernel on the card (K1 for LCLD, K8 for
        botnet), :func:`evaluate_plain` on the CPU."""
        if x_gen.is_cuda:
            from ... import kernels

            kernel = getattr(kernels, OBJECTIVE_KERNELS[self.constraints.objective_kernel])
            return kernel(
                x_gen, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                run.minimize_class, self._objective,
            )
        return evaluate_plain(self._objective, self.codec, run, x_gen, self.constraints)

    def _archive_select(self, cand_x, cand_f):
        """The archive's top-``archive_size`` candidates of one row set;
        kernel K4b on the card."""
        if not self.archive_size:
            return cand_x[:, :0], cand_f[:, :0]
        if cand_x.is_cuda:
            from ...kernels import archive_select

            return archive_select(cand_x, cand_f, cand_x[:, :0], cand_f[:, :0], self.archive_size)
        return archive_select_plain(cand_x, cand_f, self.archive_size)

    # -- the attack ----------------------------------------------------------
    def prepare(self, x: np.ndarray, minimize_class: np.ndarray) -> RunInputs:
        """Place one batch of initial states (S, D) and its bounds on the
        device."""
        xl, xu = self.constraints.get_feature_min_max(dynamic_input=x)
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            np.array(np.broadcast_to(np.asarray(a, np.float64), x.shape)),
            dtype=self.dtype,
            device=self.device,
        )
        x_t, xl_t, xu_t = as_t(x), as_t(xl), as_t(xu)
        xl_gen, xu_gen = codec_lib.genetic_bounds(self.codec, xl_t, xu_t)
        return RunInputs(
            x_init_ml=x_t,
            x_init_mm=codec_lib.minmax_normalize(x_t, xl_t, xu_t),
            xl_ml=xl_t,
            xu_ml=xu_t,
            xl_gen=xl_gen,
            xu_gen=xu_gen,
            minimize_class=torch.as_tensor(
                np.asarray(minimize_class), dtype=torch.int64, device=self.device
            ),
        )

    def draw_generation(self, gen: torch.Generator, n_states: int) -> GenerationDraws:
        """The draws of one generation step for ``n_states`` states."""
        gum_cut, gum_mem = draw_gumbels(
            gen, n_states, self.n_dirs, self.pop_size + self.n_offsprings, self.dtype
        )
        return GenerationDraws(
            offspring=draw_offspring(
                gen, n_states, self.pop_size, self.n_offsprings,
                self.codec.gen_length, self.dtype,
            ),
            gum_cut=gum_cut,
            gum_mem=gum_mem,
        )

    def init_carry(self, run: RunInputs, gum_cut, gum_mem) -> Carry:
        """Initial population, its objectives, the survival warm-up round
        (everyone survives; the normalisation state warms up) and the
        archive seeded from the whole initial population."""
        s = run.x_init_ml.shape[0]
        pop_x = tile_init(self.codec, run.x_init_ml, self.pop_size)
        pop_f = self._evaluate(run, pop_x)
        norm0 = NormState.init(s, 3, self.dtype, self.device)
        _, norm_state, _ = survive_batch(
            pop_f, self.asp_points, norm0, self.pop_size, gum_cut, gum_mem
        )
        arch_x, arch_f = self._archive_select(pop_x, pop_f)
        return Carry(pop_x, pop_f, arch_x, arch_f, norm_state)

    def offspring(self, run: RunInputs, pop_x: torch.Tensor, draws: OffspringDraws) -> torch.Tensor:
        """One mating round (K5): (S, n_offsprings, L) genetic offspring."""
        return make_offspring(
            self.tables, pop_x, run.xl_gen, run.xu_gen, self.n_offsprings,
            draws, crossover_prob=self.crossover_prob, eta_mutation=self.eta_mutation,
        )

    def gen_step(self, run: RunInputs, carry: Carry, draws: GenerationDraws) -> Carry:
        """One generation: offspring (K5), objectives (K1 or K8), merge, front
        peel (K2), normalisation (K4a), association (K3), then the fill,
        survivors first in stable order and the archive update (K4b). Each
        stage is a ``record_function`` range, which a profile of the step
        labels its kernels by."""
        pop_x, pop_f, arch_x, arch_f, norm_state = carry
        with record_function("moeva.offspring"):
            off = self.offspring(run, pop_x, draws.offspring)
        with record_function("moeva.objectives"):
            off_f = self._evaluate(run, off)
        with record_function("moeva.survival"):
            merged_f = torch.cat([pop_f, off_f], dim=1)
            ranks, norm_state, niche, dist = survive_stages(
                merged_f, self.asp_points, norm_state, self.pop_size
            )
        with record_function("moeva.fill_extract_archive"):
            if merged_f.is_cuda:
                from ...kernels import survive_fill

                out = survive_fill(
                    draws.gum_cut, draws.gum_mem, ranks, niche, dist, self.pop_size,
                    extract=(pop_x, off, pop_f, off_f),
                    archive=(arch_x, arch_f, off, off_f, self.archive_size) if self.archive_size else None,
                )
                pop_x, pop_f = out.pop_x, out.pop_f
                if self.archive_size:
                    arch_x, arch_f = out.arch_x, out.arch_f
            else:
                mask = survive_fill_plain(
                    draws.gum_cut, draws.gum_mem, ranks, niche, dist, self.pop_size
                )
                pop_x, pop_f, arch_x, arch_f = extract_archive_plain(
                    mask, pop_x, off, pop_f, off_f, arch_x, arch_f
                )
        return Carry(pop_x, pop_f, arch_x, arch_f, norm_state)

    @torch.inference_mode()
    def generate(self, x: np.ndarray, minimize_class=1) -> MoevaResult:
        """Attack every row of ``x`` (S, D) for ``n_gen`` generations."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"x must be 2-D (n_states, n_features), got {x.shape}")
        if x.shape[1] != self.codec.n_features:
            raise ValueError(
                f"x has {x.shape[1]} features, schema expects {self.codec.n_features}"
            )
        s = x.shape[0]
        if isinstance(minimize_class, (int, np.integer)):
            minimize_class = np.full((s,), int(minimize_class))
        minimize_class = np.asarray(minimize_class)
        if minimize_class.shape != (s,):
            raise ValueError("minimize_class must be scalar or length n_states")
        # a 1-column (sigmoid) head reads as [1 - p, p]: classes 0 and 1
        n_classes = max(2, self._model.n_classes)
        bad = minimize_class[~np.isin(minimize_class, np.arange(n_classes))]
        if bad.size:
            raise ValueError(
                f"minimize_class must be a class of the {n_classes}-class head, "
                f"in [0, {n_classes}), got {sorted(set(bad.tolist()))}"
            )

        t0 = time.perf_counter()
        gen = torch.Generator(device=self.device).manual_seed(int(self.seed))
        chunk = self.max_states_per_call or s
        parts = []
        for start in range(0, s, chunk):
            run = self.prepare(x[start : start + chunk], minimize_class[start : start + chunk])
            n = run.x_init_ml.shape[0]
            carry = self.init_carry(
                run, *draw_gumbels(gen, n, self.n_dirs, self.pop_size, self.dtype)
            )
            for _ in range(self.n_gen - 1):
                carry = self.gen_step(run, carry, self.draw_generation(gen, n))
            pop_x = torch.cat([carry.pop_x, carry.arch_x], dim=1)
            pop_f = torch.cat([carry.pop_f, carry.arch_f], dim=1)
            x_ml = codec_lib.genetic_to_ml(self.codec, pop_x, run.x_init_ml[:, None, :])
            parts.append([t.cpu().numpy() for t in (pop_x, pop_f, x_ml)])
        x_gen, f, x_ml = (np.concatenate(p, axis=0) for p in zip(*parts))
        return MoevaResult(
            x_gen=x_gen,
            f=f,
            x_ml=x_ml,
            x_initial=x,
            n_gen=self.n_gen,
            time=time.perf_counter() - t0,
            gens_executed=(self.n_gen - 1) * len(parts),
        )

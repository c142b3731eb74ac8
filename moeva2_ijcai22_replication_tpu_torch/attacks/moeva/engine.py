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
from ...core.norms import is_l2, lp_distance, validate_norm
from ...models.io import Surrogate
from ...models.scalers import MinMaxParams
from .initialisation import tile_init
from .operators import OffspringDraws, draw_offspring, make_offspring, make_operator_tables
from .refdirs import energy_ref_dirs, rnsga3_geometry
from .survival import NormState, draw_gumbels, survive_batch


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
        self._f2_scale = float(np.sqrt(self.codec.n_features)) if is_l2(self.norm) else 1.0
        if not 0 <= self.archive_size <= self.pop_size:
            raise ValueError(
                f"archive_size={self.archive_size} must be in [0, pop_size={self.pop_size}]"
            )
        # a private, frozen copy in the engine's dtype on its device
        self._model = copy.deepcopy(self.classifier.model).to(
            device=self.device, dtype=self.dtype
        ).eval().requires_grad_(False)
        self._scaler = None
        if self.ml_scaler is not None:
            like = torch.empty((), dtype=self.dtype, device=self.device)
            self._scaler = self.ml_scaler.tensors(like)

    @property
    def n_dirs(self) -> int:
        """Survival directions: the aspiration points plus the 3 axes."""
        return self.asp_points.shape[0] + 3

    # -- objective (K1, plain PyTorch in this slice) -------------------------
    def _evaluate(self, run: RunInputs, x_gen: torch.Tensor) -> torch.Tensor:
        """(S, N, L) genetic candidates -> (S, N, 3) objectives
        ``[P(minimize_class), Lp distance / scale, Σ violations]``."""
        x_f = codec_lib.genetic_to_ml(self.codec, x_gen, run.x_init_ml[:, None, :])
        x_mm = codec_lib.minmax_normalize(x_f, run.xl_ml[:, None, :], run.xu_ml[:, None, :])
        x_in = x_f if self._scaler is None else x_f * self._scaler[0] + self._scaler[1]
        probs = Surrogate(self._model).predict_proba(x_in)
        cls = run.minimize_class[:, None, None].expand(*probs.shape[:-1], 1)
        f1 = torch.gather(probs, -1, cls)[..., 0]
        f2 = lp_distance(x_mm - run.x_init_mm[:, None, :], self.norm) / self._f2_scale
        g = self.constraints.evaluate(x_f)
        return torch.stack([f1, f2, g.sum(-1)], dim=-1)

    # -- archive -------------------------------------------------------------
    @staticmethod
    def _archive_score(f: torch.Tensor) -> torch.Tensor:
        """Feasible-first elite ranking: feasible candidates score in [0, ~1]
        by misclassification prob + distance tiebreak, infeasible ones in
        (2, 3) by squashed violation mass."""
        g = f[..., 2]
        return torch.where(g > 0, 2.0 + g / (1.0 + g), f[..., 0] + 1e-3 * f[..., 1])

    def _archive_select(self, cand_x, cand_f):
        """Top-``archive_size`` candidates by score; a stable sort keeps the
        earlier candidate on ties."""
        elite = torch.argsort(self._archive_score(cand_f), dim=1, stable=True)[
            :, : self.archive_size
        ]
        return (
            torch.gather(cand_x, 1, elite[..., None].expand(-1, -1, cand_x.shape[-1])),
            torch.gather(cand_f, 1, elite[..., None].expand(-1, -1, cand_f.shape[-1])),
        )

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
        """One generation: offspring, objectives, merge, survival, survivors
        first in stable order, archive update. Each stage is a
        ``record_function`` range, which a profile of the step labels its
        kernels by."""
        pop_x, pop_f, arch_x, arch_f, norm_state = carry
        with record_function("moeva.offspring"):
            off = self.offspring(run, pop_x, draws.offspring)
        with record_function("moeva.objectives"):
            off_f = self._evaluate(run, off)
        with record_function("moeva.survival"):
            merged_x = torch.cat([pop_x, off], dim=1)
            merged_f = torch.cat([pop_f, off_f], dim=1)
            mask, norm_state, _ = survive_batch(
                merged_f, self.asp_points, norm_state, self.pop_size,
                draws.gum_cut, draws.gum_mem,
            )
        with record_function("moeva.extract_archive"):
            # survivors first, each group in its original order
            n_true = mask.sum(1, keepdim=True)
            dest = torch.where(
                mask, torch.cumsum(mask, 1) - 1, n_true + torch.cumsum(~mask, 1) - 1
            )
            src = torch.arange(mask.shape[1], device=mask.device).expand_as(dest)
            order = torch.zeros_like(dest).scatter_(1, dest, src)[:, : self.pop_size]
            pop_x = torch.gather(merged_x, 1, order[..., None].expand(-1, -1, merged_x.shape[-1]))
            pop_f = torch.gather(merged_f, 1, order[..., None].expand(-1, -1, 3))
            if self.archive_size:
                arch_x, arch_f = self._archive_select(
                    torch.cat([arch_x, off], dim=1), torch.cat([arch_f, off_f], dim=1)
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
        )

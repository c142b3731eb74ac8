"""MoEvA2, the multi-objective evolutionary attack, batched over states.

Port of ``attacks/moeva/engine.py``: ``init`` (the initial population,
tiled or ``lp_ratio``, its objectives, the normalisation warm-up round and
the archive seed) and the generation step ``gen_step`` (offspring,
objectives, merge, R-NSGA-III survival, stable survivors-first extraction,
elite archive update), chained for ``n_gen - 1`` generations over all
states at once, with optional ``max_states_per_call`` chunking, and the
engine's extras: the success-gated early exit with active-set compaction
(``early_stop_check_every``), double-buffered gate flushes, quality samples
(``record_quality``, ``quality_every``), checkpoint and resume
(``checkpoint_every``), the streaming ``partial_sink`` and the history of
every evaluation (``save_history``, ``history_chunk``).

Every random number a run consumes comes from one draw source
(:class:`PhiloxDraws` by default: the counter-based Philox4x32-10 stream of
``core.philox`` keyed by ``seed``, drawn on the engine's device by kernel K0),
asked for the draws of the initial round and of each generation at the
current number of rows; the knob ``draw_hook`` replaces it, so a test can
feed the JAX package's draws, at the bucket's row count after a repack too.
:meth:`gen_step` takes its draws as an argument.

A chunk of states starts with one launch of K13a (``chunk_io``: the gene
bounds, the normalised states, the initial population and the normalisation
memory; again without the population after each repack of the early exit)
and ends with one of K13b (the returned columns and their decode).

On the card a generation is one launch of K0 for its draws, then six
hand-written kernels: K5 offspring, the objectives (K1 on LCLD, K8 on botnet, K9 on a domain compiled
from a spec), K2 front peel, K4a
normalisation, K3 niche association and K4b fill, extraction and archive;
K2, K4a and K3 read the population's and the offspring's objectives
through two pointers, so a step runs no other device op. An engine's
aspiration points are one launch of K14 at its construction, once per
process and shape (``refdirs.ref_points``). With
``save_history="full"`` the objectives are K1's, K8's or K9's history
instantiation, which also writes each candidate's record (objectives, then
kept constraint terms) into the segment's device buffer; with "reduced"
the buffer's slice is the kernel's output itself. Each segment's buffer is
copied to pinned host memory on a side stream behind an event and read one
segment late, so the card holds at most two segments. A gate is one
launch of K6a (the (S, 9) statistics, fetched once) and, where states are
solved or the active set is repacked, one launch of K6b each. On the CPU
every stage runs its plain PyTorch version (``core.philox.draw_plain``,
``chunk_io.chunk_prepare_plain`` and ``chunk_decode_plain``,
:func:`evaluate_plain`,
:func:`evaluate_hist_plain`,
:func:`extract_archive_plain`, :func:`take_carry_plain`,
:func:`final_columns_plain`, ``attacks.objective.engine_quality_stats`` and
those of ``operators`` and ``survival``), which spells out its kernel's
arithmetic one rounded operation at a time.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
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
from ...core.philox import NORMAL, SYMMETRIC, Field, PhiloxStream
from ...models.io import Surrogate
from ...models.mlp import MLP, mlp_proba_plain
from ...models.scalers import MinMaxParams
from ...observability.quality import merge_chunk_quality, sample_from_per_state
from ..objective import engine_quality_stats
from .checkpoint import AttackCheckpointer
from .chunk_io import InitSpec, chunk_decode, chunk_prepare, feature_gene_tables, make_chunk_tables
from .initialisation import ball_draw_shape, n_perturbed
from .operators import OffspringDraws, make_offspring, make_operator_tables, offspring_draws, offspring_fields
from .refdirs import ref_points, rnsga3_pop_size
from .survival import (
    NormState, _sqrt_rn, _sum_last, gumbel_fields, survive_batch, survive_fill_plain, survive_stages,
)

logger = logging.getLogger(__name__)


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
    #: generation steps run, summed over the state chunks: ``n_gen - 1`` a
    #: chunk unless the early exit skipped the rest of its budget
    gens_executed: int = 0
    #: the early exit's record (None in strict mode): ``{"check_every",
    #: "gens_executed", "budget_gens", "compaction": [{"gen", "active",
    #: "bucket"(, "chunk")}, ...]}``, one entry per gate that parked states
    #: or repacked (``bucket`` the row count after it), ``active: 0`` when
    #: every state was solved
    early_stop: dict | None = None
    #: the quality history (None unless ``record_quality``): ``{"gate_every",
    #: "threshold", "eps", "archive_size", "judged", "samples": [...]}``, one
    #: sample a gate (``observability.quality.sample_from_per_state``) and a
    #: last one with ``final: True`` from the returned populations
    quality: dict | None = None
    #: the history (None unless ``save_history``): the initial population's
    #: record (S, P, C), then one (S, n_offsprings, C) record a generation
    #: step; C = 3 objectives ("reduced"), or 3 + the constraint terms
    #: ("full")
    history: list | None = None


class GenerationDraws(NamedTuple):
    """Every random number one generation step consumes."""

    offspring: OffspringDraws
    gum_cut: torch.Tensor  # (S, R) niching cutoff priorities
    gum_mem: torch.Tensor  # (S, M) niching member priorities


class InitDraws(NamedTuple):
    """Every random number the initial round consumes."""

    ball: torch.Tensor | None  # lp_ratio's ball draws (``ball_draw_shape``); None for tile
    gum_cut: torch.Tensor  # (S, R)
    gum_mem: torch.Tensor  # (S, P)


class PhiloxDraws:
    """The engine's default draw source: every draw from one Philox stream
    (``core.philox.PhiloxStream``) keyed by ``seed`` on the engine's device,
    one call (one launch of K0 on the card) for the initial round's draws
    and one for each generation's. A draw source answers :meth:`init` and
    :meth:`generation` for a number of rows; with checkpoints it also gives
    and takes its state (:meth:`get_state`, :meth:`set_state`), which a
    resumed run restores."""

    def __init__(self, engine: "Moeva2", seed: int):
        self.engine = engine
        self.stream = PhiloxStream(seed, engine.device)

    def init(self, n_states: int) -> InitDraws:
        """The initial round's draws: lp_ratio's ball (normals under L2,
        uniforms on [-1, 1) under L∞; ``ball_draw_shape``), then the
        niching gumbels (S, R) and (S, P)."""
        eng = self.engine
        fields = []
        n_pert = n_perturbed(eng.pop_size, eng.init_ratio) if eng.init == "lp_ratio" else 0
        if n_pert:
            shape = ball_draw_shape(eng.norm, (n_states, n_pert, eng.codec.gen_length))
            fields.append(Field("ball", NORMAL if is_l2(eng.norm) else SYMMETRIC, shape))
        out = self.stream.draw(fields + gumbel_fields(n_states, eng.n_dirs, eng.pop_size), eng.dtype)
        return InitDraws(out.get("ball"), out["gum_cut"], out["gum_mem"])

    def generation(self, n_states: int) -> "GenerationDraws":
        return self.engine.draw_generation(self.stream, n_states)

    def get_state(self) -> torch.Tensor:
        return self.stream.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.stream.set_state(state)


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
    """What the objectives (K1, K8, K9) need besides a run's inputs, on the
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
    feat_gene, feat_onehot = feature_gene_tables(codec)
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
OBJECTIVE_KERNELS = {"lcld": "objective_lcld", "botnet": "objective_botnet", "spec": "objective_spec"}


def _scalar(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``like``'s device. Dividing by it is a true
    division on every device, while PyTorch on CUDA turns a division by a
    Python number into a product with its rounded reciprocal."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _objectives_and_terms(obj: ObjectiveTables, codec, run: "RunInputs", x_gen, constraints):
    """:func:`evaluate_plain`'s objectives and the (S, N, K) kept terms
    they sum."""
    x_f = codec_lib.genetic_to_ml(codec, x_gen, run.x_init_ml[:, None, :])
    x_mm = codec_lib.minmax_normalize(x_f, run.xl_ml[:, None, :], run.xu_ml[:, None, :])
    x_in = x_f if obj.scaler is None else x_f * obj.scaler[0] + obj.scaler[1]
    probs = mlp_proba_plain(obj.layers, x_in)
    f1 = torch.gather(probs, -1, run.minimize_class[:, None, None].expand(*probs.shape[:-1], 1))[..., 0]
    diff = x_mm - run.x_init_mm[:, None, :]
    dist = torch.abs(diff).amax(-1) if obj.norm_inf else _sqrt_rn(_sum_last(diff * diff))
    f2 = dist / _scalar(dist, obj.f2_scale)
    g_all = constraints.evaluate(x_f)
    return torch.stack([f1, f2, _sum_last(g_all)], dim=-1), g_all


def evaluate_plain(obj: ObjectiveTables, codec, run: "RunInputs", x_gen, constraints) -> torch.Tensor:
    """(S, N, L) genetic candidates -> (S, N, 3) objectives
    ``[P(minimize_class), Lp distance / f2_scale, Σ violations]``, the
    semantics of kernels K1, K8 and K9. The violations are
    ``constraints.evaluate``, which runs K1's order of operations for LCLD,
    K8's for botnet and K9's (the spec's program) for a spec domain."""
    return _objectives_and_terms(obj, codec, run, x_gen, constraints)[0]


def evaluate_hist_plain(obj: ObjectiveTables, codec, run: "RunInputs", x_gen, constraints, save_history: str):
    """The history form of :func:`evaluate_plain`, as the JAX engine's
    ``_evaluate_hist``: ``(f, record)`` with ``record`` ``f`` itself under
    "reduced" and ``[f, kept terms]`` (S, N, 3 + K) under "full", the
    semantics of the history instantiations of K1, K8 and K9 (column 2 is the
    left-to-right sum of the columns after it)."""
    f, g_all = _objectives_and_terms(obj, codec, run, x_gen, constraints)
    return f, (torch.cat([f, g_all], dim=-1) if save_history == "full" else f)


def take_carry_plain(idx: torch.Tensor, leaves) -> list:
    """Each of ``leaves`` (S, ...) at the rows ``idx`` (B,), the semantics
    of kernel K6b's ``take_carry``."""
    return [t.index_select(0, idx) for t in leaves]


def final_columns_plain(idx: torch.Tensor, pop_x, pop_f, arch_x, arch_f):
    """The returned columns of the rows ``idx``: population then archive,
    the semantics of kernel K6b's ``final_columns``."""
    x, f, ax, af = take_carry_plain(idx, (pop_x, pop_f, arch_x, arch_f))
    return torch.cat([x, ax], dim=1), torch.cat([f, af], dim=1)


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


class _HistorySegments:
    """The history's generation records on their way to the host: each
    segment's device buffer (length, S, N, C) is copied to pinned memory on
    a side stream behind an event when it is :meth:`push`-ed and read at
    the next push (the JAX engine's ``flush_pending``), so the card holds at
    most two segments and the copy overlaps the next segment's work. With a
    checkpointer each segment also lands in its sidecar when it is read. On
    the CPU a segment's buffer is kept as it is."""

    def __init__(self, cp, chunks: list):
        self.cp = cp
        self.chunks = chunks  # (length, S, N, C) host arrays, in order
        self.pending = None  # (buffer, host copy or None, event or None)
        self._stream = None
        self._staging = None  # pinned memory; a push reads the last copy before the next starts

    def push(self, buf: torch.Tensor) -> None:
        self.flush()
        if not buf.is_cuda:
            self.pending = (buf, None, None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=buf.device)
        if self._staging is None or self._staging.numel() < buf.numel():
            self._staging = torch.empty(buf.numel(), dtype=buf.dtype, pin_memory=True)
        host = self._staging[: buf.numel()].view(buf.shape)
        self._stream.wait_stream(torch.cuda.current_stream(buf.device))
        with torch.cuda.stream(self._stream):
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self.pending = (buf, host, event)

    def flush(self) -> None:
        """Read the pending segment into :attr:`chunks` (and its sidecar)."""
        if self.pending is None:
            return
        buf, host, event = self.pending
        self.pending = None
        if event is None:
            arr = buf.numpy()
        else:
            event.synchronize()
            arr = host.numpy().copy()
        if self.cp is not None:
            self.cp.add_hist_chunk(len(self.chunks), arr)
        self.chunks.append(arr)


@dataclass
class Moeva2:
    """MoEvA2 with R-NSGA-III survival; the knobs mirror the JAX engine's.
    ``device`` defaults to the card. The host-side knobs (``n_gen``,
    ``seed``, the early exit's, quality's, checkpoint's, ``history_chunk``,
    ``partial_sink`` and ``draw_hook``) may be set per call."""

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
    #: initial population: "tile" (every individual at the initial state) or
    #: "lp_ratio" (``init_ratio`` of it moved inside an ``init_eps`` Lp ball
    #: of the normalised genetic box)
    init: str = "tile"
    init_eps: float = 0.1
    init_ratio: float = 0.5
    #: per-state elite archive of the best candidates seen in any generation,
    #: feasible first, appended to the returned populations; 0 = none
    archive_size: int = 0
    #: "reduced" records the objectives (S, N, 3) of every evaluation, "full"
    #: the objectives and each constraint term thresholded at ``tol`` (S, N,
    #: 3 + K), in ``MoevaResult.history``; incompatible with the early exit
    save_history: str | None = None
    #: generation steps per segment with a history: each segment's records
    #: go to the host while the next one runs
    history_chunk: int = 50
    #: every ``checkpoint_every`` generations the evolution state (with the
    #: draw source's state) is written atomically to ``checkpoint_path``
    #: (``.chunk{i}`` appended per state chunk); a rerun of the same attack
    #: resumes there, bit-identical to an uninterrupted run. 0 = off
    checkpoint_every: int = 0
    checkpoint_path: str | None = None
    #: attack the states in sequential chunks of at most this many
    max_states_per_call: int | None = None
    #: success-gated early exit, 0 = strict mode: every
    #: ``early_stop_check_every`` generations a gate judges population and
    #: archive (misclassified at ``early_stop_threshold``, feasible, within
    #: ``early_stop_eps`` of the engine's distance objective before its
    #: sqrt(D) scaling); solved states are parked (their populations kept on
    #: the host) and the active set is repacked down the bucket menu
    #: (``compaction_buckets``, default ``experiments.common.
    #: DEFAULT_BUCKET_SIZES``), pads repeating the last live row; when every
    #: state is solved the rest of the budget is skipped. A repack draws at
    #: the bucket's row count, so compaction changes the random stream
    early_stop_check_every: int = 0
    early_stop_threshold: float = 0.5
    early_stop_eps: float = float("inf")
    compaction_buckets: tuple | None = None
    #: defer each gate's host work (quality scatter, parked populations'
    #: copy to the host, ``partial_sink``) until the next segment is
    #: launched, so it overlaps the card's work; False flushes at the gate.
    #: The results are the same
    double_buffer: bool = True
    #: keep a quality history (``MoevaResult.quality``): one sample at each
    #: gate, judged as the early exit judges, and a final one. Without early
    #: exit, ``quality_every`` > 0 adds gates every that many generations;
    #: gates change no result
    record_quality: bool = False
    quality_every: int = 0
    #: ``partial_sink(rows, x_ml, gen)`` is called at each flush of a gate
    #: that parked states, with their original row indices and their
    #: populations decoded on the CPU; its exceptions are swallowed
    partial_sink: Any = None
    #: ``draw_hook(chunk)`` gives the draw source of state chunk ``chunk``
    #: (see :class:`PhiloxDraws`); None = one :class:`PhiloxDraws` for the
    #: whole call, whose stream the chunks share
    draw_hook: Any = None
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
        if self.init not in ("tile", "lp_ratio"):
            raise ValueError(f"init must be 'tile' or 'lp_ratio', got {self.init!r}")
        if self.save_history not in (None, False, "reduced", "full"):
            raise ValueError(f"save_history must be None, 'reduced' or 'full', got {self.save_history!r}")
        self._refuse_history()
        codec = codec_lib.make_codec(self.constraints.schema)
        self.tables = make_operator_tables(codec).to(self.device)
        #: K13's tables on the engine's device, with the codec there
        self._chunk = make_chunk_tables(codec, self.device)
        self.codec = self._chunk.codec
        #: the codec on the CPU, which decodes parked rows
        self._codec_cpu = codec
        #: gate flushes of the last ``generate`` that ran after the next
        #: segment was launched (0 with ``double_buffer`` False)
        self.last_deferred_gate_flushes = 0
        # survival consumes the raw aspiration (energy) points, from K14 on
        # the card (once per process and shape); the RNSGA3 geometry only
        # fixes the population size
        self.pop_size = rnsga3_pop_size(3, self.n_pop)
        self.asp_points = ref_points(3, self.n_pop, seed=1, device=self.device).to(self.dtype)
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

    def _refuse_history(self) -> None:
        if self.save_history and self.early_stop_check_every:
            raise ValueError(
                "early_stop_check_every is incompatible with save_history: "
                "active-set compaction changes the states axis mid-run and "
                "per-generation history records are not reassembled across "
                "repacks (run strict mode for history)"
            )

    def history_columns(self) -> int:
        """Columns of a history record: the 3 objectives, and under "full"
        the constraint set's terms after them."""
        return 3 + (self.constraints.get_nb_constraints() if self.save_history == "full" else 0)

    @property
    def n_dirs(self) -> int:
        """Survival directions: the aspiration points plus the 3 axes."""
        return self.asp_points.shape[0] + 3

    # -- objectives (K1, K8) and archive (K4b) -------------------------------
    def _evaluate(self, run: RunInputs, x_gen: torch.Tensor, record=None) -> torch.Tensor:
        """(S, N, L) genetic candidates -> (S, N, 3) objectives; the
        constraint set's objective kernel on the card (K1 for LCLD, K8 for
        botnet, K9 for a domain compiled from a spec), :func:`evaluate_plain`
        on the CPU. ``record``, a (S, N,
        :meth:`history_columns`) slice of a history buffer, takes the
        evaluation's history record (:func:`evaluate_hist_plain` on the
        CPU)."""
        if x_gen.is_cuda:
            from ... import kernels

            kernel = getattr(kernels, OBJECTIVE_KERNELS[self.constraints.objective_kernel])
            return kernel(
                x_gen, run.x_init_ml, run.xl_ml, run.xu_ml, run.x_init_mm,
                run.minimize_class, self._objective, record=record,
            )
        if record is None:
            return evaluate_plain(self._objective, self.codec, run, x_gen, self.constraints)
        f, rec = evaluate_hist_plain(self._objective, self.codec, run, x_gen, self.constraints, self.save_history)
        record.copy_(rec)
        return f

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
        device: one copy of the host's states and bounds, then K13a."""
        return self._prepare(x, minimize_class)[0]

    def init_spec(self, ball=None) -> InitSpec:
        """The engine's initial population for K13a, moved by ``ball``
        under ``lp_ratio``."""
        return InitSpec(self.pop_size, self.init == "lp_ratio", ball, self.init_eps, self.init_ratio, self.norm)

    def _prepare(self, x: np.ndarray, minimize_class: np.ndarray, init: InitSpec | None = None):
        """``(RunInputs, chunk_io.Prepared)`` of one batch of initial
        states: the feature bounds on the host (``get_feature_min_max``),
        states and bounds copied to the device in one array of the engine's
        dtype, then one K13a launch, which with ``init`` also writes the
        initial population and the normalisation memory."""
        xl, xu = self.constraints.get_feature_min_max(dynamic_input=x)
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        host = np.stack([np.broadcast_to(np.asarray(a, np.float64), x.shape) for a in (x, xl, xu)]).astype(np_dtype)
        x_t, xl_t, xu_t = torch.from_numpy(host).to(self.device)
        prep = chunk_prepare(self._chunk, x_t, xl_t, xu_t, init)
        run = RunInputs(
            x_init_ml=x_t,
            x_init_mm=prep.x_mm,
            xl_ml=xl_t,
            xu_ml=xu_t,
            xl_gen=prep.xl_gen,
            xu_gen=prep.xu_gen,
            minimize_class=torch.from_numpy(np.asarray(minimize_class).astype(np.int64)).to(self.device),
        )
        return run, prep

    def draw_generation(self, stream: PhiloxStream, n_states: int) -> GenerationDraws:
        """The draws of one generation step for ``n_states`` states: one
        call of the Philox ``stream`` (one K0 launch on the card), the
        mating round's fields then the niching gumbels (S, R) and (S, M)."""
        fields = offspring_fields(n_states, self.pop_size, self.n_offsprings, self.codec.gen_length)
        fields += gumbel_fields(n_states, self.n_dirs, self.pop_size + self.n_offsprings)
        out = stream.draw(fields, self.dtype)
        return GenerationDraws(offspring=offspring_draws(out), gum_cut=out["gum_cut"], gum_mem=out["gum_mem"])

    def init_carry(self, run: RunInputs, gum_cut, gum_mem, ball=None, record=None, start=None) -> Carry:
        """Initial population (``lp_ratio`` moves its last rows with the
        ``ball`` draws), its objectives (and their history ``record``, (S,
        P, C), where given), the survival warm-up round (everyone survives;
        the normalisation state warms up) and the archive seeded from the
        whole initial population. ``start``, the ``chunk_io.Prepared`` of
        the chunk's K13a launch, holds population and normalisation memory;
        without it K13a runs again on ``run``'s states."""
        if start is None:
            start = chunk_prepare(self._chunk, run.x_init_ml, run.xl_ml, run.xu_ml, self.init_spec(ball))
        pop_x = start.pop_x
        pop_f = self._evaluate(run, pop_x, record)
        _, norm_state, _ = survive_batch(
            pop_f, self.asp_points, start.norm_state, self.pop_size, gum_cut, gum_mem
        )
        arch_x, arch_f = self._archive_select(pop_x, pop_f)
        return Carry(pop_x, pop_f, arch_x, arch_f, norm_state)

    def offspring(self, run: RunInputs, pop_x: torch.Tensor, draws: OffspringDraws) -> torch.Tensor:
        """One mating round (K5): (S, n_offsprings, L) genetic offspring."""
        return make_offspring(
            self.tables, pop_x, run.xl_gen, run.xu_gen, self.n_offsprings,
            draws, crossover_prob=self.crossover_prob, eta_mutation=self.eta_mutation,
        )

    def gen_step(self, run: RunInputs, carry: Carry, draws: GenerationDraws, record=None) -> Carry:
        """One generation: offspring (K5), objectives (K1 or K8; with their
        history ``record``, (S, n_offsprings, C), where given), then on the
        objectives of [population, offspring], read through two pointers
        with no merged copy on the card, front peel (K2), normalisation
        (K4a), association (K3), then the fill,
        survivors first in stable order and the archive update (K4b). Each
        stage is a ``record_function`` range, which a profile of the step
        labels its kernels by."""
        pop_x, pop_f, arch_x, arch_f, norm_state = carry
        with record_function("moeva.offspring"):
            off = self.offspring(run, pop_x, draws.offspring)
        with record_function("moeva.objectives"):
            off_f = self._evaluate(run, off, record)
        with record_function("moeva.survival"):
            # K2, K4a and K3 read [pop_f, off_f] through two pointers
            ranks, norm_state, niche, dist = survive_stages(
                pop_f, self.asp_points, norm_state, self.pop_size, off_f
            )
        with record_function("moeva.fill_extract_archive"):
            if pop_f.is_cuda:
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

    # -- the early exit's gate (K6a) and repack (K6b) --------------------------
    def _gate_scalars(self) -> tuple:
        """The gate's threshold and distance bound in the engine's dtype:
        ``early_stop_eps`` divided by the f2 objective's sqrt(D) scaling."""
        eps = float(self.early_stop_eps) / self._objective.f2_scale
        as_dtype = lambda v: torch.tensor(v, dtype=self.dtype).item()  # noqa: E731
        return as_dtype(float(self.early_stop_threshold)), as_dtype(eps)

    def gate_stats(self, carry: Carry) -> torch.Tensor:
        """The (S, 9) gate statistics of population and archive
        (``attacks.objective.QUALITY_STAT_COLUMNS``); kernel K6a on the
        card."""
        thr, eps = self._gate_scalars()
        if carry.pop_f.is_cuda:
            from ...kernels import gate_stats

            return gate_stats(carry.pop_f, carry.arch_f, thr, eps)
        return engine_quality_stats(torch.cat([carry.pop_f, carry.arch_f], dim=1), thr, eps)

    def take_carry(self, carry: Carry, sel: np.ndarray) -> Carry:
        """The carry at the rows ``sel`` (host indices); kernel K6b on the
        card, one launch for every leaf."""
        leaves = (*carry[:4], *carry.norm_state)
        if carry.pop_x.is_cuda:
            from ...kernels import take_carry

            out = take_carry(sel, leaves)
        else:
            out = take_carry_plain(torch.as_tensor(np.asarray(sel, np.int64)), leaves)
        return Carry(*out[:4], NormState(*out[4:]))

    def final_columns(self, carry: Carry, idx: np.ndarray):
        """The returned columns (population, then archive) of the rows
        ``idx``; kernel K6b on the card."""
        args = (carry.pop_x, carry.pop_f, carry.arch_x, carry.arch_f)
        if carry.pop_x.is_cuda:
            from ...kernels import final_columns

            return final_columns(idx, *args)
        return final_columns_plain(torch.as_tensor(np.asarray(idx, np.int64)), *args)

    def _compaction_menu(self):
        from ...experiments.common import DEFAULT_BUCKET_SIZES, BucketMenu

        return BucketMenu(tuple(self.compaction_buckets or DEFAULT_BUCKET_SIZES))

    def _fingerprint(self, x, minimize_class, xl_ml, xu_ml) -> str:
        """The attack's identity for a checkpoint: the inputs, the feature
        bounds, every knob that changes the result, the classifier's
        weights, the scaler, the schema and the device type. A checkpoint
        with another fingerprint is ignored, never resumed into."""
        h = hashlib.md5()
        for a in (x, minimize_class, xl_ml, xu_ml):
            h.update(np.ascontiguousarray(a).tobytes())
        knobs = [
            self.n_gen, self.pop_size, self.n_offsprings, self.seed,
            self.init, self.init_eps, self.init_ratio, self.archive_size,
            self.early_stop_check_every, self.early_stop_threshold,
            self.early_stop_eps, tuple(self.compaction_buckets or ()),
            str(self.save_history), str(self.norm), self.crossover_prob,
            self.eta_mutation, str(self.dtype), self.device.type,
            type(self.constraints).__name__, self.constraints.get_nb_constraints(),
        ]
        h.update(repr(knobs).encode())
        for t in self.classifier.model.state_dict().values():
            h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
        if self.ml_scaler is not None:
            h.update(np.ascontiguousarray(self.ml_scaler.scale).tobytes())
            h.update(np.ascontiguousarray(self.ml_scaler.min_).tobytes())
        schema = self.constraints.schema
        h.update(repr([list(map(str, schema.types)), schema.mutable.tolist()]).encode())
        return h.hexdigest()

    def _decode_cpu(self, x_gen: np.ndarray, x_rows: np.ndarray) -> np.ndarray:
        """Genetic populations (R, P, L) of the initial states ``x_rows``
        (R, D) decoded to ML space on the CPU; the decode moves and rounds
        values only, so it gives the card's bits."""
        return codec_lib.genetic_to_ml(
            self._codec_cpu, torch.as_tensor(x_gen),
            torch.as_tensor(x_rows, dtype=self.dtype)[:, None, :],
        ).numpy()

    # -- the attack ----------------------------------------------------------
    @torch.inference_mode()
    def generate(self, x: np.ndarray, minimize_class=1) -> MoevaResult:
        """Attack every row of ``x`` (S, D) for ``n_gen`` generations, or
        until the early exit finds every state solved."""
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
        self._refuse_history()

        t0 = time.perf_counter()
        self.last_deferred_gate_flushes = 0
        chunk = self.max_states_per_call or s
        starts = range(0, s, chunk)
        shared = None if self.draw_hook is not None else PhiloxDraws(self, self.seed)
        parts = []
        for i, start in enumerate(starts):
            path = self.checkpoint_path
            if path and len(starts) > 1:
                path = f"{path}.chunk{i}"
            draws = shared if shared is not None else self.draw_hook(i)
            parts.append(self._run_one(
                x[start : start + chunk], minimize_class[start : start + chunk], draws, path
            ))
        gens_executed = sum(p.gens_executed for p in parts)
        early_stop = parts[0].early_stop
        if early_stop is not None and len(parts) > 1:
            early_stop = {
                "check_every": early_stop["check_every"],
                "gens_executed": gens_executed,
                "budget_gens": (self.n_gen - 1) * len(parts),
                "compaction": [dict(t, chunk=i) for i, p in enumerate(parts) for t in p.early_stop["compaction"]],
            }
        quality, history = parts[0].quality, parts[0].history
        if len(parts) > 1:
            quality = merge_chunk_quality([p.quality for p in parts], [p.x_gen.shape[0] for p in parts])
            if history is not None:
                # each record joins the chunks' on the states axis
                history = [np.concatenate(hs, axis=0) for hs in zip(*(p.history for p in parts))]
        return MoevaResult(
            x_gen=np.concatenate([p.x_gen for p in parts], axis=0),
            f=np.concatenate([p.f for p in parts], axis=0),
            x_ml=np.concatenate([p.x_ml for p in parts], axis=0),
            x_initial=x,
            n_gen=self.n_gen,
            time=time.perf_counter() - t0,
            gens_executed=gens_executed,
            early_stop=early_stop,
            quality=quality,
            history=history,
        )

    def _run_one(self, x: np.ndarray, minimize_class: np.ndarray, draws, checkpoint_path) -> MoevaResult:
        """One chunk of states: the JAX engine's ``_launch_one`` and
        ``_finalize_one``. Segments of generation steps end at the gates
        (every ``early_stop_check_every`` generations, or ``quality_every``
        with ``record_quality``), at checkpoint boundaries and, with a
        history, every ``history_chunk`` generations."""
        s = x.shape[0]
        check = int(self.early_stop_check_every or 0)
        qual_on = bool(self.record_quality)
        gate_every = check or (int(self.quality_every or 0) if qual_on else 0)
        n_steps = self.n_gen - 1
        init = draws.init(s)
        run, start = self._prepare(x, minimize_class, self.init_spec(init.ball))
        hist_cols = self.history_columns() if self.save_history else 0
        init_hist = None
        if hist_cols:
            init_hist = torch.empty((s, self.pop_size, hist_cols), dtype=self.dtype, device=self.device)
        carry = self.init_carry(run, init.gum_cut, init.gum_mem, record=init_hist, start=start)

        cp = None
        if self.checkpoint_every and checkpoint_path:
            xl, xu = (
                np.broadcast_to(np.asarray(a, np.float64), x.shape)
                for a in self.constraints.get_feature_min_max(dynamic_input=x)
            )
            cp = AttackCheckpointer(checkpoint_path, self._fingerprint(x, minimize_class, xl, xu))
        done = gens_executed = 0
        # which original row each carry row tracks (pads repeat the last live
        # row), whether its result is still wanted, and the solved rows'
        # populations, kept on the host
        row_src = np.arange(s)
        row_live = np.ones(s, dtype=bool)
        parked: dict | None = None
        trace: list = []
        hist_chunks: list = []
        qual_samples: list = []
        qual_latest = np.full((s, 9), np.nan) if qual_on else None
        if cp is not None:
            resumed = cp.load([*carry[:4], *carry.norm_state, draws.get_state()])
            if resumed is not None:
                leaves, done, hist_chunks = resumed
                carry = Carry(*leaves[:4], NormState(*leaves[4:7]))
                draws.set_state(leaves[7])
                gens_executed = done
                if cp.extra is not None:
                    row_src = np.asarray(cp.extra["row_src"])
                    row_live = np.asarray(cp.extra["row_live"]).astype(bool)
                    state = json.loads(str(cp.extra["state_json"]))
                    gens_executed = int(state["gens_executed"])
                    trace = list(state["trace"])
                    if state["parked"]:
                        parked = {k: np.asarray(cp.extra[f"parked_{k}"]) for k in ("mask", "x", "f")}
                        parked["mask"] = parked["mask"].astype(bool)
                    if len(row_src) != s:
                        run = self.prepare(x[row_src], minimize_class[row_src])
        menu = self._compaction_menu() if check else None
        history = _HistorySegments(cp, hist_chunks) if hist_cols else None
        segments = 0  # segments launched, the deferred flushes' witness
        pending: list = []  # at most one gate's deferred host work

        def flush_gate():
            """The last gate's host work: the quality scatter and sample,
            the parked populations' copy into ``parked`` and the
            ``partial_sink`` call. Decisions were made at the gate."""
            if not pending:
                return
            g = pending.pop()
            if g["segments"] < segments:
                self.last_deferred_gate_flushes += 1
            if qual_on:
                # pads never overwrite a real row; parked rows keep the stats
                # of the gate that parked them
                live = g["row_live"]
                qual_latest[g["row_src"][live]] = g["stats"][live]
                qual_samples.append(sample_from_per_state(g["gen"], qual_latest))
            if "park_rows" in g:
                rows = g["park_rows"]
                if g["event"] is not None:
                    g["event"].synchronize()
                px, pf = (t.numpy() for t in g["columns"])
                parked["x"][rows] = px
                parked["f"][rows] = pf
                if self.partial_sink is not None:
                    # a consumer's failure must not stop the attack: it is
                    # logged with its traceback
                    try:
                        self.partial_sink([int(r) for r in rows], self._decode_cpu(px, x[rows]), int(g["gen"]))
                    except Exception:
                        logger.exception("partial_sink failed at generation %d", g["gen"])

        while done < n_steps:
            length = n_steps - done
            if gate_every:
                length = min(length, gate_every - done % gate_every)
            if cp is not None:
                length = min(length, self.checkpoint_every - done % self.checkpoint_every)
            if history is not None:
                length = min(length, max(1, int(self.history_chunk)))
            n_rows = len(row_src)
            buf = None
            if history is not None:
                buf = torch.empty((length, n_rows, self.n_offsprings, hist_cols), dtype=self.dtype, device=self.device)
            for g in range(length):
                carry = self.gen_step(run, carry, draws.generation(n_rows), None if buf is None else buf[g])
            segments += 1
            done += length
            gens_executed += length
            # the previous gate's host work and the previous segment's
            # history run while the card executes the segment just launched
            flush_gate()
            if history is not None:
                history.push(buf)
            if gate_every and done % gate_every == 0 and done < n_steps:
                # the one fetch a gate needs: the (S, 9) statistics
                stats = self.gate_stats(carry).cpu().numpy()
                succ = stats[:, 6] > 0
                gate = {"gen": done, "stats": stats, "row_src": row_src.copy(), "row_live": row_live.copy()}
                if check:
                    solved = row_live & succ
                    n_parked = int(solved.sum())
                    if n_parked:
                        idx = np.where(solved)[0]
                        if parked is None:
                            cols = self.pop_size + self.archive_size
                            np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
                            parked = {
                                "mask": np.zeros(s, dtype=bool),
                                "x": np.zeros((s, cols, self.codec.gen_length), dtype=np_dtype),
                                "f": np.zeros((s, cols, 3), dtype=np_dtype),
                            }
                        rows = row_src[idx]
                        parked["mask"][rows] = True
                        gate["park_rows"] = rows
                        # gathered before the repack; on the card copied to
                        # pinned host memory behind an event, read at the flush
                        px, pf = self.final_columns(carry, idx)
                        gate["columns"], gate["event"] = (px, pf), None
                        if px.is_cuda:
                            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (px, pf)]
                            for h, t in zip(host, (px, pf)):
                                h.copy_(t, non_blocking=True)
                            gate["event"] = torch.cuda.Event()
                            gate["event"].record()
                            gate["columns"] = host
                        row_live = row_live & ~succ
                    n_active = int(row_live.sum())
                    if n_active == 0:
                        # every state holds a success: skip the rest of the
                        # budget (the flush runs below)
                        trace.append({"gen": done, "active": 0, "bucket": len(row_src)})
                        gate["segments"] = segments
                        pending.append(gate)
                        break
                    bucket = menu.shrink_bucket(n_active, len(row_src))
                    if bucket is not None:
                        keep = np.where(row_live)[0]
                        sel = np.concatenate([keep, np.full(bucket - n_active, keep[-1], keep.dtype)])
                        carry = self.take_carry(carry, sel)
                        row_src = row_src[sel]
                        row_live = np.arange(bucket) < n_active
                        run = self.prepare(x[row_src], minimize_class[row_src])
                        trace.append({"gen": done, "active": n_active, "bucket": int(bucket)})
                    elif n_parked:
                        trace.append({"gen": done, "active": n_active, "bucket": len(row_src)})
                gate["segments"] = segments
                pending.append(gate)
                if not self.double_buffer:
                    flush_gate()
            if cp is not None and done < n_steps and done % self.checkpoint_every == 0:
                # the parked populations join the snapshot, which counts
                # only history already in its sidecars
                flush_gate()
                if history is not None:
                    history.flush()
                extra = None
                if check:
                    extra = {
                        "row_src": row_src,
                        "row_live": row_live,
                        "parked_mask": parked["mask"] if parked else np.zeros(s, dtype=bool),
                        "parked_x": parked["x"] if parked else np.zeros((s, 0, 0)),
                        "parked_f": parked["f"] if parked else np.zeros((s, 0, 0)),
                        "state_json": np.asarray(json.dumps({
                            "gens_executed": int(gens_executed), "trace": trace, "parked": parked is not None,
                        })),
                    }
                cp.save([*carry[:4], *carry.norm_state, draws.get_state()], done, n_hist=len(hist_chunks),
                        extra=extra)
        flush_gate()
        records = None
        if history is not None:
            history.flush()
            # the initial record, then one a generation step
            records = [init_hist.cpu().numpy()] + [c[i] for c in hist_chunks for i in range(c.shape[0])]

        # the returned columns and their decode: K13b on the card
        out = chunk_decode(self._chunk, carry.pop_x, carry.arch_x, carry.pop_f, carry.arch_f, run.x_init_ml)
        pop_x, pop_f, x_ml = (t.cpu().numpy() for t in out)
        if parked is not None or len(row_src) != s:
            # parked rows take their kept populations, live rows go back to
            # their original index, pads drop
            out = [np.zeros((s, *a.shape[1:]), a.dtype) for a in (pop_x, pop_f, x_ml)]
            if parked is not None:
                m = parked["mask"]
                out[0][m], out[1][m] = parked["x"][m], parked["f"][m]
                out[2][m] = self._decode_cpu(parked["x"][m], x[m])
            for o, a in zip(out, (pop_x, pop_f, x_ml)):
                o[row_src[row_live]] = a[row_live]
            pop_x, pop_f, x_ml = out
        if cp is not None:
            cp.clear()
        early_stop = None
        if check:
            early_stop = {"check_every": check, "gens_executed": gens_executed, "budget_gens": n_steps,
                          "compaction": trace}
        quality = None
        if qual_on:
            eps = float(self.early_stop_eps) / self._objective.f2_scale
            final = engine_quality_stats(np.asarray(pop_f, np.float64), float(self.early_stop_threshold), eps)
            quality = {
                "gate_every": gate_every,
                "threshold": float(self.early_stop_threshold),
                "eps": float(self.early_stop_eps),
                "archive_size": int(self.archive_size),
                "judged": "engine",
                "samples": qual_samples + [sample_from_per_state(gens_executed, final, final=True)],
            }
        return MoevaResult(
            x_gen=pop_x, f=pop_f, x_ml=x_ml, x_initial=x, n_gen=self.n_gen, time=0.0,
            gens_executed=gens_executed, early_stop=early_stop, quality=quality, history=records,
        )

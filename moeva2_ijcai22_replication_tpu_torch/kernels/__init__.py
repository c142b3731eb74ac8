"""Hand-written Hopper kernels of the port and their launch counts.

In the order a generation launches them:

- ``offspring`` (K5, ``csrc/offspring.cu``): selection, crossover and
  mutation; plain version ``attacks.moeva.operators.make_offspring_plain``.
- ``objective_lcld`` (K1, ``csrc/objective_lcld.cu``) or ``objective_botnet``
  (K8, ``csrc/objective_botnet.cu``): the objectives on the LCLD or the
  botnet domain; plain version ``attacks.moeva.engine.evaluate_plain``. K1's
  instantiation for the augmented LCLD domain counts its launches as
  ``objective_lcld_aug``, K8's for the augmented botnet domain as
  ``objective_botnet_aug``. With a history record (MoEvA's
  ``save_history="full"``), their ``kHistory`` instantiations count as
  ``objective_lcld_hist``, ``objective_lcld_aug_hist``,
  ``objective_botnet_hist`` and ``objective_botnet_aug_hist``; plain
  version ``attacks.moeva.engine.evaluate_hist_plain``. On a domain
  compiled from a constraint spec, ``objective_spec`` (K9,
  ``csrc/objective_spec.cu``) computes them by running the spec's program
  (``domains.ir.program``); its history instantiation counts as
  ``objective_spec_hist``.
- ``nd_peel`` (K2, ``csrc/nd_peel.cu``): non-dominated front peeling; its
  plain version is ``attacks.moeva.nds.nd_ranks_plain``. K2, K4a and K3 read
  a generation's objectives of [population, offspring] through two
  pointers, with no merged copy; their plain versions take the
  concatenation.
- ``survive_norm`` (K4a, ``csrc/survive_norm.cu``): ideal, worst, extreme
  points, nadir and directions; plain version
  ``attacks.moeva.survival.survive_norm_plain``.
- ``associate`` (K3, ``csrc/associate.cu``): niche association; its plain
  version is ``attacks.moeva.survival.associate_plain``.
- ``survive_fill`` (K4b, ``csrc/survive_fill.cu``): the niching fill, and
  in a generation step the survivor extraction and the archive update;
  plain versions ``survival.survive_fill_plain``,
  ``engine.extract_archive_plain`` and ``engine.archive_select_plain``.

At a gate of the early exit (``Moeva2(early_stop_check_every=...)``, or
``quality_every`` samples), ``gate_stats`` (K6a, ``csrc/gate_repack.cu``):
the (S, 9) success and quality statistics over population and archive,
plain version ``attacks.objective.engine_quality_stats``; and
``take_carry`` (K6b, the same source): the gather of every carry leaf at
the kept rows after a repack, and of the solved rows' returned columns
(``final_columns``), plain versions ``attacks.moeva.engine.
take_carry_plain`` and ``final_columns_plain``. Both uses of K6b count as
``take_carry``.

And, for constrained PGD, ``pgd_lcld`` (K7, ``csrc/pgd_lcld.cu``) and
``pgd_botnet`` (K7b, ``csrc/pgd_botnet.cu``): every iteration of one run on
the LCLD or the botnet domain; plain version
``attacks.pgd.engine.pgd_run_plain``. K7's and K7b's instantiations for the
augmented domains count their launches as ``pgd_lcld_aug`` and
``pgd_botnet_aug``; their AutoPGD instantiations (plain version
``attacks.pgd.autopgd.autopgd_run_plain``) as ``pgd_lcld_auto``,
``pgd_lcld_aug_auto``, ``pgd_botnet_auto`` and ``pgd_botnet_aug_auto``. On a
domain compiled from a constraint spec, ``pgd_spec`` (K10,
``csrc/pgd_spec.cu``) runs them from the spec's reverse and repair
programs; its AutoPGD instantiation counts as ``pgd_spec_auto``.

And, for training and the defense pipelines, ``train_step`` (K11,
``csrc/train_step.cu``): one Adam step of a surrogate, plain version
``models.train.train_step_plain``; its loss-only instantiation
``train_loss``, the validation loss (``models.train.train_loss_plain``);
and ``input_grad`` (K12, ``csrc/input_grad.cu``): the attribution gradient
of the feature importance, plain version ``models.train.input_grad_plain``.

And, for every random draw of the attacks, ``draws`` (K0,
``csrc/draws.cu``): the fields of one call of the Philox4x32-10 stream, one
launch for a MoEvA generation's draws and one for its initial round's;
plain version ``core.philox.draw_plain``. Its instantiation for PGD's random
start, which also writes the start, counts as ``pgd_start``; plain version
``attacks.pgd.engine.pgd_start_plain``. For a MoEvA chunk,
``chunk_prepare`` (K13a, ``csrc/chunk_io.cu``): the gene bounds, the
normalised states, the initial population and the normalisation memory;
and ``chunk_decode`` (K13b, the same source): the returned columns and
their decode to ML space; plain versions ``attacks.moeva.chunk_io.
chunk_prepare_plain`` and ``chunk_decode_plain``.

And, once per process and shape at an engine's construction, ``refdirs``
(K14, ``csrc/refdirs.cu``): the reference directions' energy descent, one
cluster of up to 16 CTAs, each a block of the points; plain version
``attacks.moeva.refdirs.energy_descent_plain``. After
each random start of PGD or AutoPGD, ``restart`` (K15,
``csrc/restart.cu``): the restart arbitration; plain version
``attacks.pgd.engine.restart_plain``. Outside the attacks, the surrogate's
forward (K16, ``csrc/mlp_forward.cu``, a CTA a tile of 16 rows over weights
staged k-major in shared memory): ``forward_labels``, the PGD
runner's labels in float32 (plain version ``attacks.pgd.engine.
predict_plain``'s semantics), and ``forward_proba1``, the pipelines'
class-1 probabilities in float64 (plain version ``models.mlp.
proba1_plain``).

The wrappers take CUDA tensors only and raise on anything the kernel does
not take, or when a build or launch fails; callers route CPU tensors to the
plain versions. Importing this module builds nothing: the library is built
and loaded at the first launch (``build.library``).

Each wrapper adds one to its entry of the launch count where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_LAUNCHES = {
    name: 0
    for name in (
        "offspring", "objective_lcld", "nd_peel", "survive_norm", "associate", "survive_fill",
        "pgd_lcld", "objective_botnet", "pgd_botnet", "objective_lcld_aug", "pgd_lcld_aug",
        "objective_botnet_aug", "pgd_lcld_auto", "pgd_lcld_aug_auto", "pgd_botnet_auto",
        "gate_stats", "take_carry", "objective_lcld_hist", "objective_lcld_aug_hist", "objective_botnet_hist",
        "objective_botnet_aug_hist", "objective_spec", "objective_spec_hist", "pgd_spec", "pgd_spec_auto", "train_step", "train_loss",
        "input_grad", "draws", "pgd_start", "chunk_prepare", "chunk_decode", "refdirs", "restart",
        "forward_labels", "forward_proba1", "pgd_botnet_aug", "pgd_botnet_aug_auto",
    )
}


def launch_counts() -> dict:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _one_device(*tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"a kernel's inputs must lie on one device, got {devices}")
    return devices.pop()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.moeva_error_string(err).decode()}")


def _merged(f, off_f, what: str):
    """``(f, off_f, M, P)`` of the merged objectives [f (S, P, 3), off_f (S,
    O, 3)] that K2, K4a and K3 read through two pointers (O = 0 without
    ``off_f``), contiguous, float32 on one card."""
    if f.dim() != 3:
        raise ValueError(f"{what}'s f must be (S, P, 3), got {tuple(f.shape)}")
    s, p, _ = f.shape
    _check(f, "f", (s, p, 3))
    if off_f is None:
        return f.contiguous(), None, p, p
    if off_f.dim() != 3:
        raise ValueError(f"{what}'s off_f must be (S, O, 3), got {tuple(off_f.shape)}")
    _check(off_f, "off_f", (s, off_f.shape[1], 3))
    _one_device(f, off_f)
    return f.contiguous(), off_f.contiguous(), p + off_f.shape[1], p


def nd_peel(f: torch.Tensor, n_stop: int, off_f: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K2: front ranks (S, M) int32 of the merged objectives [f (S,
    P, 3), off_f (S, M - P, 3)] float32, read through two pointers (M = P
    without ``off_f``)."""
    from .build import library

    f, off_f, m, p = _merged(f, off_f, "nd_peel")
    s = f.shape[0]
    lib = library()
    if m > lib.moeva_nd_peel_max_candidates():
        raise ValueError(
            f"nd_peel takes at most {lib.moeva_nd_peel_max_candidates()} "
            f"candidates per state, got {m}"
        )
    ranks = torch.empty((s, m), dtype=torch.int32, device=f.device)
    with torch.cuda.device(f.device):
        err = lib.moeva_nd_peel_f32(f.data_ptr(), _ptr(off_f), ranks.data_ptr(), s, m, p, int(n_stop),
                                    _stream(f.device))
    _raise_on_error(lib, err, "nd_peel")
    _LAUNCHES["nd_peel"] += 1
    return ranks


def offspring(tables, pop_x, xl, xu, n_offsprings: int, draws, crossover_prob=0.9, eta_mutation=20.0):
    """Kernel K5: (S, n_offsprings, L) float32 offspring of ``pop_x``
    (S, P, L) within ``xl``/``xu`` (S, L), from ``draws`` (an
    ``OffspringDraws``) and the gene tables ``tables`` (an
    ``OperatorTables``), all on one card. Parent indices must lie in
    [0, P): the kernel does not check them."""
    from .build import library

    if pop_x.dim() != 3:
        raise ValueError(f"pop_x must be (S, P, L), got {tuple(pop_x.shape)}")
    s, p, l = pop_x.shape
    n_mat = (n_offsprings + 1) // 2
    _check(pop_x, "pop_x", (s, p, l))
    _check(xl, "xl", (s, l))
    _check(xu, "xu", (s, l))
    _check(draws.pairs, "pairs", (s, n_mat, 2), torch.int64)
    _check(draws.cut_a, "cut_a", (3, s, n_mat), torch.int64)
    _check(draws.cut_b, "cut_b", (3, s, n_mat), torch.int64)
    _check(draws.coins, "coins", (3, s, n_mat))
    _check(draws.mut_select, "mut_select", (s, n_offsprings, l))
    _check(draws.mut_u, "mut_u", (s, n_offsprings, l))
    _check(tables.type_id, "type_id", (l,), torch.int64)
    _check(tables.rank_in_type, "rank_in_type", (l,), torch.int64)
    _check(tables.mut_prob, "mut_prob", (l,), torch.float64)
    _check(tables.int_mask, "int_mask", (l,), torch.bool)
    dev = _one_device(pop_x, xl, xu, *draws, tables.type_id, tables.rank_in_type,
                      tables.mut_prob, tables.int_mask)
    ins = [t.contiguous() for t in (pop_x, xl, xu, *draws, tables.type_id,
                                    tables.rank_in_type, tables.mut_prob, tables.int_mask)]
    lib = library()
    out = torch.empty((s, n_offsprings, l), dtype=torch.float32, device=dev)
    eta_p1 = float(eta_mutation) + 1.0
    with torch.cuda.device(dev):
        err = lib.moeva_offspring_f32(
            *(t.data_ptr() for t in ins), *tables.type_sizes, out.data_ptr(),
            s, p, l, n_offsprings, n_mat, float(crossover_prob), eta_p1, 1.0 / eta_p1,
            _stream(dev),
        )
    _raise_on_error(lib, err, "offspring")
    _LAUNCHES["offspring"] += 1
    return out


def _history_record(record, out, n_terms: int, kernel: str):
    """The record pointer that ``kernel`` writes, and its output: ``record``
    (S, N, 3 + C) float32, contiguous, beside ``out`` (S, N, 3) on its
    device. C = ``n_terms`` (the kept terms, "full") launches the kernel's
    history instantiation, which writes both; C = 0 ("reduced") makes
    ``record`` itself the output of the base kernel. None: no record."""
    if record is None:
        return None, out
    s, n, _ = out.shape
    cols = record.shape[-1] if record.dim() == 3 else -1
    if cols not in (3, 3 + n_terms):
        raise ValueError(f"{kernel}'s record must be (S, N, 3) or (S, N, {3 + n_terms}), got {tuple(record.shape)}")
    _check(record, "record", (s, n, cols))
    if record.device != out.device:
        raise ValueError(f"record must lie on {out.device}, got {record.device}")
    if not record.is_contiguous():
        raise ValueError(f"{kernel}'s record must be contiguous")
    return (None, record) if cols == 3 else (record.data_ptr(), out)


def _lcld_pairs(lib, cons, kernel: str, d: int, where: str) -> int:
    """The pair count P of the augmented LCLD tables ``cons`` (a
    ``domains.lcld.LcldPairTables``, None on the base domain) that
    ``kernel`` reads from ``where``; raises unless the rows have 47 + P
    features, P is at most the library's limit and the tables have their
    layout."""
    n_pairs = 0 if cons is None else cons.idx.shape[0]
    if n_pairs > lib.moeva_lcld_max_pairs() or d != 47 + n_pairs:
        raise ValueError(
            f"{kernel} takes LCLD's 47 features, or 47 + P on the augmented domain with its P <= "
            f"{lib.moeva_lcld_max_pairs()} pair tables in {where}, got {d} features and {n_pairs} pairs"
        )
    if cons is not None:
        _check(cons.idx, "pair_idx", (n_pairs, 2), torch.int32)
        _check(cons.thr, "pair_thr", (n_pairs, 2))
    return n_pairs


def objective_lcld(x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj, record=None):
    """Kernel K1: (S, N, 3) float32 objectives ``[f1, f2, Σ violations]``
    of the LCLD candidates ``x_gen`` (S, N, L), given the run's (S, D) rows
    and ``minimize_class`` (S,) int64, and ``obj`` (an
    ``engine.ObjectiveTables``) in float32 on the same card. On the
    augmented domain D = 47 + P and ``obj.cons`` holds the P pairs'
    tables (``domains.lcld.LcldPairTables``), whose feature indices must
    lie in [0, 47): the kernel does not check them. The kernel reads any
    class but 0 as class 1 and does not check it: ``Moeva2.generate``
    refuses a class outside the head's [0, 2) before anything reaches the
    card. Launches on the augmented domain count as ``objective_lcld_aug``.

    ``record``, a contiguous (S, N, 3 + 10 + P) float32 tensor on the same
    card, makes it launch its history instantiation (counted as
    ``objective_lcld_hist`` or ``objective_lcld_aug_hist``), which also
    writes each row's objectives and kept terms there; a (S, N, 3) one is
    written as the output itself, by the base kernel."""
    from .build import library

    if x_gen.dim() != 3 or x_init_ml.dim() != 2:
        raise ValueError("x_gen and x_init_ml must be (S, N, L) and (S, D)")
    s, n, l = x_gen.shape
    d = x_init_ml.shape[1]
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    _check(x_gen, "x_gen", (s, n, l))
    for name, t in (("x_init_ml", x_init_ml), ("xl_ml", xl_ml), ("xu_ml", xu_ml), ("x_init_mm", x_init_mm)):
        _check(t, name, (s, d))
    _check(minimize_class, "minimize_class", (s,), torch.int64)
    _check(obj.feat_gene, "feat_gene", (d,), torch.int32)
    _check(obj.feat_onehot, "feat_onehot", (d,), torch.int32)
    _check(obj.params, "params", (n_params,))
    scale, offset = obj.scaler if obj.scaler is not None else (None, None)
    if scale is not None:
        _check(scale, "scale", (d,))
        _check(offset, "offset", (d,))
    lib = library()
    n_pairs = _lcld_pairs(lib, obj.cons, "objective_lcld", d, "obj.cons")
    pairs = (None, None) if obj.cons is None else (obj.cons.idx, obj.cons.thr)
    if widths[0] != d or not 1 <= widths[-1] <= 2:
        raise ValueError(f"objective_lcld takes a {d}-input stack with 1 or 2 classes, got widths {widths}")
    if len(widths) - 1 > lib.moeva_objective_max_layers() or max(widths) > lib.moeva_objective_max_width():
        raise ValueError(
            f"objective_lcld takes at most {lib.moeva_objective_max_layers()} layers of width "
            f"{lib.moeva_objective_max_width()}, got widths {widths}"
        )
    if n_params > lib.moeva_objective_max_params():
        raise ValueError(f"objective_lcld's weights must fit shared memory: {n_params} parameters")
    dev = _one_device(x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class,
                      obj.feat_gene, obj.feat_onehot, obj.params, scale, offset, *pairs)
    ins = [None if t is None else t.contiguous() for t in (
        x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj.feat_gene,
        obj.feat_onehot, obj.params, scale, offset, *pairs)]
    rec, out = _history_record(record, torch.empty((s, n, 3), dtype=torch.float32, device=dev), 10 + n_pairs,
                               "objective_lcld")
    c_widths = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(dev):
        err = lib.moeva_objective_lcld_f32(
            *map(_ptr, ins[:9]), c_widths, len(widths) - 1, _ptr(ins[9]), _ptr(ins[10]),
            obj.f2_scale, int(obj.norm_inf), obj.tol, out.data_ptr(), rec, s, n, l, d, _ptr(ins[11]),
            _ptr(ins[12]), n_pairs, _stream(dev),
        )
    _raise_on_error(lib, err, "objective_lcld")
    _LAUNCHES[("objective_lcld_aug" if n_pairs else "objective_lcld") + ("_hist" if rec else "")] += 1
    return out


#: the widest layer K8 takes (``kBotnetMaxWidth`` in ``csrc/kernels.h``)
BOTNET_MAX_WIDTH = 64
#: botnet's base features (``kBotnetFeatures`` in ``csrc/kernels.h``); the
#: augmented domain's P pair features follow them
BOTNET_FEATURES = 756


def _botnet_counts(cons, kernel: str, where: str) -> list:
    """The segment counts of the botnet gather tables ``cons`` (a
    ``domains.botnet.BotnetTables``) that ``kernel`` reads from ``where``;
    raises unless they have its layout."""
    counts = [int(c) for c in getattr(cons, "counts", ())]
    if (len(counts) != 12 or min(counts[:4]) < 1 or min(counts) < 0
            or any(counts[k] != counts[k + 1] for k in range(4, 12, 2))):
        raise ValueError(
            f"{kernel} takes the botnet gather tables (BotnetTables) in {where}: non-empty flow and bytes lists and "
            f"paired ratio and ordering lists, got counts {counts}"
        )
    return counts


def objective_botnet(x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj, record=None):
    """Kernel K8: (S, N, 3) float32 objectives ``[f1, f2, Σ violations]``
    of the botnet candidates ``x_gen`` (S, N, L), the arguments of
    :func:`objective_lcld`; ``obj.cons`` holds the 360 terms' gather lists
    (``domains.botnet.BotnetTables``). It takes a stack of 2 to K1's most
    layers of at most ``BOTNET_MAX_WIDTH`` units, a first hidden width that
    is a multiple of 4, and 1 or 2 classes. The kernel reads any class but 0
    as class 1, as K1 does. D is 756, or 756 + P on the augmented domain,
    whose P pairs' tables ``obj.cons`` holds too (``pair_idx``, feature
    indices in [0, 756), which the kernel does not check, and
    ``pair_thr``); its launches count as ``objective_botnet_aug``.
    ``record`` as :func:`objective_lcld` takes it, (S, N, 3 + T) over the
    T = 360 (+ P) terms; the history instantiation counts as
    ``objective_botnet_hist`` or ``objective_botnet_aug_hist``."""
    from .build import library

    if x_gen.dim() != 3 or x_init_ml.dim() != 2:
        raise ValueError("x_gen and x_init_ml must be (S, N, L) and (S, D)")
    s, n, l = x_gen.shape
    d = x_init_ml.shape[1]
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    if (widths[0] != d or len(widths) < 3 or max(widths[1:]) > BOTNET_MAX_WIDTH or widths[1] % 4
            or not 1 <= widths[-1] <= 2):
        raise ValueError(
            f"objective_botnet takes a {d}-input stack of at least 2 layers of at most {BOTNET_MAX_WIDTH} "
            f"units, a first width that is a multiple of 4 and 1 or 2 classes, got widths {widths}"
        )
    cons = obj.cons
    counts = _botnet_counts(cons, "objective_botnet", "obj.cons")
    n_pairs = 0 if cons.pair_idx is None else cons.pair_idx.shape[0]
    if d != BOTNET_FEATURES + n_pairs:
        raise ValueError(f"objective_botnet takes botnet's {BOTNET_FEATURES} features, or {BOTNET_FEATURES} + P on the "
                         f"augmented domain with its P pair tables in obj.cons, got {d} features and {n_pairs} pairs")
    pairs = (None, None) if cons.pair_idx is None else (cons.pair_idx, cons.pair_thr)
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    _check(x_gen, "x_gen", (s, n, l))
    for name, t in (("x_init_ml", x_init_ml), ("xl_ml", xl_ml), ("xu_ml", xu_ml), ("x_init_mm", x_init_mm)):
        _check(t, name, (s, d))
    _check(minimize_class, "minimize_class", (s,), torch.int64)
    _check(obj.feat_gene, "feat_gene", (d,), torch.int32)
    _check(obj.feat_onehot, "feat_onehot", (d,), torch.int32)
    _check(obj.params, "params", (n_params,))
    _check(obj.first_t, "first_t", (d, widths[1]))
    _check(cons.index, "gather lists", (sum(counts),), torch.int32)
    if n_pairs:
        _check(cons.pair_idx, "pair_idx", (n_pairs, 2), torch.int32)
        _check(cons.pair_thr, "pair_thr", (n_pairs, 2))
    scale, offset = obj.scaler if obj.scaler is not None else (None, None)
    if scale is not None:
        _check(scale, "scale", (d,))
        _check(offset, "offset", (d,))
    lib = library()
    if n_pairs > lib.moeva_botnet_max_pairs():
        raise ValueError(f"objective_botnet takes at most {lib.moeva_botnet_max_pairs()} pairs, got {n_pairs}")
    if len(widths) - 1 > lib.moeva_objective_max_layers():
        raise ValueError(f"objective_botnet takes at most {lib.moeva_objective_max_layers()} layers, got {widths}")
    max_d = lib.moeva_objective_botnet_max_features(widths[1], sum(counts), n_pairs)
    if d > max_d:
        raise ValueError(f"objective_botnet takes at most {max_d} features with a first layer of {widths[1]} units, "
                         f"{sum(counts)} gather entries and {n_pairs} pairs, got {d}")
    dev = _one_device(x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj.feat_gene,
                      obj.feat_onehot, obj.params, obj.first_t, cons.index, scale, offset, *pairs)
    ins = [None if t is None else t.contiguous() for t in (
        x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj.feat_gene,
        obj.feat_onehot, obj.params, obj.first_t, scale, offset, cons.index, *pairs)]
    n_terms = 2 + counts[4] + counts[6] + counts[8] + counts[10] + n_pairs
    rec, out = _history_record(record, torch.empty((s, n, 3), dtype=torch.float32, device=dev), n_terms,
                               "objective_botnet")
    c_counts = (ctypes.c_int * len(counts))(*counts)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(dev):
        err = lib.moeva_objective_botnet_f32(
            *map(_ptr, ins[:13]), c_counts, c_widths, len(widths) - 1, obj.f2_scale, int(obj.norm_inf), obj.tol,
            out.data_ptr(), rec, s, n, l, d, _ptr(ins[13]), _ptr(ins[14]), n_pairs, _stream(dev),
        )
    _raise_on_error(lib, err, "objective_botnet")
    _LAUNCHES[("objective_botnet_aug" if n_pairs else "objective_botnet") + ("_hist" if rec else "")] += 1
    return out


def objective_spec(x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj, record=None):
    """Kernel K9: (S, N, 3) float32 objectives ``[f1, f2, Σ violations]``
    of the candidates ``x_gen`` (S, N, L) of a domain compiled from a spec,
    the arguments of :func:`objective_lcld`; ``obj.cons`` holds the spec's
    constraint program (``domains.ir.program.SpecProgram``), whose feature
    and slot indices the kernel does not check: ``lower_spec`` emits them in
    range. It takes a stack of 1 to K1's most layers of at most
    ``moeva_spec_max_width`` units, 1 or 2 classes, and the program limits
    of ``csrc/kernels.h``; any class but 0 reads as class 1, as in K1.
    ``record`` as :func:`objective_lcld` takes it, (S, N, 3 + T) over the
    program's T terms; the history instantiation counts as
    ``objective_spec_hist``."""
    from .build import library

    if x_gen.dim() != 3 or x_init_ml.dim() != 2:
        raise ValueError("x_gen and x_init_ml must be (S, N, L) and (S, D)")
    s, n, l = x_gen.shape
    d = x_init_ml.shape[1]
    prog = obj.cons
    if not all(hasattr(prog, k) for k in ("code", "n_slots", "n_terms", "n_features")):
        raise ValueError(f"objective_spec takes a spec's program (SpecProgram) in obj.cons, got {type(prog).__name__}")
    widths = [obj.layers[0][0].shape[1], *(w.shape[0] for w, _ in obj.layers)]
    n_params = sum(w.numel() + b.numel() for w, b in obj.layers)
    n_instr = prog.code.shape[0]
    _check(x_gen, "x_gen", (s, n, l))
    for name, t in (("x_init_ml", x_init_ml), ("xl_ml", xl_ml), ("xu_ml", xu_ml), ("x_init_mm", x_init_mm)):
        _check(t, name, (s, d))
    _check(minimize_class, "minimize_class", (s,), torch.int64)
    _check(obj.feat_gene, "feat_gene", (d,), torch.int32)
    _check(obj.feat_onehot, "feat_onehot", (d,), torch.int32)
    _check(obj.params, "params", (n_params,))
    _check(obj.first_t, "first_t", (d, widths[1]))
    _check(prog.code, "program", (n_instr, 4), torch.int32)
    scale, offset = obj.scaler if obj.scaler is not None else (None, None)
    if scale is not None:
        _check(scale, "scale", (d,))
        _check(offset, "offset", (d,))
    lib = library()
    limits = {"features": (d, lib.moeva_spec_max_features()),
              "instructions": (n_instr, lib.moeva_spec_max_instructions()),
              "slots": (prog.n_slots, lib.moeva_spec_max_slots()), "terms": (prog.n_terms, lib.moeva_spec_max_terms())}
    if any(not 1 <= n <= limit for n, limit in limits.values()) or prog.n_features != d:
        raise ValueError(f"objective_spec takes a program over the rows' {d} features within its limits "
                         f"(count, limit): {limits}; the program has {prog.n_features} features")
    max_w = lib.moeva_spec_max_width()
    if (widths[0] != d or not 1 <= widths[-1] <= 2 or max(widths[1:]) > max_w
            or len(widths) - 1 > lib.moeva_objective_max_layers()):
        raise ValueError(f"objective_spec takes a {d}-input stack of at most {lib.moeva_objective_max_layers()} "
                         f"layers of at most {max_w} units and 1 or 2 classes, got widths {widths}")
    if lib.moeva_objective_spec_tile_rows(n_instr, d, prog.n_slots, max(widths[1:])) == 0:
        raise ValueError(f"objective_spec's buffers of {n_instr} instructions, {d} features, {prog.n_slots} slots and "
                         f"layers of {max(widths[1:])} units do not fit one block's shared memory")
    dev = _one_device(x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj.feat_gene,
                      obj.feat_onehot, obj.params, obj.first_t, prog.code, scale, offset)
    ins = [None if t is None else t.contiguous() for t in (
        x_gen, x_init_ml, xl_ml, xu_ml, x_init_mm, minimize_class, obj.feat_gene,
        obj.feat_onehot, obj.params, obj.first_t, scale, offset, prog.code)]
    if ins[12].data_ptr() % 16:
        raise ValueError("objective_spec reads its program as 16-byte instructions: the code must be 16-byte aligned")
    rec, out = _history_record(record, torch.empty((s, n, 3), dtype=torch.float32, device=dev), prog.n_terms,
                               "objective_spec")
    c_widths = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(dev):
        err = lib.moeva_objective_spec_f32(
            *map(_ptr, ins), n_instr, prog.n_slots, prog.n_terms, c_widths, len(widths) - 1, obj.f2_scale,
            int(obj.norm_inf), obj.tol, out.data_ptr(), rec, s, n, l, d, _stream(dev),
        )
    _raise_on_error(lib, err, "objective_spec")
    _LAUNCHES["objective_spec" + ("_hist" if rec else "")] += 1
    return out


def survive_norm(f, ranks, asp_points, state, off_f=None):
    """Kernel K4a: ``(ideal, worst, extreme, nadir, dirs)`` from the merged
    objectives [f (S, P, 3), off_f (S, M - P, 3)] (M = P without
    ``off_f``), their front ranks (S, M) int32, ``asp_points`` (A, 3) and
    the normalisation state ``(ideal, worst, extreme)``, all float32 on one
    card; ``dirs`` is (S, A + 3, 3). M and A + 3 are at most the survival
    kernels' limit, as ``survive_fill`` takes them."""
    from .build import library

    if asp_points.dim() != 2:
        raise ValueError("asp_points must be (A, 3)")
    f, off_f, m, p = _merged(f, off_f, "survive_norm")
    s = f.shape[0]
    a = asp_points.shape[0]
    if m < 1:
        raise ValueError("survive_norm needs at least one candidate per state")
    ideal, worst, extreme = state
    _check(ranks, "ranks", (s, m), torch.int32)
    _check(asp_points, "asp_points", (a, 3))
    _check(ideal, "ideal", (s, 3))
    _check(worst, "worst", (s, 3))
    _check(extreme, "extreme", (s, 3, 3))
    dev = _one_device(f, ranks, asp_points, ideal, worst, extreme)
    ins = [t.contiguous() for t in (ranks, asp_points, ideal, worst, extreme)]
    lib = library()
    limit = lib.moeva_survive_max_candidates()
    if max(m, a + 3) > limit:
        raise ValueError(f"survive_norm takes at most {limit} candidates and directions per state, got M={m}, R={a + 3}")
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for shape in ((s, 3), (s, 3), (s, 3, 3), (s, 3), (s, a + 3, 3))]
    with torch.cuda.device(dev):
        err = lib.moeva_survive_norm_f32(
            f.data_ptr(), _ptr(off_f), *(t.data_ptr() for t in ins + outs), s, m, p, a, _stream(dev)
        )
    _raise_on_error(lib, err, "survive_norm")
    _LAUNCHES["survive_norm"] += 1
    return tuple(outs)


class FillResult(NamedTuple):
    """What one launch of K4b returns; None where it was not asked for."""

    mask: torch.Tensor | None  # (S, M) bool
    pop_x: torch.Tensor | None  # (S, P, L) survivors first
    pop_f: torch.Tensor | None  # (S, P, 3)
    arch_x: torch.Tensor | None  # (S, A, L)
    arch_f: torch.Tensor | None  # (S, A, 3)


def _fill_launch(s, fill=None, extract=None, archive=None) -> FillResult:
    """One launch of K4b. ``fill`` = (gum_cut, gum_mem, ranks, niche, dist,
    n_survive); ``extract`` = (pop_x, off_x, pop_f, off_f); ``archive`` =
    (a_x, a_f, b_x, b_f, size)."""
    from .build import library

    tensors = []
    m = r = p = l = n_a = n_b = size = n_survive = 0
    mask = new_x = new_f = arch_x = arch_f = None
    if fill is not None:
        gum_cut, gum_mem, ranks, niche, dist, n_survive = fill
        if ranks.dim() != 2 or gum_cut.dim() != 2:
            raise ValueError("ranks and gum_cut must be (S, M) and (S, R)")
        m, r = ranks.shape[1], gum_cut.shape[1]
        _check(ranks, "ranks", (s, m), torch.int32)
        _check(niche, "niche", (s, m), torch.int64)
        _check(dist, "dist", (s, m))
        _check(gum_cut, "gum_cut", (s, r))
        _check(gum_mem, "gum_mem", (s, m))
        tensors += [ranks, niche, dist, gum_cut, gum_mem]
        mask = torch.empty((s, m), dtype=torch.bool, device=ranks.device)
    if extract is not None:
        pop_x, off_x, pop_f, off_f = extract
        p, l = pop_x.shape[1], pop_x.shape[2]
        if m <= p:
            raise ValueError(f"extraction needs offspring: M={m}, P={p}")
        _check(pop_x, "pop_x", (s, p, l))
        _check(off_x, "off_x", (s, m - p, l))
        _check(pop_f, "pop_f", (s, p, 3))
        _check(off_f, "off_f", (s, m - p, 3))
        tensors += [pop_x, off_x, pop_f, off_f]
        new_x = torch.empty((s, p, l), dtype=torch.float32, device=pop_x.device)
        new_f = torch.empty((s, p, 3), dtype=torch.float32, device=pop_x.device)
    if archive is not None:
        a_x, a_f, b_x, b_f, size = archive
        n_a, n_b, l = a_x.shape[1], b_x.shape[1], a_x.shape[2]
        _check(a_x, "a_x", (s, n_a, l))
        _check(a_f, "a_f", (s, n_a, 3))
        _check(b_x, "b_x", (s, n_b, l))
        _check(b_f, "b_f", (s, n_b, 3))
        tensors += [a_x, a_f, b_x, b_f]
        arch_x = torch.empty((s, size, l), dtype=torch.float32, device=a_x.device)
        arch_f = torch.empty((s, size, 3), dtype=torch.float32, device=a_x.device)
    dev = _one_device(*tensors)
    lib = library()
    limit = lib.moeva_survive_max_candidates()
    if max(m, r) > limit:
        raise ValueError(f"survive_fill takes at most {limit} candidates and directions per state, got M={m}, R={r}")
    if archive is not None and (not 0 < size <= n_a + n_b or n_a + n_b > 2 * limit):
        raise ValueError(f"archive of {size} from {n_a} + {n_b} candidates (at most {2 * limit})")
    if fill is not None:
        ranks, niche, dist, gum_cut, gum_mem = (t.contiguous() for t in tensors[:5])
    if extract is not None:
        pop_x, off_x, pop_f, off_f = (t.contiguous() for t in extract)
    if archive is not None:
        a_x, a_f, b_x, b_f = (t.contiguous() for t in archive[:4])
    flags = (fill is not None) | (extract is not None) << 1 | (archive is not None) << 2
    with torch.cuda.device(dev):
        err = lib.moeva_survive_fill_f32(
            *map(_ptr, (ranks, niche, dist, gum_cut, gum_mem, mask) if fill is not None else (None,) * 6),
            int(n_survive),
            *map(_ptr, (pop_x, off_x, pop_f, off_f, new_x, new_f) if extract is not None else (None,) * 6),
            p,
            *map(_ptr, (a_x, a_f, b_x, b_f, arch_x, arch_f) if archive is not None else (None,) * 6),
            n_a, n_b, size, s, m, r, l, flags, _stream(dev),
        )
    _raise_on_error(lib, err, "survive_fill")
    _LAUNCHES["survive_fill"] += 1
    return FillResult(mask, new_x, new_f, arch_x, arch_f)


def survive_fill(gum_cut, gum_mem, ranks, niche, dist, n_survive: int, extract=None, archive=None) -> FillResult:
    """Kernel K4b: the survivor mask (S, M) from the niching draws
    ``gum_cut`` (S, R) and ``gum_mem`` (S, M), the front ranks (int32),
    niches (int64) and distances, the arguments of ``survive_fill_plain``.
    With ``extract=(pop_x, off_x, pop_f, off_f)`` the
    same launch writes the next population, survivors of
    [population, offspring] first; with ``archive=(a_x, a_f, b_x, b_f,
    size)`` the ``size`` best of [a rows, b rows]. float32 on one card;
    ranks must be in [0, M) or ``UNRANKED``, as ``nd_peel`` gives them."""
    if ranks.dim() != 2:
        raise ValueError(f"ranks must be (S, M), got {tuple(ranks.shape)}")
    return _fill_launch(
        ranks.shape[0], fill=(gum_cut, gum_mem, ranks, niche, dist, n_survive),
        extract=extract, archive=archive,
    )


def archive_select(a_x, a_f, b_x, b_f, size: int):
    """Kernel K4b without the fill: the ``size`` best candidates of
    [a rows, b rows] by archive score, as ``(arch_x, arch_f)``."""
    if a_x.dim() != 3:
        raise ValueError(f"a_x must be (S, n_a, L), got {tuple(a_x.shape)}")
    out = _fill_launch(a_x.shape[0], archive=(a_x, a_f, b_x, b_f, size))
    return out.arch_x, out.arch_f


def associate(f, dirs, ideal, nadir, off_f=None):
    """Kernel K3: ``(niche (S, M) int64, dist (S, M) float32)`` from the
    merged objectives [f (S, P, 3), off_f (S, M - P, 3)] (M = P without
    ``off_f``), ``dirs`` (S, R, 3), ``ideal``/``nadir`` (S, 3), all float32
    on one card; R is at most the directions one block's shared memory
    holds (14528)."""
    from .build import library

    if dirs.dim() != 3:
        raise ValueError("dirs must be (S, R, 3)")
    f, off_f, m, p = _merged(f, off_f, "associate")
    s = f.shape[0]
    r = dirs.shape[1]
    _check(dirs, "dirs", (s, r, 3))
    _check(ideal, "ideal", (s, 3))
    _check(nadir, "nadir", (s, 3))
    if len({t.device for t in (f, dirs, ideal, nadir)}) != 1:
        raise ValueError("associate's inputs must lie on one device")
    dirs, ideal, nadir = (t.contiguous() for t in (dirs, ideal, nadir))
    lib = library()
    if not 1 <= r <= lib.moeva_associate_max_directions():
        raise ValueError(f"associate takes 1 to {lib.moeva_associate_max_directions()} directions per state, got {r}")
    niche = torch.empty((s, m), dtype=torch.int64, device=f.device)
    dist = torch.empty((s, m), dtype=torch.float32, device=f.device)
    with torch.cuda.device(f.device):
        err = lib.moeva_associate_f32(
            f.data_ptr(), _ptr(off_f), dirs.data_ptr(), ideal.data_ptr(), nadir.data_ptr(),
            niche.data_ptr(), dist.data_ptr(), s, m, p, r, _stream(f.device),
        )
    _raise_on_error(lib, err, "associate")
    _LAUNCHES["associate"] += 1
    return niche, dist


def _check_pgd_run(tables, sched, x_init, y, x_start) -> None:
    """The checks of the arguments K7 and K7b take alike: (N, D) float32
    rows, (N,) int64 labels, the stack's flat weights, the (D,) scaler and
    mask and a ``PgdSchedule`` of T rows."""
    n, d = x_init.shape
    t = sched.step.numel()
    _check(x_init, "x_init", (n, d))
    _check(x_start, "x_start", (n, d))
    _check(y, "y", (n,), torch.int64)
    _check(tables.params, "params", (sum(w.numel() + b.numel() for w, b in tables.layers),))
    _check(tables.scale, "scale", (d,))
    _check(tables.min_, "min_", (d,))
    _check(tables.mutable, "mutable", (d,), torch.bool)
    for name in ("w_class", "w_cons", "step"):
        _check(getattr(sched, name), name, (t,))
    _check(sched.ctr, "ctr", (t,), torch.int32)


def _pgd_outputs(n: int, d: int, t: int, n_terms: int, norm_inf: bool, repair: bool, targeted: bool, record, dev):
    """``(x_adv, pred, hist, history columns, flags)`` of a PGD kernel's
    launch: the outputs on ``dev`` and the flags both kernels read (1 =
    L-inf, 2 = repair, 4 = targeted, 8 = the grad-norm column, 16 = the
    set's ``n_terms`` violations)."""
    x_adv = torch.empty((n, d), dtype=torch.float32, device=dev)
    pred = torch.empty((n,), dtype=torch.int64, device=dev)
    cols = 0 if record is None else 3 + bool(record[0]) + (n_terms if record[1] else 0)
    hist = None if record is None else torch.empty((t, n, cols), dtype=torch.float32, device=dev)
    flags = (int(norm_inf) | int(repair) << 1 | int(targeted) << 2
             | (0 if record is None else int(bool(record[0])) << 3 | int(bool(record[1])) << 4))
    return x_adv, pred, hist, cols, flags


def pgd_lcld(tables, sched, x_init, y, x_start, eps: float, clip: tuple, norm_inf: bool, repair: bool,
             targeted: bool, record=None, auto=None):
    """Kernel K7: one constrained PGD run on LCLD rows, ``(x_adv (N, D)
    float32, pred (N,) int64, hist)``, the semantics of
    ``attacks.pgd.engine.pgd_run_plain``: ``tables`` a ``PgdTables`` (a
    relu stack of D inputs, 1 or 2 classes and at most K1's layers and
    width, whose weights fit shared memory), ``sched`` a ``PgdSchedule`` of
    T rows, ``x_init``/``x_start`` (N, D) scaled rows, ``y`` (N,) int64
    labels, all float32 (int32 tables) on one card; ``hist`` is (T, N, C)
    with ``record = (grad_norm, full)``, else None. D is 47, or 47 + P on
    the augmented domain, whose P pairs' tables are ``tables.cons``
    (``domains.lcld.LcldPairTables``, feature indices in [0, 47), which the
    kernel does not check); its launches count as ``pgd_lcld_aug``. The
    kernel reads any label but 0 and 1 as neither class:
    ``ConstrainedPGD.generate`` refuses them before anything reaches the
    card.

    With ``auto`` (``attacks.pgd.autopgd.AutoPgdTables`` for T iterations)
    the run is AutoPGD's, the semantics of ``autopgd_run_plain`` (the
    schedule's step is not read): ``(x_best, pred, hist, eta)``, ``pred``
    the class at x_best and ``eta`` (N,) float32 each row's final step;
    its launches count as ``pgd_lcld_auto`` (``pgd_lcld_aug_auto`` on the
    augmented domain)."""
    from .build import library

    if x_init.dim() != 2:
        raise ValueError(f"x_init must be (N, D), got {tuple(x_init.shape)}")
    n, d = x_init.shape
    t = sched.step.numel()
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    _check_pgd_run(tables, sched, x_init, y, x_start)
    if tables.ohe.dim() != 2:
        raise ValueError(f"ohe must be (G, K), got {tuple(tables.ohe.shape)}")
    _check(tables.ohe, "ohe", tuple(tables.ohe.shape), torch.int32)
    lib = library()
    n_pairs = _lcld_pairs(lib, tables.cons, "pgd_lcld", d, "tables.cons")
    pairs = (None, None) if tables.cons is None else (tables.cons.idx, tables.cons.thr)
    if widths[0] != d or not 1 <= widths[-1] <= 2:
        raise ValueError(f"pgd_lcld takes a {d}-input stack with 1 or 2 classes, got widths {widths}")
    if len(widths) - 1 > lib.moeva_objective_max_layers() or max(widths) > lib.moeva_objective_max_width():
        raise ValueError(
            f"pgd_lcld takes at most {lib.moeva_objective_max_layers()} layers of width "
            f"{lib.moeva_objective_max_width()}, got widths {widths}"
        )
    if tables.ohe.numel() > lib.moeva_pgd_max_ohe_slots():
        raise ValueError(f"pgd_lcld takes at most {lib.moeva_pgd_max_ohe_slots()} one-hot slots")
    if auto is not None:
        _check(auto.is_ckpt, "is_ckpt", (t + 1,), torch.bool)
        _check(auto.thr, "thr", (t + 1,))
        if not (-1 <= auto.ctr < 10 + n_pairs):
            raise ValueError(f"the tracking constraint {auto.ctr} is not one of the {10 + n_pairs} terms or -1")
    ckpt = (None, None) if auto is None else (auto.is_ckpt, auto.thr)
    dev = _one_device(x_init, x_start, y, tables.params, tables.scale, tables.min_, tables.mutable, tables.ohe,
                      *sched, *pairs, *ckpt)
    ins = [t_.contiguous() for t_ in (x_init, x_start, y, tables.mutable, tables.params, tables.scale, tables.min_,
                                      tables.ohe, *sched)]
    pairs = [None if t_ is None else t_.contiguous() for t_ in pairs]
    ckpt = [None if t_ is None else t_.contiguous() for t_ in ckpt]
    x_adv, pred, hist, cols, flags = _pgd_outputs(n, d, t, 10 + n_pairs, norm_inf, repair, targeted, record, dev)
    eta = None
    scalars = (0.0, 0.0, -1, 0.0, 1.0)
    if auto is not None:
        eta = torch.empty((n,), dtype=torch.float32, device=dev)
        scalars = (float(auto.w_class), float(auto.w_cons), int(auto.ctr), float(auto.eta0), float(auto.alpha))
        flags |= 32
    c_widths = (ctypes.c_int * len(widths))(*widths)
    lo, hi = clip
    with torch.cuda.device(dev):
        err = lib.moeva_pgd_lcld_f32(
            *(u.data_ptr() for u in ins[:5]), c_widths, len(widths) - 1,
            *(u.data_ptr() for u in ins[5:8]), tables.ohe.shape[0], tables.ohe.shape[1],
            *(u.data_ptr() for u in ins[8:]), x_adv.data_ptr(), pred.data_ptr(), _ptr(hist), cols, n, t,
            float(eps), float(lo), float(hi), float(tables.tol), flags, d, *map(_ptr, pairs), n_pairs,
            *map(_ptr, ckpt), *scalars, _ptr(eta), _stream(dev),
        )
    _raise_on_error(lib, err, "pgd_lcld")
    _LAUNCHES[("pgd_lcld_aug" if n_pairs else "pgd_lcld") + ("" if auto is None else "_auto")] += 1
    return (x_adv, pred, hist) if auto is None else (x_adv, pred, hist, eta)


def pgd_botnet(tables, sched, x_init, y, x_start, eps: float, clip: tuple, norm_inf: bool, repair: bool,
               targeted: bool, record=None, auto=None):
    """Kernel K7b: one constrained PGD run on botnet rows, ``(x_adv (N, D)
    float32, pred (N,) int64, hist)``, the semantics of
    ``attacks.pgd.engine.pgd_run_plain`` with ``BotnetConstraints``: the
    arguments of :func:`pgd_lcld`, with ``tables.cons`` the set's gather
    and inverse tables (``domains.botnet.BotnetTables``) and
    ``tables.first_t`` the first layer transposed. It takes a relu stack of
    D inputs, 2 to K1's most layers of at most ``BOTNET_MAX_WIDTH`` units
    and 1 or 2 classes; ``hist`` holds the set's terms with ``record[1]``.
    The kernel reads any label but 0 and 1 as neither class, as K7 does.
    D is 756, or 756 + 171 on the augmented domain
    (``BotnetAugmentedConstraints`` at k = 19), whose pairs' tables
    ``tables.cons`` holds too (``pair_idx``, feature indices in [0, 756),
    which the kernel does not check, and ``pair_thr``): its own
    instantiation, compiled for those 927 features, without repair (the set
    has none); its launches count as ``pgd_botnet_aug``.

    With ``auto`` the run is AutoPGD's, as :func:`pgd_lcld` takes it
    (``autopgd_run_plain``'s semantics): ``(x_best, pred, hist, eta)``; its
    launches count as ``pgd_botnet_auto`` (``pgd_botnet_aug_auto`` on the
    augmented domain)."""
    from .build import library

    if x_init.dim() != 2:
        raise ValueError(f"x_init must be (N, D), got {tuple(x_init.shape)}")
    n, d = x_init.shape
    t = sched.step.numel()
    cons = tables.cons
    n_pairs = 0 if getattr(cons, "pair_idx", None) is None else cons.pair_idx.shape[0]
    if d != BOTNET_FEATURES + n_pairs:
        raise ValueError(f"pgd_botnet takes botnet's {BOTNET_FEATURES} features, or {BOTNET_FEATURES} + P on the "
                         f"augmented domain with its P pair tables in tables.cons, got {d} features and {n_pairs} pairs")
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    if widths[0] != d or len(widths) < 3 or max(widths[1:-1]) > BOTNET_MAX_WIDTH or not 1 <= widths[-1] <= 2:
        raise ValueError(
            f"pgd_botnet takes a {d}-input stack of at least 2 layers of at most {BOTNET_MAX_WIDTH} units and 1 "
            f"or 2 classes, got widths {widths}"
        )
    counts = _botnet_counts(cons, "pgd_botnet", "tables.cons")
    if n_pairs and repair:
        raise ValueError("pgd_botnet takes no repair on the augmented domain: the set's repair is undefined")
    _check_pgd_run(tables, sched, x_init, y, x_start)
    _check(tables.first_t, "first_t", (d, widths[1]))
    _check(cons.index, "gather lists", (sum(counts),), torch.int32)
    if cons.inverse.dim() != 2:
        raise ValueError(f"the inverse table must be (D, degree), got {tuple(cons.inverse.shape)}")
    degree = cons.inverse.shape[1]
    _check(cons.inverse, "inverse table", (d, degree), torch.int32)
    if n_pairs:
        _check(cons.pair_idx, "pair_idx", (n_pairs, 2), torch.int32)
        _check(cons.pair_thr, "pair_thr", (n_pairs, 2))
    lib = library()
    if n_pairs not in (0, lib.moeva_pgd_botnet_aug_pairs()):
        raise ValueError(f"pgd_botnet's augmented instantiation is compiled for {lib.moeva_pgd_botnet_aug_pairs()} "
                         f"pairs (k = 19 important features), got {n_pairs}")
    if len(widths) - 1 > lib.moeva_objective_max_layers():
        raise ValueError(f"pgd_botnet takes at most {lib.moeva_objective_max_layers()} layers, got widths {widths}")
    if not 1 <= degree <= lib.moeva_pgd_botnet_max_degree():
        raise ValueError(f"pgd_botnet takes 1 to {lib.moeva_pgd_botnet_max_degree()} entries per feature, "
                         f"got {degree}")
    n_terms = 2 + sum(counts[4::2]) + n_pairs
    if auto is not None:
        _check(auto.is_ckpt, "is_ckpt", (t + 1,), torch.bool)
        _check(auto.thr, "thr", (t + 1,))
        if not (-1 <= auto.ctr < n_terms):
            raise ValueError(f"the tracking constraint {auto.ctr} is not one of the {n_terms} terms or -1")
    ckpt = (None, None) if auto is None else (auto.is_ckpt, auto.thr)
    pairs = (None, None) if not n_pairs else (cons.pair_idx, cons.pair_thr)
    dev = _one_device(x_init, x_start, y, tables.params, tables.first_t, tables.scale, tables.min_,
                      tables.mutable, cons.index, cons.inverse, *sched, *ckpt, *pairs)
    ins = [t_.contiguous() for t_ in (x_init, x_start, y, tables.mutable, tables.params, tables.first_t,
                                      tables.scale, tables.min_, cons.index, cons.inverse, *sched)]
    ckpt = [None if t_ is None else t_.contiguous() for t_ in ckpt]
    pairs = [None if t_ is None else t_.contiguous() for t_ in pairs]
    x_adv, pred, hist, cols, flags = _pgd_outputs(n, d, t, n_terms, norm_inf, repair, targeted, record, dev)
    eta = None
    scalars = (0.0, 0.0, -1, 0.0, 1.0)
    if auto is not None:
        eta = torch.empty((n,), dtype=torch.float32, device=dev)
        scalars = (float(auto.w_class), float(auto.w_cons), int(auto.ctr), float(auto.eta0), float(auto.alpha))
        flags |= 32
    c_widths = (ctypes.c_int * len(widths))(*widths)
    c_counts = (ctypes.c_int * len(counts))(*counts)
    lo, hi = clip
    with torch.cuda.device(dev):
        err = lib.moeva_pgd_botnet_f32(
            *(u.data_ptr() for u in ins[:6]), c_widths, len(widths) - 1,
            *(u.data_ptr() for u in ins[6:9]), c_counts, ins[9].data_ptr(), degree,
            *(u.data_ptr() for u in ins[10:]), x_adv.data_ptr(), pred.data_ptr(), _ptr(hist), cols, n, t,
            float(eps), float(lo), float(hi), float(tables.tol), flags, *map(_ptr, ckpt), *scalars, _ptr(eta),
            *map(_ptr, pairs), n_pairs, _stream(dev),
        )
    _raise_on_error(lib, err, "pgd_botnet")
    _LAUNCHES[("pgd_botnet_aug" if n_pairs else "pgd_botnet") + ("" if auto is None else "_auto")] += 1
    return (x_adv, pred, hist) if auto is None else (x_adv, pred, hist, eta)


def pgd_spec(tables, sched, x_init, y, x_start, eps: float, clip: tuple, norm_inf: bool, repair: bool,
             targeted: bool, record=None, auto=None):
    """Kernel K10: one constrained PGD run on the rows of a domain compiled
    from a constraint spec, ``(x_adv (N, D) float32, pred (N,) int64,
    hist)``, the semantics of ``attacks.pgd.engine.pgd_run_plain`` with a
    ``SpecConstraintSet``: the arguments of :func:`pgd_lcld`, with
    ``tables.cons`` the set's reverse and repair programs and the reverse
    program's term and contribution tables
    (``domains.ir.torch_backend.SpecPgdTables``, whose feature, slot and
    contribution indices the kernel does not check: the lowering emits them
    in range) and
    ``tables.first_t`` the first layer transposed. It takes a relu stack of
    D inputs, at most K1's layers, hidden layers of at most
    ``moeva_spec_max_width`` units and 1 or 2 classes, the programs' limits of
    ``csrc/kernels.h`` and as many features as one row's buffers fit in a
    block's shared memory; ``hist`` holds the program's terms with
    ``record[1]``. The kernel reads any label but 0 and 1 as neither class,
    as K7 does.

    With ``auto`` the run is AutoPGD's, as :func:`pgd_lcld` takes it
    (``autopgd_run_plain``'s semantics): ``(x_best, pred, hist, eta)``; its
    launches count as ``pgd_spec_auto``."""
    from .build import library

    if x_init.dim() != 2:
        raise ValueError(f"x_init must be (N, D), got {tuple(x_init.shape)}")
    n, d = x_init.shape
    t = sched.step.numel()
    widths = [tables.layers[0][0].shape[1], *(w.shape[0] for w, _ in tables.layers)]
    progs = tables.cons
    if not all(hasattr(progs, k) for k in ("vjp", "repair")):
        raise ValueError(f"pgd_spec takes a spec's programs (SpecPgdTables) in tables.cons, got {type(progs).__name__}")
    vjp, rep = progs.vjp, progs.repair
    n_acc = progs.acc_idx.numel()
    _check_pgd_run(tables, sched, x_init, y, x_start)
    _check(tables.first_t, "first_t", (d, widths[1]))
    if tables.ohe.dim() != 2:
        raise ValueError(f"ohe must be (G, K), got {tuple(tables.ohe.shape)}")
    _check(tables.ohe, "ohe", tuple(tables.ohe.shape), torch.int32)
    _check(vjp.code, "reverse program", (vjp.code.shape[0], 4), torch.int32)
    _check(rep.code, "repair program", (rep.code.shape[0], 4), torch.int32)
    _check(progs.term_start, "term starts", (vjp.n_terms + 1,), torch.int32)
    _check(progs.acc_ptr, "contribution pointers", (d + 1,), torch.int32)
    _check(progs.acc_idx, "contribution indices", (n_acc,), torch.int32)
    lib = library()
    limits = {"features": (d, lib.moeva_spec_max_features()), "terms": (vjp.n_terms, lib.moeva_spec_max_terms()),
              "reverse instructions": (vjp.code.shape[0], lib.moeva_spec_vjp_max_instructions()),
              "repair instructions": (max(rep.code.shape[0], 1), lib.moeva_spec_vjp_max_instructions()),
              "slots": (max(vjp.n_slots, rep.n_slots), lib.moeva_spec_vjp_max_slots())}
    if any(not 1 <= c <= limit for c, limit in limits.values()) or vjp.n_features != d or rep.n_features != d:
        raise ValueError(f"pgd_spec takes programs over the rows' {d} features within its limits (count, limit): "
                         f"{limits}; the programs have {vjp.n_features} and {rep.n_features} features")
    max_w = lib.moeva_spec_max_width()
    if (widths[0] != d or not 1 <= widths[-1] <= 2 or max(widths[1:-1], default=1) > max_w
            or len(widths) - 1 > lib.moeva_objective_max_layers()):
        raise ValueError(f"pgd_spec takes a {d}-input stack of at most {lib.moeva_objective_max_layers()} layers, "
                         f"hidden ones of at most {max_w} units, and 1 or 2 classes, got widths {widths}")
    c_widths = (ctypes.c_int * len(widths))(*widths)
    if lib.moeva_pgd_spec_block_rows(d, c_widths, len(widths) - 1, vjp.n_terms, n_acc, int(auto is not None)) == 0:
        raise ValueError(f"pgd_spec's buffers for one row of {d} features, {vjp.n_terms} terms, {n_acc} "
                         f"contributions and the stack {widths} do not fit one block's shared memory")
    if auto is not None:
        _check(auto.is_ckpt, "is_ckpt", (t + 1,), torch.bool)
        _check(auto.thr, "thr", (t + 1,))
        if not (-1 <= auto.ctr < vjp.n_terms):
            raise ValueError(f"the tracking constraint {auto.ctr} is not one of the {vjp.n_terms} terms or -1")
    ckpt = (None, None) if auto is None else (auto.is_ckpt, auto.thr)
    dev = _one_device(x_init, x_start, y, tables.params, tables.first_t, tables.scale, tables.min_,
                      tables.mutable, tables.ohe, vjp.code, rep.code, progs.term_start, progs.acc_ptr,
                      progs.acc_idx, *sched, *ckpt)
    ins = [t_.contiguous() for t_ in (x_init, x_start, y, tables.mutable, tables.params, tables.first_t,
                                      tables.scale, tables.min_, tables.ohe, *sched, vjp.code, rep.code,
                                      progs.term_start, progs.acc_ptr, progs.acc_idx)]
    if ins[13].data_ptr() % 16 or (rep.code.shape[0] and ins[14].data_ptr() % 16):
        raise ValueError("pgd_spec reads its programs as 16-byte instructions: the code must be 16-byte aligned")
    ckpt = [None if t_ is None else t_.contiguous() for t_ in ckpt]
    x_adv, pred, hist, cols, flags = _pgd_outputs(n, d, t, vjp.n_terms, norm_inf, repair, targeted, record, dev)
    eta = None
    scalars = (0.0, 0.0, -1, 0.0, 1.0)
    if auto is not None:
        eta = torch.empty((n,), dtype=torch.float32, device=dev)
        scalars = (float(auto.w_class), float(auto.w_cons), int(auto.ctr), float(auto.eta0), float(auto.alpha))
        flags |= 32
    lo, hi = clip
    with torch.cuda.device(dev):
        err = lib.moeva_pgd_spec_f32(
            *(u.data_ptr() for u in ins[:6]), c_widths, len(widths) - 1,
            *(u.data_ptr() for u in ins[6:9]), tables.ohe.shape[0], tables.ohe.shape[1],
            *(u.data_ptr() for u in ins[9:14]), vjp.code.shape[0], vjp.n_terms,
            *(u.data_ptr() for u in ins[15:]), n_acc, _ptr(ins[14]) if rep.code.shape[0] else None,
            rep.code.shape[0], x_adv.data_ptr(), pred.data_ptr(), _ptr(hist), cols, n, t,
            float(eps), float(lo), float(hi), float(tables.tol), flags, d, *map(_ptr, ckpt),
            *scalars[:2], scalars[2], *scalars[3:], _ptr(eta), _stream(dev),
        )
    _raise_on_error(lib, err, "pgd_spec")
    _LAUNCHES["pgd_spec" if auto is None else "pgd_spec_auto"] += 1
    return (x_adv, pred, hist) if auto is None else (x_adv, pred, hist, eta)


def gate_stats(pop_f, arch_f, thr: float, eps: float) -> torch.Tensor:
    """Kernel K6a: the (S, 9) float32 gate statistics of the population's
    objectives ``pop_f`` (S, P, 3) and the archive's ``arch_f`` (S, A, 3,
    A may be 0), judged at ``thr`` and ``eps`` rounded to float32: the
    columns of ``attacks.objective.QUALITY_STAT_COLUMNS``."""
    from .build import library

    if pop_f.dim() != 3 or arch_f.dim() != 3:
        raise ValueError(f"pop_f and arch_f must be (S, P, 3) and (S, A, 3), got {tuple(pop_f.shape)}, "
                         f"{tuple(arch_f.shape)}")
    s, p, _ = pop_f.shape
    a = arch_f.shape[1]
    if p < 1:
        raise ValueError("gate_stats needs at least one population column")
    _check(pop_f, "pop_f", (s, p, 3))
    _check(arch_f, "arch_f", (s, a, 3))
    dev = _one_device(pop_f, arch_f)
    pop_f, arch_f = pop_f.contiguous(), arch_f.contiguous()
    lib = library()
    out = torch.empty((s, 9), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_gate_stats_f32(
            pop_f.data_ptr(), arch_f.data_ptr() if a else None, out.data_ptr(), s, p, a,
            float(thr), float(eps), _stream(dev),
        )
    _raise_on_error(lib, err, "gate_stats")
    _LAUNCHES["gate_stats"] += 1
    return out


def _host_rows(idx, n_src: int) -> torch.Tensor:
    """``idx`` (host indices: a CPU int64 tensor or an integer numpy array)
    as a 1-D CPU int64 tensor, every entry checked to lie in [0, n_src)."""
    if isinstance(idx, torch.Tensor):
        if idx.is_cuda:
            raise ValueError("take_carry takes host row indices (a CPU tensor or numpy array), not a CUDA tensor")
        if idx.dtype != torch.int64:
            raise TypeError(f"row indices must be int64, got {idx.dtype}")
        rows = idx
    else:
        import numpy as np

        arr = np.asarray(idx)
        if arr.dtype.kind not in "iu":
            raise TypeError(f"row indices must be integers, got {arr.dtype}")
        rows = torch.as_tensor(arr.astype(np.int64))
    if rows.dim() != 1:
        raise ValueError(f"row indices must be 1-D, got shape {tuple(rows.shape)}")
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= n_src):
        raise ValueError(f"row indices must lie in [0, {n_src}), got [{int(rows.min())}, {int(rows.max())}]")
    return rows


def _take(idx: torch.Tensor, n_src: int, segments, dev) -> None:
    """One K6b launch: for each ``(src, dst, dst_stride, dst_offset)`` of
    ``segments``, row b of ``dst`` takes ``src``'s row ``idx[b]`` at its
    offset. ``idx`` is an int64 tensor on ``dev`` whose entries the caller
    has checked to lie in [0, n_src)."""
    from .build import library

    lib = library()
    segments = [seg for seg in segments if seg[0].numel()]
    if len(segments) > lib.moeva_take_max_segments():
        raise ValueError(f"take_carry gathers at most {lib.moeva_take_max_segments()} leaves, got {len(segments)}")
    n = len(segments)
    if not n or not idx.numel():
        return  # nothing to gather: no launch
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    with torch.cuda.device(dev):
        err = lib.moeva_take_f32(
            (vp * n)(*(src.data_ptr() for src, _, _, _ in segments)),
            (vp * n)(*(dst.data_ptr() for _, dst, _, _ in segments)),
            (ll * n)(*(src.numel() // n_src for src, _, _, _ in segments)),
            (ll * n)(*(stride for _, _, stride, _ in segments)),
            (ll * n)(*(offset for _, _, _, offset in segments)),
            n, idx.data_ptr(), idx.numel(), n_src, _stream(dev),
        )
    _raise_on_error(lib, err, "take_carry")
    _LAUNCHES["take_carry"] += 1


def _take_leaves(leaves, what: str):
    leaves = list(leaves)
    if not leaves or any(t.dim() < 1 for t in leaves):
        raise ValueError(f"{what} needs tensors with a leading states axis")
    n_src = leaves[0].shape[0]
    for i, t in enumerate(leaves):
        _check(t, f"{what} leaf {i}", (n_src, *t.shape[1:]))
    return [t.contiguous() for t in leaves], n_src, _one_device(*leaves)


def take_carry(idx, leaves):
    """Kernel K6b: every tensor of ``leaves`` (float32 (S, ...) on one
    card: a carry's pop_x, pop_f, arch_x, arch_f and normalisation state)
    gathered at the host row indices ``idx`` (B,) over the states axis into
    new (B, ...) buffers, in one launch. Duplicate indices repeat rows;
    indices outside [0, S) raise before anything is launched."""
    leaves, n_src, dev = _take_leaves(leaves, "take_carry")
    rows = _host_rows(idx, n_src)
    outs = [torch.empty((rows.numel(), *t.shape[1:]), dtype=torch.float32, device=dev) for t in leaves]
    _take(rows.to(dev), n_src, [(t, o, t[0].numel(), 0) for t, o in zip(leaves, outs)], dev)
    return outs


def final_columns(idx, pop_x, pop_f, arch_x, arch_f):
    """Kernel K6b for the returned columns of the host rows ``idx`` (B,):
    ``(x (B, P + A, L), f (B, P + A, 3))``, population columns then the
    archive's, in one launch; counts as ``take_carry``."""
    (pop_x, pop_f, arch_x, arch_f), n_src, dev = _take_leaves((pop_x, pop_f, arch_x, arch_f), "final_columns")
    s, p, l = pop_x.shape
    a = arch_x.shape[1]
    _check(pop_f, "pop_f", (s, p, 3))
    _check(arch_x, "arch_x", (s, a, l))
    _check(arch_f, "arch_f", (s, a, 3))
    rows = _host_rows(idx, n_src)
    out_x = torch.empty((rows.numel(), p + a, l), dtype=torch.float32, device=dev)
    out_f = torch.empty((rows.numel(), p + a, 3), dtype=torch.float32, device=dev)
    _take(rows.to(dev), n_src, [
        (pop_x, out_x, (p + a) * l, 0), (arch_x, out_x, (p + a) * l, p * l),
        (pop_f, out_f, (p + a) * 3, 0), (arch_f, out_f, (p + a) * 3, p * 3),
    ], dev)
    return out_x, out_f


#: K11's and K12's most layers (``kTrainMaxLayers`` in ``csrc/kernels.h``)
TRAIN_MAX_LAYERS = 8


def _mlp_widths(widths, what: str):
    """``widths`` as a ctypes int array, its layer count and the stack's
    parameter count, after the checks of K11 and K12 that need no library:
    1 to ``TRAIN_MAX_LAYERS`` layers and 2 classes."""
    widths = [int(v) for v in widths]
    n_layers = len(widths) - 1
    if not 1 <= n_layers <= TRAIN_MAX_LAYERS or widths[-1] != 2 or min(widths) < 1:
        raise ValueError(f"{what} takes a relu stack of 1 to {TRAIN_MAX_LAYERS} layers and 2 classes, "
                         f"got widths {widths}")
    n_params = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    return (ctypes.c_int * len(widths))(*widths), n_layers, n_params


def _train_library(c_widths, n_layers: int, what: str):
    """The kernel library, after checking that a tile of the stack fits one
    block's shared memory."""
    from .build import library

    lib = library()
    if lib.moeva_train_smem_bytes(c_widths, n_layers) == 0:
        raise ValueError(f"{what}: a tile of {lib.moeva_train_tile_rows()} rows of the stack {list(c_widths)} does "
                         "not fit one block's shared memory")
    return lib


def _train_rows(x, y, d: int, what: str) -> int:
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (N, D), got {tuple(x.shape)}")
    n = x.shape[0]
    if n < 1:
        raise ValueError(f"{what} takes at least one row")
    _check(x, "x", (n, d))
    if y is not None:
        _check(y, "y", (n,), torch.int64)
    return n


def train_step(widths, params, mu, nu, x, y, w, cw, adam) -> torch.Tensor:
    """Kernel K11: one training step of the relu stack ``widths`` (D, ...,
    2) on the batch ``x`` (N, D) float32 with labels ``y`` (N,) int64,
    sample weights ``w`` (N,) and class weights ``cw`` (2,): the flat
    float32 parameters ``params`` and Adam's moments ``mu`` and ``nu`` (P,)
    are updated in place; returns the step's loss (1,) on the card. ``adam``
    holds the float32 constants (1 - b1, b1, 1 - b2, b2, the two bias
    corrections, eps, -lr). The semantics of ``models.train.
    train_step_plain``; labels are clamped into [0, 1] as JAX's gather
    clamps them."""
    c_widths, n_layers, n_params = _mlp_widths(widths, "train_step")
    n = _train_rows(x, y, c_widths[0], "train_step")
    for name, t in (("params", params), ("mu", mu), ("nu", nu)):
        _check(t, name, (n_params,))
        if not t.is_contiguous():
            raise ValueError(f"train_step updates {name} in place: it must be contiguous")
    _check(w, "w", (n,))
    _check(cw, "cw", (2,))
    if len(adam) != 8:
        raise ValueError(f"adam holds 8 constants, got {len(adam)}")
    dev = _one_device(params, mu, nu, x, y, w, cw)
    x, y, w, cw = (t.contiguous() for t in (x, y, w, cw))
    lib = _train_library(c_widths, n_layers, "train_step")
    n_tiles = -(-n // lib.moeva_train_tile_rows())
    part_grad = torch.empty((n_tiles, n_params), dtype=torch.float32, device=dev)
    part_loss = torch.empty((n_tiles, 2), dtype=torch.float32, device=dev)
    loss = torch.empty((1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_train_step_f32(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), cw.data_ptr(), params.data_ptr(), mu.data_ptr(),
            nu.data_ptr(), c_widths, n_layers, n, *(float(a) for a in adam), part_grad.data_ptr(),
            part_loss.data_ptr(), loss.data_ptr(), _stream(dev),
        )
    _raise_on_error(lib, err, "train_step")
    _LAUNCHES["train_step"] += 1
    return loss


def train_loss(widths, params, x, y, cw) -> torch.Tensor:
    """Kernel K11's loss-only instantiation: each tile's sum of ``cw[y] *
    loss`` over its rows, (ceil(N / tile rows),) float32 on the card, the
    semantics of ``models.train.train_loss_plain`` (the caller sums the
    tiles left to right and divides by N)."""
    c_widths, n_layers, n_params = _mlp_widths(widths, "train_loss")
    n = _train_rows(x, y, c_widths[0], "train_loss")
    _check(params, "params", (n_params,))
    _check(cw, "cw", (2,))
    dev = _one_device(params, x, y, cw)
    x, y, cw, params = (t.contiguous() for t in (x, y, cw, params))
    lib = _train_library(c_widths, n_layers, "train_loss")
    part_loss = torch.empty((-(-n // lib.moeva_train_tile_rows()),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_train_loss_f32(x.data_ptr(), y.data_ptr(), cw.data_ptr(), params.data_ptr(), c_widths,
                                       n_layers, n, part_loss.data_ptr(), _stream(dev))
    _raise_on_error(lib, err, "train_loss")
    _LAUNCHES["train_loss"] += 1
    return part_loss


def input_grad(widths, params, x) -> torch.Tensor:
    """Kernel K12: per row of ``x`` (N, D) float32 the gradient (N, D) of the
    stack's softmax class-0 probability with respect to the row, for the
    flat float32 ``params`` of the relu stack ``widths`` (D, ..., 2); the
    semantics of ``models.train.input_grad_plain``."""
    c_widths, n_layers, n_params = _mlp_widths(widths, "input_grad")
    n = _train_rows(x, None, c_widths[0], "input_grad")
    _check(params, "params", (n_params,))
    dev = _one_device(params, x)
    x, params = x.contiguous(), params.contiguous()
    lib = _train_library(c_widths, n_layers, "input_grad")
    out = torch.empty((n, c_widths[0]), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_input_grad_f32(x.data_ptr(), params.data_ptr(), c_widths, n_layers, n, out.data_ptr(),
                                       _stream(dev))
    _raise_on_error(lib, err, "input_grad")
    _LAUNCHES["input_grad"] += 1
    return out


def _field_arrays(fields, first):
    """The host arrays of a call's fields that K0's C interface takes."""
    n = len(fields)
    ll, ci, cu = ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    return (
        (ll * n)(*(f.numel for f in fields)), (ll * n)(*first), (ci * n)(*(f.kind for f in fields)),
        (cu * n)(*(f.n for f in fields)),
    )


def _draw_call(fields, dtype, key: int, base: int, what: str):
    """The checked layout of one K0 call: ``(fields, first, total)``."""
    from ..core import philox

    if dtype != torch.float32:
        raise TypeError(f"{what}: the card draws float32, not {dtype}")
    fields = list(fields)
    if not 1 <= len(fields) <= 8:
        raise ValueError(f"{what} takes 1 to 8 fields a call, got {len(fields)}")
    if not 0 <= key < 2**64 or not 0 <= base < 2**63:
        raise ValueError(f"{what}: key {key} or base {base} out of range")
    first, total = philox.layout(fields, dtype)
    return fields, first, total


def draw_buffer(fields, device):
    """One float32 buffer on ``device`` for a K0 call's ``fields`` (its
    ``float32`` draws): ``({name: view}, [each field's byte offset], the
    buffer)``, each field 16-byte aligned, an int64 field a view of two
    words an element.
    Two ATen ops and one or two views a field, so the host's cost a
    generation stays small."""
    from ..core import philox

    sizes, offsets, words = [], [], 0
    for f in fields:
        n = f.numel * (2 if philox.out_dtype(f, torch.float32) == torch.int64 else 1)
        offsets.append(4 * words)
        sizes += [n, -(-n // 4) * 4 - n]
        words += sizes[-2] + sizes[-1]
    buf = torch.empty(words, dtype=torch.float32, device=device)
    parts = buf.split(sizes)
    out = {}
    for f, part in zip(fields, parts[0::2]):
        if philox.out_dtype(f, torch.float32) == torch.int64:
            part = part.view(torch.int64)
        out[f.name] = part.view(f.shape)
    return out, offsets, buf


def draws(fields, dtype, key: int, base: int, device) -> dict:
    """Kernel K0: each of ``fields`` (``core.philox.Field``) of the Philox
    call whose first block is ``base`` under ``key``, as views of one
    buffer on ``device`` (:func:`draw_buffer`): ``{name: tensor}``,
    float32 or int64."""
    from .build import library

    fields, first, total = _draw_call(fields, dtype, key, base, "draws")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"draws runs on a CUDA device, got {dev}")
    out, offsets, buf = draw_buffer(fields, dev)
    lib = library()
    vp = ctypes.c_void_p
    ptrs = (vp * len(fields))(*(buf.data_ptr() + off for off in offsets))
    with torch.cuda.device(dev):
        err = lib.moeva_draws_f32(ptrs, *_field_arrays(fields, first), len(fields), key, base, total, _stream(dev))
    _raise_on_error(lib, err, "draws")
    _LAUNCHES["draws"] += 1
    return out


def pgd_start(fields, key: int, base: int, x_init, mutable, eps: float, clip: tuple, norm_inf: bool):
    """Kernel K0's PGD instantiation: the random start (N, D) float32
    around ``x_init`` from the Philox call's ``fields`` (a direction, then
    under L2 a radius; ``attacks.pgd.engine.start_fields``), on mutable
    features only, clipped to ``clip``."""
    from .build import library

    fields, first, total = _draw_call(fields, torch.float32, key, base, "pgd_start")
    if x_init.dim() != 2:
        raise ValueError(f"x_init must be (N, D), got {tuple(x_init.shape)}")
    n, d = x_init.shape
    _check(x_init, "x_init", (n, d))
    _check(mutable, "mutable", (d,), torch.bool)
    want = [(n, d)] if norm_inf else [(n, d), (n, 1)]
    if [tuple(f.shape) for f in fields] != want:
        raise ValueError(f"pgd_start's fields must have shapes {want}, got {[tuple(f.shape) for f in fields]}")
    if not norm_inf and d * 4 > 48 * 1024:
        raise ValueError(f"pgd_start under L2 takes at most {48 * 1024 // 4} features, got {d}")
    dev = _one_device(x_init, mutable)
    x_init = x_init.contiguous()
    out = torch.empty_like(x_init)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.moeva_pgd_start_f32(
            *_field_arrays(fields, first), len(fields), key, base, total, x_init.data_ptr(), mutable.data_ptr(),
            out.data_ptr(), float(clip[0]), float(clip[1]), float(eps), 1.0 / d, int(norm_inf), n, d, _stream(dev),
        )
    _raise_on_error(lib, err, "pgd_start")
    _LAUNCHES["pgd_start"] += 1
    return out


def chunk_prepare(tables, x, xl, xu, init=None):
    """Kernel K13a: ``attacks.moeva.chunk_io.Prepared`` of the states ``x``
    and bounds ``xl``, ``xu`` (S, D) float32 on one card: the gene bounds
    (S, L), the normalised states (S, D) and, with ``init`` (a
    ``chunk_io.InitSpec``), the initial population (S, P, L) and the
    normalisation memory, in one launch."""
    from ..attacks.moeva.chunk_io import Prepared, init_moves
    from ..attacks.moeva.initialisation import ball_draw_shape
    from ..attacks.moeva.survival import NormState
    from ..core.norms import is_inf
    from .build import library

    if x.dim() != 2:
        raise ValueError(f"x must be (S, D), got {tuple(x.shape)}")
    s, d = x.shape
    for t, name in ((x, "x"), (xl, "xl"), (xu, "xu")):
        _check(t, name, (s, d))
    codec = tables.codec
    l, g = codec.gen_length, codec.n_groups
    k = tables.group_idx.shape[1]
    if d != codec.n_features:
        raise ValueError(f"x has {d} features, the codec {codec.n_features}")
    _check(tables.gene_feat, "gene_feat", (l,), torch.int32)
    _check(tables.group_idx, "group_idx", (g, k), torch.int32)
    _check(tables.int_gene, "int_gene", (l,), torch.bool)
    n_pert = init_moves(init)
    p = init.n_pop if init is not None else 0
    ball, ball_cols, norm_inf, eps = None, 0, 0, 0.0
    if n_pert:
        norm_inf = int(is_inf(init.norm))
        want = ball_draw_shape(init.norm, (s, n_pert, l))
        if init.ball is None:
            raise ValueError(f"lp_ratio needs ball draws of shape {want}, got None")
        _check(init.ball, "ball", want)
        ball, ball_cols, eps = init.ball.contiguous(), want[-1], float(init.eps)
    if (3 * l + n_pert) * 4 > 48 * 1024:
        raise ValueError(f"chunk_prepare takes at most 48 KB of genes and moved rows, got L = {l}, {n_pert} rows")
    dev = _one_device(x, xl, xu, tables.gene_feat, ball)
    x, xl, xu = x.contiguous(), xl.contiguous(), xu.contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    xl_gen, xu_gen, x_mm = new(s, l), new(s, l), new(s, d)
    pop = norm = None
    if init is not None:
        pop = new(s, p, l)
        norm = NormState(new(s, 3), new(s, 3), new(s, 3, 3))
    lib = library()
    with torch.cuda.device(dev):
        err = lib.moeva_chunk_prepare_f32(
            x.data_ptr(), xl.data_ptr(), xu.data_ptr(), tables.gene_feat.data_ptr(), tables.group_idx.data_ptr(),
            tables.int_gene.data_ptr(), _ptr(ball), xl_gen.data_ptr(), xu_gen.data_ptr(), x_mm.data_ptr(),
            _ptr(pop), *(_ptr(t) for t in (norm or (None,) * 3)), s, d, l, codec.n_non_ohe, g, k, p, n_pert,
            ball_cols, norm_inf, eps, _stream(dev),
        )
    _raise_on_error(lib, err, "chunk_prepare")
    _LAUNCHES["chunk_prepare"] += 1
    return Prepared(xl_gen, xu_gen, x_mm, pop, norm)


def chunk_decode(tables, pop_x, arch_x, pop_f, arch_f, x_init):
    """Kernel K13b: ``(x_gen (S, P + A, L), f (S, P + A, 3), x_ml (S, P +
    A, D))`` float32, the returned columns (population then archive) and
    their decode to ML space around ``x_init`` (S, D), in one launch."""
    from .build import library

    if pop_x.dim() != 3:
        raise ValueError(f"pop_x must be (S, P, L), got {tuple(pop_x.shape)}")
    s, p, l = pop_x.shape
    a = arch_x.shape[1] if arch_x.dim() == 3 else -1
    d = tables.codec.n_features
    _check(pop_x, "pop_x", (s, p, l))
    _check(arch_x, "arch_x", (s, a, l))
    _check(pop_f, "pop_f", (s, p, 3))
    _check(arch_f, "arch_f", (s, a, 3))
    _check(x_init, "x_init", (s, d))
    _check(tables.feat_gene, "feat_gene", (d,), torch.int32)
    _check(tables.feat_onehot, "feat_onehot", (d,), torch.int32)
    if p < 1 or l != tables.codec.gen_length:
        raise ValueError(f"chunk_decode needs P >= 1 and L = {tables.codec.gen_length}, got {p} and {l}")
    dev = _one_device(pop_x, arch_x, pop_f, arch_f, x_init, tables.feat_gene)
    pop_x, arch_x, pop_f, arch_f, x_init = (t.contiguous() for t in (pop_x, arch_x, pop_f, arch_f, x_init))
    x_gen = torch.empty((s, p + a, l), dtype=torch.float32, device=dev)
    f = torch.empty((s, p + a, 3), dtype=torch.float32, device=dev)
    x_ml = torch.empty((s, p + a, d), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.moeva_chunk_decode_f32(
            pop_x.data_ptr(), arch_x.data_ptr() if a else None, pop_f.data_ptr(), arch_f.data_ptr() if a else None,
            x_init.data_ptr(), tables.feat_gene.data_ptr(), tables.feat_onehot.data_ptr(), x_gen.data_ptr(),
            f.data_ptr(), x_ml.data_ptr(), s, p, a, l, d, _stream(dev),
        )
    _raise_on_error(lib, err, "chunk_decode")
    _LAUNCHES["chunk_decode"] += 1
    return x_gen, f, x_ml


def refdirs(theta0, sched, s: float):
    """Kernel K14: the energy descent of ``attacks.moeva.refdirs.
    energy_descent_plain`` from ``theta0`` (n, n_dim) float64 over the
    schedule ``sched`` (n_iter, 3) float64 (``refdirs.descent_schedule``),
    both on one card; returns softmax(theta) (n, n_dim) float64. One
    cluster of CTAs, 2 to 1024 points of at most 4 dimensions."""
    from ..attacks.moeva.refdirs import ADAM_B1, ADAM_B2, ADAM_EPS
    from .build import library

    if theta0.dim() != 2 or sched.dim() != 2:
        raise ValueError("theta0 and sched must be (n, n_dim) and (n_iter, 3)")
    n, k = theta0.shape
    _check(theta0, "theta0", (n, k), torch.float64)
    _check(sched, "sched", (sched.shape[0], 3), torch.float64)
    dev = _one_device(theta0, sched)
    lib = library()
    if not 2 <= n <= lib.moeva_refdirs_max_points() or not 1 <= k <= lib.moeva_refdirs_max_dim():
        raise ValueError(f"refdirs takes 2 to {lib.moeva_refdirs_max_points()} points of 1 to "
                         f"{lib.moeva_refdirs_max_dim()} dimensions, got {(n, k)}")
    theta0, sched = theta0.contiguous(), sched.contiguous()
    out = torch.empty((n, k), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_refdirs_f64(
            theta0.data_ptr(), sched.data_ptr(), out.data_ptr(), n, k, sched.shape[0], float(s),
            1.0 - ADAM_B1, ADAM_B1, 1.0 - ADAM_B2, ADAM_B2, ADAM_EPS, _stream(dev),
        )
    _raise_on_error(lib, err, "refdirs")
    _LAUNCHES["refdirs"] += 1
    return out


def restart(x_adv, pred, y, hist, best_x, best_hist, curve, r: int, targeted: bool):
    """Kernel K15: PGD's arbitration after start ``r``'s run, the semantics
    of ``attacks.pgd.engine.restart_plain``. ``x_adv`` (N, D) float32,
    ``pred`` and ``y`` (N,) int64 and ``hist`` (T, N, C) float32 or None
    are the run's; ``best_x`` and ``best_hist`` the rows and history kept
    so far (``x_init`` and None before the first start); ``curve`` (R, N)
    bool the cumulative success, whose row ``r`` the launch writes from row
    r - 1. Returns ``(best_x, best_hist)``: from the second start on the
    same tensors, updated in place; at the first, new ones."""
    from .build import library

    if x_adv.dim() != 2 or curve.dim() != 2:
        raise ValueError("x_adv and curve must be (N, D) and (R, N)")
    n, d = x_adv.shape
    if not 0 <= r < curve.shape[0]:
        raise ValueError(f"start {r} is not a row of the ({curve.shape[0]}, N) curve")
    _check(x_adv, "x_adv", (n, d))
    _check(pred, "pred", (n,), torch.int64)
    _check(y, "y", (n,), torch.int64)
    _check(best_x, "best_x", (n, d))
    _check(curve, "curve", (curve.shape[0], n), torch.bool)
    t = c = 0
    if hist is not None:
        if hist.dim() != 3:
            raise ValueError(f"hist must be (T, N, C), got {tuple(hist.shape)}")
        t, _, c = hist.shape
        _check(hist, "hist", (t, n, c))
        if best_hist is not None:
            _check(best_hist, "best_hist", (t, n, c))
    elif best_hist is not None:
        raise ValueError("a kept history without the run's history")
    if r > 0 and hist is not None and best_hist is None:
        raise ValueError("the first start's history must be kept before the next start")
    dev = _one_device(x_adv, pred, y, hist, best_x, best_hist, curve)
    for name, tensor in (("x_adv", x_adv), ("pred", pred), ("y", y), ("hist", hist), ("best_x", best_x),
                         ("best_hist", best_hist), ("curve", curve)):
        if tensor is not None and not tensor.is_contiguous():
            raise ValueError(f"restart updates in place: {name} must be contiguous")
    first = r == 0
    out_x = torch.empty_like(best_x) if first else best_x
    out_hist = None if hist is None else torch.empty_like(hist) if first else best_hist
    lib = library()
    with torch.cuda.device(dev):
        err = lib.moeva_restart_f32(
            x_adv.data_ptr(), pred.data_ptr(), y.data_ptr(), _ptr(hist), best_x.data_ptr(), out_x.data_ptr(),
            None if first else _ptr(best_hist), _ptr(out_hist), None if first else curve[r - 1].data_ptr(),
            curve[r].data_ptr(), n, d, t, c, int(targeted), _stream(dev),
        )
    _raise_on_error(lib, err, "restart")
    _LAUNCHES["restart"] += 1
    return out_x, out_hist


def _forward_args(x, params, widths, dtype, what: str):
    from .build import library

    widths = [int(w) for w in widths]
    if x.dim() != 2:
        raise ValueError(f"{what}'s rows must be (N, D), got {tuple(x.shape)}")
    n = x.shape[0]
    _check(x, "x", (n, widths[0]), dtype)
    n_params = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    _check(params, "params", (n_params,), dtype)
    lib = library()
    if (not 1 <= len(widths) - 1 <= lib.moeva_forward_max_layers()
            or max(widths[1:]) > lib.moeva_forward_max_width() or widths[-1] not in (1, 2)):
        raise ValueError(f"{what} takes at most {lib.moeva_forward_max_layers()} layers of at most "
                         f"{lib.moeva_forward_max_width()} units and 1 or 2 classes, got widths {widths}")
    dev = _one_device(x, params)
    return lib, dev, n, x.contiguous(), params.contiguous(), (ctypes.c_int * len(widths))(*widths), len(widths) - 1


def forward_labels(x, params, widths):
    """Kernel K16, float32: the (N,) int64 class of each row of ``x`` (N,
    D) through the relu stack of ``widths`` (D, hidden..., 1 or 2 classes)
    whose flat float32 ``params`` hold each layer's weight (out, in) then
    its bias, both on one card: ``attacks.pgd.engine.predict_plain``'s
    semantics."""
    lib, dev, n, x, params, c_widths, n_layers = _forward_args(x, params, widths, torch.float32, "forward_labels")
    labels = torch.empty((n,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_forward_labels_f32(x.data_ptr(), params.data_ptr(), c_widths, n_layers, n,
                                           labels.data_ptr(), _stream(dev))
    _raise_on_error(lib, err, "forward_labels")
    _LAUNCHES["forward_labels"] += 1
    return labels


def forward_proba1(x, params, widths):
    """Kernel K16, float64: the (N,) class-1 probabilities of ``x`` (N, D)
    through the stack, as :func:`forward_labels` takes it but in float64:
    ``models.mlp.proba1_plain``'s semantics."""
    lib, dev, n, x, params, c_widths, n_layers = _forward_args(x, params, widths, torch.float64, "forward_proba1")
    out = torch.empty((n,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.moeva_forward_proba1_f64(x.data_ptr(), params.data_ptr(), c_widths, n_layers, n,
                                           out.data_ptr(), _stream(dev))
    _raise_on_error(lib, err, "forward_proba1")
    _LAUNCHES["forward_proba1"] += 1
    return out

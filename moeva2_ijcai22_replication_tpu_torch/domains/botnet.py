"""CTU-13 botnet netflow domain: 756 features, 360 relational constraints;
its augmented variant adds C(19, 2) = 171 XOR pair features and their
consistency terms (927 features, 360 + 171 terms).

Port of ``moeva2_ijcai22_replication_tpu/domains/botnet.py``. Every
constraint is a gather over static port-group index tables read from
``feat_idx.pickle``, in the reference's order: [g1, g2] (per direction, the
protocol flow sums equal the bytes sums), 34 bytes/pkts ratios <= 1500,
then 108 max <= sum, 108 min <= sum and 108 min <= max orderings.

The reference sizes the ratio loop by ``len("bytes_out_sum_s_idx") - 2 ==
17``, so only the first 17 of the 18 ports per direction are checked; the
port keeps that count (2 + 34 + 324 = 360).

Constrained PGD differentiates the terms by hand (``smooth_vjp``, with
``jax.grad``'s conventions) so that kernel K7b (``kernels/csrc/
pgd_botnet.cu``) can repeat the backward in its order, on the base domain
and, in its own instantiation, on the augmented one (k = 19: 927 features;
another pair count is refused by the kernel's wrapper). The augmented
domain has no repair, as in the JAX package: a ``+repair`` loss raises its
``NotImplementedError`` before anything launches.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..core.constraints import ConstraintSet
from ..core.norms import sum_last
from ..core.schema import ConstraintBounds, FeatureSchema
from ..core.vjp import abs_vjp, clip_vjp, div_vjp
from . import augmentation

_SUM_KEYS = ["bytes_out_sum_{0}_idx", "pkts_out_sum_{0}_idx", "duration_sum_{0}_idx"]
_MAX_KEYS = ["bytes_out_max_{0}_idx", "pkts_out_max_{0}_idx", "duration_max_{0}_idx"]
_MIN_KEYS = ["bytes_out_min_{0}_idx", "pkts_out_min_{0}_idx", "duration_min_{0}_idx"]
_RATIO_PORTS = 17  # the reference's string-length quirk; see the module docstring
#: the largest bytes/pkts value a ratio term allows (an Ethernet MTU)
MTU = 1500.0
N_BASE_FEATURES = 756
N_BASE_TERMS = 360


class BotnetTables(NamedTuple):
    """The gather lists of the 360 terms as kernels K8 and K7b read them:
    one int32 tensor of feature indices, its segments in the order of
    ``counts``; and, for K7b's backward, the inverse of that gather."""

    index: torch.Tensor  # (sum(counts),) int32, each in [0, D)
    #: (flows s, bytes s, flows d, bytes d, ratio bytes, ratio pkts, then
    #: lower and upper of each of the three orderings)
    counts: tuple
    #: (D, degree) int32: for each feature, the positions in ``index`` of
    #: its entries in the order of their terms (g1 first), -1 after them
    inverse: torch.Tensor
    #: the augmented domain's pairs, as K8 reads them: (P, 2) int32 base
    #: features and (P, 2) float32 thresholds (rounded once from the float64
    #: means); None on the base domain
    pair_idx: torch.Tensor | None = None
    pair_thr: torch.Tensor | None = None


def entry_terms(counts) -> np.ndarray:
    """The term of each entry of the gather lists laid out by ``counts``:
    the two flow equalities, the ratios, then the orderings."""
    c = list(counts)
    ratios = np.arange(2, 2 + c[4])
    terms = [np.zeros(c[0] + c[1], np.int64), np.ones(c[2] + c[3], np.int64), ratios, ratios]
    start = 2 + c[4]
    for lo, up in zip(c[6::2], c[7::2]):
        order = np.arange(start, start + lo)
        terms += [order, order]
        start += lo
    return np.concatenate(terms)


def inverse_table(index: np.ndarray, counts, n_features: int) -> np.ndarray:
    """(D, degree) int32: for each feature the positions of its entries in
    ``index``, ordered by term and then by position, padded with -1 to the
    largest degree."""
    order = np.lexsort((np.arange(len(index)), entry_terms(counts), index))
    feats = index[order]
    degree = np.bincount(index, minlength=n_features)
    table = np.full((n_features, max(int(degree.max()), 1)), -1, np.int32)
    slot = np.arange(len(order)) - np.repeat(np.cumsum(degree) - degree, degree)
    table[feats, slot] = order
    return table


class BotnetConstraints(ConstraintSet):
    n_constraints = 360
    #: kernel K8 (``kernels/csrc/objective_botnet.cu``) computes these terms
    #: inside the objectives on the card
    objective_kernel = "botnet"
    #: kernel K7b (``kernels/csrc/pgd_botnet.cu``) runs constrained PGD on
    #: the card with these terms and their backward
    pgd_kernel = "botnet"

    def __init__(self, features_path: str, constraints_path: str, important_features_path: str | None = None):
        super().__init__(FeatureSchema.from_csv(features_path), ConstraintBounds.from_csv(constraints_path))
        data_dir = os.path.dirname(features_path)
        with open(os.path.join(data_dir, "feat_idx.pickle"), "rb") as f:
            fi = {k: np.asarray(v, dtype=np.int64) for k, v in pickle.load(f).items()}
        if important_features_path is None:
            important_features_path = os.path.join(data_dir, "important_features_19.npy")
        self.important_features = (
            np.load(important_features_path) if os.path.exists(important_features_path) else None
        )
        # per direction: the protocol port sums, then bytes in and out
        flows = [
            (np.concatenate([fi[f"{p}_sum_{side}_idx"] for p in ("icmp", "udp", "tcp")]),
             np.concatenate([fi[f"bytes_in_sum_{side}_idx"], fi[f"bytes_out_sum_{side}_idx"]]))
            for side in ("s", "d")
        ]
        ratio = (
            np.concatenate([fi[f"bytes_out_sum_{side}_idx"][:_RATIO_PORTS] for side in ("s", "d")]),
            np.concatenate([fi[f"pkts_out_sum_{side}_idx"][:_RATIO_PORTS] for side in ("s", "d")]),
        )

        # lower <= upper, flattened over (side, kind, port)
        def ordering(upper_tpls, lower_tpls):
            lo, up = [], []
            for side in ("s", "d"):
                for u_tpl, l_tpl in zip(upper_tpls, lower_tpls):
                    up.append(fi[u_tpl.format(side)])
                    lo.append(fi[l_tpl.format(side)])
            return np.concatenate(lo), np.concatenate(up)

        orderings = [
            ordering(_SUM_KEYS, _MAX_KEYS),  # max <= sum
            ordering(_SUM_KEYS, _MIN_KEYS),  # min <= sum
            ordering(_MAX_KEYS, _MIN_KEYS),  # min <= max
        ]
        segments = [*flows[0], *flows[1], *ratio, *(a for pair in orderings for a in pair)]
        self._index = np.concatenate(segments)
        self._counts = tuple(len(a) for a in segments)
        d = self.schema.n_features
        if self._index.min() < 0 or self._index.max() >= d:
            raise ValueError(f"feat_idx.pickle indexes outside the schema's {d} features")
        self._inverse = inverse_table(self._index, self._counts, d)
        self._on_device = {}

    def segments(self) -> list:
        """The gather lists as int64 numpy arrays, in the order of
        ``BotnetTables.counts``: flows and bytes of each direction, the
        ratios' bytes and packets, then lower and upper of each ordering."""
        return np.split(self._index, np.cumsum(self._counts)[:-1])

    def _tables(self, device) -> list:
        """The index lists as int64 tensors on ``device``, then the inverse
        table for the plain backward (:meth:`smooth_vjp`), made once."""
        key = torch.device(device)
        if key not in self._on_device:
            # column 0 and the padding read a zero slot, so each feature's
            # sum starts from 0 and ends with +0s, which change no value
            summed = np.concatenate([np.zeros((len(self._inverse), 1), np.int64), self._inverse + 1], axis=1)
            self._on_device[key] = [torch.as_tensor(a, device=key) for a in self.segments()] + [
                torch.as_tensor(summed, device=key)]
        return self._on_device[key]

    def kernel_tables(self, device) -> BotnetTables:
        """K8's and K7b's gather lists and K7b's inverse table on ``device``."""
        return BotnetTables(torch.as_tensor(self._index, dtype=torch.int32, device=device), self._counts,
                            torch.as_tensor(self._inverse, device=device))

    def _forward(self, x: torch.Tensor):
        """``(v, b, nz, den, raw)``: the flow equalities' differences ``v``
        (two (...) tensors), the ratios' bytes ``b``, packets test ``nz``
        and denominators ``den``, and the 360 unthresholded terms ``raw``,
        one rounded operation at a time in the order kernels K8 and K7b
        compute them: each sum left to right, the ratio a true division by a
        tensor."""
        fs, bs, fd, bd, rb, rp, *orders = self._tables(x.device)[:-1]
        v = [sum_last(x[..., f]) - sum_last(x[..., b]) for f, b in ((fs, bs), (fd, bd))]
        b, p = x[..., rb], x[..., rp]
        nz = p != 0
        den = torch.where(nz, p, 1.0)
        terms = [torch.abs(v[0])[..., None], torch.abs(v[1])[..., None], torch.where(nz, b / den, 0.0) - MTU]
        terms += [x[..., lo] - x[..., up] for lo, up in zip(orders[::2], orders[1::2])]
        return v, b, nz, den, torch.cat(terms, dim=-1)

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        """The 360 unthresholded terms (:meth:`_forward`)."""
        return self._forward(x)[-1]

    def smooth_vjp(self, u: torch.Tensor, ct_g: torch.Tensor):
        """``(g, ct_u)``: the smooth violations ``g = clip(_raw(u) - tol, 0,
        inf)`` (..., 360) of the unscaled rows ``u`` (..., D), as
        :meth:`evaluate_smooth` computes them, and the cotangent of ``u``
        from ``ct_g`` (..., 360), the backward ``jax.grad`` takes through
        :meth:`_raw`.

        The conventions are ``jax.grad``'s (abs, clip and division as
        ``core/vjp.py`` gives them): a flow equality sends its abs's
        cotangent to each flow feature and its negation to each bytes
        feature; a ratio's outer ``where`` passes its cotangent to the
        division where the packets are not 0 and an exact 0 elsewhere, its
        inner one the denominator's cotangent to the packets where they are
        not 0; an ordering sends its cotangent to its lower feature and the
        negation to its upper one. Every product is taken, also where a
        cotangent is 0, so NaN lands where ``jax.grad`` puts it.

        The backward runs in two steps, as kernel K7b does: the cotangent
        of each of the gather lists' entries, then each feature's sum of its
        entries from 0, term by term (g1 first), through the inverse table
        (``BotnetTables.inverse``)."""
        fs, bs, fd, bd, rb, _, *orders, summed = self._tables(u.device)
        v, b, nz, den, raw = self._forward(u)
        pre = raw - self.tol
        g = torch.clamp(pre, min=0.0)

        # the cotangent of each gathered entry, in the order of the lists
        c = clip_vjp(pre, ct_g)
        n_ratio = rb.shape[0]
        entries = []
        for k, (f, bb) in enumerate(((fs, bs), (fd, bd))):
            c_v = abs_vjp(v[k], c[..., k])[..., None]
            entries += [c_v.expand(*c_v.shape[:-1], f.shape[0]), (-c_v).expand(*c_v.shape[:-1], bb.shape[0])]
        c_b, c_den = div_vjp(torch.where(nz, c[..., 2:2 + n_ratio], 0.0), b, den)
        entries += [c_b, torch.where(nz, c_den, 0.0)]
        start = 2 + n_ratio
        for lo in orders[::2]:
            c_o = c[..., start:start + lo.shape[0]]
            entries += [c_o, -c_o]
            start += lo.shape[0]
        zero = torch.zeros((*u.shape[:-1], 1), dtype=u.dtype, device=u.device)
        ect = torch.cat([zero, *entries], dim=-1)
        # each feature: 0, then its entries term by term
        return g, sum_last(ect[..., summed])


class BotnetAugmentedConstraints(BotnetConstraints):
    """Botnet and the XOR-consistency terms of its augmented features: 360 +
    P terms (P = C(k, 2) pairs of k important features; 360 + 171 = 531 at
    k = 19, the reference's defense)."""

    n_constraints = 531
    #: kernel K7b's augmented instantiation (``pgd_botnet_aug_kernel``, 927
    #: features) runs constrained PGD on the card with these terms, the
    #: pairs' after the base ones, and their backward
    pgd_kernel = "botnet"
    #: why a ``+repair`` loss is refused (JAX's ``repair`` raises it)
    repair_undefined = "Repair is undefined for the augmented botnet domain (reference parity)."

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.important_features is None:
            raise FileNotFoundError(
                "BotnetAugmentedConstraints requires important_features_19.npy "
                "(pass important_features_path or place it next to features.csv)"
            )
        feats = self.important_features[:, 0]
        if not np.isin(feats, np.arange(N_BASE_FEATURES)).all():
            # the XOR features are derived from base features only (K8
            # reads them as 16-bit base feature indices)
            raise ValueError(f"important features must index base features in [0, {N_BASE_FEATURES}), got {feats}")
        self._pairs = augmentation.PairTables.build(self.important_features)

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([super()._raw(x), self._pairs.consistency_terms(x)], dim=-1)

    def repair(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(self.repair_undefined)

    def kernel_tables(self, device) -> BotnetTables:
        """K8's and K7b's gather lists, K7b's inverse table (no entry at a
        pair's column) and the pairs' tables on ``device``, the thresholds
        rounded once to float32 (``augmentation.PairTables.xor_features``'
        rounding in the plain path)."""
        return super().kernel_tables(device)._replace(
            pair_idx=self._pairs.idx.to(device=device, dtype=torch.int32),
            pair_thr=torch.as_tensor(self._pairs.thr, dtype=torch.float32, device=device),
        )

    def smooth_vjp(self, u: torch.Tensor, ct_g: torch.Tensor):
        """``(g, ct_u)`` over the 360 + P terms: :meth:`BotnetConstraints.
        smooth_vjp` of the base terms over the first 756 columns, then each
        pair's ``abs_vjp(v, clip_vjp(pre, ct))`` added to its augmented
        column from 0 (the base terms touch none of them). No cotangent flows
        through the comparisons, as under ``jax.grad``."""
        # the base backward's inverse table gives the augmented columns no
        # entry, so their cotangent is a sum of zeros, +0
        g_base, ct = super().smooth_vjp(u, ct_g[..., :N_BASE_TERMS])
        p = self._pairs.n_pairs
        v = u[..., u.shape[-1] - p :] - self._pairs.xor_features(u)
        pre = torch.abs(v) - self.tol
        c_v = abs_vjp(v, clip_vjp(pre, ct_g[..., N_BASE_TERMS:]))
        ct[..., u.shape[-1] - p :] = ct[..., u.shape[-1] - p :] + c_v
        return torch.cat([g_base, torch.clamp(pre, min=0.0)], dim=-1), ct

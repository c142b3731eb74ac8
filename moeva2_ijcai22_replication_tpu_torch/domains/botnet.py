"""CTU-13 botnet netflow domain: 756 features, 360 relational constraints.

Port of ``moeva2_ijcai22_replication_tpu/domains/botnet.py`` (the augmented
variant is not ported yet). Every constraint is a gather over static
port-group index tables read from ``feat_idx.pickle``, in the reference's
order: [g1, g2] (per direction, the protocol flow sums equal the bytes
sums), 34 bytes/pkts ratios <= 1500, then 108 max <= sum, 108 min <= sum and
108 min <= max orderings.

The reference sizes the ratio loop by ``len("bytes_out_sum_s_idx") - 2 ==
17``, so only the first 17 of the 18 ports per direction are checked; the
port keeps that count (2 + 34 + 324 = 360).
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

_SUM_KEYS = ["bytes_out_sum_{0}_idx", "pkts_out_sum_{0}_idx", "duration_sum_{0}_idx"]
_MAX_KEYS = ["bytes_out_max_{0}_idx", "pkts_out_max_{0}_idx", "duration_max_{0}_idx"]
_MIN_KEYS = ["bytes_out_min_{0}_idx", "pkts_out_min_{0}_idx", "duration_min_{0}_idx"]
_RATIO_PORTS = 17  # the reference's string-length quirk; see the module docstring
#: the largest bytes/pkts value a ratio term allows (an Ethernet MTU)
MTU = 1500.0


class BotnetTables(NamedTuple):
    """The gather lists of the 360 terms as kernel K8 reads them: one int32
    tensor of feature indices, its segments in the order of ``counts``."""

    index: torch.Tensor  # (sum(counts),) int32, each in [0, D)
    #: (flows s, bytes s, flows d, bytes d, ratio bytes, ratio pkts, then
    #: lower and upper of each of the three orderings)
    counts: tuple


class BotnetConstraints(ConstraintSet):
    n_constraints = 360
    #: kernel K8 (``kernels/csrc/objective_botnet.cu``) computes these terms
    #: inside the objectives on the card
    objective_kernel = "botnet"

    def __init__(self, features_path: str, constraints_path: str):
        super().__init__(FeatureSchema.from_csv(features_path), ConstraintBounds.from_csv(constraints_path))
        with open(os.path.join(os.path.dirname(features_path), "feat_idx.pickle"), "rb") as f:
            fi = {k: np.asarray(v, dtype=np.int64) for k, v in pickle.load(f).items()}
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
        self._on_device = {}

    def _tables(self, device) -> list:
        """The index lists as int64 tensors on ``device``, made once."""
        key = torch.device(device)
        if key not in self._on_device:
            self._on_device[key] = [torch.as_tensor(a, device=key) for a in np.split(
                self._index, np.cumsum(self._counts)[:-1])]
        return self._on_device[key]

    def kernel_tables(self, device) -> BotnetTables:
        """K8's gather lists on ``device``."""
        return BotnetTables(torch.as_tensor(self._index, dtype=torch.int32, device=device), self._counts)

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        """The 360 unthresholded terms, one rounded operation at a time in
        the order kernel K8 computes them: each sum left to right, the ratio
        a true division by a tensor."""
        fs, bs, fd, bd, rb, rp, *orders = self._tables(x.device)
        terms = [torch.abs(sum_last(x[..., f]) - sum_last(x[..., b]))[..., None] for f, b in ((fs, bs), (fd, bd))]
        b, p = x[..., rb], x[..., rp]
        nz = p != 0
        terms.append(torch.where(nz, b / torch.where(nz, p, 1.0), 0.0) - MTU)
        terms += [x[..., lo] - x[..., up] for lo, up in zip(orders[::2], orders[1::2])]
        return torch.cat(terms, dim=-1)

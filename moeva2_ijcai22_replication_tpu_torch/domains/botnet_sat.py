"""Botnet constraints as MILP rows: fully linear, no mode search.

Port of ``domains/botnet_sat.py``. Reference semantics:
``botnet_constraints_sat.py`` (the per-direction sum equalities, bytes <=
1500 · packets per port, the orderings). The rows come from the
constraint set's own gather lists (:meth:`BotnetConstraints.segments`),
which hold the JAX package's groups in its order, so the static rows are
the JAX builder's, row for row.
"""

from __future__ import annotations

import numpy as np

from ..attacks.sat.engine import LinearRows
from .botnet import MTU, BotnetConstraints

SLACK = 1e-4


def make_botnet_sat_builder(constraints: BotnetConstraints):
    flows_s, bytes_s, flows_d, bytes_d, ratio_bytes, ratio_pkts, *orders = constraints.segments()

    static_rows = []

    # g1/g2: sum(icmp+udp+tcp) == sum(bytes_in + bytes_out) per direction
    for flows, byts in ((flows_s, bytes_s), (flows_d, bytes_d)):
        cols = np.concatenate([flows, byts])
        coefs = np.concatenate([np.ones(len(flows)), -np.ones(len(byts))])
        static_rows.append((cols, coefs, -SLACK, SLACK))

    # bytes <= 1500 * pkts per port (the reference's 17-port loop)
    for b, p in zip(ratio_bytes, ratio_pkts):
        static_rows.append(([int(b), int(p)], [1.0, -MTU], -np.inf, 0.0))

    # orderings lower <= upper
    for lo_idx, up_idx in zip(orders[::2], orders[1::2]):
        for lo, up in zip(lo_idx, up_idx):
            static_rows.append(([int(lo), int(up)], [1.0, -1.0], -np.inf, 0.0))

    def build(x_init: np.ndarray, hot: np.ndarray, box: tuple | None = None) -> LinearRows:
        # box unused: every botnet constraint is linear already. rows is a
        # fresh list per call: the engine may append rows to the spec.
        return LinearRows(rows=list(static_rows), fixes={})

    return build

"""Ready-made attack problems for smoke runs and profiles.

``synthetic_lcld_problem`` and ``synthetic_botnet_problem`` are the
problems ``chip_smoke.py`` drives and profiles: a code-derived schema,
feasible synthetic states, a seeded surrogate (64-32-16-2 for LCLD,
64-64-32-2 for botnet) and a MinMax scaler over the data and the feature
bounds (so attacked candidates at their bounds stay in [0, 1] for the
judgement). ``botnet_hard_candidates`` puts the botnet terms' edge cases
into candidates, for the checks of kernel K8 against its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .domains.botnet import BotnetConstraints
from .domains.lcld import LcldConstraints
from .domains.synth import synth_botnet, synth_botnet_schema, synth_lcld, synth_lcld_schema
from .models.io import Surrogate
from .models.mlp import botnet_mlp, lcld_mlp
from .models.scalers import MinMaxParams, fit_minmax


def _problem(cons, x: np.ndarray, model):
    cons.check_constraints_error(x)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    return cons, Surrogate(model), scaler, x


def synthetic_lcld_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[LcldConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x): ``synth_lcld(n_states, seed)``
    rows, checked feasible, with the schema files written to ``out_dir``."""
    paths = synth_lcld_schema(out_dir)
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(n_states, cons.schema, seed=seed)
    return _problem(cons, x, lcld_mlp(cons.schema.n_features, seed=model_seed))


def synthetic_botnet_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[BotnetConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x): ``synth_botnet(n_states, seed)``
    rows, checked feasible, with the schema files written to ``out_dir``."""
    paths = synth_botnet_schema(out_dir)
    cons = BotnetConstraints(paths["features"], paths["constraints"])
    x = synth_botnet(n_states, cons.schema, seed=seed)
    return _problem(cons, x, botnet_mlp(cons.schema.n_features, seed=model_seed))


def botnet_hard_candidates(codec, names, x_gen: torch.Tensor) -> torch.Tensor:
    """``x_gen`` (S, N, L) botnet candidates with, on every ninth row from
    row 1 to 8, a case the main path makes rarely: a port with bytes and 0
    packets (the ratio's 0 sentinel), -0.0 packets, NaN packets (a NaN ratio,
    which counts 0), an infinite protocol sum (an infinite term), inf - inf
    in a flow equality (a NaN term), bytes of exactly 1500 per packet (a
    ratio term of 0), an ordering at -inf, and 0 bytes with 0 packets. The
    features are named as ``synth_botnet_schema`` names them, and must be
    mutable."""
    gene = {int(d): i for i, d in enumerate(codec.non_ohe_ml_idx)}
    col = {name: gene[k] for k, name in enumerate(names) if k in gene}
    x = x_gen.clone()
    x[:, 1::9, col["pkts_out_sum_s_p0"]] = 0.0
    x[:, 2::9, col["pkts_out_sum_d_p1"]] = -0.0
    x[:, 3::9, col["pkts_out_sum_s_p2"]] = torch.nan
    x[:, 4::9, col["icmp_sum_s_p0"]] = torch.inf
    x[:, 5::9, col["udp_sum_d_p0"]] = torch.inf
    x[:, 5::9, col["bytes_in_sum_d_p0"]] = torch.inf
    x[:, 6::9, col["bytes_out_sum_s_p3"]] = 1500.0 * x[:, 6::9, col["pkts_out_sum_s_p3"]]
    x[:, 7::9, col["duration_min_d_p5"]] = -torch.inf
    x[:, 8::9, col["bytes_out_sum_d_p4"]] = 0.0
    x[:, 8::9, col["pkts_out_sum_d_p4"]] = 0.0
    return x

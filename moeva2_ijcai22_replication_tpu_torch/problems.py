"""Ready-made attack problems for smoke runs and profiles.

``synthetic_lcld_problem`` is the problem ``chip_smoke.py`` drives and
profiles: the code-derived LCLD schema, feasible synthetic
states, a seeded 64-32-16-2 surrogate and a MinMax scaler over the data
and the feature bounds (so attacked candidates at their bounds stay in
[0, 1] for the judgement).
"""

from __future__ import annotations

import numpy as np

from .domains.lcld import LcldConstraints
from .domains.synth import synth_lcld, synth_lcld_schema
from .models.io import Surrogate
from .models.mlp import lcld_mlp
from .models.scalers import MinMaxParams, fit_minmax


def synthetic_lcld_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[LcldConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x): ``synth_lcld(n_states, seed)``
    rows, checked feasible, with the schema files written to ``out_dir``."""
    paths = synth_lcld_schema(out_dir)
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(n_states, cons.schema, seed=seed)
    cons.check_constraints_error(x)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    return cons, Surrogate(lcld_mlp(cons.schema.n_features, seed=model_seed)), scaler, x

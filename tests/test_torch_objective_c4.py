"""The judgement's range check (``ObjectiveCalculator.objectives``) against
the JAX package's, on the CPU: min-max scaled candidates and initial states
must lie in [0, 1] (within 1e-4), and a NaN or an infinity anywhere in
either fails the check in both packages with the same ``AssertionError``
(the reference reduces with ``jnp.minimum``/``jnp.maximum``, which keep a
NaN). Clean inputs pass in both, with the same objectives in float64.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.objective import ObjectiveCalculator as JObjective
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import ObjectiveCalculator
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.synth import synth_lcld, synth_lcld_schema
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate, params_from_numpy
from moeva2_ijcai22_replication_tpu_torch.models.scalers import fit_minmax

torch.set_num_threads(1)

N_STATES = 8
N_CAND = 3
MESSAGE = "min-max scaled values outside"


@pytest.fixture(scope="module")
def calculators(tmp_path_factory):
    """The two packages' calculators over one synthetic LCLD schema, one
    seeded 47-64-32-16-2 surrogate and one scaler fitted to the bounds."""
    paths = synth_lcld_schema(str(tmp_path_factory.mktemp("c4")))
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(N_STATES, cons.schema, seed=5)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    model = jmlp.MLP(hidden=(64, 32, 16), n_classes=2)
    params = jmlp.init_params(model, x.shape[1], seed=2)
    thresholds = {"f1": 0.5, "f2": 0.2}
    jscaler = JMinMax(scaler.scale, scaler.min_)
    jcalc = JObjective(classifier=jio.Surrogate(model, params), constraints=JLcld(paths["features"], paths["constraints"]),
                       thresholds=dict(thresholds), min_max_scaler=jscaler, ml_scaler=jscaler, minimize_class=1, norm=2,
                       precise=False)  # float64 all the same: the tests run JAX with x64
    calc = ObjectiveCalculator(classifier=Surrogate(params_from_numpy(jax.tree.map(np.asarray, params), torch.float64)),
                               constraints=cons, thresholds=dict(thresholds), min_max_scaler=scaler, ml_scaler=scaler,
                               minimize_class=1, norm=2)
    # candidates: each state's row with a small move inside its bounds
    rng = np.random.default_rng(6)
    cand = np.repeat(x[:, None, :], N_CAND, axis=1)
    cand = np.clip(cand + rng.normal(scale=1e-3, size=cand.shape) * (xu - xl)[:, None, :], xl[:, None, :], xu[:, None, :])
    return jcalc, calc, x, cand


def _poison(x: np.ndarray, cand: np.ndarray, case: str):
    x, cand = x.copy(), cand.copy()
    if case == "NaN in the candidates":
        cand[2, 1, 0] = np.nan
    elif case == "NaN in the initial states":
        x[3, 5] = np.nan
    elif case == "+inf in the candidates":
        cand[0, 2, 7] = np.inf
    elif case == "-inf in the candidates":
        cand[5, 0, 3] = -np.inf
    return x, cand


@pytest.mark.parametrize("case", ["NaN in the candidates", "NaN in the initial states", "+inf in the candidates",
                                  "-inf in the candidates"])
def test_range_check_raises_where_jax_raises(calculators, case):
    jcalc, calc, x, cand = calculators
    x, cand = _poison(x, cand, case)
    with pytest.raises(AssertionError, match=MESSAGE):
        jcalc.objectives(x, cand)
    with pytest.raises(AssertionError, match=MESSAGE):
        calc.objectives(x, cand)


def test_clean_inputs_pass_in_both(calculators):
    jcalc, calc, x, cand = calculators
    np.testing.assert_allclose(calc.objectives(x, cand), np.asarray(jcalc.objectives(x, cand)), rtol=1e-12, atol=1e-12)

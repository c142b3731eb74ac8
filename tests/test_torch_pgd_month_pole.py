"""NaN rows of constrained PGD on LCLD at feature 22's lower bound, in both packages.

LCLD's g8 = |x23 - x11/x22| and g9 = |x24 - x16/x22| divide by feature 22,
the month count of the credit history. A PGD trajectory that brings x22 to
its lower bound 0 while x11 or x16 is positive meets an infinite gradient
entry, and the L2 step (the gradient over its norm) turns the whole row
NaN. The judgement then refuses the result, in both packages' runners
(``test_torch_runners.py::test_pgd_runner_refuses_nan_rows_as_jax``).

Which rows of rq1's synthetic LCLD point (``synth_lcld(4000, seed=42)``,
the seeded surrogate, ``constraints+flip``, L2, ε 0.2, 1000 iterations)
reach the pole depends on the rounding. In float64 both packages give the
same rows. In float32 on the H100 the port gives other rows
(``chip_smoke.NAN_REFUSALS``), and ``chip_smoke.py`` checks there that each
of them met an infinite g8 or g9 before it turned NaN. Here: the float64
rows of both packages, and the card's rows put at the pole turning NaN
after one step in both packages, in float32 and in float64.
"""

from __future__ import annotations

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu.attacks.pgd import ConstrainedPGD as JPGD
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models.scalers import MinMaxParams as JMinMax
from moeva2_ijcai22_replication_tpu_torch.attacks.pgd import ConstrainedPGD
from moeva2_ijcai22_replication_tpu_torch.experiments.pgd import surrogate_labels
from moeva2_ijcai22_replication_tpu_torch.models.io import save_params
from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the rows of rq1's LCLD point that turn NaN in float64, in both packages
FLOAT64_NAN_ROWS = (220, 1609, 1857, 2378, 3621, 3732)
EPS = 0.2 - 1e-6  # the runner's ε, as experiments/pgd.py passes it


def _card_rows() -> tuple:
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.NAN_REFUSALS[("lcld", "constraints+flip")]


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """rq1's synthetic LCLD point, and the JAX package's surrogate,
    constraints and scaler read from the same files."""
    tmp = str(tmp_path_factory.mktemp("lcld4000"))
    cons, sur, scaler, x = synthetic_lcld_problem(tmp, 4000)
    save_params(sur, f"{tmp}/nn.msgpack")
    jax_side = (jio.load_params(f"{tmp}/nn.msgpack"),
                JLcld(f"{tmp}/features.csv", f"{tmp}/constraints.csv"), JMinMax(scaler.scale, scaler.min_))
    return cons, sur, scaler, x, jax_side


def _nan_rows(problem, x, dtype, max_iter: int) -> tuple:
    """(port, JAX) rows of x_adv holding a NaN, for ``constraints+flip``
    under L2 from the rows ``x`` (unscaled)."""
    cons, sur, scaler, _, (jsur, jcons, jscaler) = problem
    xs = scaler.transform(x)
    y = surrogate_labels(sur, xs, "cpu", dtype)
    knobs = dict(max_iter=max_iter, norm=2, loss_evaluation="constraints+flip")
    port = ConstrainedPGD(sur, cons, scaler, device="cpu", dtype=dtype, **knobs).generate(xs, y, eps=EPS, eps_step=0.1)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = np.asarray(JPGD(jsur, jcons, jscaler, dtype=jdtype, **knobs).generate(
        xs, y, eps=EPS, eps_step=0.1, max_iter=max_iter))
    return tuple(np.flatnonzero(~np.isfinite(a).all(1)).tolist() for a in (port, ref))


def test_float64_nan_rows_are_jax_rows(problem):
    """Over the float64 rows, the card's rows and two others, 1000
    iterations in float64: both packages turn the same rows NaN, the
    float64 rows and no other."""
    rows = sorted(set(FLOAT64_NAN_ROWS) | set(_card_rows())) + [0, 1]
    port, ref = _nan_rows(problem, problem[3][rows], torch.float64, 1000)
    assert [rows[i] for i in port] == [rows[i] for i in ref] == list(FLOAT64_NAN_ROWS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_a_row_at_the_pole_turns_nan_in_both_packages(problem, dtype):
    """The card's rows with x22 put at its lower bound, 0, and x11 at 1 or more
    turn NaN after one step in both packages. With x11 and x16 at 0 the
    ratios are 0/0, a NaN gradient entry, which the step zeroes: no NaN
    row. Left as they are, the rows take a finite step."""
    _, _, scaler, x, _ = problem
    rows = list(_card_rows())
    at_pole = x[rows].copy()
    at_pole[:, 22] = -scaler.min_[22] / scaler.scale[22]  # scaled 0, where the projection clips
    assert at_pole[0, 22] == 0 and (scaler.transform(at_pole)[:, 22] == 0).all()
    zero_ratios = at_pole.copy()
    at_pole[:, 11] = np.maximum(at_pole[:, 11], 1.0)
    zero_ratios[:, [11, 16]] = 0.0
    n = len(rows)
    port, ref = _nan_rows(problem, np.vstack([at_pole, zero_ratios, x[rows]]), dtype, 1)
    assert port == ref == list(range(n))

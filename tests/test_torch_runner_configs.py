"""``chip_smoke.py`` phase 10 drives the repo's rq1 configs, not look-alikes.

Its configs are dict literals in the script.
Composed by ``chip_smoke.runner_config``, each must equal what the grid
runner composes from ``config/`` (``experiments/rq.py::_compose``: the
attack's yaml, the project's static yaml, then seed and budget, then ε and
the loss) at the rq1 grid point it stands for, apart from the artifact
paths, the results directory and the one listed cut.
"""

from __future__ import annotations

import copy
import importlib.util
import os

import pytest

from moeva2_ijcai22_replication_tpu_torch.utils.config import load_config_file, merge_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _compose(base: str, project: str, overrides: list) -> dict:
    cfg: dict = {}
    merge_config(cfg, load_config_file(os.path.join(REPO, "config", f"{base}.yaml")))
    merge_config(cfg, load_config_file(os.path.join(REPO, "config", f"{project}.yaml")))
    for o in overrides:
        merge_config(cfg, copy.deepcopy(o))
    return cfg


def _points(domain: str):
    """(attack, loss, the grid runner's config) of every rq1 point phase 10
    runs: MoEvA at the grid's first budget, PGD's five losses at the last."""
    grid = load_config_file(os.path.join(REPO, "config", f"rq1.{domain}.yaml"))
    (project,), (seed,), (eps,) = grid["projects"], grid["seeds"], grid["eps_list"]
    yield "moeva", None, _compose("moeva", project, [{"seed": seed, "budget": grid["budgets"][0]},
                                                      {"eps_list": grid["eps_list"]}])
    for loss in grid["loss_evaluations"]:
        yield "pgd", loss, _compose("pgd", project, [{"seed": seed, "budget": grid["budgets"][-1]},
                                                     {"eps": eps, "loss_evaluation": loss}])


@pytest.mark.parametrize("domain", ["lcld", "botnet"])
def test_phase_10_configs_are_the_repo_configs(domain):
    smoke = _smoke()
    points = list(_points(domain))
    assert [loss for attack, loss, _ in points if attack == "pgd"] == list(smoke.RQ1_LOSSES)
    for attack, loss, want in points:
        got = smoke.runner_config(domain, attack, "/artifacts", loss)
        cut = smoke.RUNNER_CUTS.get((domain, loss), {})
        assert set(got["paths"]) == set(want["paths"])
        assert got["paths"]["model"].endswith(".msgpack") and got["paths"]["ml_scaler"].endswith(".npz")
        for key in ("paths", "dirs"):
            got.pop(key), want.pop(key)
        for key, value in cut.items():
            assert got[key] == value and want[key] != value
            got[key] = want[key]
        assert got == want, (attack, loss)


@pytest.mark.parametrize("reconstruction", [False, True])
def test_phase_11_configs_are_the_repo_configs(reconstruction):
    """Phase 11's rq2.lcld points: the grid runner's composition of
    ``config/rq2.lcld.yaml`` (its one scenario) with ``rq2.lcld.static`` and
    ``moeva.yaml``/``pgd.yaml``, apart from the artifact paths, the results
    directory and the evaluation's constraints path; ``reconstruction:
    true`` is the one change of the point run again."""
    smoke = _smoke()
    grid = load_config_file(os.path.join(REPO, "config", "rq2.lcld.yaml"))
    (project,), (seed,), (loss,), (scenario,) = (grid[k] for k in ("projects", "seeds", "loss_evaluations",
                                                                   "scenari"))
    assert (tuple(grid["budgets"]), loss, grid["eps_list"]) == (smoke.RQ2_GRID["budgets"], smoke.RQ2_GRID["loss"],
                                                                [smoke.RQ2_GRID["eps"]])
    for budget in grid["budgets"]:
        for attack, last in (("moeva", {"eps_list": grid["eps_list"]}),
                             ("pgd", {"eps": grid["eps_list"][0], "loss_evaluation": loss})):
            want = _compose(attack, project, [{"seed": seed, "budget": budget}, scenario, last])
            want["reconstruction"] = reconstruction
            got = smoke.rq2_config(attack, budget, "/artifacts", reconstruction)
            assert set(got["paths"]) == set(want["paths"])
            assert got["paths"]["model"].endswith(".msgpack") and got["paths"]["ml_scaler"].endswith(".npz")
            assert got["evaluation"].pop("constraints") == got["paths"]["constraints"]
            want["evaluation"].pop("constraints")
            for key in ("paths", "dirs"):
                got.pop(key), want.pop(key)
            assert got == want, (attack, budget)


def test_the_one_cut_is_lcld_flip_sat():
    assert _smoke().RUNNER_CUTS == {("lcld", "flip+sat"): {"n_initial_state": 256}}


def test_phase_12_config_is_the_repo_config():
    """Phase 12's rq2.botnet point: the grid runner's composition of
    ``config/rq2.botnet.yaml`` (MoEvA alone, one seed, budget, ε and
    scenario) with ``rq2.botnet.static`` and ``moeva.yaml``, apart from the
    artifact paths (the scenario's important features among them), the
    results directory and the evaluation's constraints path."""
    smoke = _smoke()
    grid = load_config_file(os.path.join(REPO, "config", "rq2.botnet.yaml"))
    (project,), (seed,), (budget,), (scenario,) = (grid[k] for k in ("projects", "seeds", "budgets", "scenari"))
    assert grid["attacks"] == ["moeva"]
    assert (seed, budget, grid["eps_list"]) == (smoke.RQ2_BOTNET_GRID["seed"], smoke.RQ2_BOTNET_GRID["budget"],
                                                [smoke.RQ2_BOTNET_GRID["eps"]])
    want = _compose("moeva", project, [{"seed": seed, "budget": budget}, scenario, {"eps_list": grid["eps_list"]}])
    got = smoke.rq2_botnet_config("/artifacts")
    assert set(got["paths"]) == set(want["paths"]) and "important_features" in got["paths"]
    assert got["paths"]["model"].endswith(".msgpack") and got["paths"]["ml_scaler"].endswith(".npz")
    assert got["paths"]["important_features"].endswith("/important_features_19.npy")
    assert got["evaluation"].pop("constraints") == got["paths"]["constraints"]
    want["evaluation"].pop("constraints")
    for key in ("paths", "dirs"):
        got.pop(key), want.pop(key)
    assert got == want

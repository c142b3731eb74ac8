"""``chip_smoke.py`` phases 10-13 drive the repo's configs, not look-alikes.

Phases 10-12's configs are dict literals in the script.
Composed by ``chip_smoke.runner_config``, each must equal what the grid
runner composes from ``config/`` (``experiments/rq.py::_compose``: the
attack's yaml, the project's static yaml, then seed and budget, then ε and
the loss) at the rq1 grid point it stands for, apart from the artifact
paths, the results directory and the one listed cut. Phase 13 writes a
``config_dir`` from ``config/``'s files, which must equal them apart from
the artifact paths, the results directories, ``config_dir`` and its one
listed cut.
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


PHASE_13_FILES = ["moeva.yaml", "pgd.yaml"] + [f"{s}.yaml" for s in (
    "rq1.lcld.static", "rq1.botnet.static", "rq2.lcld.static", "rq2.botnet.static", "rq3.lcld.static",
    "rq3.botnet.static", "sm1.lcld.static", "sm1.botnet.static")] + [
    f"{q}.{d}.yaml" for q in ("rq1", "rq2", "rq3", "sm1.1", "sm1.2") for d in ("lcld", "botnet")]


def _is_artifact(path: str) -> bool:
    return path.startswith("/artifacts/") and not path.endswith((".model", ".joblib"))


@pytest.mark.parametrize("name", PHASE_13_FILES)
def test_phase_13_config_dir_is_the_repo_configs(tmp_path, name):
    """Phase 13's ``config_dir``: ``moeva.yaml`` and ``pgd.yaml`` as they
    are; every static and grid file of ``config/`` it runs equal to the
    repo's apart from the artifact paths (each a synthetic artifact: a
    ``.msgpack`` model, an ``.npz`` scaler), ``dirs.results``,
    ``config_dir`` and the listed cuts."""
    smoke = _smoke()
    assert set(smoke.GRID_FILES) | {f"{s}.yaml" for s in smoke.GRID_STATICS} | {"moeva.yaml", "pgd.yaml"} == set(
        PHASE_13_FILES)
    out = smoke.write_grid_config_dir(str(tmp_path), "/artifacts")
    assert sorted(os.listdir(out)) == sorted(PHASE_13_FILES)
    with open(os.path.join(out, name), "rb") as f:
        written = f.read()
    with open(os.path.join(REPO, "config", name), "rb") as f:
        repo = f.read()
    if name in ("moeva.yaml", "pgd.yaml"):
        assert written == repo
        return
    got = load_config_file(os.path.join(out, name))
    want = load_config_file(os.path.join(REPO, "config", name))
    if "static" in name:
        assert set(got["paths"]) == set(want["paths"]) and all(_is_artifact(p) for p in got["paths"].values())
        assert got["dirs"]["results"] == os.path.join(str(tmp_path), want["dirs"]["results"].removeprefix("./"))
        for key in ("paths", "dirs"):
            got.pop(key), want.pop(key)
    else:
        assert got.pop("config_dir") == out and want.pop("config_dir") == "./config/"
        for g, w in zip(got.get("scenari", []), want.get("scenari", [])):
            assert set(g["paths"]) == set(w["paths"]) and all(_is_artifact(p) for p in g["paths"].values())
            assert g["evaluation"].pop("constraints") == g["paths"]["constraints"]
            w["evaluation"].pop("constraints")
            g.pop("paths"), w.pop("paths")
        if "models" in want:
            assert len(got["models"]) == len(want["models"])
            assert all(_is_artifact(m) and m.endswith(".msgpack") for m in got.pop("models"))
            want.pop("models")
    for key, cut in smoke.GRID_CUTS.get(name, {}).items():
        if isinstance(cut, tuple):
            assert set(cut) <= set(want[key]) and not set(cut) & set(got[key])
            assert got[key] == [v for v in want[key] if v not in cut]
        else:
            assert got[key] == cut and want[key] != cut
        got[key] = want[key]
    assert got == want


def test_the_one_cut_of_phase_13_is_flip_sat():
    """rq1.botnet keeps ``flip+sat``, so the grid path through the MILP
    repair runs; every other grid with that loss drops it."""
    assert _smoke().GRID_CUTS == {
        "rq1.lcld.yaml": {"loss_evaluations": ("flip+sat",)},
        "sm1.2.lcld.yaml": {"loss_evaluations": ("flip+sat",)},
        "sm1.2.botnet.yaml": {"loss_evaluations": ("flip+sat",)},
    }


def test_phase_16_config_is_the_repo_config():
    """Phase 16's runner config: the grid runner's composition of
    ``config/moeva.yaml`` with ``config/lcld.yaml`` (the full-history
    config) at rq1.lcld's seed, first budget and ε, apart from the artifact
    paths and the results directory; its "reduced" and history-free runs
    differ in ``save_history`` alone."""
    smoke = _smoke()
    grid = load_config_file(os.path.join(REPO, "config", "rq1.lcld.yaml"))
    (seed,) = grid["seeds"]
    want = _compose("moeva", "lcld", [{"seed": seed, "budget": grid["budgets"][0]}, {"eps_list": grid["eps_list"]}])
    got = smoke.history_config("/artifacts", "full")
    assert set(got["paths"]) == set(want["paths"])
    for key in ("paths", "dirs"):
        got.pop(key), want.pop(key)
    assert got == want
    for mode in ("reduced", False):
        other = smoke.history_config("/artifacts", mode)
        assert other["save_history"] == mode and {**other, "save_history": "full"} == smoke.history_config(
            "/artifacts", "full")

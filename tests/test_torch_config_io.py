"""The port's config, IO and record formats against the JAX package's.

Config: ``get_dict_hash``, ``merge_config``, ``parse_config`` and the ``-p``
value typing equal JAX's on every ``config/*.yaml`` and on ``-j``/``-p``
cases; the config snapshot is JAX's text and loads back equal through
``yaml.safe_load``. Weights: the port reads a ``.msgpack`` written by JAX's
``save_params`` to the same float32 arrays, JAX reads the port's file to the
same arrays, and the two files are the same bytes. Scalers: the ``.npz``
format round-trips the sklearn scaler's parameters. Records: the event
stream's events equal JAX's for the same calls (but their clock), the
success-rate CSV is pandas' bytes. Registry: the ported domains resolve,
the others are refused with their roadmap item or JAX's ``ValueError``.
"""

from __future__ import annotations

import glob
import json
import math
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from moeva2_ijcai22_replication_tpu.domains import get_constraints_class as j_get_constraints_class
from moeva2_ijcai22_replication_tpu.models import io as jio
from moeva2_ijcai22_replication_tpu.models import mlp as jmlp
from moeva2_ijcai22_replication_tpu.utils import config as jconfig
from moeva2_ijcai22_replication_tpu.utils import streaming as jstreaming
from moeva2_ijcai22_replication_tpu_torch.attacks.objective import O_COLUMNS, write_success_rate_csv
from moeva2_ijcai22_replication_tpu_torch.domains import (
    BotnetAugmentedConstraints, BotnetConstraints, LcldAugmentedConstraints, LcldConstraints, get_constraints_class,
)
from moeva2_ijcai22_replication_tpu_torch.models import io as pio
from moeva2_ijcai22_replication_tpu_torch.models.mlp import botnet_mlp
from moeva2_ijcai22_replication_tpu_torch.models.scalers import from_sklearn_minmax, load_npz, save_npz
from moeva2_ijcai22_replication_tpu_torch.utils import config as pconfig
from moeva2_ijcai22_replication_tpu_torch.utils import streaming as pstreaming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_hash_and_merge_as_jax(path):
    want = jconfig.parse_config(["-c", path, "-p", "seed=7", "-j", '{"dirs": {"results": "x"}}'])
    got = pconfig.parse_config(["-c", path, "-p", "seed=7", "-j", '{"dirs": {"results": "x"}}'])
    assert got == want
    assert pconfig.get_dict_hash(got) == jconfig.get_dict_hash(want)
    base = jconfig.load_config_file(path)
    assert pconfig.load_config_file(path) == base
    over = {"paths": {"model": "m.msgpack"}, "eps_list": [4], "system": {"n_jobs": 1}}
    assert pconfig.merge_config(json.loads(json.dumps(base)), over) == jconfig.merge_config(
        json.loads(json.dumps(base)), over)


VALUES = ["5", "+5", "-5", "0", "00", "007", "08", "-017", "1.5", "-1.5", ".5", "-.5", "+.5", "1.", "1e5", "1e-5",
          "1.5e-3", "1.5e3", "1.0e+3", "3.14159265358979", "-0.0", "12345678901234567890", "abc", "1_000",
          "0.1.2", "", "inf", "nan", "true", "null", "1,5"]


def test_p_values_type_as_pyyaml():
    for v in VALUES:
        got, want = pconfig.value_parser(v), jconfig.value_parser(v)
        assert type(got) is type(want) and (got == want or (got != got and want != want)), v
        if isinstance(got, float):
            assert math.copysign(1, got) == math.copysign(1, want), v


@pytest.mark.parametrize("argv", [
    ["-j", '{"a": {"b": 1, "c": [1, 2]}}', "-j", '{"a": {"c": [3]}}', "-p", "a.b=2.5"],
    ["-p", "x.y.z=abc", "-p", "x.y.w=010", "-p", "eps=0.000001", "-p", "name=flip+sat"],
    ["-j", '{"budget": 100, "loss_evaluation": "constraints+flip"}', "-p", "budget=1e3", "-p", "seed=-3"],
])
def test_inline_configs_parse_as_jax(argv):
    got, want = pconfig.parse_config(argv), jconfig.parse_config(argv)
    assert got == want
    assert pconfig.get_dict_hash(got) == jconfig.get_dict_hash(want)


def test_config_snapshot_loads_back_equal(tmp_path):
    cfg = {
        "eps": 0.000001, "big": 1e300, "neg": -2.5e-8, "inf": math.inf, "ninf": -math.inf, "zero": 0.0,
        "ints": [1, -2, 0], "nested": {"deep": {"list": [[], {}, {"k": None}], "flag": True, "off": False}},
        "name": "flip+sat", "quote": 'a "b" \\ c', "unicode": "ε é", "empty": "", "colon": "a: b",
        "numstr": "1e5", "yes": "yes",
    }
    path = pconfig.save_config(cfg, str(tmp_path / "config_pgd_"))
    assert os.path.basename(path) == f"config_pgd_{pconfig.get_dict_hash(cfg)}.yaml"
    with open(path) as f:
        assert yaml.safe_load(f) == cfg
    jpath = jconfig.save_config(cfg, str(tmp_path / "jax_"))
    with open(jpath) as f:
        assert yaml.safe_load(f) == cfg
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_snapshot_as_jax(path, tmp_path):
    cfg = jconfig.load_config_file(path)
    got = pconfig.save_config(cfg, str(tmp_path / "port_"))
    want = jconfig.save_config(cfg, str(tmp_path / "jax_"))
    assert os.path.basename(got)[len("port_"):] == os.path.basename(want)[len("jax_"):]
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()


def test_port_reads_jax_weights_and_jax_reads_the_port(tmp_path):
    for model, n_features, seed in ((jmlp.lcld_mlp(), 47, 1), (jmlp.botnet_mlp(), 756, 2)):
        params = jmlp.init_params(model, n_features, seed=seed)
        jio.save_params(jio.Surrogate(model, params), str(tmp_path / "jax.msgpack"))
        sur = pio.load_params(str(tmp_path / "jax.msgpack"))
        tree = pio.params_to_numpy(sur.model)
        want = jax.tree.map(np.asarray, params)
        for name, layer in want["params"].items():
            for k in ("kernel", "bias"):
                assert tree["params"][name][k].dtype == np.float32
                np.testing.assert_array_equal(tree["params"][name][k], layer[k])
        pio.save_params(sur, str(tmp_path / "port.msgpack"))
        back = jio.load_params(str(tmp_path / "port.msgpack"))
        assert back.model == model
        for name, layer in want["params"].items():
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(np.asarray(back.params["params"][name][k]), layer[k])
        # the same bytes: header, then the params in JAX's order
        assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_port_written_weights_round_trip(tmp_path):
    sur = pio.Surrogate(botnet_mlp(seed=3))
    pio.save_params(sur, str(tmp_path / "nn.msgpack"))
    back = pio.load_classifier(str(tmp_path / "nn.msgpack"))
    x = torch.rand(5, 756)
    assert torch.equal(back.predict_proba(x), sur.predict_proba(x))


def test_host_classifiers_wait_for_a12(tmp_path):
    """ROADMAP A12 ported the ``.joblib`` branch: a host classifier loads
    as ``HostClassifier``; other artifacts stay surrogates."""
    import joblib
    from sklearn.linear_model import LogisticRegression

    from moeva2_ijcai22_replication_tpu_torch.utils.in_out import HostClassifier, load_model

    x = np.random.default_rng(2).normal(size=(30, 3))
    joblib.dump(LogisticRegression().fit(x, (x[:, 0] > 0).astype(int)), tmp_path / "rf.joblib")
    host = load_model(str(tmp_path / "rf.joblib"))
    assert isinstance(host, HostClassifier) and host.predict_proba(x).shape == (30, 2)
    pio.save_params(pio.Surrogate(botnet_mlp(seed=3)), str(tmp_path / "nn.msgpack"))
    assert isinstance(load_model(str(tmp_path / "nn.msgpack")), pio.Surrogate)


@pytest.mark.parametrize("suffix", [".orbax", ".model"])
def test_unported_model_formats_are_refused(tmp_path, suffix):
    with pytest.raises(NotImplementedError, match="not read by the port"):
        pio.load_classifier(str(tmp_path / f"nn{suffix}"))


def test_npz_scaler_round_trips_the_sklearn_one(tmp_path):
    from sklearn.preprocessing import MinMaxScaler

    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 7)) * np.array([1, 10, 1e4, 1e-3, 5, 0, 2]) + 3
    sk = MinMaxScaler().fit(x)
    params = from_sklearn_minmax(sk)
    save_npz(params, str(tmp_path / "scaler.npz"))
    back = load_npz(str(tmp_path / "scaler.npz"))
    for a, b in zip(back, params):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.transform(x), sk.transform(x))


def _events(module, path):
    with module.ExperimentStream(path, name="lcld:pgd_flip") as s:
        s.log_parameters({"eps": 0.2, "paths": {"model": "m"}, "arr": np.arange(3), "n": np.int64(4)})
        s.log_metric("time", 1.25)
        s.log_metric("o1", np.float64(0.5), step=3)
        s.log_event("request", id="r1", status=200)
        s.log_series("mean_loss", np.array([1.0, 0.5]), start_step=2)
    return [{k: v for k, v in e.items() if k != "t"} for e in module.read_events(path)]


def test_stream_events_equal_jax(tmp_path):
    assert _events(pstreaming, str(tmp_path / "p.jsonl")) == _events(jstreaming, str(tmp_path / "j.jsonl"))
    cfg = {"streaming": True, "project_name": "lcld", "dirs": {"results": str(tmp_path)}}
    assert pstreaming.stream_for(cfg, "moeva", "h").path == jstreaming.stream_for(cfg, "moeva", "h").path
    assert not pstreaming.stream_for({}, "moeva", "h").enabled


def test_success_rate_csv_is_pandas_bytes(tmp_path):
    import pandas as pd

    for vals in ([1.0, 0.5, 0.0, 1 / 3, 0.0625, 2 / 7, 1e-05], [0.1, 0.2, 0.30000000000000004, 1e-20, 0.999, 1, 0]):
        record = dict(zip(O_COLUMNS, map(float, vals)))
        pd.DataFrame(np.asarray(vals, float).reshape(1, -1), columns=list(O_COLUMNS)).to_csv(
            tmp_path / "pandas.csv", index=False)
        write_success_rate_csv(record, str(tmp_path / "port.csv"))
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_registry_resolves_and_refuses():
    assert get_constraints_class("lcld") is LcldConstraints
    assert get_constraints_class("lcld_augmented") is LcldAugmentedConstraints
    assert get_constraints_class("botnet") is BotnetConstraints
    assert get_constraints_class("botnet_augmented") is BotnetAugmentedConstraints
    # the spec domains resolve since the constraint IR is ported, as in JAX
    for name in ("lcld_spec", "botnet_spec", "phishing", "family21"):
        assert get_constraints_class(name).spec.name == j_get_constraints_class(name).spec.name
        assert get_constraints_class(name).objective_kernel == "spec"
    # the message lists the names registered so far: the same in both
    from moeva2_ijcai22_replication_tpu.domains import CONSTRAINTS_REGISTRY as J_REGISTRY
    from moeva2_ijcai22_replication_tpu_torch.domains import CONSTRAINTS_REGISTRY

    for name in set(CONSTRAINTS_REGISTRY) | set(J_REGISTRY):
        get_constraints_class(name), j_get_constraints_class(name)
    with pytest.raises(ValueError) as got:
        get_constraints_class("nope")
    with pytest.raises(ValueError) as want:
        j_get_constraints_class("nope")
    assert str(got.value) == str(want.value)

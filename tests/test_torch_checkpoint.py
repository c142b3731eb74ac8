"""Checkpoint and resume of the port's MoEvA2 engine: a run interrupted
after a checkpoint and run again resumes there and ends bit-identical to an
uninterrupted run (strict, early exit with a compacted active set, state
chunks, and the history of every evaluation, whose segments the snapshots
count in sidecars); a stale or corrupt checkpoint is ignored; the
fingerprint follows the inputs, the bounds, the weights and the scaler."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu_torch.attacks.moeva import Moeva2
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.checkpoint import AttackCheckpointer
from moeva2_ijcai22_replication_tpu_torch.models.io import Surrogate
from moeva2_ijcai22_replication_tpu_torch.models.scalers import MinMaxParams
from moeva2_ijcai22_replication_tpu_torch.problems import synthetic_lcld_problem

# tier-1 runs several test processes side by side: one intra-op thread
# each keeps these small-tensor tests from oversubscribing the cores
torch.set_num_threads(1)

KNOBS = dict(norm=2, n_gen=16, n_pop=12, n_offsprings=8, archive_size=4, seed=5)
#: the early exit parks states at several gates and repacks 24 -> 16 -> 8
EARLY = dict(early_stop_check_every=3, early_stop_threshold=0.47, compaction_buckets=(4, 8, 16),
             record_quality=True)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    cons, sur, scaler, x = synthetic_lcld_problem(str(tmp_path_factory.mktemp("ckpt")), 24)
    return cons, sur, scaler, x


def _engine(problem, **knobs):
    cons, sur, scaler, _ = problem
    knobs = {"classifier": sur, "ml_scaler": scaler, **KNOBS, **knobs}
    return Moeva2(constraints=cons, device="cpu", **knobs)


def _count_steps(eng):
    calls = []
    step = eng.gen_step
    eng.gen_step = lambda *a: calls.append(1) or step(*a)
    return calls


def _assert_same(a, b):
    for k in ("x_gen", "f", "x_ml"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.gens_executed == b.gens_executed and a.early_stop == b.early_stop
    assert (a.history is None) == (b.history is None)
    for ha, hb in zip(a.history or (), b.history or ()):
        np.testing.assert_array_equal(ha, hb)
    assert len(a.history or ()) == len(b.history or ())


class Crash(RuntimeError):
    pass


CASES = {
    "strict": (dict(), None),
    "early-exit": (EARLY, None),
    "chunked": (dict(EARLY, early_stop_threshold=0.48, max_states_per_call=12), ".chunk1"),
    # segments of 3 generations, cut at the checkpoints every 4
    "history-reduced": (dict(save_history="reduced", history_chunk=3), None),
    "history-full": (dict(save_history="full", history_chunk=3, max_states_per_call=16), ".chunk1"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_after_a_crash_is_bit_identical(problem, tmp_path, monkeypatch, case):
    knobs, crash_in = CASES[case]
    x = problem[3]
    want = _engine(problem, **knobs).generate(x, 1)
    full_steps = _count_steps(eng := _engine(problem, **knobs))
    eng.generate(x, 1)
    path = str(tmp_path / "run.npz")
    saves = []
    save = AttackCheckpointer.save

    def crashing_save(self, *args, **kwargs):
        save(self, *args, **kwargs)
        if knobs.get("save_history"):
            # the snapshot counts the history segments already in sidecars
            with np.load(self.path) as z:
                n_hist = json.loads(str(z["__meta__"]))["n_hist"]
            assert n_hist == kwargs["n_hist"] > 0
            assert len(os.listdir(self.hist_dir)) >= n_hist
        if crash_in is None or self.path.endswith(crash_in):
            saves.append(self.path)
            if len(saves) == 2:
                raise Crash(self.path)

    monkeypatch.setattr(AttackCheckpointer, "save", crashing_save)
    with pytest.raises(Crash) as crashed:
        _engine(problem, checkpoint_every=4, checkpoint_path=path, **knobs).generate(x, 1)
    assert os.path.exists(str(crashed.value))
    monkeypatch.setattr(AttackCheckpointer, "save", save)
    eng = _engine(problem, checkpoint_every=4, checkpoint_path=path, **knobs)
    steps = _count_steps(eng)
    got = eng.generate(x, 1)
    _assert_same(got, want)
    assert len(steps) < len(full_steps)  # it resumed: fewer generation steps ran
    assert not [f for f in os.listdir(tmp_path) if f.startswith("run.npz")]  # a completed run clears its files


def test_checkpointing_changes_no_result(problem, tmp_path):
    x = problem[3]
    for knobs in (dict(), EARLY):
        want = _engine(problem, **knobs).generate(x, 1)
        got = _engine(problem, checkpoint_every=5, checkpoint_path=str(tmp_path / "c.npz"), **knobs).generate(x, 1)
        _assert_same(got, want)


@pytest.mark.parametrize("bad", ["stale", "corrupt", "truncated"])
def test_a_stale_or_corrupt_checkpoint_is_ignored(problem, tmp_path, monkeypatch, bad):
    x = problem[3]
    path = str(tmp_path / "run.npz")
    if bad == "stale":
        # a checkpoint of another attack (another seed) at the same path
        def stop(self, *args, **kwargs):
            save(self, *args, **kwargs)
            raise Crash()

        save = AttackCheckpointer.save
        monkeypatch.setattr(AttackCheckpointer, "save", stop)
        with pytest.raises(Crash):
            _engine(problem, checkpoint_every=4, checkpoint_path=path, seed=99).generate(x, 1)
        monkeypatch.setattr(AttackCheckpointer, "save", save)
    else:
        with open(path, "wb") as fh:
            fh.write(b"not a checkpoint" if bad == "corrupt" else b"PK\x03\x04")
    assert os.path.exists(path)
    eng = _engine(problem, checkpoint_every=4, checkpoint_path=path)
    steps = _count_steps(eng)
    _assert_same(eng.generate(x, 1), _engine(problem).generate(x, 1))
    assert len(steps) == KNOBS["n_gen"] - 1  # a fresh start
    assert not os.path.exists(path)


def test_fingerprint_follows_inputs_bounds_weights_and_scaler(problem):
    cons, sur, scaler, x = problem
    eng = _engine(problem)
    mc = np.ones(len(x), dtype=np.int64)
    xl, xu = (np.array(np.broadcast_to(np.asarray(a, float), x.shape)) for a in cons.get_feature_min_max(x))
    base = eng._fingerprint(x, mc, xl, xu)
    assert eng._fingerprint(x.copy(), mc.copy(), xl.copy(), xu.copy()) == base
    x2, xl2, xu2 = x.copy(), xl.copy(), xu.copy()
    x2[0, 0] += 1
    xl2[1, 2] -= 1
    xu2[2, 3] += 1
    changed = [
        eng._fingerprint(x2, mc, xl, xu), eng._fingerprint(x, mc * 0, xl, xu),
        eng._fingerprint(x, mc, xl2, xu), eng._fingerprint(x, mc, xl, xu2),
    ]
    other = _engine(problem, ml_scaler=MinMaxParams(scaler.scale * 2, scaler.min_))
    changed.append(other._fingerprint(x, mc, xl, xu))
    model = copy.deepcopy(sur.model)
    with torch.no_grad():
        model.layers[0].bias.add_(1.0)
    changed.append(_engine(problem, classifier=Surrogate(model))._fingerprint(x, mc, xl, xu))
    for knob in (dict(seed=1), dict(n_gen=3), dict(archive_size=2), dict(early_stop_check_every=2),
                 dict(init="lp_ratio")):
        changed.append(_engine(problem, **knob)._fingerprint(x, mc, xl, xu))
    assert base not in changed and len(set(changed)) == len(changed)
    # knobs that change no result leave it alone
    for knob in (dict(double_buffer=False), dict(record_quality=True, quality_every=3)):
        assert _engine(problem, **knob)._fingerprint(x, mc, xl, xu) == base


def test_checkpointer_round_trip(tmp_path):
    path = str(tmp_path / "c.npz")
    cp = AttackCheckpointer(path, "abc")
    assert cp.load([torch.zeros(2, 3)]) is None
    leaves = [torch.arange(6.0).reshape(2, 3), torch.tensor([[1, 2]], dtype=torch.int64),
              torch.tensor([7, 8, 9], dtype=torch.uint8)]
    cp.add_hist_chunk(0, np.ones((2, 2)))
    cp.add_hist_chunk(1, np.zeros(3))
    cp.save(leaves, done=7, n_hist=2, extra={"row_src": np.array([4, 1])})
    template = [torch.zeros(5, 3), torch.zeros(1, 2, dtype=torch.int64), torch.zeros(3, dtype=torch.uint8)]
    got, done, hist = AttackCheckpointer(path, "abc").load(template)
    assert done == 7 and [h.shape for h in hist] == [(2, 2), (3,)]
    for g, w in zip(got, leaves):
        assert g.dtype == w.dtype and torch.equal(g, w)
    reader = AttackCheckpointer(path, "abc")
    reader.load(template)
    np.testing.assert_array_equal(reader.extra["row_src"], [4, 1])
    assert AttackCheckpointer(path, "other").load(template) is None
    assert AttackCheckpointer(path, "abc").load(template[:2]) is None
    assert AttackCheckpointer(path, "abc").load([torch.zeros(2, 4), *template[1:]]) is None
    assert AttackCheckpointer(path, "abc").load([template[0].double(), *template[1:]]) is None
    os.remove(cp._hist_file(1))
    assert AttackCheckpointer(path, "abc").load(template) is None  # a sidecar is missing
    cp.clear()
    assert not os.path.exists(path) and not os.path.exists(cp.hist_dir)

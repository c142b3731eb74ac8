"""The port's LCLD preprocessing against the JAX package's, on the CPU.

Both take ``tests/test_preprocess.py``'s synthetic raw LendingClub sample
and must emit the same frame (columns, order, dtypes, values); the port's
imports pandas only inside its functions and, without pandas, raises an
ImportError that says so.
"""

from __future__ import annotations

import sys

import pandas as pd
import pytest
from test_preprocess import raw_sample

from moeva2_ijcai22_replication_tpu.experiments import preprocess as jpre
from moeva2_ijcai22_replication_tpu_torch.experiments import preprocess as ppre


@pytest.mark.parametrize("n, seed", [(40, 0), (200, 1), (500, 7)])
def test_same_frame_as_jax(n, seed):
    raw = raw_sample(n, seed)
    pd.testing.assert_frame_equal(ppre.preprocess_lcld(raw.copy()), jpre.preprocess_lcld(raw.copy()))


def test_schema_order_and_tables_equal_jax():
    assert ppre._schema_order() == jpre._schema_order()
    assert (ppre.KEEP, ppre.GRADES, ppre.OHE_LEVELS, ppre.BINARY_LEVELS) == \
        (jpre.KEEP, jpre.GRADES, jpre.OHE_LEVELS, jpre.BINARY_LEVELS)


def test_missing_columns_raise_as_jax():
    raw = raw_sample().drop(columns=["grade"])
    with pytest.raises(ValueError) as want:
        jpre.preprocess_lcld(raw.copy())
    with pytest.raises(ValueError) as got:
        ppre.preprocess_lcld(raw.copy())
    assert str(got.value) == str(want.value)


def test_run_writes_the_jax_csv(tmp_path):
    raw_sample(120, 3).to_csv(tmp_path / "raw.csv", index=False)
    for pkg, name in ((jpre, "jax.csv"), (ppre, "port.csv")):
        pkg.run({"paths": {"raw_data": str(tmp_path / "raw.csv"), "dataset": str(tmp_path / name)}})
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_refused_without_pandas(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="needs|pandas, which is not installed"):
        ppre.preprocess_lcld(None)
    with pytest.raises(ImportError, match="pandas"):
        ppre.run({"paths": {"raw_data": "raw.csv", "dataset": "out.csv"}})

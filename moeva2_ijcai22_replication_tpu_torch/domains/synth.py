"""Synthetic constraint-satisfying LCLD samples (numpy only).

A copy of the LCLD part of ``moeva2_ijcai22_replication_tpu/domains/synth.py``
and of ``domains/ir/ops.py::months``: for the same seed it writes the same
CSV bytes and draws the same rows, so the port builds its own problem.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.schema import FeatureSchema


def months(date_feature):
    """YYYYMM integer-coded date -> month count: floor(f/100)*12 + f mod 100.

    Works on numpy arrays and on torch tensors (both have the same
    floor/mod semantics for the non-negative dates used here)."""
    if isinstance(date_feature, (np.ndarray, np.generic, float, int)):
        return np.floor(date_feature / 100.0) * 12.0 + np.mod(date_feature, 100.0)
    import torch

    # a 0-d divisor: a true division on the card too, as in kernel K1
    hundred = torch.full((), 100.0, dtype=date_feature.dtype, device=date_feature.device)
    return torch.floor(date_feature / hundred) * 12.0 + torch.remainder(date_feature, hundred)


def _random_date(rng, lo_yyyymm: int, hi_yyyymm: int, size) -> np.ndarray:
    """Uniform YYYYMM dates with valid months."""
    lo_m = (lo_yyyymm // 100) * 12 + lo_yyyymm % 100
    hi_m = (hi_yyyymm // 100) * 12 + hi_yyyymm % 100
    m = rng.integers(lo_m, hi_m + 1, size=size)
    year, month = (m - 1) // 12, (m - 1) % 12 + 1
    return (year * 100 + month).astype(np.float64)


def synth_lcld_schema(out_dir: str) -> dict:
    """Write a self-contained LCLD schema pair (``features.csv`` +
    ``constraints.csv``) and return their paths.

    Indices 0..25 are the named numeric features of ``domains/lcld.py``'s
    constraint kernel, 26..46 three one-hot groups (4+14+3), bounds covering
    :func:`synth_lcld`'s generator ranges.
    """
    rows = [
        ("loan_amnt", "real", "TRUE", 1000, 40000),
        ("term", "int", "TRUE", 36, 60),
        ("int_rate", "real", "TRUE", 5.31, 30.99),
        ("installment", "real", "TRUE", 0, 3500),
        ("grade", "int", "TRUE", 0, 7),
        ("emp_length", "int", "TRUE", 0, 10),
        ("annual_inc", "real", "TRUE", 10000, 300000),
        ("issue_d", "int", "FALSE", 201203, 201812),
        ("dti", "real", "TRUE", 0, 45),
        ("earliest_cr_line", "int", "FALSE", 198001, 201812),
        ("open_acc", "int", "TRUE", 0, 80),
        ("pub_rec", "int", "TRUE", 0, 10),
        ("revol_bal", "real", "TRUE", 0, 100000),
        ("revol_util", "real", "TRUE", 0, 150),
        ("total_acc", "int", "TRUE", 0, 80),
        ("mort_acc", "int", "TRUE", 0, 10),
        ("pub_rec_bankruptcies", "int", "TRUE", 0, 10),
        ("fico_score", "real", "TRUE", 600, 850),
        ("initial_list_status_w", "int", "TRUE", 0, 1),
        ("application_type_joint", "int", "TRUE", 0, 1),
        ("ratio_loan_income", "real", "TRUE", 0, 4),
        ("ratio_open_total", "real", "TRUE", 0, 1),
        ("month_since_cr_line", "real", "TRUE", 0, 400),
        ("ratio_pubrec_month", "real", "TRUE", 0, 1),
        ("ratio_bankrupt_month", "real", "TRUE", 0, 1),
        ("ratio_bankrupt_pubrec", "real", "TRUE", -1, 1),
    ]
    for g, k in (("ohe0", 4), ("ohe1", 14), ("ohe2", 3)):
        for j in range(k):
            rows.append((f"{g}_{j}", g, "TRUE", 0, 1))
    os.makedirs(out_dir, exist_ok=True)
    features = os.path.join(out_dir, "features.csv")
    with open(features, "w") as f:
        f.write("feature,type,mutable,min,max,augmentation\n")
        for name, t, mut, lo, hi in rows:
            f.write(f"{name},{t},{mut},{lo},{hi},FALSE\n")
    constraints = os.path.join(out_dir, "constraints.csv")
    with open(constraints, "w") as f:
        f.write("constraint,min,max\n")
        for i in range(10):
            f.write(f"g{i + 1},0,1\n")
    return {"features": features, "constraints": constraints}


def synth_lcld(
    n: int, schema: FeatureSchema, seed: int = 0, label_rate: float = 0.5
) -> np.ndarray:
    """Generate ``n`` LCLD samples satisfying all 10 constraints exactly."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, schema.n_features))

    x[:, 0] = rng.uniform(1000, 40000, n)  # loan_amnt
    x[:, 1] = rng.choice([36.0, 60.0], n)  # term
    x[:, 2] = rng.uniform(5.31, 30.99, n)  # int_rate
    r = x[:, 2] / 1200.0
    growth = (1.0 + r) ** x[:, 1]
    x[:, 3] = x[:, 0] * r * growth / (growth - 1.0)  # installment
    x[:, 4] = rng.integers(1, 8, n)  # grade
    x[:, 5] = rng.integers(0, 11, n)  # emp_length
    x[:, 6] = rng.uniform(20000, 300000, n)  # annual_inc
    x[:, 7] = _random_date(rng, 201203, 201812, n)  # issue_d
    x[:, 8] = rng.uniform(0, 40, n)  # dti
    # earliest_cr_line at least 36 months before issue_d (bound of feature 22)
    issue_m = months(x[:, 7])
    offset = rng.integers(36, 300, n).astype(np.float64)
    ecl_m = issue_m - offset
    year, month = (ecl_m - 1) // 12, (ecl_m - 1) % 12 + 1
    x[:, 9] = year * 100 + month  # earliest_cr_line
    x[:, 14] = np.round(rng.uniform(2, 80, n))  # total_acc
    x[:, 10] = np.round(rng.uniform(1, x[:, 14]))  # open_acc <= total_acc
    x[:, 11] = np.round(rng.uniform(0, 5, n) * (rng.random(n) < 0.3))  # pub_rec
    x[:, 12] = rng.uniform(0, 100000, n)  # revol_bal
    x[:, 13] = rng.uniform(0, 150, n)  # revol_util
    x[:, 15] = np.round(rng.uniform(0, 10, n))  # mort_acc
    x[:, 16] = np.round(rng.uniform(0, x[:, 11]))  # pub_rec_bankruptcies <= pub_rec
    x[:, 17] = rng.uniform(662, 847.5, n)  # fico_score
    x[:, 18] = rng.integers(0, 2, n)  # initial_list_status_w
    x[:, 19] = rng.integers(0, 2, n)  # application_type_Joint App

    diff = issue_m - months(x[:, 9])
    x[:, 20] = x[:, 0] / x[:, 6]
    x[:, 21] = x[:, 10] / x[:, 14]
    x[:, 22] = diff
    x[:, 23] = x[:, 11] / diff
    x[:, 24] = x[:, 16] / diff
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(x[:, 11] == 0, -1.0, x[:, 16] / np.where(x[:, 11] == 0, 1, x[:, 11]))
    x[:, 25] = ratio

    # One-hot groups: pick one member per group uniformly.
    for group in schema.ohe_groups():
        choice = rng.integers(0, len(group), n)
        x[np.arange(n)[:, None], np.asarray(group)[None, :]] = 0.0
        x[np.arange(n), np.asarray(group)[choice]] = 1.0

    return x

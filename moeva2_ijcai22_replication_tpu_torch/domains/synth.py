"""Synthetic constraint-satisfying LCLD, botnet and phishing samples (numpy).

A copy of the LCLD, botnet and phishing parts of
``moeva2_ijcai22_replication_tpu/domains/synth.py``: for the same seed it
writes the same files and draws the same rows, so the port builds its own
problems. ``months`` is the constraint IR's (``domains/ir/ops.py``), the
port's one definition.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.schema import FeatureSchema
from .ir.ops import months

__all__ = ["months", "synth_botnet", "synth_botnet_schema", "synth_lcld", "synth_lcld_schema", "synth_phishing"]


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




# -- botnet -------------------------------------------------------------------

_BOTNET_PORTS = 18
_BOTNET_KINDS = ("bytes_out", "pkts_out", "duration")
_BOTNET_STATS = ("sum", "max", "min")


def synth_botnet_schema(out_dir: str) -> dict:
    """Write a self-contained botnet schema (``features.csv`` +
    ``constraints.csv`` + ``feat_idx.pickle``) and return the paths.

    The reference's CTU-13 schema is not redistributed; this one reproduces
    its *structure* exactly — 756 features, the 18-port group tables
    ``domains/botnet.py`` gathers through (9 stat keys + 3 protocol-sum keys
    + 1 bytes_in key per direction), 360 constraint rows — from committed
    code alone.
    """
    names: list = []
    feat_idx: dict = {}

    def alloc(key: str, count: int, prefix: str) -> None:
        base = len(names)
        names.extend(f"{prefix}_p{j}" for j in range(count))
        feat_idx[key] = np.arange(base, base + count, dtype=np.int64)

    for side in ("s", "d"):
        for kind in _BOTNET_KINDS:
            for stat in _BOTNET_STATS:
                alloc(f"{kind}_{stat}_{side}_idx", _BOTNET_PORTS, f"{kind}_{stat}_{side}")
        for proto in ("icmp", "udp", "tcp"):
            alloc(f"{proto}_sum_{side}_idx", _BOTNET_PORTS, f"{proto}_sum_{side}")
        alloc(f"bytes_in_sum_{side}_idx", _BOTNET_PORTS, f"bytes_in_sum_{side}")
    while len(names) < 756:
        names.append(f"ctx_{len(names)}")
    assert len(names) == 756

    os.makedirs(out_dir, exist_ok=True)
    features = os.path.join(out_dir, "features.csv")
    with open(features, "w") as f:
        f.write("feature,type,mutable,min,max,augmentation\n")
        for name in names:
            hi = 1.0 if name.startswith("ctx_") else 1e7
            f.write(f"{name},real,TRUE,0,{hi},FALSE\n")
    constraints = os.path.join(out_dir, "constraints.csv")
    with open(constraints, "w") as f:
        f.write("constraint,min,max\n")
        for i in range(360):
            f.write(f"c{i},0,1\n")
    idx_path = os.path.join(out_dir, "feat_idx.pickle")
    with open(idx_path, "wb") as f:
        pickle.dump(feat_idx, f)
    return {"features": features, "constraints": constraints, "feat_idx": idx_path}


def synth_botnet(n: int, schema: FeatureSchema, seed: int = 0) -> np.ndarray:
    """Generate ``n`` botnet samples satisfying all 360 constraints exactly.

    Construction: per (kind, side, port) three draws sorted into
    min <= median <= max with sum = min+median+max (>= max, so every
    ordering holds); bytes_out triples rescaled under 1500·pkts_out (MTU
    ratio); protocol port sums constructed so Σflows == Σbytes_in +
    Σbytes_out per direction EXACTLY.

    Every constrained value is quantized to a multiple of 1/16 with
    magnitude far below 2**18, so values, triple sums, and the 54-term
    flow-identity sums are all exactly representable in float32 in any
    summation order: the equalities hold bit-exactly under the engines'
    f32 casts (the serving request path validates in f32), not just in
    the f64 sampler.
    """
    rng = np.random.default_rng(seed)
    d = schema.n_features
    x = np.zeros((n, d))
    x[:, :] = rng.uniform(0.0, 1.0, (n, d))  # filler/ctx features

    cols = {name: i for i, name in enumerate(schema.names)}

    def q16(v: np.ndarray) -> np.ndarray:
        """Quantize to 1/16 steps (monotone, so orderings survive)."""
        return np.floor(v * 16.0) / 16.0

    def block(prefix: str) -> np.ndarray:
        return np.array(
            [cols[f"{prefix}_p{j}"] for j in range(_BOTNET_PORTS)], dtype=np.int64
        )

    for side in ("s", "d"):
        triples = {}
        for kind in _BOTNET_KINDS:
            scale = {"bytes_out": 3000.0, "pkts_out": 40.0, "duration": 60.0}[kind]
            draws = np.sort(
                rng.uniform(0.0, scale, (n, _BOTNET_PORTS, 3)), axis=-1
            )
            # sparsify: some ports saw no traffic at all
            draws *= (rng.random((n, _BOTNET_PORTS, 1)) < 0.7)
            triples[kind] = q16(draws)
        # MTU: bytes_out_sum <= 1500 * pkts_out_sum, preserved under the
        # triple's internal ordering by scaling the whole triple; the
        # re-quantize after scaling only shrinks bytes, keeping the bound
        b_sum = triples["bytes_out"].sum(-1)
        p_sum = triples["pkts_out"].sum(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            factor = np.where(
                (p_sum > 0) & (b_sum > 1500.0 * p_sum),
                np.where(b_sum > 0, 1500.0 * p_sum / np.where(b_sum > 0, b_sum, 1.0), 1.0),
                1.0,
            )
        triples["bytes_out"] = q16(triples["bytes_out"] * factor[..., None])
        # pkts==0 ports pass via the sentinel, but only if bytes==0 too is
        # not required — the guard passes any bytes; keep them anyway.
        for kind in _BOTNET_KINDS:
            mn, md, mx = (triples[kind][..., k] for k in range(3))
            x[:, block(f"{kind}_min_{side}")] = mn
            x[:, block(f"{kind}_max_{side}")] = mx
            x[:, block(f"{kind}_sum_{side}")] = mn + md + mx
        # flow-volume identity: Σ proto sums == Σ bytes_in + Σ bytes_out.
        # target is a multiple of 1/16; quantizing the scaled flows only
        # undershoots, and the residual (also a multiple of 1/16) lands on
        # the first flow — the identity is exact, not approximately scaled
        x[:, block(f"bytes_in_sum_{side}")] = q16(
            rng.uniform(0.0, 2000.0, (n, _BOTNET_PORTS))
        )
        target = (
            x[:, block(f"bytes_in_sum_{side}")].sum(-1)
            + x[:, block(f"bytes_out_sum_{side}")].sum(-1)
        )
        flows = rng.uniform(0.1, 100.0, (n, 3 * _BOTNET_PORTS))
        flows = q16(flows * (target / flows.sum(-1))[:, None])
        flows[:, 0] += target - flows.sum(-1)
        x[:, block(f"icmp_sum_{side}")] = flows[:, :_BOTNET_PORTS]
        x[:, block(f"udp_sum_{side}")] = flows[:, _BOTNET_PORTS : 2 * _BOTNET_PORTS]
        x[:, block(f"tcp_sum_{side}")] = flows[:, 2 * _BOTNET_PORTS :]
    return x


# -- phishing -----------------------------------------------------------------


def synth_phishing(n: int, schema: FeatureSchema, seed: int = 0) -> np.ndarray:
    """Generate ``n`` samples of the spec-only phishing/URL domain
    (``domains/specs/phishing/``) satisfying all 10 constraints exactly.

    The domain has no hand-written constraint class (the committed CSV spec
    is its one definition), so this sampler builds rows constraint-first:
    lengths split hostname+path <= url, punctuation counts summed into
    n_punct, ratios derived by the same guarded division the spec uses.
    """
    rng = np.random.default_rng(seed)
    cols = {name: i for i, name in enumerate(schema.names)}
    x = np.zeros((n, schema.n_features))

    url = np.round(rng.uniform(30, 300, n))
    host = np.round(rng.uniform(4, 25, n))
    path = np.round(rng.uniform(0, url - host))
    dots = np.round(rng.uniform(1, 10, n))
    hyphens = np.round(rng.uniform(0, 5, n))
    slash = np.round(rng.uniform(1, 8, n))
    digits = np.round(rng.uniform(0, 0.3 * url))
    special = np.round(rng.uniform(0, 0.2 * url))

    x[:, cols["length_url"]] = url
    x[:, cols["length_hostname"]] = host
    x[:, cols["length_path"]] = path
    x[:, cols["nb_dots"]] = dots
    x[:, cols["nb_hyphens"]] = hyphens
    x[:, cols["nb_slash"]] = slash
    x[:, cols["nb_digits"]] = digits
    x[:, cols["nb_special"]] = special
    x[:, cols["n_subdomains"]] = np.minimum(np.round(rng.uniform(0, 4, n)), dots)
    x[:, cols["https"]] = rng.integers(0, 2, n)
    x[:, cols["n_punct"]] = dots + hyphens + slash
    x[:, cols["ratio_digits_url"]] = digits / url
    x[:, cols["ratio_special_url"]] = special / url
    x[:, cols["ratio_hostname_url"]] = host / url
    return x

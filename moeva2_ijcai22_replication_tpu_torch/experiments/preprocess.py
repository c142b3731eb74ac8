"""LCLD raw-data preprocessing: LendingClub CSV → the 47-feature dataset.

Port of ``experiments/preprocess.py``: host code on pandas, which is
imported inside the functions that need it (:func:`_pandas`), so importing
this module needs numpy alone; on a machine without pandas they raise an
``ImportError`` that says so. Capability parity with the reference's
``src/experiments/lcld/00_data_preprocess.py:9-150`` (status filter, investor-known column whitelist, emp_length/grade encodings,
YYYYMM date ints, fico average, the six derived ratio features, one-hot
dummies, ``charged_off`` target). The raw LendingClub CSV is not
redistributed with the reference, so this stage has nothing to run on in CI
— ``domains/synth.py`` generates constraint-valid data instead — but the
transform itself ships so a user with the raw export gets the same dataset.

Reshaped from the reference's 150-line imperative script into declarative
tables (encodings, derived-feature formulas, pinned category lists). Pinning
the categorical levels to the committed ``features.csv`` schema is a
deliberate difference: ``pd.get_dummies`` on a raw sample that happens to
miss a level would silently emit a narrower frame; here the output columns
are the schema's 47, always.
"""

from __future__ import annotations

import numpy as np

#: investor-known columns kept from the raw export (``00_data_preprocess.py:33-37``)
KEEP = [
    "annual_inc", "application_type", "dti", "earliest_cr_line", "emp_length",
    "fico_range_high", "fico_range_low", "grade", "home_ownership",
    "initial_list_status", "installment", "int_rate", "issue_d", "loan_amnt",
    "loan_status", "mort_acc", "open_acc", "pub_rec", "pub_rec_bankruptcies",
    "purpose", "revol_bal", "revol_util", "term", "total_acc",
    "verification_status",
]

GRADES = {g: i + 1 for i, g in enumerate("ABCDEFG")}

#: pinned one-hot levels, in the committed features.csv order
OHE_LEVELS = {
    "home_ownership": ["MORTGAGE", "OTHER", "OWN", "RENT"],
    "verification_status": ["Not Verified", "Source Verified", "Verified"],
    "purpose": [
        "car", "credit_card", "debt_consolidation", "educational",
        "home_improvement", "house", "major_purchase", "medical", "moving",
        "other", "renewable_energy", "small_business", "vacation", "wedding",
    ],
}
#: drop-first binaries (``00_data_preprocess.py:116``)
BINARY_LEVELS = {"initial_list_status": "w", "application_type": "Joint App"}


def _pandas():
    """pandas, or an ImportError saying that preprocessing needs it."""
    try:
        import pandas
    except ImportError as exc:
        raise ImportError(
            "LCLD preprocessing reads and writes the raw LendingClub CSV with pandas, which is not installed "
            "here: run it where pandas is, and give the card's machine the dataset it writes"
        ) from exc
    return pandas


def _date_to_yyyymm(s):
    pd = _pandas()
    return pd.to_datetime(s).map(
        lambda d: np.nan if pd.isnull(d) else int(d.strftime("%Y%m"))
    )


def _months(d):
    return np.floor(d / 100) * 12 + d % 100


def preprocess_lcld(raw):
    """Raw LendingClub frame (pandas) → cleaned frame: the 47 schema
    features (in ``features.csv`` order) + the ``charged_off`` target."""
    pd = _pandas()
    missing_raw = [c for c in KEEP + ["loan_status"] if c not in raw.columns]
    if missing_raw:
        raise ValueError(
            f"raw export is missing required columns: {missing_raw} — the "
            "47-feature schema cannot be derived from this file"
        )
    loans = raw.loc[raw["loan_status"].isin(["Fully Paid", "Charged Off"])]
    loans = loans[KEEP].copy()

    # scalar encodings
    loans["term"] = loans["term"].map(lambda s: int(str(s).split()[0]))
    loans["emp_length"] = (
        loans["emp_length"]
        .replace({"10+ years": "10 years", "< 1 year": "0 years"})
        .map(lambda s: s if pd.isnull(s) else int(str(s).split()[0]))
    )
    loans["home_ownership"] = loans["home_ownership"].replace(
        ["NONE", "ANY"], "OTHER"
    )
    loans["grade"] = loans["grade"].map(GRADES)

    # dates as YYYYMM ints; a 1900-01 earliest_cr_line marks missing
    loans["earliest_cr_line"] = _date_to_yyyymm(
        loans["earliest_cr_line"].fillna("1900-01-01")
    ).replace({190001: np.nan})
    loans["issue_d"] = _date_to_yyyymm(loans["issue_d"])

    loans["fico_score"] = (
        loans.pop("fico_range_low") + loans.pop("fico_range_high")
    ) / 2.0

    # binary / one-hot expansions against the pinned level lists; column
    # names keep the raw level verbatim ("application_type_Joint App",
    # "verification_status_Not Verified") — the committed schema's names
    for col, level in BINARY_LEVELS.items():
        loans[f"{col}_{level}"] = (loans.pop(col) == level).astype(np.uint8)
    ohe_frames = {}
    for col, levels in OHE_LEVELS.items():
        vals = loans.pop(col)
        for lv in levels:
            ohe_frames[f"{col}_{lv}"] = (vals == lv).astype(np.uint8)

    # derived features (the constraint formulas' right-hand sides)
    loans["ratio_loan_amnt_annual_inc"] = loans["loan_amnt"] / loans["annual_inc"]
    loans["ratio_open_acc_total_acc"] = loans["open_acc"] / loans["total_acc"]
    diff = _months(loans["issue_d"]) - _months(loans["earliest_cr_line"])
    loans["diff_issue_d_earliest_cr_line"] = diff
    loans["ratio_pub_rec_diff_issue_d_earliest_cr_line"] = loans["pub_rec"] / diff
    loans["ratio_pub_rec_bankruptcies_diff_issue_d_earliest_cr_line"] = (
        loans["pub_rec_bankruptcies"] / diff
    )
    loans["ratio_pub_rec_bankruptcies_pub_rec"] = np.where(
        loans["pub_rec"] > 0,
        loans["pub_rec_bankruptcies"] / loans["pub_rec"].replace({0: 1}),
        -1.0,
    )

    for name, col in ohe_frames.items():
        loans[name] = col
    loans["charged_off"] = (loans.pop("loan_status") == "Charged Off").astype(
        np.uint8
    )
    loans = loans.dropna()

    order = _schema_order()
    missing = [c for c in order if c not in loans.columns]
    if missing:
        raise ValueError(
            f"raw export is missing columns needed for the 47-feature schema: "
            f"{missing} — refusing to emit a silently narrowed dataset"
        )
    return loans[order + ["charged_off"]]


def _schema_order() -> list[str]:
    """The committed features.csv column order (hard-coded so preprocessing
    does not require the schema file; cross-checked by the test suite)."""
    return (
        ["loan_amnt", "term", "int_rate", "installment", "grade", "emp_length",
         "annual_inc", "issue_d", "dti", "earliest_cr_line", "open_acc",
         "pub_rec", "revol_bal", "revol_util", "total_acc", "mort_acc",
         "pub_rec_bankruptcies", "fico_score", "initial_list_status_w",
         "application_type_Joint App", "ratio_loan_amnt_annual_inc",
         "ratio_open_acc_total_acc", "diff_issue_d_earliest_cr_line",
         "ratio_pub_rec_diff_issue_d_earliest_cr_line",
         "ratio_pub_rec_bankruptcies_diff_issue_d_earliest_cr_line",
         "ratio_pub_rec_bankruptcies_pub_rec"]
        + [f"home_ownership_{l}" for l in OHE_LEVELS["home_ownership"]]
        + [f"verification_status_{l}" for l in OHE_LEVELS["verification_status"]]
        + [f"purpose_{l}" for l in OHE_LEVELS["purpose"]]
    )


def run(config: dict):
    pd = _pandas()
    raw = pd.read_csv(config["paths"]["raw_data"], low_memory=False)
    out = preprocess_lcld(raw)
    out.to_csv(config["paths"]["dataset"], index=False)
    print(f"Saved dataset {out.shape} -> {config['paths']['dataset']}")
    return out


if __name__ == "__main__":
    from ..utils.config import parse_config

    run(parse_config())

"""Ready-made attack problems for smoke runs and profiles.

``synthetic_lcld_problem`` and ``synthetic_botnet_problem`` are the
problems ``chip_smoke.py`` drives and profiles: a code-derived schema,
feasible synthetic states, a seeded surrogate (64-32-16-2 for LCLD,
64-64-32-2 for botnet) and a MinMax scaler over the data and the feature
bounds (so attacked candidates at their bounds stay in [0, 1] for the
judgement). ``synthetic_lcld_augmented_problem`` is LCLD's augmented
variant (57 features, 10 + 10 terms), and ``lcld_augmented_edge_rows`` puts
its pair terms' edge cases into rows. ``lcld_immutable_term_schema`` and
``lcld_immutable_repair_rows`` give a schema and rows whose repair rewrites
an immutable feature, for the check of kernel K7's round trip after repair.
``synthetic_botnet_pgd_problem`` adds the scaled rows and the
labels constrained PGD takes on botnet. ``botnet_hard_candidates`` puts the
botnet terms' edge cases into candidates, for the checks of kernel K8
against its plain version, and ``botnet_edge_starts`` into PGD starts, for
kernel K7b's. ``synthetic_botnet_augmented_problem`` is botnet's augmented
variant (927 features, 360 + 171 terms), and ``botnet_augmented_edge_rows``
puts its pair terms' edge cases into rows.

The domains compiled from a constraint spec (``domains/ir``):
``synthetic_lcld_spec_problem`` and ``synthetic_botnet_spec_problem`` are
the LCLD and botnet problems above with ``lcld_spec`` and ``botnet_spec``
in place of the hand-written classes (the same files, rows, surrogates and
scalers); ``synthetic_family_problem`` is a seeded ``family<seed>`` domain;
``phishing_problem`` is ``tools/oracle_check.py::build_phishing`` with the
port (the fixture's surrogate, ``PHISHING_SURROGATE``), and
``spec_edge_rows`` puts the spec operators' edge cases into rows.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from .domains import augmentation, get_constraints_class, spec_domain_dir
from .domains.botnet import N_BASE_FEATURES as BOTNET_BASE_FEATURES
from .domains.botnet import BotnetAugmentedConstraints, BotnetConstraints
from .domains.lcld import N_BASE_FEATURES, LcldAugmentedConstraints, LcldConstraints
from .domains.ir import sample_family, write_family
from .domains.synth import synth_botnet, synth_botnet_schema, synth_lcld, synth_lcld_schema, synth_phishing
from .models.io import Surrogate, load_params
from .models.mlp import botnet_mlp, lcld_mlp
from .models.scalers import MinMaxParams, fit_minmax


def _problem(cons, x: np.ndarray, model):
    cons.check_constraints_error(x)
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    scaler = fit_minmax(np.minimum(x.min(0), xl.min(0)), np.maximum(x.max(0), xu.max(0)))
    return cons, Surrogate(model), scaler, x


def synthetic_lcld_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[LcldConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x): ``synth_lcld(n_states, seed)``
    rows, checked feasible, with the schema files written to ``out_dir``."""
    paths = synth_lcld_schema(out_dir)
    cons = LcldConstraints(paths["features"], paths["constraints"])
    x = synth_lcld(n_states, cons.schema, seed=seed)
    return _problem(cons, x, lcld_mlp(cons.schema.n_features, seed=model_seed))


#: the important features of :func:`synthetic_lcld_augmented_problem`: term
#: and installment, which the repair changes, and three drawn from the seed
LCLD_IMPORTANT_FIXED = (1, 3)
LCLD_IMPORTANT_K = 5


def write_augmented_schema(paths: dict, n_new: int, out_dir: str) -> dict:
    """Copies of the schema files of ``paths`` in ``out_dir`` with ``n_new``
    augmented features and constraints appended, as the JAX package's
    ``experiments/defense.py::augmented_schema_rows`` appends them
    (``augmented_i,int,TRUE,0,1,TRUE``; constraint rows ``0,1,TRUE``), and
    the ``augmentation`` column FALSE on the base rows where it is missing."""
    out = {}
    for kind, new_row in (
        ("features", lambda i: {"feature": f"augmented_{i}", "type": "int", "mutable": "TRUE", "min": "0",
                                "max": "1", "augmentation": "TRUE"}),
        ("constraints", lambda i: {"constraint": f"augmented_{i}", "min": "0", "max": "1",
                                   "augmentation": "TRUE"}),
    ):
        with open(paths[kind], newline="") as f:
            reader = csv.DictReader(f)
            fields = list(reader.fieldnames)
            rows = [dict(r) for r in reader]
        if "augmentation" not in fields:
            fields.append("augmentation")
            for r in rows:
                r["augmentation"] = "FALSE"
        rows += [new_row(i) for i in range(n_new)]
        out[kind] = os.path.join(out_dir, f"{kind}_augmented.csv")
        with open(out[kind], "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
            writer.writeheader()
            writer.writerows(rows)
    return out


def synthetic_lcld_augmented_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[LcldAugmentedConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x) of LCLD's augmented variant:
    k = 5 important features (term and installment, and three mutable base
    features drawn by ``np.random.default_rng(seed)``), each with its mean
    over the ``synth_lcld(n_states, seed)`` rows as threshold (the JAX
    package's ``experiments/defense.py`` forms them so), written as
    ``important_features.npy`` beside the augmented schema files in
    ``out_dir``; the rows augmented, so feasible by construction; a seeded
    ``lcld_mlp(57)``."""
    base_paths = synth_lcld_schema(out_dir)
    base = LcldConstraints(base_paths["features"], base_paths["constraints"])
    x = synth_lcld(n_states, base.schema, seed=seed)
    rng = np.random.default_rng(seed)
    pool = [k for k in np.flatnonzero(base.schema.mutable) if k not in LCLD_IMPORTANT_FIXED]
    drawn = rng.choice(pool, LCLD_IMPORTANT_K - len(LCLD_IMPORTANT_FIXED), replace=False)
    top = np.array([*LCLD_IMPORTANT_FIXED, *drawn])
    important = np.column_stack([top, x[:, top].mean(0)])
    paths = write_augmented_schema(base_paths, augmentation.n_pairs(important), out_dir)
    np.save(os.path.join(out_dir, "important_features.npy"), important)
    cons = LcldAugmentedConstraints(paths["features"], paths["constraints"])
    x = augmentation.augment(torch.as_tensor(x), important).numpy()
    return _problem(cons, x, lcld_mlp(cons.schema.n_features, seed=model_seed))


#: rows of :func:`lcld_augmented_edge_rows` at the pair terms' edges
LCLD_AUGMENTED_EDGE_ROWS = 6


def straddling_preimages(target: float, k: int, scale, min_, dtype=np.float32):
    """``(below, at)``: consecutive scaled values of feature ``k`` in
    ``dtype`` whose unscalings ``(x - min_) / scale`` in ``dtype`` are the
    largest below ``dtype(target)`` and the smallest at or above it (equal
    to it where the unscaling reaches it)."""
    want, sc, mn = dtype(target), dtype(scale[k]), dtype(min_[k])
    unscale = lambda v: dtype(dtype(v - mn) / sc)  # noqa: E731
    at = dtype(want * sc + mn)
    step = dtype(np.inf) if sc > 0 else dtype(-np.inf)
    for _ in range(1024):
        below = np.nextafter(at, -step, dtype=dtype)
        if unscale(at) >= want and unscale(below) < want:
            return below, at
        at = np.nextafter(at, step if unscale(at) < want else -step, dtype=dtype)
    raise AssertionError(f"no {np.dtype(dtype).name} scaled values of feature {k} straddle {target}")


def lcld_augmented_edge_rows(x: np.ndarray, important_features, scaler=None, dtype=np.float32) -> np.ndarray:
    """Copies in ``dtype`` of the augmented LCLD rows ``x`` (unscaled, or
    scaled by ``scaler`` when given) whose first ``LCLD_AUGMENTED_EDGE_ROWS``
    rows hold the pair terms' edge cases: every important feature exactly at
    its threshold rounded to ``dtype`` and every one one ulp of ``dtype``
    below it (scaled: the two values whose unscalings straddle the
    threshold, the first equal to it where the unscaling reaches it), every
    important feature at NaN, and every augmented column at 0, at 1 and at
    0.5."""
    important = np.asarray(important_features)
    feats = important[:, 0].astype(int)
    thr = important[:, 1].astype(dtype)
    n_aug = x.shape[1] - N_BASE_FEATURES
    if scaler is None:
        out = np.array(x, dtype)
        for k, t in zip(feats, thr):
            out[0, k] = t
            out[1, k] = np.nextafter(t, dtype(-np.inf), dtype=dtype)
    else:
        out = np.asarray(scaler.transform(np.asarray(x, np.float64)), dtype)
        for k, t in zip(feats, thr):
            out[1, k], out[0, k] = straddling_preimages(t, k, scaler.scale, scaler.min_, dtype)
    out[2, feats] = np.nan
    for row, value in ((3, 0.0), (4, 1.0), (5, 0.5)):
        for j in range(N_BASE_FEATURES, N_BASE_FEATURES + n_aug):
            out[row, j] = value if scaler is None else scaled_preimage(value, j, scaler.scale, scaler.min_, dtype)
    return out


#: the feature that :func:`lcld_immutable_term_schema` marks immutable: term,
#: which LCLD's repair snaps to {36, 60}
LCLD_IMMUTABLE_FEATURE = 1
#: term values of :func:`lcld_immutable_repair_rows`, each off {36, 60} so
#: that the repair rewrites it: below the midpoint 48, at it, above it
LCLD_IMMUTABLE_TERMS = (45.0, 48.0, 50.0, 59.0)


def lcld_immutable_term_schema(paths: dict, out_dir: str) -> dict:
    """Copies in ``out_dir`` of the LCLD schema files of ``paths`` (base or
    augmented, with the important features beside them) whose term
    (feature 1) is immutable: a schema whose repair rewrites an immutable
    feature, so that a PGD run with repair keeps x there while the repaired
    row moves. No schema of the reference marks term so; this one tests
    that a kernel keeps ``pgd_run_plain``'s rule."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    with open(paths["features"], newline="") as f:
        reader = csv.DictReader(f)
        fields = list(reader.fieldnames)
        rows = [dict(r) for r in reader]
    rows[LCLD_IMMUTABLE_FEATURE]["mutable"] = "FALSE"
    out["features"] = os.path.join(out_dir, os.path.basename(paths["features"]))
    with open(out["features"], "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    out["constraints"] = os.path.join(out_dir, os.path.basename(paths["constraints"]))
    with open(paths["constraints"]) as src, open(out["constraints"], "w") as dst:
        dst.write(src.read())
    important = os.path.join(os.path.dirname(paths["features"]), "important_features.npy")
    if os.path.exists(important):
        np.save(os.path.join(out_dir, "important_features.npy"), np.load(important))
    return out


def lcld_immutable_repair_rows(x: np.ndarray, scaler=None, dtype=np.float32) -> np.ndarray:
    """Copies in ``dtype`` of the LCLD rows ``x`` (unscaled, or scaled by
    ``scaler`` when given) whose first ``len(LCLD_IMMUTABLE_TERMS)`` rows
    hold a term off {36, 60} (scaled: within an ulp of it after
    unscaling), so that the repair rewrites it."""
    out = np.array(x, np.float64)
    out[: len(LCLD_IMMUTABLE_TERMS), LCLD_IMMUTABLE_FEATURE] = LCLD_IMMUTABLE_TERMS
    return np.asarray(out if scaler is None else scaler.transform(out), dtype)


def synthetic_botnet_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[BotnetConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x): ``synth_botnet(n_states, seed)``
    rows, checked feasible, with the schema files written to ``out_dir``."""
    paths = synth_botnet_schema(out_dir)
    cons = BotnetConstraints(paths["features"], paths["constraints"])
    x = synth_botnet(n_states, cons.schema, seed=seed)
    return _problem(cons, x, botnet_mlp(cons.schema.n_features, seed=model_seed))


#: :func:`synthetic_botnet_augmented_problem`'s important features: the
#: reference's defense takes the 19 most important (``nb_important=19``), at
#: least ``BOTNET_IMPORTANT_GATHERED`` of them from the ratio terms' bytes and
#: packets sums, the rest from the other base features
BOTNET_IMPORTANT_K = 19
BOTNET_IMPORTANT_GATHERED = 4


def synthetic_botnet_augmented_problem(
    out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7
) -> tuple[BotnetAugmentedConstraints, Surrogate, MinMaxParams, np.ndarray]:
    """(constraints, surrogate, scaler, x) of botnet's augmented variant:
    k = 19 important features, distinct mutable base features drawn by
    ``np.random.default_rng(seed)`` (4 from the bytes and packets sums the
    ratio terms gather, 15 from the other base features), each with its
    mean over the ``synth_botnet(n_states, seed)`` rows as threshold (the
    JAX package's ``experiments/defense.py`` forms them so), written as
    ``important_features_19.npy`` beside the augmented schema files (and
    ``feat_idx.pickle``) in ``out_dir``; the rows augmented, so feasible by
    construction (checked); a seeded ``botnet_mlp(927)``."""
    base_paths = synth_botnet_schema(out_dir)
    base = BotnetConstraints(base_paths["features"], base_paths["constraints"])
    x = synth_botnet(n_states, base.schema, seed=seed)
    rng = np.random.default_rng(seed)
    segments = base.segments()
    gathered = np.unique(np.concatenate(segments[4:6]))
    mutable = np.flatnonzero(base.schema.mutable)
    first = rng.choice(np.intersect1d(gathered, mutable), BOTNET_IMPORTANT_GATHERED, replace=False)
    rest = rng.choice(np.setdiff1d(mutable, first), BOTNET_IMPORTANT_K - BOTNET_IMPORTANT_GATHERED, replace=False)
    top = np.concatenate([first, rest])
    important = np.column_stack([top, x[:, top].mean(0)])
    paths = write_augmented_schema(base_paths, augmentation.n_pairs(important), out_dir)
    np.save(os.path.join(out_dir, "important_features_19.npy"), important)
    cons = BotnetAugmentedConstraints(paths["features"], paths["constraints"])
    x = augmentation.augment(torch.as_tensor(x), important).numpy()
    return _problem(cons, x, botnet_mlp(cons.schema.n_features, seed=model_seed))


#: rows of :func:`botnet_augmented_edge_rows` at the pair terms' edges
BOTNET_AUGMENTED_EDGE_ROWS = 6


def botnet_augmented_edge_rows(x: np.ndarray, important_features, dtype=np.float32) -> np.ndarray:
    """Copies in ``dtype`` of the augmented botnet rows ``x`` (unscaled)
    whose first ``BOTNET_AUGMENTED_EDGE_ROWS`` rows hold the pair terms'
    edge cases: every important feature exactly at its threshold rounded to
    ``dtype``, every one one ulp of ``dtype`` below it, every one at NaN,
    and every augmented column at 0, at 1 and at 0.5. The base terms' edge
    cases are :func:`botnet_hard_candidates`', which leaves every ninth
    candidate from the first alone for these rows."""
    important = np.asarray(important_features)
    feats = important[:, 0].astype(int)
    thr = important[:, 1].astype(dtype)
    out = np.array(x, dtype)
    for k, t in zip(feats, thr):
        out[0, k] = t
        out[1, k] = np.nextafter(t, dtype(-np.inf), dtype=dtype)
    out[2, feats] = np.nan
    for row, value in ((3, 0.0), (4, 1.0), (5, 0.5)):
        out[row, BOTNET_BASE_FEATURES:] = value
    return out


def botnet_hard_candidates(codec, names, x_gen: torch.Tensor) -> torch.Tensor:
    """``x_gen`` (S, N, L) botnet candidates with, on every ninth row from
    row 1 to 8, a case the main path makes rarely: a port with bytes and 0
    packets (the ratio's 0 sentinel), -0.0 packets, NaN packets (a NaN ratio,
    which counts 0), an infinite protocol sum (an infinite term), inf - inf
    in a flow equality (a NaN term), bytes of exactly 1500 per packet (a
    ratio term of 0), an ordering at -inf, and 0 bytes with 0 packets. The
    features are named as ``synth_botnet_schema`` names them, and must be
    mutable."""
    gene = {int(d): i for i, d in enumerate(codec.non_ohe_ml_idx)}
    col = {name: gene[k] for k, name in enumerate(names) if k in gene}
    x = x_gen.clone()
    x[:, 1::9, col["pkts_out_sum_s_p0"]] = 0.0
    x[:, 2::9, col["pkts_out_sum_d_p1"]] = -0.0
    x[:, 3::9, col["pkts_out_sum_s_p2"]] = torch.nan
    x[:, 4::9, col["icmp_sum_s_p0"]] = torch.inf
    x[:, 5::9, col["udp_sum_d_p0"]] = torch.inf
    x[:, 5::9, col["bytes_in_sum_d_p0"]] = torch.inf
    x[:, 6::9, col["bytes_out_sum_s_p3"]] = 1500.0 * x[:, 6::9, col["pkts_out_sum_s_p3"]]
    x[:, 7::9, col["duration_min_d_p5"]] = -torch.inf
    x[:, 8::9, col["bytes_out_sum_d_p4"]] = 0.0
    x[:, 8::9, col["pkts_out_sum_d_p4"]] = 0.0
    return x


def synthetic_botnet_pgd_problem(out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7):
    """(constraints, surrogate, scaler, x, x_scaled, y): the rows of
    :func:`synthetic_botnet_problem`, scaled, and labels from the surrogate,
    its own classes of the scaled rows in float32, as ``experiments/pgd.py``
    takes them (ART infers labels when none are given)."""
    cons, sur, scaler, x = synthetic_botnet_problem(out_dir, n_states, seed, model_seed)
    xs = scaler.transform(x)
    with torch.inference_mode():
        y = sur.predict_proba(torch.as_tensor(xs, dtype=torch.float32)).argmax(-1).numpy()
    return cons, sur, scaler, x, xs, y


def scaled_preimage(target: float, k: int, scale, min_, dtype=np.float32):
    """A scaled value of feature ``k`` in ``dtype`` whose unscaling ``(x -
    min_) / scale`` in ``dtype`` is exactly ``dtype(target)``."""
    want, sc, mn = dtype(target), dtype(scale[k]), dtype(min_[k])
    x0 = dtype(want * sc + mn)
    up = down = x0
    for c in [x0] + [None] * 512:
        if c is None:
            up = np.nextafter(up, dtype(np.inf), dtype=dtype)
            down = np.nextafter(down, dtype(-np.inf), dtype=dtype)
            cands = (up, down)
        else:
            cands = (c,)
        for v in cands:
            if dtype(dtype(v - mn) / sc) == want:
                return v
    raise AssertionError(f"no {np.dtype(dtype).name} scaled value of feature {k} unscales to {target}")


#: rows of :func:`botnet_edge_starts` at the terms' edges
BOTNET_EDGE_ROWS = 12


def botnet_edge_starts(names, scaler, xs: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Copies in ``dtype`` of the scaled botnet rows ``xs`` whose first
    ``BOTNET_EDGE_ROWS`` rows hold the terms' edge cases, each unscaled
    value exact in ``dtype``: packets of 0 with bytes (the ratio's 0
    sentinel), NaN packets, an infinite protocol sum, inf - inf in a flow
    equality, an ordering exactly at the tolerance, a flow equality at
    exactly +0 inside its abs and one exactly at the tolerance, bytes of
    exactly 1500 per packet, 0 bytes with 0 packets, and features at the clip
    bounds (a row rounded to {0, 1}, a row of 0s, a row of 1s). The features
    are named as ``synth_botnet_schema`` names them."""
    col = {name: k for k, name in enumerate(names)}
    st = np.array(xs, dtype)

    def put(row, name, value):
        k = col[name]
        st[row, k] = value if not np.isfinite(value) else scaled_preimage(value, k, scaler.scale, scaler.min_, dtype)

    put(0, "pkts_out_sum_s_p0", 0.0)
    put(1, "pkts_out_sum_d_p1", np.nan)
    put(2, "icmp_sum_s_p0", np.inf)
    put(3, "udp_sum_d_p0", np.inf)
    put(3, "bytes_in_sum_d_p0", np.inf)
    put(4, "duration_sum_s_p2", 0.0)  # min <= sum, min at exactly the tolerance
    put(4, "duration_min_s_p2", 1e-3)
    flows_s = [n for n in names if n.split("_p")[0] in ("icmp_sum_s", "udp_sum_s", "tcp_sum_s", "bytes_in_sum_s",
                                                           "bytes_out_sum_s")]
    for row in (5, 6):
        for name in flows_s:
            put(row, name, 0.0)
    put(6, "tcp_sum_s_p7", 1e-3)  # |Σ flows - Σ bytes| exactly at the tolerance
    put(7, "pkts_out_sum_s_p3", 2.0)
    put(7, "bytes_out_sum_s_p3", 3000.0)
    put(8, "pkts_out_sum_d_p4", 0.0)
    put(8, "bytes_out_sum_d_p4", 0.0)
    st[9] = np.round(st[9])
    st[10], st[11] = 0.0, 1.0
    return st


# -- domains compiled from a constraint spec --------------------------------------


def synthetic_lcld_spec_problem(out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7):
    """:func:`synthetic_lcld_problem` with the ``lcld_spec`` domain (LCLD's
    spec, ``domains/specs/lcld.yaml``) over the same schema files, rows,
    surrogate and scaler."""
    _, sur, scaler, x = synthetic_lcld_problem(out_dir, n_states, seed, model_seed)
    paths = synth_lcld_schema(out_dir)
    cons = get_constraints_class("lcld_spec")(paths["features"], paths["constraints"])
    cons.check_constraints_error(x)
    return cons, sur, scaler, x


def synthetic_botnet_spec_problem(out_dir: str, n_states: int, seed: int = 42, model_seed: int = 7):
    """:func:`synthetic_botnet_problem` with the ``botnet_spec`` domain
    (``domains/specs/botnet.yaml``, its groups read from the schema's
    ``feat_idx.pickle``) over the same files, rows, surrogate and scaler."""
    _, sur, scaler, x = synthetic_botnet_problem(out_dir, n_states, seed, model_seed)
    paths = synth_botnet_schema(out_dir)
    cons = get_constraints_class("botnet_spec")(paths["features"], paths["constraints"])
    cons.check_constraints_error(x)
    return cons, sur, scaler, x


def synthetic_family_problem(out_dir: str, family: int, n_states: int, model_seed: int = 7):
    """(constraints, surrogate, scaler, x) of the seeded ``family<family>``
    domain: its schema and spec written to ``out_dir``
    (``domains.ir.write_family``), ``sample_family(n_states, family)``'s
    feasible rows and a seeded LCLD-topology surrogate over its features."""
    write_family(out_dir, family)
    cons = get_constraints_class(f"family{family}")(os.path.join(out_dir, "features.csv"),
                                                    os.path.join(out_dir, "constraints.csv"))
    x, _, _ = sample_family(n_states, family)
    return _problem(cons, x, lcld_mlp(cons.schema.n_features, seed=model_seed))


#: the surrogate of the phishing domain's oracle rates
#: (``tests/fixtures/oracle_interior_rates.json``): the JAX package's
#: ``init_params(lcld_mlp(), 14, seed=1)`` in float64, written by its
#: ``save_params`` (``tests/test_torch_spec_engine.py`` holds the file equal
#: to what that call writes)
PHISHING_SURROGATE = os.path.join(os.path.dirname(__file__), "fixtures", "phishing_oracle_mlp.msgpack")


def phishing_problem(cfg: dict):
    """(constraints, surrogate, scaler, x) of the phishing domain at the
    fixture's config ``cfg`` (its ``domains.phishing.config``), as
    ``tools/oracle_check.py::build_phishing`` builds them: the committed
    spec domain, ``synth_phishing(pool, pool_seed)`` rows, a scaler over the
    rows and the bounds, and ``n_states`` rows spread over those the float64
    surrogate puts in class 1 at ``thresholds.f1``, most likely first."""
    d = spec_domain_dir("phishing")
    cons = get_constraints_class("phishing")(os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv"))
    sur = load_params(PHISHING_SURROGATE, dtype=torch.float64)
    pool = synth_phishing(cfg["pool"], cons.schema, seed=cfg["pool_seed"])
    xl, xu = (np.broadcast_to(np.asarray(a, float), pool.shape) for a in cons.get_feature_min_max(pool))
    scaler = fit_minmax(np.minimum(pool.min(0), xl.min(0)), np.maximum(pool.max(0), xu.max(0)))
    with torch.no_grad():
        p1 = sur.predict_proba(torch.as_tensor(scaler.transform(pool)))[:, 1].numpy()
    cand = np.where(p1 >= cfg["thresholds"]["f1"])[0]
    cand = cand[np.argsort(-p1[cand])]
    sel = cand[np.linspace(0, len(cand) - 1, cfg["n_states"]).astype(int)]
    return cons, sur, scaler, pool[sel]


def spec_edge_rows(cons, x: np.ndarray) -> np.ndarray:
    """Copies of the rows ``x`` of a spec domain with its operators' edge
    cases: each division's, ``safe_div``'s and ``finite_div``'s denominator
    at 0, -0.0, NaN, +inf and -inf (where the denominator is a feature);
    each membership's values met exactly; ±0 in every feature; every
    feature at its lower and at its upper bound. One edge per row, cycling
    through ``x``'s rows."""
    from .domains.ir import expr as E

    env = cons.resolved.env
    edges = []
    for c in cons.resolved.spec.constraints:
        nodes = list(E.walk(c.lhs)) + ([] if c.kind == "member" else list(E.walk(c.rhs)))
        for node in nodes:
            den = None
            if isinstance(node, E.Bin) and node.op == "/":
                den = node.rhs
            elif isinstance(node, E.Call) and node.fn in ("safe_div", "finite_div"):
                den = node.args[1]
            if isinstance(den, E.Feat):
                cols = [env.col(den.name)]
            elif isinstance(den, E.Group):
                cols = [int(k) for k in env.group(den.name)[:3]]
            else:
                continue
            edges += [(k, v) for k in cols for v in (0.0, -0.0, np.nan, np.inf, -np.inf)]
        if c.kind == "member" and isinstance(c.lhs, E.Feat):
            edges += [(env.col(c.lhs.name), v) for v in c.rhs]
    xl, xu = (np.broadcast_to(np.asarray(a, float), x.shape) for a in cons.get_feature_min_max(x))
    n = cons.schema.n_features
    edges += [(k, v) for k in range(n) for v in (0.0, -0.0)]
    rows = []
    for i, (k, v) in enumerate(edges):
        r = x[i % len(x)].copy()
        r[k] = v
        rows.append(r)
    for i in range(n):
        for bound in (xl, xu):
            r = x[i % len(x)].copy()
            r[i] = bound[i % len(x), i]
            rows.append(r)
    return np.asarray(rows)



def spec_candidates(codec, cons, x: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """(S, n, L) float64 genetic candidates of the states ``x`` (S, D) of a
    spec domain: the genes of its edge rows (:func:`spec_edge_rows`) and of
    the states scaled by 1 + 0.05 N, dealt out to the states in turn.
    ``codec`` is the engine's codec on the CPU; an immutable feature's edge
    does not reach a candidate (it is decoded from its state)."""
    from .core.codec import ml_to_genetic

    rng = np.random.default_rng(seed)
    pert = np.repeat(x, -(-n // 2), axis=0) * (1.0 + 0.05 * rng.standard_normal((len(x) * -(-n // 2), x.shape[1])))
    rows = np.concatenate([spec_edge_rows(cons, x), pert])
    genes = ml_to_genetic(codec, torch.as_tensor(rows, dtype=torch.float64)).numpy()
    s = len(x)
    return genes[np.arange(s * n) % len(genes)].reshape(s, n, -1)

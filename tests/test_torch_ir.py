"""Port parity of the constraint IR (``domains/ir/``): parser, canonical form
and spec hash, the copied spec files, each operator's evaluation, the
compiled domains' terms against JAX's and against the port's hand-written
twins, kernel K9's program against the AST evaluation, the repair, the
family generator and the registry.

Tolerances: float64 terms equal JAX's bit for bit, but for the terms that
read a group sum, which JAX reduces in its own order and the port left to
right (within 1e-12 of the term's summed operand magnitudes); float32 terms
within 1e-5 of those magnitudes of JAX's float32 ones (the float32 bound of
``tests/test_torch_botnet.py``: XLA's float32 ``pow`` and its reduction
order differ from the port's float64 ``pow`` rounded once and its
left-to-right sums), with NaN at the same places."""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu import domains as jdomains
from moeva2_ijcai22_replication_tpu.domains import ir as jir
from moeva2_ijcai22_replication_tpu.domains import synth as jsynth
from moeva2_ijcai22_replication_tpu.domains.ir.expr import canon_constraint as j_canon
from moeva2_ijcai22_replication_tpu.domains.ir.repair_backend import compile_repair as j_compile_repair
from moeva2_ijcai22_replication_tpu.core.codec import full_ohe_tables as j_full_ohe_tables
from moeva2_ijcai22_replication_tpu_torch import domains
from moeva2_ijcai22_replication_tpu_torch.domains import ir
from moeva2_ijcai22_replication_tpu_torch.domains import synth
from moeva2_ijcai22_replication_tpu_torch.domains.botnet import BotnetConstraints
from moeva2_ijcai22_replication_tpu_torch.domains.ir import expr as E
from moeva2_ijcai22_replication_tpu_torch.domains.ir import program as P
from moeva2_ijcai22_replication_tpu_torch.domains.lcld import LcldConstraints
from moeva2_ijcai22_replication_tpu_torch.problems import spec_edge_rows

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_FILES = ("lcld.yaml", "botnet.yaml", "phishing/constraints.csv", "phishing/features.csv")
COMPILED = ("lcld_spec", "botnet_spec", "phishing", "family7")


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    """Schema files of each compiled domain: (features, constraints) paths."""
    out = {}
    d = str(tmp_path_factory.mktemp("lcld"))
    p = synth.synth_lcld_schema(d)
    out["lcld_spec"] = out["lcld"] = (p["features"], p["constraints"])
    d = str(tmp_path_factory.mktemp("botnet"))
    p = synth.synth_botnet_schema(d)
    out["botnet_spec"] = out["botnet"] = (p["features"], p["constraints"])
    d = domains.spec_domain_dir("phishing")
    out["phishing"] = (os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv"))
    d = str(tmp_path_factory.mktemp("family7"))
    ir.write_family(d, 7)
    out["family7"] = (os.path.join(d, "features.csv"), os.path.join(d, "constraints.csv"))
    return out


def _pair(name, schemas):
    feats, cons = schemas[name]
    return jdomains.get_constraints_class(name)(feats, cons), domains.get_constraints_class(name)(feats, cons)


def _rows(name, cons, seed=3):
    """Feasible rows of the domain, the same rows perturbed, and the spec
    operators' edge rows (0, -0.0, NaN and ±inf denominators, membership
    values met, ±0 everywhere, features at their bounds)."""
    if name == "lcld_spec":
        x = synth.synth_lcld(12, cons.schema, seed=seed)
    elif name == "botnet_spec":
        x = synth.synth_botnet(6, cons.schema, seed=seed)
    elif name == "phishing":
        x = synth.synth_phishing(12, cons.schema, seed=seed)
    else:
        x, _, _ = ir.sample_family(12, int(name[len("family"):]))
    rng = np.random.default_rng(seed)
    pert = x * (1.0 + 0.05 * rng.standard_normal(x.shape))
    return np.concatenate([x, pert, spec_edge_rows(cons, pert)])


def _term_meta(cons, x):
    """Per term: the summed magnitudes of the features its instructions
    read (the scale its rounding errors grow with), and whether its
    constraint reads a group sum."""
    scale, feats = [], []
    for op, _, a, b in P.decode(cons.program.code):
        if op == P.TERM:
            cols = sorted(set(feats))
            scale.append(np.abs(np.where(np.isfinite(x[:, cols]), x[:, cols], 0.0)).sum(-1))
            feats = []
            continue
        feats += [v for k, v in (a, b) if k == P.FEAT]
    sums = []
    for c, width in zip(cons.resolved.spec.constraints, cons.resolved.widths):
        nodes = list(E.walk(c.lhs)) + ([] if c.kind == "member" else list(E.walk(c.rhs)))
        sums += [any(isinstance(n, E.Call) and n.fn == "sum" for n in nodes)] * width
    return np.stack(scale, -1), np.asarray(sums)


def _assert_terms(got, want, scale, sums, rel):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    diff = np.abs(np.where(fin, got, 0.0) - np.where(fin, want, 0.0))
    assert (diff <= rel * scale).all(), f"max excess {np.max(diff - rel * scale)}"
    return diff


# -- parser, canonical form, hash, files ---------------------------------------------


@pytest.mark.parametrize("rel", SPEC_FILES)
def test_spec_files_are_byte_copies(rel):
    with open(os.path.join(jdomains.SPEC_DIR, rel), "rb") as f:
        want = f.read()
    with open(os.path.join(domains.SPEC_DIR, rel), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", ["lcld_spec", "botnet_spec", "phishing"] + [f"family{k}" for k in range(6)])
def test_parse_canon_and_hash_equal_jax(name):
    if name.startswith("family"):
        seed = int(name[len("family"):])
        jrows = jir.generate_family(seed)
        trows = ir.generate_family(seed)
        assert trows[0] == jrows[0] and trows[1] == jrows[1] and trows[3] == jrows[3]
        jspec, tspec = jrows[2], trows[2]
    else:
        path = domains.SPEC_DOMAINS[name]
        jspec = jir.load_spec(os.path.join(jdomains.SPEC_DIR, path), name=name)
        tspec = ir.load_spec(os.path.join(domains.SPEC_DIR, path), name=name)
    assert tspec.canonical() == jspec.canonical()
    assert ir.spec_hash(tspec) == jir.spec_hash(jspec)
    for tc, jc in zip(tspec.constraints, jspec.constraints):
        text = E.canon_constraint(tc)
        assert text == j_canon(jc)
        # the canonical text is a fixed point of parse + canon
        assert E.canon_constraint(E.parse_constraint(tc.name, text)) == text


def _refusal(parse, text):
    try:
        parse("c", text)
    except ValueError as exc:
        return f"{type(exc).__name__}: {exc}"
    return None


def test_parser_refusals_match_jax():
    for text in ("a <= ", "foo(a) <= b", "abs(a, b) <= c", "a in {b}", "a <= b c", "a < b", "a ? b"):
        want = _refusal(jir.parse_constraint, text)
        assert want is not None and _refusal(ir.parse_constraint, text) == want


# -- operators ----------------------------------------------------------------------

#: one constraint per operator of the language, and the literal forms
OPERATORS = {
    "add": "a + b <= c", "sub": "a - b <= c", "mul": "a * b <= c", "div": "a / b <= c",
    "pow": "(1.0 + a / 1200.0) ^ b <= c", "pow_literal": "a ^ 2.0 <= c", "neg": "-a <= b",
    "abs": "abs(a - b) <= 0.5", "months": "c == months(d1) - months(d2)", "safe_div": "safe_div(a, b, -1.0) <= c",
    "finite_div": "finite_div(a, b, 0.0) == c", "sum": "sum(@g) == a", "group": "@g <= @h", "broadcast": "@g <= a",
    "member": "a in {1.0, 2.0, 3.0}", "literal_only": "1.0 <= 2.0", "fold": "2.0 * 3.1 + a <= b",
    "divide_by_fold": "a / (1.0 + 2.1) <= b", "literal_side": "0.099999 <= a - b", "literal_over_row": "3.3 / a <= b",
}
_OP_FEATURES = ("a", "b", "c", "d1", "d2", "g0", "g1", "g2", "h0", "h1", "h2")


@pytest.fixture(scope="module")
def op_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ops")
    with open(d / "features.csv", "w") as f:
        f.write("feature,type,mutable,min,max,augmentation\n")
        for n in _OP_FEATURES:
            f.write(f"{n},real,TRUE,0,10,FALSE\n")
    for op, text in OPERATORS.items():
        (d / f"{op}.yaml").write_text(
            f"name: {op}\ngroups:\n  g:\n    - {{features: [g0, g1, g2]}}\n  h:\n    - {{features: [h0, h1, h2]}}\n"
            f"constraints:\n  - name: {op}\n    expr: \"{text}\"\n")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, len(_OP_FEATURES))) * 3
    x[:, 3:5] = rng.integers(200001, 202012, (64, 2))
    # poles and NaN: 0, -0.0, NaN and ±inf denominators, 0 / 0, members met
    x[0, 1], x[1, 1], x[2, 1], x[3, 1], x[6, 1] = 0.0, np.nan, np.inf, -np.inf, -0.0
    x[4, :2], x[5, 0], x[7, 0] = 0.0, 2.0, np.nan
    x[8, 0], x[9, 5] = 1.0, np.nan
    return d, x


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_operator_matches_jax(op_dir, op):
    d, x = op_dir
    jcons = jir.compile_spec_path(str(d / f"{op}.yaml"))(str(d / "features.csv"))
    tcons = ir.compile_spec_path(str(d / f"{op}.yaml"))(str(d / "features.csv"))
    want = np.asarray(jcons._raw(jnp.asarray(x)))
    got = tcons._raw(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)  # float64: bit for bit (NaN at the same places)
    scale, sums = _term_meta(tcons, x)
    want32 = np.asarray(jcons._raw(jnp.asarray(x, dtype=jnp.float32))).astype(np.float64)
    got32 = tcons._raw(torch.as_tensor(x, dtype=torch.float32)).numpy().astype(np.float64)
    _assert_terms(got32, want32, np.maximum(scale, 1.0), sums, 1e-5)
    # K9's program: the AST's terms bit for bit
    x32 = torch.as_tensor(x, dtype=torch.float32)
    np.testing.assert_array_equal(P.run_program_plain(tcons.program, x32).numpy(), tcons._raw(x32).numpy())


# -- compiled domains ---------------------------------------------------------------


@pytest.mark.parametrize("name", COMPILED)
def test_raw_terms_match_jax(schemas, name):
    jcons, tcons = _pair(name, schemas)
    assert tcons.n_constraints == jcons.n_constraints
    x = _rows(name, tcons)
    scale, sums = _term_meta(tcons, x)
    want = np.asarray(jcons._raw(jnp.asarray(x)))
    got = tcons._raw(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got[..., ~sums], want[..., ~sums])
    _assert_terms(got, want, scale, sums, 1e-12)
    np.testing.assert_array_equal(tcons.raw_numpy(x), got)
    want32 = np.asarray(jcons._raw(jnp.asarray(x, dtype=jnp.float32))).astype(np.float64)
    got32 = tcons._raw(torch.as_tensor(x, dtype=torch.float32)).numpy().astype(np.float64)
    _assert_terms(got32, want32, np.maximum(scale, 1.0), sums, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lcld", "botnet"])
def test_spec_equals_handwritten_bit_for_bit(schemas, name, dtype):
    feats, cons_path = schemas[name]
    hand = (LcldConstraints if name == "lcld" else BotnetConstraints)(feats, cons_path)
    spec = domains.get_constraints_class(f"{name}_spec")(feats, cons_path)
    assert spec.n_constraints == hand.n_constraints
    x = _rows(f"{name}_spec", spec)
    if name == "lcld":
        # the ratio poles: month count, pub_rec and annual_inc at 0, and NaN
        x[:4, 22], x[4:8, 11], x[8:10, 6], x[10, 16] = 0.0, 0.0, 0.0, np.nan
    xt = torch.as_tensor(x, dtype=dtype)
    got, want = spec._raw(xt), hand._raw(xt)
    assert not bool(torch.isfinite(want).all())  # the poles show
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", COMPILED + tuple(f"family{k}" for k in range(6)))
def test_program_equals_ast_bit_for_bit(schemas, name, tmp_path):
    if name in schemas:
        feats, cons_path = schemas[name]
    else:
        ir.write_family(str(tmp_path), int(name[len("family"):]))
        feats, cons_path = str(tmp_path / "features.csv"), str(tmp_path / "constraints.csv")
    cons = domains.get_constraints_class(name)(feats, cons_path)
    x = torch.as_tensor(_rows(name, cons), dtype=torch.float32)
    got = P.run_program_plain(cons.program, x)
    np.testing.assert_array_equal(got.numpy(), cons._raw(x).numpy())
    assert cons.program.n_terms == cons.n_constraints and cons.program.n_slots <= P.SPEC_MAX_SLOTS


def test_program_limits_match_the_kernel_header_and_refuse(tmp_path):
    with open(os.path.join(REPO, "moeva2_ijcai22_replication_tpu_torch/kernels/csrc/kernels.h")) as f:
        header = dict(re.findall(r"constexpr int (kSpec\w+) = (\d+);", f.read()))
    assert {k: int(v) for k, v in header.items() if k != "kSpecMaxWidth"} == {
        "kSpecMaxInstructions": P.SPEC_MAX_INSTRUCTIONS, "kSpecMaxSlots": P.SPEC_MAX_SLOTS,
        "kSpecMaxTerms": P.SPEC_MAX_TERMS, "kSpecMaxFeatures": P.SPEC_MAX_FEATURES,
        "kSpecVjpMaxInstructions": P.SPEC_VJP_MAX_INSTRUCTIONS, "kSpecVjpMaxSlots": P.SPEC_VJP_MAX_SLOTS}
    with open(tmp_path / "features.csv", "w") as f:
        f.write("feature,type,mutable,min,max,augmentation\n")
        for n in "abc":
            f.write(f"{n},real,TRUE,0,10,FALSE\n")
    with open(tmp_path / "long.yaml", "w") as f:
        f.write("name: long\nconstraints:\n")
        for i in range(700):  # 3 instructions each: ADD, SUB, TERM
            f.write(f"  - name: c{i}\n    expr: \"a + b <= c\"\n")
    cls = ir.compile_spec_path(str(tmp_path / "long.yaml"))
    with pytest.raises(ir.SpecError, match="2100 instructions.*kSpecMaxInstructions = 2048"):
        cls(str(tmp_path / "features.csv"))


# -- repair, generator, registry ----------------------------------------------------


@pytest.mark.parametrize("name", ["lcld_spec", "phishing", "family3"])
def test_repair_matches_jax(schemas, name, tmp_path):
    if name == "family3":
        ir.write_family(str(tmp_path), 3)
        feats, cons_path = str(tmp_path / "features.csv"), str(tmp_path / "constraints.csv")
        jcons = jdomains.get_constraints_class(name)(feats, cons_path)
        tcons = domains.get_constraints_class(name)(feats, cons_path)
    else:
        jcons, tcons = _pair(name, schemas)
    rng = np.random.default_rng(4)
    x = _rows(name, tcons)[:24]
    x = x * (1.0 + 0.3 * rng.standard_normal(x.shape))
    j_repair = j_compile_repair(jcons.resolved, jcons.schema, *j_full_ohe_tables(jcons.schema))
    want = np.asarray(j_repair(jnp.asarray(x)))
    got = tcons.repair(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the repaired rows satisfy the defining equalities the repair re-derives
    assert got.shape == x.shape


@pytest.mark.parametrize("seed", range(6))
def test_family_generator_and_sampler_match_jax(seed, tmp_path):
    jrows, trows = jir.generate_family(seed), ir.generate_family(seed)
    assert (trows[0], trows[1], trows[3]) == (jrows[0], jrows[1], jrows[3])
    jx, jschema, jspec = jir.sample_family(40, seed)
    tx, tschema, tspec = ir.sample_family(40, seed)
    np.testing.assert_array_equal(tx, np.asarray(jx))
    assert tschema.names == jschema.names and ir.spec_hash(tspec) == jir.spec_hash(jspec)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jir.write_family(str(jdir), seed)
    ir.write_family(str(tdir), seed)
    for f in ("features.csv", "constraints.csv"):
        assert (tdir / f).read_bytes() == (jdir / f).read_bytes()
    cons = domains.get_constraints_class(f"family{seed}")(str(tdir / "features.csv"), str(tdir / "constraints.csv"))
    cons.check_constraints_error(tx)


def test_registry_names_and_origins():
    assert domains.SPEC_DOMAINS == jdomains.SPEC_DOMAINS
    for name in ("lcld", "botnet", "lcld_augmented", "botnet_augmented", "lcld_spec", "botnet_spec", "phishing",
                 "family0", "family21"):
        assert domains.domain_origin(name) == jdomains.domain_origin(name), name
    assert issubclass(domains.get_constraints_class("phishing"), ir.SpecConstraintSet)
    assert domains.get_constraints_class("family21").origin == "generated"
    # the message lists the names registered so far: the same in both
    for name in set(domains.CONSTRAINTS_REGISTRY) | set(jdomains.CONSTRAINTS_REGISTRY):
        domains.get_constraints_class(name), jdomains.get_constraints_class(name)
    with pytest.raises(ValueError) as got:
        domains.get_constraints_class("nope")
    with pytest.raises(ValueError) as want:
        jdomains.get_constraints_class("nope")
    assert str(got.value) == str(want.value)


def test_ledger_tag_and_validation(schemas):
    for name in ("lcld_spec", "botnet_spec", "phishing"):
        jcons, tcons = _pair(name, schemas)
        assert tcons.ledger_tag == jcons.ledger_tag == f"spec:{tcons.spec.name}:{tcons.resolved.hash[:12]}"
        assert ir.validate_spec(tcons.spec, tcons.schema) == jir.validate_spec(jcons.spec, jcons.schema)
        assert tcons.objective_kernel == "spec" and tcons.pgd_kernel == "spec"
        assert not hasattr(tcons, "no_pgd_kernel") and not hasattr(tcons, "no_smooth_vjp")


def test_months_single_source():
    assert synth.months is ir.months
    d = np.array([201203.0, 198001.0, 201812.0])
    np.testing.assert_array_equal(ir.months(d), jir.months(d))
    np.testing.assert_array_equal(ir.months(torch.as_tensor(d)).numpy(), np.asarray(jir.months(jnp.asarray(d))))
    x = jsynth.synth_phishing(8, domains.get_constraints_class("phishing")(
        *(os.path.join(domains.spec_domain_dir("phishing"), f) for f in ("features.csv", "constraints.csv"))).schema,
        seed=5)
    np.testing.assert_array_equal(synth.synth_phishing(8, jdomains.get_constraints_class("phishing")(
        *(os.path.join(jdomains.spec_domain_dir("phishing"), f) for f in ("features.csv", "constraints.csv"))).schema,
        seed=5), x)

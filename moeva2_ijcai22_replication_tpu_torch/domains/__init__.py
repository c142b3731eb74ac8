"""Tabular domains of the port and their registry.

Port of ``domains/__init__.py``'s :func:`get_constraints_class`: a project
name resolves to its constraint class, from three origins:

- ``handwritten``: ``lcld``, ``lcld_augmented``, ``botnet`` and
  ``botnet_augmented``;
- ``spec``: domains compiled from the constraint IR (:mod:`.ir`), the
  committed re-expressions ``lcld_spec`` and ``botnet_spec`` (bit for bit
  equal to their hand-written twins) and ``phishing``, which exists only as
  a spec; their files are the port's own copies under ``domains/specs/``;
- ``generated``: seeded synthetic families, ``family<seed>``, compiled on
  first lookup from :func:`.ir.generate_family`.

:func:`domain_origin` reports ``{origin, spec_hash}`` per registered name.
"""

from __future__ import annotations

import os
import re

from .botnet import BotnetAugmentedConstraints, BotnetConstraints
from .ir import compile_spec, generate_family, load_spec, spec_hash
from .lcld import LcldAugmentedConstraints, LcldConstraints

SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")

CONSTRAINTS_REGISTRY = {
    "lcld": LcldConstraints,
    "lcld_augmented": LcldAugmentedConstraints,
    "botnet": BotnetConstraints,
    "botnet_augmented": BotnetAugmentedConstraints,
}

#: committed spec-front domains: registry name -> spec file under SPEC_DIR
SPEC_DOMAINS = {
    "lcld_spec": "lcld.yaml",
    "botnet_spec": "botnet.yaml",
    "phishing": os.path.join("phishing", "constraints.csv"),
}

_GENERATED_RE = re.compile(r"family(\d+)$")


def spec_domain_dir(project_name: str) -> str:
    """Directory of a committed spec domain's package data (where a
    data-only domain like phishing keeps its ``features.csv`` and
    ``constraints.csv``)."""
    rel = SPEC_DOMAINS[project_name]
    return os.path.dirname(os.path.join(SPEC_DIR, rel)) or SPEC_DIR


def register_spec_domain(name: str, spec_path: str) -> type:
    """Compile a spec file and register it under ``name`` (a new class, and
    so a new identity, at every call)."""
    cls = compile_spec(load_spec(spec_path, name=name))
    CONSTRAINTS_REGISTRY[name] = cls
    return cls


def get_constraints_class(project_name: str):
    try:
        return CONSTRAINTS_REGISTRY[project_name]
    except KeyError:
        pass
    if project_name in SPEC_DOMAINS:
        return register_spec_domain(project_name, os.path.join(SPEC_DIR, SPEC_DOMAINS[project_name]))
    m = _GENERATED_RE.fullmatch(project_name)
    if m:
        _, _, spec, _ = generate_family(int(m.group(1)))
        cls = compile_spec(spec)
        cls.origin = "generated"
        CONSTRAINTS_REGISTRY[project_name] = cls
        return cls
    raise ValueError(
        f"Unknown project {project_name!r}; known: "
        f"{sorted(set(CONSTRAINTS_REGISTRY) | set(SPEC_DOMAINS))} "
        "(plus generated family<seed> domains)"
    ) from None


def domain_origin(project_name: str) -> dict:
    """Provenance of a registered domain: ``{"origin": handwritten|spec|
    generated, "spec_hash": <sha256> | None}``."""
    cls = get_constraints_class(project_name)
    spec = getattr(cls, "spec", None)
    return {
        "origin": getattr(cls, "origin", "handwritten"),
        "spec_hash": spec_hash(spec) if spec is not None else None,
    }


__all__ = [
    "BotnetAugmentedConstraints",
    "BotnetConstraints",
    "CONSTRAINTS_REGISTRY",
    "LcldAugmentedConstraints",
    "LcldConstraints",
    "SPEC_DIR",
    "SPEC_DOMAINS",
    "domain_origin",
    "get_constraints_class",
    "register_spec_domain",
    "spec_domain_dir",
]

"""Tabular domains of the port and their registry.

Port of ``domains/__init__.py``'s :func:`get_constraints_class`: a project
name resolves to its constraint class. ``lcld``, ``lcld_augmented``,
``botnet`` and ``botnet_augmented`` are ported; the domains compiled from
the constraint IR (the ``lcld_spec`` and ``botnet_spec`` re-expressions,
``phishing`` and the seeded ``family<seed>`` domains) are refused with the
roadmap item that ports them.
"""

from __future__ import annotations

import re

from .botnet import BotnetAugmentedConstraints, BotnetConstraints
from .lcld import LcldAugmentedConstraints, LcldConstraints

CONSTRAINTS_REGISTRY = {
    "lcld": LcldConstraints,
    "lcld_augmented": LcldAugmentedConstraints,
    "botnet": BotnetConstraints,
    "botnet_augmented": BotnetAugmentedConstraints,
}

#: the JAX package's other registry names, each with the roadmap item that
#: ports it
_NOT_PORTED = {
    "lcld_spec": "the constraint IR (ROADMAP A11)",
    "botnet_spec": "the constraint IR (ROADMAP A11)",
    "phishing": "the constraint IR (ROADMAP A11)",
}
_GENERATED_RE = re.compile(r"family(\d+)$")


def get_constraints_class(project_name: str):
    try:
        return CONSTRAINTS_REGISTRY[project_name]
    except KeyError:
        pass
    if project_name in _NOT_PORTED or _GENERATED_RE.fullmatch(project_name):
        item = _NOT_PORTED.get(project_name, "the constraint IR (ROADMAP A11)")
        raise NotImplementedError(f"domain {project_name!r} is not ported yet: it comes with {item}")
    raise ValueError(
        f"Unknown project {project_name!r}; known: "
        f"{sorted(set(CONSTRAINTS_REGISTRY) | set(_NOT_PORTED))} "
        "(plus generated family<seed> domains)"
    ) from None


__all__ = [
    "BotnetAugmentedConstraints", "BotnetConstraints", "CONSTRAINTS_REGISTRY", "LcldAugmentedConstraints",
    "LcldConstraints",
    "get_constraints_class",
]

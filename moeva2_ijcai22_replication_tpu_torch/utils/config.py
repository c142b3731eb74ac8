"""Layered experiment configuration with hash identity.

Port of ``utils/config.py``: repeatable ``-c`` (YAML or JSON file), ``-j``
(inline JSON) and ``-p`` (dotted ``key.sub=value``) sources, deep-merged in
that order with replace semantics (later sources override; lists replace,
dicts recurse). :func:`get_dict_hash` is the md5 of the sorted-key JSON
dump, bit-identical to the JAX package's, so a config names the same
experiment, and the same output files, in both packages.

PyYAML is imported inside the functions that need it, as in the JAX
package: reading a ``.yaml`` file, typing a number-shaped ``-p`` value and
writing the config snapshot. ``-j`` and dict configs need no PyYAML.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re

_NUMBER_RE = re.compile(r"^[-+]?[0-9]*\.?[0-9]+(e[-+]?[0-9]+)?$")


def value_parser(value: str):
    """Scalar typing for ``-p`` values: number-shaped strings become int or
    float through YAML, all else stays str."""
    if _NUMBER_RE.match(value) is None:
        return str(value)
    import yaml

    return yaml.safe_load(f"v: {value}")["v"]


def merge_config(a: dict, b: dict) -> dict:
    """Deep-merge ``b`` into ``a`` in place: dicts recurse, any other value
    (lists included) is replaced."""
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            merge_config(a[k], v)
        else:
            a[k] = v
    return a


def dotted_to_dict(key: str, value) -> dict:
    """``a.b.c=v`` -> {"a": {"b": {"c": v}}}."""
    head, _, rest = key.partition(".")
    return {head: dotted_to_dict(rest, value)} if rest else {head: value}


def load_config_file(path: str) -> dict:
    ext = os.path.splitext(path)[1]
    with open(path) as f:
        if ext in (".yaml", ".yml"):
            import yaml

            return yaml.full_load(f)
        if ext == ".json":
            return json.load(f)
    raise ValueError(f"Unknown config extension {ext!r} for {path}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", action="append", help="config file (yaml or json)")
    parser.add_argument("-j", action="append", help="inline json")
    parser.add_argument("-p", action="append", help="dotted key.sub=value override")
    return parser


def _config_of(args) -> dict:
    config: dict = {}
    for path in args.c or []:
        merge_config(config, load_config_file(path))
    for blob in args.j or []:
        merge_config(config, json.loads(blob))
    for kv in args.p or []:
        key, _, raw = kv.partition("=")
        merge_config(config, dotted_to_dict(key, value_parser(raw)))
    return config


def parse_config(argv=None) -> dict:
    """A config dict from ``-c``/``-j``/``-p`` arguments: files, then inline
    JSON, then dotted overrides, each group in the order given."""
    return _config_of(_parser().parse_args(argv))


#: the ``--dtype`` names of the entry points' command lines
DTYPES = ("float32", "float64")


def parse_run_args(argv=None) -> tuple[dict, dict]:
    """``(config, run arguments)`` of an entry point's command line: the
    config as :func:`parse_config` builds it, and ``device`` (``--device``,
    default ``cuda``) and ``dtype`` (``--dtype``, default ``float32``, as a
    ``torch.dtype``). The device and dtype are arguments, never config
    keys, so the config hash stays the JAX package's."""
    import torch

    parser = _parser()
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: the card)")
    parser.add_argument("--dtype", default="float32", choices=DTYPES, help="the attack's float type")
    args = parser.parse_args(argv)
    return _config_of(args), {"device": args.device, "dtype": getattr(torch, args.dtype)}


def get_dict_hash(config: dict) -> str:
    """md5 of the sorted-key JSON dump, as the JAX package computes it."""
    return hashlib.md5(json.dumps(config, sort_keys=True).encode("utf-8")).hexdigest()


def save_config(config: dict, pre_path: str) -> str:
    """Snapshot the config beside its results as ``{pre_path}{hash}.yaml``,
    written by ``yaml.dump`` as the JAX package writes it."""
    import yaml

    path = f"{pre_path}{get_dict_hash(config)}.yaml"
    with open(path, "w") as f:
        yaml.dump(config, f)
    return path

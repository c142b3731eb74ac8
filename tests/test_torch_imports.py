"""The PyTorch port imports neither JAX nor the JAX package, and importing
it loads none of the host libraries the card's machine may lack (PyYAML,
msgpack, joblib, sklearn, pandas): those are imported only inside the
functions that read their formats."""

from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import moeva2_ijcai22_replication_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|moeva2_ijcai22_replication_tpu)\b", re.M
)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([PORT_DIR], prefix=port.__name__ + ".")
    )


def test_port_has_every_module_of_the_slice():
    mods = set(_port_modules())
    for name in (
        "core.schema", "core.codec", "core.norms", "core.constraints", "core.vjp",
        "domains.synth", "domains.lcld", "domains.botnet", "domains.augmentation", "models.scalers", "models.mlp",
        "models.io", "attacks.objective", "attacks.moeva.refdirs",
        "attacks.moeva.initialisation", "attacks.moeva.operators",
        "attacks.moeva.nds", "attacks.moeva.survival", "attacks.moeva.engine",
        "attacks.pgd", "attacks.pgd.engine", "attacks.pgd.autopgd", "kernels", "kernels.build", "problems",
        "utils.config", "utils.in_out", "utils.observability", "utils.streaming", "domains",
        "experiments.common", "experiments.moeva", "experiments.pgd", "attacks.sat",
        "attacks.sat.engine", "domains.lcld_sat", "domains.botnet_sat",
        "experiments.rq", "experiments.pipeline", "experiments.run_all",
        "attacks.moeva.checkpoint", "observability", "observability.quality",
        "domains.ir", "domains.ir.ops", "domains.ir.expr", "domains.ir.spec", "domains.ir.torch_backend",
        "domains.ir.repair_backend", "domains.ir.generator", "domains.ir.program", "domains.ir.vjp",
        "domains.ir.milp_backend", "models.train", "experiments.defense", "experiments.rq4",
        "experiments.preprocess", "core.philox", "attacks.moeva.chunk_io",
    ):
        assert f"{port.__name__}.{name}" in mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'moeva2_ijcai22_replication_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "host = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('yaml', 'msgpack', 'joblib', 'sklearn', 'pandas'))\n"
        "assert not host, host\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize(
    "path",
    sorted(
        os.path.relpath(os.path.join(d, f), REPO)
        for d, _, files in os.walk(PORT_DIR)
        for f in files
        if f.endswith(".py")
    )
    + ["chip_smoke.py", "tools/compare_botnet_base.py", "tools/compare_lcld_base.py",
       "tools/compare_pgd_botnet_base.py", "tools/compare_main_path.py", "tools/probe_stages.py"],
)
def test_no_jax_import_in_source(path):
    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    assert not FORBIDDEN.search(src), f"{path} imports JAX or the JAX package"

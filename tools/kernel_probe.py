"""The loop the kernel probes share (``tools/probe_objective_botnet.py``,
``tools/probe_pgd_botnet.py``): each compares designs of one of the port's
kernel sources side by side on one NVIDIA card, and keeps only its
``ProbeSpec``.

A variant is a ``csrc`` directory holding the kernel's source and the
headers it includes (the port's own, one unpacked from another commit, or
an edited copy). Every variant is compiled with ``nvcc`` into a small
library beside the port's ``bindings.cpp`` (the other kernels' launchers
stubbed), its SASS written to ``<out>/sass_<name>.txt``, driven through the
port's own wrapper, held bit for bit against the plain version (except a
variant named ``diag-...``: an ablation that drops work to see its cost,
run but not held), and timed in turns (all variants, twice) with CUDA
events around the replay of a CUDA graph. A variant whose source has the
spec's stamps hook (``<TAG>_STAMPS``) is built once more with it, and one
launch at each of the spec's stamp cases gives its breakdown: per phase
(the names the hook gives), the ``clock64()`` cycles block 0 sees per
stamped warp (warp 0's, their mean and their max), divided by the case's
units (the iterations of a run), and each stamped warp's. Prints one JSON
line per variant with its ptxas registers, stack and spill, and writes the
records to
``<out>/probe_<tag>.json`` (``--out DIR``, by default
``.torch_ext_build/probe``).
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: each kernel source's launchers as stubs, for a variant's library that
#: leaves that source out
STUBS = {
    "nd_peel.cu": "cudaError_t launch_nd_peel(const float*, const float*, int32_t*, int, int, int, int, "
                  "cudaStream_t) { return cudaErrorNotSupported; }",
    "associate.cu": "cudaError_t launch_associate(const float*, const float*, const float*, const float*, "
                    "const float*, int64_t*, float*, int, int, int, int, cudaStream_t) "
                    "{ return cudaErrorNotSupported; }",
    "offspring.cu": "cudaError_t launch_offspring(const float*, const float*, const float*, const int64_t*, "
                    "const int64_t*, const int64_t*, const float*, const float*, const float*, const int64_t*, "
                    "const int64_t*, const double*, const bool*, const int64_t*, float*, int, int, int, int, int, "
                    "float, double, double, cudaStream_t) { return cudaErrorNotSupported; }",
    "objective_lcld.cu": "cudaError_t launch_objective_lcld(const float*, const float*, const float*, const float*, "
                         "const float*, const int64_t*, const int32_t*, const int32_t*, const float*, const int*, "
                         "int, const float*, const float*, float, int, float, float*, int, int, int, int, "
                         "const int32_t*, const float*, int, cudaStream_t) { return cudaErrorNotSupported; }",
    "survive_norm.cu": "cudaError_t launch_survive_norm(const float*, const float*, const int32_t*, const float*, "
                       "const float*, const float*, const float*, float*, float*, float*, float*, float*, int, "
                       "int, int, int, cudaStream_t) { return cudaErrorNotSupported; }",
    "survive_fill.cu": "cudaError_t launch_survive_fill(const SurviveFillArgs&, cudaStream_t) "
                       "{ return cudaErrorNotSupported; }",
    "pgd_lcld.cu": "cudaError_t launch_pgd_lcld(const PgdArgs&, cudaStream_t) { return cudaErrorNotSupported; }",
    "objective_botnet.cu": "cudaError_t launch_objective_botnet(BotnetObjectiveArgs, cudaStream_t) "
                           "{ return cudaErrorNotSupported; }\n"
                           "int objective_botnet_max_features(int, int, int) { return 0; }",
    "pgd_botnet.cu": "cudaError_t launch_pgd_botnet(PgdBotnetArgs, cudaStream_t) { return cudaErrorNotSupported; }",
    "refdirs.cu": "cudaError_t launch_refdirs(const double*, const double*, double*, int, int, int, double, "
                  "const RefdirsAdam&, cudaStream_t) { return cudaErrorNotSupported; }",
    "restart.cu": "cudaError_t launch_restart(const RestartArgs&, cudaStream_t) { return cudaErrorNotSupported; }",
    "mlp_forward.cu": "cudaError_t launch_forward_labels(const float*, const float*, const ForwardShape&, int, "
                      "int64_t*, cudaStream_t) { return cudaErrorNotSupported; }\n"
                      "cudaError_t launch_forward_proba1(const double*, const double*, const ForwardShape&, int, "
                      "double*, cudaStream_t) { return cudaErrorNotSupported; }",
}


@dataclass(frozen=True)
class ProbeSpec:
    """One kernel's probe. ``tag`` names the records' file and the stamps
    hook: ``<TAG>_STAMPS`` in the source, and the ``<tag>_take_cycles``,
    ``<tag>_phase_names`` and ``<tag>_stamped_warps`` it exports."""

    tag: str
    #: the kernel's source, then the headers it includes
    files: tuple
    #: the prefix of the kernel's ptxas entry
    kernel: str
    #: case -> a zero-argument launch of the port's wrapper
    cases: dict
    #: holds the library in use against the plain version, raising on a
    #: difference; takes the variant's name for the message
    hold: Callable[[str], None]
    #: case -> the units its stamped cycles are divided by
    stamp_cases: dict
    #: ``chip_smoke.graph_ms``'s launches and repeats
    time_kw: dict = field(default_factory=dict)


def build_variant(name: str, csrc: Path, work: Path, files: tuple, kernel: str, flags: tuple = ()):
    """The variant's library, built from ``files`` of ``csrc`` (the first a
    kernel source, the rest its headers) with the other sources' launchers
    stubbed, its ptxas entry for ``kernel`` and its SASS."""
    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    src = work / name
    (src / "csrc").mkdir(parents=True)
    for f in files:
        shutil.copy(csrc / f, src / "csrc" / f)
    shutil.copy(build.PACKAGE_DIR / "bindings.cpp", src / "bindings.cpp")
    (src / "stubs.cu").write_text('#include "csrc/kernels.h"\n'
                                  + "\n".join(v for k, v in STUBS.items() if k != files[0]) + "\n")
    nvcc = build.nvcc_path()
    objs, log = [], []
    for f in (f"csrc/{files[0]}", "stubs.cu", "bindings.cpp"):
        obj = src / (Path(f).name + ".o")
        out = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-c", str(src / f), "-o", str(obj)],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{f}:\n{out.stdout}{out.stderr}")
        log.append(f"== {f}\n{out.stdout}{out.stderr}")
        objs.append(str(obj))
    lib = src / f"libprobe_{name}.so"
    out = subprocess.run([nvcc, "-shared", build.NVCC_FLAGS[0], *objs, "-o", str(lib)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"linking {name} failed:\n{out.stdout}{out.stderr}")
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", objs[0]], capture_output=True, text=True)
    entry = [k for k in cs.ptxas_resources("\n".join(log)) if k["kernel"].startswith(kernel)]
    return lib, entry[0] if entry else None, sass.stdout + sass.stderr


def use(lib: Path):
    """Route the port's wrappers to ``lib``; returns the loaded library."""
    from moeva2_ijcai22_replication_tpu_torch.kernels import build

    build.build = lambda: build.BuildInfo(lib, 0.0, "")
    build.library.cache_clear()
    return build.library()


def stamp_breakdown(spec: ProbeSpec, lib) -> dict:
    """Per stamp case and phase, block 0's cycles per unit: warp 0's, and
    the mean and max over the stamped warps."""
    import torch

    take = getattr(lib, f"{spec.tag}_take_cycles")
    take.argtypes = [ctypes.c_void_p]
    names = getattr(lib, f"{spec.tag}_phase_names")
    names.restype = ctypes.c_char_p
    phases = names().decode().split(";")
    warps = getattr(lib, f"{spec.tag}_stamped_warps")()
    cycles = (ctypes.c_ulonglong * (warps * len(phases)))()
    out = {}
    for case, units in spec.stamp_cases.items():
        for _ in range(2):  # the first launch warms up, its cycles are dropped
            take(cycles)
            spec.cases[case]()
            torch.cuda.synchronize()
        if take(cycles):
            raise RuntimeError(f"reading {spec.tag}'s stamps failed")
        per_warp = np.asarray(cycles, dtype=np.float64).reshape(warps, len(phases)) / units
        out[case] = {p: {"w0": float(per_warp[0, i]), "mean": float(per_warp[:, i].mean()),
                         "max": float(per_warp[:, i].max()), "each": per_warp[:, i].tolist()}
                     for i, p in enumerate(phases)}
    return out


def run(spec: ProbeSpec, variants: list, out_dir: Path) -> int:
    """Builds, holds, times and stamps every ``(name, csrc)`` variant."""
    records = {}
    out_dir.mkdir(parents=True, exist_ok=True)
    (ROOT / ".torch_ext_build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / ".torch_ext_build") as tmp:
        libs = {}
        for name, csrc in variants:
            libs[name], entry, sass = build_variant(name, Path(csrc), Path(tmp), spec.files, spec.kernel)
            (out_dir / f"sass_{name}.txt").write_text(sass)
            use(libs[name])
            if name.startswith("diag-"):
                for launch in spec.cases.values():
                    launch()
            else:
                spec.hold(name)
            records[name] = {"variant": name, "csrc": csrc, "ptxas": entry, "ms": {c: [] for c in spec.cases}}
        for _ in range(2):
            for name in libs:
                use(libs[name])
                for case, launch in spec.cases.items():
                    records[name]["ms"][case].append(cs.graph_ms(launch, **spec.time_kw))
        for name, csrc in variants:
            if f"{spec.tag.upper()}_STAMPS" not in (Path(csrc) / spec.files[0]).read_text():
                continue
            lib, _, _ = build_variant(name + "_stamps", Path(csrc), Path(tmp), spec.files, spec.kernel,
                                      (f"-D{spec.tag.upper()}_STAMPS",))
            records[name]["cycles_block0"] = stamp_breakdown(spec, use(lib))
    smi = cs.nvidia_smi_line()
    for rec in records.values():
        rec["card"] = smi
        print(json.dumps(rec))
    (out_dir / f"probe_{spec.tag}.json").write_text(json.dumps(list(records.values()), indent=1))
    return 0


def main(make_spec: Callable, doc: str) -> int:
    """``[--out DIR] name=csrc ...``: builds the spec on card 0 with
    ``make_spec(device)`` and runs it."""
    import torch

    if not torch.cuda.is_available():
        print("kernel probe: CUDA is not available", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    out_dir = ROOT / ".torch_ext_build" / "probe"
    if args[:1] == ["--out"]:
        out_dir, args = Path(args[1]), args[2:]
    variants = [a.split("=", 1) for a in args]
    if not variants:
        print(doc, file=sys.stderr)
        return 2
    return run(make_spec(torch.device("cuda", 0)), variants, out_dir)

#!/usr/bin/env python3
"""Time designs of the port's niche-association kernel (K3) side by side on
one NVIDIA card.

Each variant is a ``csrc`` directory holding ``associate.cu`` and
``kernels.h`` (the port's own, one unpacked from another commit, or an
edited copy). Every variant is compiled alone with ``nvcc`` into
a small library, held against ``associate_plain`` entry for entry at both
shapes, and timed in turns (all variants, twice) with CUDA events around
the replay of a CUDA graph of 20 launches, at (S, M, R) = (1000, 203, 103),
the main path's shape, and (1000, 303, 203), ``config/moeva.yaml``'s. The
inputs are ``chip_smoke.py``'s sweep objectives and directions. Prints one
JSON line per variant, with its ptxas registers and spill and the count of
``BSSY``/``BSYNC`` instructions in its SASS, and writes each variant's SASS
to ``<out>/sass_<name>.txt`` and the records to ``<out>/probe_k3.json``
(``--out DIR``, by default ``.torch_ext_build/probe``).

It also times two floors at each shape: an empty kernel on the new
launcher's grid at (1000, 203, .) (four states of 104 threads per block),
and a kernel that only reads f and writes niche and dist.

``--shapes SxMxR,...`` times other shapes besides (R = 3, the fewest the
sweep's directions take, leaves about the fixed costs: launch, staging,
loads and stores).

Run from the root of a checkout:

    python3 tools/probe_associate.py [--out DIR] [--shapes 1000x203x3,1000x203x403] \\
        change=moeva2_ijcai22_replication_tpu_torch/kernels/csrc \\
        parent=<unpacked parent>/moeva2_ijcai22_replication_tpu_torch/kernels/csrc
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (S, M, R): the main path's shape and config/moeva.yaml's
SHAPES = ((1000, 203, 103), (1000, 303, 203))
# besides the launcher, two floors at the same shapes: an empty kernel on
# K3's grid (launch and block scheduling), and one that only reads f and
# writes niche and dist, a thread per candidate (K3's bytes)
SHIM = r"""
#include "kernels.h"
__global__ void probe_empty_kernel() {}
__global__ void probe_copy_kernel(const float* f, int64_t* niche, float* dist, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    niche[i] = static_cast<int64_t>(f[3 * i]);
    dist[i] = f[3 * i + 1] + f[3 * i + 2];
  }
}
extern "C" int probe_floor(const void* f, void* niche, void* dist, int s, int m, int copy, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (copy) {
    probe_copy_kernel<<<(s * m + 255) / 256, 256, 0, st>>>(static_cast<const float*>(f), static_cast<int64_t*>(niche),
                                                           static_cast<float*>(dist), s * m);
  } else {
    probe_empty_kernel<<<(s + 3) / 4, 416, 0, st>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
extern "C" int probe_associate(const void* f, const void* dirs, const void* ideal, const void* nadir,
                               void* niche, void* dist, int s, int m, int r, void* stream) {
  return static_cast<int>(launch_associate(
      static_cast<const float*>(f), nullptr, static_cast<const float*>(dirs), static_cast<const float*>(ideal),
      static_cast<const float*>(nadir), static_cast<int64_t*>(niche), static_cast<float*>(dist), s, m, m, r,
      static_cast<cudaStream_t>(stream)));
}
"""


def build_variant(name: str, csrc: Path, out: Path):
    """Compile ``csrc/associate.cu`` into a library; return it loaded, its
    ptxas report and its SASS."""
    from moeva2_ijcai22_replication_tpu_torch.kernels.build import NVCC_FLAGS, nvcc_path

    nvcc = nvcc_path()
    shim = out / f"{name}_shim.cu"
    shim.write_text(SHIM)
    flags = [*NVCC_FLAGS, f"-I{csrc}"]
    obj, shim_obj, lib = out / f"{name}.o", out / f"{name}_shim.o", out / f"lib{name}.so"
    report = subprocess.run([nvcc, *flags, "-c", str(csrc / "associate.cu"), "-o", str(obj)],
                            capture_output=True, text=True)
    if report.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{report.stdout}{report.stderr}")
    subprocess.run([nvcc, *flags, "-c", str(shim), "-o", str(shim_obj)], check=True, capture_output=True)
    subprocess.run([nvcc, "-shared", NVCC_FLAGS[0], str(obj), str(shim_obj), "-o", str(lib)], check=True,
                   capture_output=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(obj)], capture_output=True,
                          text=True).stdout
    handle = ctypes.CDLL(str(lib))
    handle.probe_associate.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    handle.probe_associate.restype = ctypes.c_int
    handle.probe_floor.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    handle.probe_floor.restype = ctypes.c_int
    return handle, report.stdout + report.stderr, sass


def main(argv) -> int:
    import torch

    from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.survival import associate_plain

    if not torch.cuda.is_available():
        print("probe_associate: CUDA is not available", file=sys.stderr)
        return 1
    shapes, outdir = SHAPES, ROOT / ".torch_ext_build" / "probe"
    while argv and argv[0] in ("--shapes", "--out"):
        if argv[0] == "--shapes":
            shapes += tuple(tuple(map(int, x.split("x"))) for x in argv[1].split(","))
        else:
            outdir = Path(argv[1]).resolve()
        argv = argv[2:]
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    inputs = {}
    for s, m, r in shapes:
        f = torch.as_tensor(cs.sweep_objectives(rng, s, m), device=device)
        dirs = torch.as_tensor(cs.sweep_directions(rng, s, r), device=device)
        ideal, nadir = cs.finite_ideal_nadir(f)
        inputs[(s, m, r)] = (f, dirs, ideal, nadir, associate_plain(f, dirs, ideal, nadir))
    outdir.mkdir(parents=True, exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for spec in argv:
            name, _, csrc = spec.partition("=")
            lib, report, sass = build_variant(name, (ROOT / csrc).resolve(), Path(tmp))
            (outdir / f"sass_{name}.txt").write_text(sass)
            res = cs.ptxas_resources(f"== {name}\n{report}")
            results[name] = {"name": name, "csrc": csrc, "ptxas": [
                {k: e[k] for k in ("kernel", "registers", "stack", "spill_stores", "spill_loads")} for e in res],
                "bssy": sass.count("BSSY"), "bsync": sass.count("BSYNC"), "ms": {}}
            libs[name] = lib

        def call(lib, shape):
            f, dirs, ideal, nadir, _ = inputs[shape]
            s, m, r = shape
            niche = torch.empty((s, m), dtype=torch.int64, device=device)
            dist = torch.empty((s, m), dtype=torch.float32, device=device)
            err = lib.probe_associate(f.data_ptr(), dirs.data_ptr(), ideal.data_ptr(), nadir.data_ptr(),
                                      niche.data_ptr(), dist.data_ptr(), s, m, r,
                                      torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")
            return niche, dist

        for name, lib in libs.items():
            for shape in shapes:
                got = call(lib, shape)
                torch.cuda.synchronize()
                for what, g, w in zip(("niche", "dist"), got, inputs[shape][4]):
                    cs.hold_equal(g, w, f"{name} {what} at {shape}")
        def floor(lib, shape, copy):
            f = inputs[shape][0]
            niche = torch.empty(shape[:2], dtype=torch.int64, device=device)
            dist = torch.empty(shape[:2], dtype=torch.float32, device=device)
            err = lib.probe_floor(f.data_ptr(), niche.data_ptr(), dist.data_ptr(), shape[0], shape[1], copy,
                                  torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        any_lib = next(iter(libs.values()))
        floors = {name: {"x".join(map(str, shape)): cs.graph_ms(lambda: floor(any_lib, shape, copy))
                         for shape in shapes} for name, copy in (("empty", 0), ("copy", 1))}
        print(json.dumps({"floors_ms": floors}), flush=True)
        for _ in range(2):  # in turns, so that every variant sees the card's drift
            for name, lib in libs.items():
                for shape in shapes:
                    key = "x".join(map(str, shape))
                    results[name]["ms"].setdefault(key, []).append(cs.graph_ms(lambda: call(lib, shape)))
    smi = cs.nvidia_smi_line()
    for rec in results.values():
        rec["card"] = smi
        print(json.dumps(rec), flush=True)
    (outdir / "probe_k3.json").write_text(json.dumps(list(results.values()), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into `build/kernels/lib<name>-<hash>.so` at the repository root
(the hash covers the source, the shared `csrc/*.cuh` headers and the
flags, so an edited source or header rebuilds),
then loaded with `ctypes`. Nothing is built at import: the first call
that launches a kernel builds its library, and `build_all` builds every
source at once, one `nvcc` process per source, started together. A
library's build or load runs under the span `kernel.build`
(rebvo_tpu_torch.obs); the counters `kernel.built` and `kernel.cached`
count sources compiled by nvcc and libraries found up to date.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

from rebvo_tpu_torch import obs

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# --fmad=false: no a*b+c is fused into one rounding, so the kernels round
# like their plain PyTorch versions (see csrc/detect_candidates.cu).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

SOURCES = ("detect_candidates", "build_scale_space")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_all(names: List[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no up-to-date library, all
    `nvcc` processes running at once. Returns {name: {"seconds",
    "ptxas", "cached"}}; raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    info = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            obs.count("kernel.cached")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                      "cached": False}
        obs.count("kernel.built")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with obs.span("kernel.build"):
        build_all([name])
        return ctypes.CDLL(str(_lib_path(name)))

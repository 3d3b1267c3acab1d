"""Host build of the scale-space kernels K1 and K2 for the CPU tests.

`library()` compiles `tests/tile_host.cpp`, which includes both kernel
sources of `rebvo_tpu_torch/csrc` and their launchers, with g++ under
`tests/cuda_host_emu.h` into `build/host_emu/` at the repository root
(once per hash of the sources and flags), and loads it with ctypes.
`detect` and `sspace` run the kernels through the CUDA wrappers' own launch
path (`cuda_scale_space.detect_launch`, `sspace_launch`) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from rebvo_tpu_torch.kernels import cuda_scale_space as cs

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
CSRC = ROOT / "rebvo_tpu_torch" / "csrc"
BUILD_DIR = ROOT / "build" / "host_emu"
# -ffp-contract=off: no fused multiply-add, as the card's --fmad=false
FLAGS = ["-std=c++20", "-O2", "-ffp-contract=off", "-Wno-unknown-pragmas",
         "-shared", "-fPIC", "-pthread"]


def compiler():
    """The g++ the host build uses, or None."""
    return shutil.which("g++")


@functools.cache
def library() -> ctypes.CDLL:
    """The host build of both kernels, compiled first if needed."""
    srcs = [TESTS / "cuda_host_emu.h", TESTS / "tile_host.cpp",
            *sorted(CSRC.glob("*.cu*"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs) +
                            " ".join(FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libtile_host-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *FLAGS, "-include", str(TESTS / "cuda_host_emu.h"),
               "-I", str(CSRC), "-o", str(tmp), str(TESTS / "tile_host.cpp")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.detect_candidates_launch.argtypes = cs.K1_ARGTYPES
    lib.build_scale_space_launch.argtypes = cs.K2_ARGTYPES
    for fn in (lib.detect_candidates_launch, lib.build_scale_space_launch,
               lib.tile_reciprocals, lib.tile_table_shape):
        fn.restype = ctypes.c_int
    return lib


def detect(img, grad_thresh, **kw):
    """K1's host build on a CPU `img`, as `detect_candidates_cuda`."""
    return cs.detect_launch(library().detect_candidates_launch, img,
                            grad_thresh, None, **kw)


def sspace(img, sigma0, k_sigma):
    """K2's host build on a CPU `img`, as `build_scale_space_cuda`."""
    return cs.sspace_launch(library().build_scale_space_launch, img, None,
                            sigma0, k_sigma)

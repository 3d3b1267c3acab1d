"""Host build of the CUDA kernels K1 to K5 for the CPU tests.

`library()` compiles `tests/tile_host.cpp`, which includes the kernel
sources of `rebvo_tpu_torch/csrc` and their launchers, with g++ under
`tests/cuda_host_emu.h` into `build/host_emu/` at the repository root
(once per hash of the sources and flags), and loads it with ctypes.
`detect`, `sspace`, `pose`, `kf`, `md_match` and `md_depth` run the
kernels through the CUDA wrappers' own launch paths
(`cuda_scale_space.detect_launch`, `sspace_launch`,
`pose_solver.pose_launch`, `kf_tracking.kf_launch`,
`match_depth.match_launch`, `depth_launch`) on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from rebvo_tpu_torch.frontend import kf_tracking as kft
from rebvo_tpu_torch.kernels import cuda_scale_space as cs
from rebvo_tpu_torch.kernels import match_depth as mdk
from rebvo_tpu_torch.kernels import pose_solver as ps

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
    """The host build of the kernels, compiled first if needed."""
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
    lib.pose_lm_launch.argtypes = ps.K3_ARGTYPES
    lib.pose_v_launch.argtypes = ps.K3_ARGTYPES
    lib.kf_correct_launch.argtypes = kft.K4_ARGTYPES
    lib.md_match_launch.argtypes = mdk.MATCH_ARGTYPES
    lib.md_depth_launch.argtypes = mdk.DEPTH_ARGTYPES
    for fn in (lib.detect_candidates_launch, lib.build_scale_space_launch,
               lib.pose_lm_launch, lib.pose_v_launch, lib.kf_correct_launch,
               lib.md_match_launch, lib.md_depth_launch,
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


def pose(tensors, dof=6, **kw):
    """K3's host build on CPU inputs (pose_solver._INPUTS' order), as the
    card's `minimizer_rv` (dof 6) or `minimizer_v` (dof 3): the packed
    outputs and m_id_f."""
    lib = library()
    launch = lib.pose_lm_launch if dof == 6 else lib.pose_v_launch
    return ps.pose_launch(launch, tensors, None, dof=dof, **kw)


def kf(tensors, **kw):
    """K4's host build on CPU inputs (kf_tracking._INPUTS' order), as the
    card's `correct_and_augment`: m_f, m_kf and the counts."""
    return kft.kf_launch(library().kf_correct_launch, tensors, None, **kw)


def md_match(*args, **kw):
    """K5's md_match, host build, on CPU inputs (match_depth.match_plain's
    arguments), as the card's md_match: the float and int rows, R0,
    nmatch and est_ok."""
    return mdk.match_launch(library().md_match_launch, *args, None, **kw)


def md_depth(*args, **kw):
    """K5's md_depth, host build, on CPU inputs (match_depth.depth_plain's
    arguments): the rows and the scalars."""
    return mdk.depth_launch(library().md_depth_launch, *args, None, **kw)

"""The port's profiling and bench modules on the CPU at 96x64.

`roofline` uses the JAX package's byte models, so for one set of stage
times it gives the JAX roofline's achieved GB/s; only the utilisation
differs, by the ratio of the two peaks (the H100's memory rate against
the TPU v5e's). The stage breakdown and the bench phases run here at a
small size only to check their control flow and fields: a time taken on
the CPU says nothing of the card.
"""

import math
import types

import numpy as np
import pytest
import torch

from rebvo_tpu import profiling as jprof
from rebvo_tpu.config import REBVOParameters as JaxParams
from rebvo_tpu_torch import bench, profiling
from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.convert import params_from_jax
from rebvo_tpu_torch.frontend.step import VOFrontend

torch.set_num_threads(2)

STAGE_KEYS = {"detect", "field", "pose_solver", "matching", "depth_filter",
              "full_step"}


def _small(**kw):
    return REBVOParameters().replace(
        ImageWidth=96, ImageHeight=64, PPx=48.0, PPy=32.0, ZfX=80.0,
        ZfY=80.0, KeylineMax=512, MaxPoints=512, TrackPoints=512,
        ReferencePoints=300, NavLogCap=64, **kw)


@pytest.fixture(scope="module")
def small():
    p = _small()
    return dict(p=p, serial=bench._render_lane(p, 6, bench.SERIAL_SEED),
                lane=bench.rendered_lanes(p, 3, 1)[0])


def _state(p, lane):
    fe = VOFrontend(p, device="cpu")
    st = fe.bootstrap(fe.init(), lane[0], 0.0)
    st, _ = fe.step(st, lane[1], 0.05)
    st, _ = fe.step(st, lane[2], 0.10)
    return fe, st


@pytest.mark.parametrize("fused", [True, False])
def test_roofline_matches_jax_byte_models(fused):
    jp = JaxParams()
    stage = dict(pose_solver=41.5, matching=2.25, depth_filter=1.75,
                 full_step=80.0)
    jkey, tkey = (("scale_space_pallas", "scale_space_cuda") if fused
                  else ("scale_space_xla", "scale_space_torch"))
    ref = jprof.roofline(types.SimpleNamespace(params=jp),
                         {**stage, jkey: 0.0625})
    out = profiling.roofline(
        types.SimpleNamespace(params=params_from_jax(jp)),
        {**stage, tkey: 0.0625})
    names = ("scale_space", "pose_solver", "matching", "depth_filter")
    assert set(out) == {f"{n}_{k}" for n in names
                        for k in ("gbps", "mem_util")}
    ratio = jprof.HBM_PEAK_BYTES_S / profiling.H100_MEM_BYTES_PER_S
    for n in names:
        assert out[f"{n}_gbps"] == pytest.approx(ref[f"{n}_gbps"],
                                                 rel=1e-12)
        assert out[f"{n}_mem_util"] == pytest.approx(
            ref[f"{n}_hbm_util"] * ratio, rel=1e-12)


@pytest.mark.parametrize("use_pallas", [-1, 0])
def test_stage_breakdown_keys(small, use_pallas):
    """The fused configuration times K2 (`scale_space_cuda`, its plain
    version on the CPU) beside the prefix-sum twin; UsePallas=0 only the
    twin."""
    fe, st = _state(small["p"].replace(UsePallas=use_pallas), small["lane"])
    out = profiling.stage_breakdown(fe, st, small["lane"][1], n=1)
    want = STAGE_KEYS | {"scale_space_torch"}
    if use_pallas:
        want |= {"scale_space_cuda"}
    assert set(out) == want
    assert all(math.isfinite(v) and v > 0 for v in out.values())


def test_gather_floor_and_flop_count(small):
    fe, st = _state(small["p"], small["lane"])
    floor = profiling.matching_gather_floor(fe, st, n=1)
    assert math.isfinite(floor) and floor > 0
    flops = profiling.step_cost_analysis(fe, st, small["lane"][1])
    assert set(flops) == {"matmul_flops_per_step"}
    assert flops["matmul_flops_per_step"] > 0


def test_stage_breakdown_leaves_state_unchanged(small):
    """stage_breakdown steps the same state many times, which only a pure
    step allows."""
    fe, st = _state(small["p"], small["lane"])
    navlog = st.navlog.clone()
    profiling.stage_breakdown(fe, st, small["lane"][1], n=2)
    assert torch.equal(navlog, st.navlog)


def test_bench_phase_warm(small):
    out = bench.phase_warm(small["p"], "cpu", small["serial"])
    assert set(out) == {"warm_wall_s"} and out["warm_wall_s"] > 0


def test_bench_phase_serial(small):
    out = bench.phase_serial(small["p"], "cpu", small["serial"], n_chunks=2,
                             chunk=2)
    assert set(out) == {"serial_fps", "kl_num", "klm_num", "chunk_ms",
                        "serial_step_ms", "dispatch_overhead_ms",
                        "serial_fps_nondonated", "chunk_ms_nondonated"}
    assert len(out["chunk_ms"]) == 2 and len(out["chunk_ms_nondonated"]) == 1
    assert out["kl_num"] > 0 and out["serial_fps"] > 0
    assert out["dispatch_overhead_ms"] > 0


def test_bench_phase_scan(small):
    out = bench.phase_scan(small["p"], "cpu", small["serial"], n_chunks8=1,
                           n_chunks2=2)
    assert set(out) == {"serial_fps_scan8", "live_fps_chunk2", "chunk_ms_8",
                        "chunk_ms_2"}
    assert len(out["chunk_ms_8"]) == 1 and len(out["chunk_ms_2"]) == 2
    assert out["serial_fps_scan8"] > 0 and out["live_fps_chunk2"] > 0


def test_bench_phase_stages(small):
    out = bench.phase_stages(small["p"], "cpu", small["lane"], n=1)
    assert set(out) == {"stage_ms", "speed_of_light",
                        "matching_gather_floor_ms", "matmul_flops_per_step"}
    assert "scale_space_cuda" in out["stage_ms"]
    assert np.isfinite(list(out["speed_of_light"].values())).all()


def test_bench_main_needs_a_card(monkeypatch, capsys):
    """The bench measures the card only: with none it exits non-zero and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    assert capsys.readouterr().out == ""

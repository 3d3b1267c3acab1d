"""Configuration system.

Reproduces the reference's parameter surface (``REBVOParameters``,
reference include/rebvo/rebvo.h:64-235) and its INI-like config-file
format (``&Section`` headers, ``name=value`` pairs, ``//`` comments;
reference src/UtilLib/configurator.cpp) so existing REBVO config files
(e.g. app/rebvorun/GlobalConfig_EuRoC) translate 1:1.

Unlike the reference (which aborts when any key is missing,
reference src/rebvo/rebvo.cpp:53-193), missing keys here fall back to
the canonical EuRoC defaults; `load_config(path, strict=True)` restores
the reference behaviour.

Added TPU-specific keys live in the ``&TPU`` section: keyline batch
size (``KeylineMax``), mesh shape, dtypes. The section keeps its name in
the PyTorch port so one config file drives both packages; ``UsePallas``
selects the fused detector kernel (CUDA here) exactly as it selects the
Pallas kernel in the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, Tuple


# ---------------------------------------------------------------------------
# Parameter container — names follow the reference config keys.
# ---------------------------------------------------------------------------


@dataclass
class REBVOParameters:
    # --- &Detector (reference rebvo.cpp:106-121) ---
    Sigma0: float = 1.7818
    KSigma: float = 1.2599
    ReferencePoints: int = 12000
    MaxPoints: int = 16000
    TrackPoints: int = 12000
    DetectorThresh: float = 0.01
    DetectorAutoGain: float = 5e-7
    DetectorMaxThresh: float = 0.5
    DetectorMinThresh: float = 0.005
    DetectorPlaneFitSize: int = 2
    DetectorPosNegThresh: float = 0.4
    DetectorDoGThresh: float = 0.095259868922420

    # --- &TrackMaper (reference rebvo.cpp:123-146) ---
    SearchRange: int = 40
    QCutOffNumBins: int = 100
    QCutOffQuantile: float = 0.9
    TrackerIterNum: int = 5
    TrackerInitType: int = 2
    TrackerInitIterNum: int = 2
    TrackerMatchThresh: float = 0.5
    MatchThreshModule: float = 1.0
    MatchThreshAngle: float = 45.0
    MatchNumThresh: int = 0
    ReweigthDistance: float = 2.0
    RegularizeThresh: float = 0.5
    LocationUncertaintyMatch: float = 2.0
    ReshapeQAbsolute: float = 1e-4
    ReshapeQRelative: float = 1.6968e-4
    LocationUncertainty: float = 1.0
    DoReScaling: int = 0
    GlobalMatchThreshold: int = 500

    # --- &Camera (reference rebvo.cpp:57-99) ---
    ZfX: float = 458.654
    ZfY: float = 457.296
    PPx: float = 367.215
    PPy: float = 248.375
    KcR2: float = -0.28340811
    KcR4: float = 0.07395907
    KcR6: float = 0.0
    KcP1: float = 0.00019359
    KcP2: float = 1.76187114e-05
    ImageWidth: int = 752
    ImageHeight: int = 480
    config_fps: float = 20.0        # key "FPS"
    soft_fps: float = 20.0          # key "SoftFPS" (defaults to FPS)
    useUndistort: int = 1           # key "UseUndistort"
    rotatedCam: int = 0             # key "Rotate180"
    CameraDevice: str = "/dev/video0"

    # --- &REBVO (reference rebvo.cpp:62-105) ---
    CameraType: int = 2
    VideoNetHost: str = "127.0.0.1"
    VideoNetPort: int = 2708
    BlockingUDP: int = 0
    VideoNetEnabled: int = 0
    VideoSave: int = 0
    VideoSaveFile: str = "EncodedVideo.mjpeg"
    VideoSaveBuffersize: int = 200000000
    EncoderType: int = 0
    EncoderDevice: str = "/dev/video9"
    EdgeMapDelay: int = 0
    SaveLog: int = 1
    LogFile: str = "rebvo_log.m"
    TrayFile: str = "rebvo_tray.txt"
    StereoAvaiable: int = 0
    TrackKeyFrames: int = 1
    KFSavePercent: float = 0.7

    # --- &DataSetCamera (reference rebvo.cpp:66-75) ---
    DataSetDir: str = ""
    DataSetFile: str = ""
    DataSetDirStereo: str = ""
    DataSetFileStereo: str = ""
    CamTimeScale: float = 1e-9      # key "TimeScale" in &DataSetCamera

    # --- &IMU (reference rebvo.cpp:148-193) ---
    ImuMode: int = 0
    ImuFile: str = ""
    CamImuSE3File: str = ""
    ImuTimeScale: float = 1e-9      # key "TimeScale" in &IMU
    TimeDesinc: float = 0.0
    InitBias: int = 1
    InitBiasFrameNum: int = 10
    BiasHintX: float = 0.0
    BiasHintY: float = 0.0
    BiasHintZ: float = 0.0
    GiroMeasStdDev: float = 1.6968e-04
    GiroBiasStdDev: float = 1.9393e-05
    AcelMeasStdDev: float = 2.0000e-3
    g_module: float = 9.8
    g_module_uncer: float = 0.2e3
    g_uncert: float = 2e-3
    VBiasStdDev: float = 1e-7
    ScaleStdDevMult: float = 1e-2
    ScaleStdDevMax: float = 1e-4
    ScaleStdDevInit: float = 1.2e-3
    CircBufferSize: int = 1000
    SampleTime: float = 0.00125
    DeviceName: str = "/dev/ttySAC2"

    # --- &Stereo (reference rebvo.cpp:196-221) ---
    StereoZfX: float = 457.587
    StereoZfY: float = 456.134
    StereoPPx: float = 379.999
    StereoPPy: float = 255.238
    StereoKcR2: float = -0.28368365
    StereoKcR4: float = 0.07451284
    StereoKcR6: float = 0.0
    StereoKcP1: float = -0.00010473
    StereoKcP2: float = -3.555907e-05
    # cam0->cam1 extrinsics (X1 = R01 X0 + t01). The reference hard-codes
    # the EuRoC values inside the step (rebvo_second_t.cpp:467-470, a
    # noted bug); here they are config keys whose *defaults* are those
    # EuRoC values, consistent with the rest of this schema. A 12-value
    # SE3 file (row-major R then T, same format as CamImuSE3File)
    # overrides the scalars when set.
    StereoSE3File: str = ""
    StereoR11: float = 0.999997256477450
    StereoR12: float = 0.002312067192420
    StereoR13: float = 0.000376008102351
    StereoR21: float = -0.002317135723285
    StereoR22: float = 0.999898048506528
    StereoR23: float = 0.014089835846697
    StereoR31: float = -0.000343393120589
    StereoR32: float = -0.014090668452670
    StereoR33: float = 0.999900662638179
    StereoTx: float = -0.110073808127139
    StereoTy: float = 0.000399121547014
    StereoTz: float = -0.000853702503351

    # --- &SimuCamera ---
    SimVideoFile: str = "sim_video"
    SimVideoNFrames: int = 500
    SimuTimeOn: int = 0
    SimuTimeSweep: float = 3.0
    SimuTimeStep: float = 1e5
    SimuTimeStart: float = -2.0

    # --- &ProcesorConfig (affinity: kept for config parity, unused) ---
    cpuSetAffinity: int = 0
    cpu0: int = 1
    cpu1: int = 2
    cpu2: int = 3

    # --- &TPU (new: device-execution parameters, no reference analogue) ---
    KeylineMax: int = 16384        # fixed keyline-batch size (SoA slots)
    MatchMaxSteps: int = 44        # static bound on epipolar search steps
    StereoSearchRange: float = 100.0  # stereo epipolar search radius (px);
                                   # the reference hard-codes 100
                                   # (rebvo_second_t.cpp:471)
    StereoMatchMaxSteps: int = 112  # static bound on the stereo ladder
    # online keyframe tracking (TrackKeyFrames). The reference hard-codes
    # dist_thresh=10, tolerance=0 (rebvo_second_t.cpp:438,442); the step
    # bounds are the fixed budgets replacing its unbounded chain walks.
    KFDistThresh: float = 10.0     # epipolar prune distance (px)
    KFMinBaselinePx: float = 2.0   # below this expected disparity
                                   # (zfm*|t|*mean_rho) the KF epipolar
                                   # correct/prune is skipped (the
                                   # essential matrix is degenerate)
    KFChainSteps: int = 6          # chain-descent steps per correction
    KFAugIters: int = 4            # match-propagation iterations
    # KF pose re-anchor acceptance: an innovation chi^2 gate. The
    # correction dX=[dV;dW] between the dead-reckoned pose and the
    # KF-aligned pose is accepted iff its Mahalanobis norm under
    # S = age * diag(KFDriftTransStd^2, KFDriftRotStd^2) + Cov(align)
    # passes the 6-dof 99.9% quantile, AND the alignment itself is
    # well-conditioned (its own covariance below the caps) — degenerate
    # geometry (stale KF out of view, textureless frame) produces a
    # near-singular JtJ and is rejected by the caps, while a bogus
    # large correction (e.g. wrong-scale prior) fails the chi^2.
    BootstrapRescaleFrames: int = 20  # apply the depth rescale (the
                                   # reference's DoReScaling mechanism)
                                   # during the first N frames: pins the
                                   # bootstrap mono gauge at RhoInit,
                                   # killing the co-adaptation transient
                                   # and the post-bootstrap drift toward
                                   # fresh-keyline RhoInit injections.
    StereoVelRescale: int = 1      # stereo: 1-D refinement of the solved
                                   # translation scale against the pair-
                                   # anchored metric depths over the
                                   # directed-matching correspondences
                                   # (kernels/stereo.velocity_scale_refine)
    StereoScaleBaseFrames: int = 8   # scale-anchor epoch length (frames)
                                   # for the long-baseline translation-
                                   # scale observer (kernels/stereo.
                                   # anchor_scale_measure): per-frame
                                   # displacement is sub-pixel on slow
                                   # scenes, so scale is measured over
                                   # this many frames of accumulated
                                   # motion instead
    StereoPriorWindow: int = 0     # 1 = reference-windowed stereo search
                                   # (epipolar band from the mono prior's
                                   # +-sigma, edge_tracker.cpp:520-537);
                                   # 0 = prior-free full-range search with
                                   # ambiguity rejection (the default:
                                   # prior-windowed stereo self-confirms
                                   # the mono gauge and never recovers
                                   # metric scale — see kernels/stereo.py)
    SeedRhoMapMedian: int = 1      # STEREO mode: initialise FRESH keylines at the map's
                                   # median inverse depth instead of the
                                   # reference's fixed RhoInit=1
                                   # (edge_finder.h:42). A fixed seed far
                                   # from the converged population keeps
                                   # re-injecting a second depth gauge
                                   # every frame; the mixed-gauge map then
                                   # biases the pose solver toward a
                                   # shrunken translation (measured on
                                   # loop_st: V 13x under metric with a
                                   # stereo-pinned map). Median seeding is
                                   # gauge-neutral once converged and a
                                   # no-op at bootstrap (falls back to
                                   # RhoInit while nothing is mature).
    ScaleFilterLogDet: int = 0     # add the 1/2 log|Pz(alpha)| MLE term
                                   # to the scale filter (the reference
                                   # omits it). Reference-exact (0) wins
                                   # VI parity; see frontend/imu.py.
    KFReAnchor: int = 0            # use the KF alignment to correct the
                                   # global pose. Off by default: the
                                   # reference's online TrackKeyFrames
                                   # block never feeds the pose either
                                   # (its kfvo optimisers are dead code),
                                   # and measured on the parity scenes a
                                   # mono re-anchor from stale KF depths
                                   # adds drift (loop: 0.026 -> 0.17).
                                   # The chains/saves below are pose-
                                   # neutral and power the offline BA.
    KFDriftRotStd: float = 2e-3    # dead-reckoning rot drift (rad/frame)
    KFDriftTransStd: float = 8e-3  # trans drift (VO gauge units/frame)
    KFAlignRotUncertMax: float = 0.02   # max sqrt(tr RW0) accepted (rad)
    KFAlignTransUncertMax: float = 0.10  # max sqrt(tr RVel) accepted
    MatchFieldStride: int = 4      # directed matching samples the cached
                                   # match field at this pixel stride
                                   # (0 = probe the exact 1px id mask)
    FieldRadius: int = 6           # match-field paint radius (px). With the
                                   # capped robust cost, matches beyond
                                   # k_huber are score-identical to misses,
                                   # so this can be far below SearchRange;
                                   # it must stay >= MatchFieldStride + 2
                                   # so the strided matcher can't step
                                   # across a band.
    MeshDataAxis: int = 1          # sequences sharded over this many devices
    UseBf16Images: int = 0         # bfloat16 image path
    UsePallas: int = -1            # fused detector kernel for the pixel-
                                   # dense stage: 0 = off (the separate
                                   # scale_space + edge_detect ops), else
                                   # on: the CUDA kernel for a CUDA tensor,
                                   # its plain PyTorch version on the CPU
    NavLogCap: int = 4096          # device-resident nav-log ring capacity
                                   # (rows). The step appends one packed row
                                   # per frame so apps fetch the WHOLE run
                                   # log in one transfer at the end instead
                                   # of syncing the device every frame
                                   # (0 disables the ring)
    GaugeExport: int = 1           # mono: divide exported displacements by
                                   # the cumulative rescaling ratio
                                   # prod(Kp) so the trajectory stays in
                                   # the bootstrap depth gauge instead of
                                   # inheriting the EKF-convergence gauge
                                   # creep (new over the reference)

    # ------------------------------------------------------------------

    def replace(self, **kw) -> "REBVOParameters":
        return dataclasses.replace(self, **kw)

    @property
    def zf_mean(self) -> float:
        """Mean focal length ('zfm' in the reference, cam_model.h:52)."""
        return 0.5 * (self.ZfX + self.ZfY)

    def stereo_extrinsics(self):
        """cam0->cam1 (R01, t01) as numpy arrays; StereoSE3File (12-value
        row-major R then T) takes precedence over the scalar keys."""
        import numpy as np
        if self.StereoSE3File:
            with open(self.StereoSE3File) as fh:
                txt = fh.read().replace(",", " ").split()
            vals = [float(v) for v in txt[:12]]
            return (np.asarray(vals[:9], np.float64).reshape(3, 3),
                    np.asarray(vals[9:12], np.float64))
        R = np.asarray([
            [self.StereoR11, self.StereoR12, self.StereoR13],
            [self.StereoR21, self.StereoR22, self.StereoR23],
            [self.StereoR31, self.StereoR32, self.StereoR33]], np.float64)
        T = np.asarray([self.StereoTx, self.StereoTy, self.StereoTz],
                       np.float64)
        return R, T


# Mapping (section, key) -> dataclass field for names that differ.
_KEY_ALIASES: Dict[Tuple[str, str], str] = {
    ("Camera", "FPS"): "config_fps",
    ("Camera", "SoftFPS"): "soft_fps",
    ("Camera", "UseUndistort"): "useUndistort",
    ("Camera", "Rotate180"): "rotatedCam",
    ("DataSetCamera", "TimeScale"): "CamTimeScale",
    ("IMU", "TimeScale"): "ImuTimeScale",
    ("Stereo", "ZfX"): "StereoZfX",
    ("Stereo", "ZfY"): "StereoZfY",
    ("Stereo", "PPx"): "StereoPPx",
    ("Stereo", "PPy"): "StereoPPy",
    ("Stereo", "KcR2"): "StereoKcR2",
    ("Stereo", "KcR4"): "StereoKcR4",
    ("Stereo", "KcR6"): "StereoKcR6",
    ("Stereo", "KcP1"): "StereoKcP1",
    ("Stereo", "KcP2"): "StereoKcP2",
    ("Stereo", "SE3File"): "StereoSE3File",
    ("Stereo", "R11"): "StereoR11",
    ("Stereo", "R12"): "StereoR12",
    ("Stereo", "R13"): "StereoR13",
    ("Stereo", "R21"): "StereoR21",
    ("Stereo", "R22"): "StereoR22",
    ("Stereo", "R23"): "StereoR23",
    ("Stereo", "R31"): "StereoR31",
    ("Stereo", "R32"): "StereoR32",
    ("Stereo", "R33"): "StereoR33",
    ("Stereo", "Tx"): "StereoTx",
    ("Stereo", "Ty"): "StereoTy",
    ("Stereo", "Tz"): "StereoTz",
    ("ProcesorConfig", "SetAffinity"): "cpuSetAffinity",
    ("ProcesorConfig", "CamaraT1"): "cpu0",
    ("ProcesorConfig", "CamaraT2"): "cpu1",
    ("ProcesorConfig", "CamaraT3"): "cpu2",
}


def parse_config_text(text: str) -> Dict[Tuple[str, str], str]:
    """Parse the reference's config format into {(section, key): value}.

    Grammar (reference src/UtilLib/configurator.cpp:33-155): lines are
    ``&Section`` or ``key=value``; ``//`` starts a comment; whitespace is
    stripped; a trailing ``;`` on values is tolerated.
    """
    entries: Dict[Tuple[str, str], str] = {}
    section = ""
    for raw in text.splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            section = line[1:].strip()
            continue
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        key = key.strip()
        val = val.strip().rstrip(";").strip()
        entries[(section, key)] = val
    return entries


def _coerce(raw: str, pytype: type):
    if pytype is int:
        return int(float(raw))  # reference uses atof for everything
    if pytype is float:
        return float(raw)
    return raw


def params_from_entries(
    entries: Dict[Tuple[str, str], str], strict: bool = False
) -> REBVOParameters:
    params = REBVOParameters()
    fields = {f.name: f for f in dataclasses.fields(REBVOParameters)}
    updates = {}
    seen = set()
    for (section, key), raw in entries.items():
        name = _KEY_ALIASES.get((section, key), key)
        f = fields.get(name)
        if f is None:
            continue  # unknown key: ignored (forward compatible)
        updates[name] = _coerce(raw, f.type if isinstance(f.type, type) else type(getattr(params, name)))
        seen.add(name)
    if strict:
        missing = set(fields) - seen
        # TPU section and purely-optional reference keys are exempt.
        optional = {
            "KeylineMax", "MatchMaxSteps", "MeshDataAxis", "UseBf16Images",
            "soft_fps", "TrackKeyFrames", "KFSavePercent", "GaugeExport",
            "CamImuSE3File",       # optional in the reference too
                                   # (rebvo.cpp:180, no InitOK&=)
        }
        missing -= optional
        if missing:
            raise ValueError(f"missing mandatory config keys: {sorted(missing)}")
    return params.replace(**updates)


def load_config(path: str, strict: bool = False) -> REBVOParameters:
    with open(path) as fh:
        return params_from_entries(parse_config_text(fh.read()), strict=strict)


# Section layout for dump_config: every reference-queried (section, key)
# (the mandatory set of reference src/rebvo/rebvo.cpp:53-221) maps to a
# dataclass field; extra repo-only keys go to their own sections, which
# the reference Configurator parses and ignores.
_SECTION_FIELDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("Detector", ("Sigma0", "KSigma", "ReferencePoints", "MaxPoints",
                  "TrackPoints", "DetectorThresh", "DetectorAutoGain",
                  "DetectorMaxThresh", "DetectorMinThresh",
                  "DetectorPlaneFitSize", "DetectorPosNegThresh",
                  "DetectorDoGThresh")),
    ("TrackMaper", ("SearchRange", "QCutOffNumBins", "QCutOffQuantile",
                    "TrackerIterNum", "TrackerInitType",
                    "TrackerInitIterNum", "TrackerMatchThresh",
                    "MatchThreshModule", "MatchThreshAngle",
                    "MatchNumThresh", "ReweigthDistance",
                    "RegularizeThresh", "LocationUncertaintyMatch",
                    "ReshapeQAbsolute", "ReshapeQRelative",
                    "LocationUncertainty", "DoReScaling",
                    "GlobalMatchThreshold")),
    ("Camera", ("CameraDevice", "ZfX", "ZfY", "PPx", "PPy", "KcR2", "KcR4",
                "KcR6", "KcP1", "KcP2", "ImageWidth", "ImageHeight",
                "config_fps", "soft_fps", "useUndistort", "rotatedCam")),
    ("REBVO", ("CameraType", "VideoNetHost", "VideoNetPort", "BlockingUDP",
               "VideoNetEnabled", "VideoSave", "VideoSaveFile",
               "VideoSaveBuffersize", "EncoderType", "EncoderDevice",
               "EdgeMapDelay", "SaveLog", "LogFile", "TrayFile",
               "StereoAvaiable", "TrackKeyFrames", "KFSavePercent")),
    ("DataSetCamera", ("DataSetDir", "DataSetFile", "DataSetDirStereo",
                       "DataSetFileStereo", "CamTimeScale")),
    ("IMU", ("ImuMode", "ImuFile", "CamImuSE3File", "ImuTimeScale",
             "TimeDesinc", "InitBias", "InitBiasFrameNum", "BiasHintX",
             "BiasHintY", "BiasHintZ", "GiroMeasStdDev", "GiroBiasStdDev",
             "AcelMeasStdDev", "g_module", "g_module_uncer", "g_uncert",
             "VBiasStdDev", "ScaleStdDevMult", "ScaleStdDevMax",
             "ScaleStdDevInit", "CircBufferSize", "SampleTime",
             "DeviceName")),
    ("Stereo", ("StereoZfX", "StereoZfY", "StereoPPx", "StereoPPy",
                "StereoKcR2", "StereoKcR4", "StereoKcR6", "StereoKcP1",
                "StereoKcP2", "StereoSE3File", "StereoR11", "StereoR12",
                "StereoR13", "StereoR21", "StereoR22", "StereoR23",
                "StereoR31", "StereoR32", "StereoR33", "StereoTx",
                "StereoTy", "StereoTz")),
    ("SimuCamera", ("SimVideoFile", "SimVideoNFrames", "SimuTimeOn",
                    "SimuTimeSweep", "SimuTimeStep", "SimuTimeStart")),
    ("ProcesorConfig", ("cpuSetAffinity", "cpu0", "cpu1", "cpu2")),
    ("TPU", ("KeylineMax", "MatchMaxSteps", "StereoSearchRange",
             "StereoMatchMaxSteps", "KFDistThresh", "KFChainSteps",
             "KFAugIters", "KFMinBaselinePx",
             "BootstrapRescaleFrames", "SeedRhoMapMedian",
             "StereoPriorWindow", "StereoVelRescale", "StereoScaleBaseFrames",
             "ScaleFilterLogDet", "KFReAnchor", "KFDriftRotStd", "KFDriftTransStd",
             "KFAlignRotUncertMax", "KFAlignTransUncertMax",
             "MatchFieldStride", "FieldRadius", "MeshDataAxis",
             "UseBf16Images", "UsePallas", "NavLogCap", "GaugeExport")),
)

_FIELD_TO_KEY: Dict[str, Tuple[str, str]] = {
    fname: (section, key) for (section, key), fname in _KEY_ALIASES.items()
}


def dump_config(params: REBVOParameters) -> str:
    """Serialize parameters to the reference config format — the exact
    file a reference `rebvorun` accepts (all mandatory keys of
    rebvo.cpp:53-221 present; repo-only keys in extra sections the
    reference's Configurator parses and ignores)."""
    out = ["// REBVO configuration (generated by rebvo_tpu_torch)"]
    for section, fnames in _SECTION_FIELDS:
        out.append(f"\n&{section}\n")
        for fname in fnames:
            sec_key = _FIELD_TO_KEY.get(fname, (section, fname))
            key = sec_key[1]
            val = getattr(params, fname)
            if fname == "CamImuSE3File" and not val:
                # optional in the reference (rebvo.cpp:180 — no InitOK&=);
                # an empty value would make it try LoadCamImuSE3("") and
                # abort, so the key is omitted when unset
                continue
            if isinstance(val, float):
                sval = repr(val)
            else:
                sval = str(val)
            out.append(f"    {key}={sval}")
    return "\n".join(out) + "\n"


def save_config(params: REBVOParameters, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(dump_config(params))

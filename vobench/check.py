"""How `correct` is decided: the plain reference (vobench/reference)
steps from the program's own state on the same inputs, and the gaps
between what the two produce are held to the cell's limits.

Every comparison is of a unit of the timed path: the state before it
and after it, and the per-frame outputs it produced. States and outputs
are flattened into named leaves ("state.klm.rho", "out.nav.Pos") in a
canonical layout: states [L, ...] and outputs [L, F, ...] for L lanes
of F frames each. The reference rebuilds its own state from the
program's leaves, works out the frames' undistortion and the IMU
windows again from the raw inputs, runs its plain step, and the gaps
below are read leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

# The numbers compared, in the order they are printed.
NUMBERS = ("count_gap", "keyline_gap_px", "rho_gap", "pos_gap_m",
           "vel_gap_mps", "rot_gap_rad", "imu_filter_gap", "leaf_gap")

_POS = ("out.nav.Pos", "state.Pos", "state.kf.Pos")
_VEL = ("out.nav.Vel",)
_ROT = ("out.nav.RotLie", "out.nav.PoseLie")


# ---------------------------------------------------------------------------
# Named leaves
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix: str) -> Dict[str, Tensor]:
    """{dotted name: tensor} of a nest of NamedTuples, tuples and lists."""
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(named_leaves(getattr(tree, f), f"{prefix}.{f}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, x in enumerate(tree):
            out.update(named_leaves(x, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


def from_named(template, named: Dict[str, Tensor], prefix: str):
    """`template`'s structure with each leaf taken from `named`."""
    if hasattr(template, "_fields"):
        return type(template)(*[from_named(getattr(template, f), named,
                                           f"{prefix}.{f}")
                                for f in template._fields])
    if isinstance(template, (tuple, list)):
        return type(template)(from_named(x, named, f"{prefix}.{i}")
                              for i, x in enumerate(template))
    return named[prefix]


def snapshot(tree, prefix: str, lanes: Optional[int]) -> Dict[str, Tensor]:
    """Copies of `tree`'s leaves on the host (so that a snapshot takes
    no device memory); `lanes=None` adds a lane axis of 1 (a
    one-sequence tree), else the tree has `lanes` on axis 0."""
    out = {}
    for k, v in named_leaves(tree, prefix).items():
        v = torch.as_tensor(v).detach().to("cpu", copy=True)
        out[k] = v.unsqueeze(0) if lanes is None else v
    return out


def stack_named(items: List[Dict[str, Tensor]], dim: int) -> Dict[str, Tensor]:
    return {k: torch.stack([d[k] for d in items], dim) for k in items[0]}


# ---------------------------------------------------------------------------
# The reference side
# ---------------------------------------------------------------------------


class Unit(NamedTuple):
    """One compared unit of the timed path: per lane, the frames it
    stepped as (period frame index, time) and the time of the frame
    before them; the state before it and after it, and its outputs
    (canonical named leaves)."""

    frames: List[List[tuple]]
    t_prev: List[float]
    before: Dict[str, Tensor]
    after: Dict[str, Tensor]
    outs: Dict[str, Tensor]


class Reference:
    """The plain step on `device`, built from the cell's parameters.
    `system=True` adds the embedded system's host layer (the keyframe
    store and the pose-graph log, vobench.reference.system). A stereo
    configuration (StereoAvaiable) steps each frame with its cam1 frame
    from `frames_pair`, undistorted through cam1's own map; it needs
    them, and it has no system layer: either lack raises ValueError.

    `variant` puts a stand-in in the program's place:
      "bf16"     the control: the carried state's float leaves and each
                 frame rounded to bfloat16 before every step;
      "reorder"  a sound change that adds the float64 products and long
                 sums in another order (core.numerics.reversed_sums);
      "nudge"    float32 rounding noise: the same leaves and frames as
                 the control moved by one float32 ulp (toward +inf)
                 before every step."""

    def __init__(self, params: dict, device, frames: Tensor,
                 imu_rows: Optional[np.ndarray] = None,
                 variant: Optional[str] = None, system: bool = False,
                 frames_pair: Optional[Tensor] = None):
        from vobench.reference.config import REBVOParameters
        from vobench.reference.frontend.step import VOFrontend
        from vobench.reference.io.undistort import build_undistort_map
        if variant not in (None, "bf16", "reorder", "nudge"):
            raise ValueError(f"unknown reference variant {variant!r}")
        self.params = REBVOParameters(**params)
        self.device = torch.device(device)
        self.fe = VOFrontend(self.params, device=self.device)
        self.umap = (build_undistort_map(self.fe.cam, device=self.device)
                     if self.params.useUndistort else None)
        self.frames = frames            # [L, P, H, W] uint8, host
        self.stereo = bool(self.params.StereoAvaiable)
        if self.stereo and frames_pair is None:
            raise ValueError("a stereo configuration (StereoAvaiable=1) "
                             "needs cam1's frames (frames_pair)")
        if self.stereo and system:
            raise ValueError("the reference has no stereo system layer: a "
                             "stereo configuration cannot be checked with "
                             "system=True")
        self.umap_pair = (build_undistort_map(self.fe.cam_pair,
                                              device=self.device)
                          if self.stereo and self.params.useUndistort
                          else None)
        self.frames_pair = frames_pair  # cam1's [L, P, H, W] uint8, host
        self.imu_rows = imu_rows
        self.variant = variant
        self.system = system
        self.template = self.fe.init()

    @property
    def _perturbs(self) -> bool:
        return self.variant in ("bf16", "nudge")

    def _perturb(self, x: Tensor) -> Tensor:
        if self.variant == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return torch.nextafter(x, torch.full_like(x, float("inf")))

    def frame(self, lane: int, idx: int) -> Tensor:
        """Period frame `idx` of scene lane `lane`, on the intensity scale
        of the program's dataset reader (8 bits x 3), undistorted."""
        return self._image(self.frames, self.umap, lane, idx)

    def frame_pair(self, lane: int, idx: int) -> Optional[Tensor]:
        """cam1's frame of the same period index, as `frame` makes cam0's
        (perturbed alike), undistorted through cam1's map; None in mono."""
        if not self.stereo:
            return None
        return self._image(self.frames_pair, self.umap_pair, lane, idx)

    def _image(self, frames, umap, lane, idx):
        from vobench.reference.io.undistort import apply_undistort
        f = frames[lane, idx].to(self.device, torch.float32) * 3.0
        if self._perturbs:
            f = self._perturb(f)
        return apply_undistort(umap, f) if umap is not None else f

    def window(self, t_prev: float, t: float):
        from vobench.reference.io.imu_windows import (imu_window_size,
                                                      slice_imu_windows)
        p = self.params
        r = self.imu_rows
        lo = t_prev + p.TimeDesinc
        sel = r[(r[:, 0] > lo) & (r[:, 0] <= t + p.TimeDesinc + 1e-12)]
        return slice_imu_windows(sel, [t], imu_window_size(p),
                                 p.TimeDesinc)[0]

    def _round(self, state):
        if not self._perturbs:
            return state

        def r(x):
            if isinstance(x, Tensor) and x.dtype == torch.float32:
                return self._perturb(x)
            return x
        named = {k: r(v) for k, v in named_leaves(state, "state").items()}
        return from_named(state, named, "state")

    def run(self, lane: int, state: Optional[Dict[str, Tensor]], frames,
            t_prev: float):
        """Step scene lane `lane` through `frames` [(period index, t), ...]
        from `state` (named leaves without a lane axis), or, when it is
        None, from the initial state with a bootstrap on the first frame.
        Returns (state, [outputs]) as named leaves with a lane axis of 1
        (outputs [1, F, ...])."""
        from vobench.reference.core.numerics import reversed_sums
        if self.variant == "reorder":
            with reversed_sums():
                return self._run(lane, state, frames, t_prev)
        return self._run(lane, state, frames, t_prev)

    def _run(self, lane, state, frames, t_prev):
        from vobench.reference import system
        fe = self.fe
        outs = []
        sysd = None
        if state is None:
            (idx, t), frames = frames[0], frames[1:]
            st = fe.bootstrap(fe.init(), self.frame(lane, idx), t,
                              frame_pair=self.frame_pair(lane, idx))
            t_prev = t
            if self.system:
                sysd = system.after_bootstrap(system.empty(self.params
                                                           .KeylineMax))
        else:
            st = from_named(self.template, {k: v.to(self.device)
                                            for k, v in state.items()
                                            if k.startswith("state.")},
                            "state")
            if self.system:
                sysd = system.counters_from(
                    {k: v[None] for k, v in state.items()
                     if k.startswith("sys.")},
                    int(state["state.kf.count"]),
                    int(state["state.frame_count"]))
        for idx, t in frames:
            st = self._round(st)
            f, pair = self.frame(lane, idx), self.frame_pair(lane, idx)
            if self.params.ImuMode:
                st, o = fe.step_imu(st, f, t, self.window(t_prev, t),
                                    frame_pair=pair)
            else:
                st, o = fe.step(st, f, t, frame_pair=pair)
            o_named = snapshot(o, "out", None)
            if sysd is not None:
                sysd, meas = system.after_step(sysd, st, o)
                o_named.update({k: v[None] for k, v in meas.items()})
            outs.append(o_named)
            t_prev = t
        named = snapshot(st, "state", None)
        if sysd is not None:
            named.update(sysd)
        return named, (stack_named(outs, 1) if outs else {})


def lane_state(named: Dict[str, Tensor], lane: int) -> Dict[str, Tensor]:
    return {k: v[lane] for k, v in named.items()}


def _cat(items: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    return {k: torch.cat([d[k] for d in items]) for k in items[0]}


def reference_unit(ref: Reference, unit: Unit):
    """The reference's (after, outs) for `unit`, canonical layout."""
    afters, outs = [], []
    for b, frames in enumerate(unit.frames):
        st, o = ref.run(b, lane_state(unit.before, b), frames,
                        unit.t_prev[b])
        afters.append(st)
        outs.append(o)
    return _cat(afters), _cat(outs)


def reference_start(ref: Reference, frames: List[List[tuple]]):
    """The reference's state after the set-up's frames, from the
    initial state (canonical layout)."""
    return _cat([ref.run(b, None, fr, 0.0)[0] for b, fr in enumerate(frames)])


# ---------------------------------------------------------------------------
# The gaps
# ---------------------------------------------------------------------------


def _absdiff(a: Tensor, b: Tensor) -> Tensor:
    a = a.double()
    b = b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return torch.nan_to_num(d, nan=float("inf"))


def _relative(d: Tensor, p: Tensor, r: Tensor) -> Tensor:
    """Each entry's |difference| over the sum of both magnitudes and the
    reference leaf's median magnitude (1 for a leaf of zeros): 0 where
    equal, about 1.2e-7 a float32 ulp, below 1 always; entries near zero
    and sentinel entries are read on the leaf's own scale."""
    a = torch.nan_to_num(r.double().abs(), nan=0.0, posinf=0.0)
    b = torch.nan_to_num(p.double().abs(), nan=0.0, posinf=0.0)
    m = float(a.median()) if a.numel() else 0.0
    den = a + b + (m if m > 0 else 1.0)
    return torch.where(d == 0, torch.zeros_like(d),
                       torch.clamp(d / den, max=1.0))


def _max(t: Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def gaps(prog: Dict[str, Tensor], ref: Dict[str, Tensor]) -> Dict[str, float]:
    """Each number of NUMBERS between the program's named leaves and the
    reference's (states and outputs of one unit, canonical layout):

    count_gap       largest difference of any integer or boolean leaf
                    (keyline and match counts, valid masks, match ids,
                    keyframe ids and counts, frame and log counters, the
                    keyframe store and the pose-graph log)
    keyline_gap_px  largest |dx|, |dy| of the keylines' subpixel image
                    positions, where the reference's keyline is valid
    rho_gap         largest |d rho| (inverse depth, 1/m), same keylines
    pos_gap_m       largest |d Pos| of the outputs, the state and the
                    tracked keyframe (m)
    vel_gap_mps     largest |d Vel| of the outputs (m/s)
    rot_gap_rad     largest |d| of the outputs' RotLie and PoseLie
    imu_filter_gap  largest relative |d| of the IMU filter's float leaves:
                    each entry's |d| over both magnitudes plus the
                    leaf's median magnitude (0 to 1)
    leaf_gap        the same over every float leaf of the state and the
                    outputs (the keyframe carry, thresholds, nav log)
    """
    g = dict.fromkeys(NUMBERS, 0.0)
    valid = ref.get("state.klm.valid")
    for k, r in ref.items():
        p = prog[k]
        if p.shape != r.shape:
            raise ValueError(f"{k}: program {tuple(p.shape)} against "
                             f"reference {tuple(r.shape)}")
        p = p.to(r.device)
        d = _absdiff(p, r)
        if not r.is_floating_point():
            g["count_gap"] = max(g["count_gap"], _max(d))
            continue
        if k in _POS:
            g["pos_gap_m"] = max(g["pos_gap_m"], _max(d))
        elif k in _VEL:
            g["vel_gap_mps"] = max(g["vel_gap_mps"], _max(d))
        elif k in _ROT:
            g["rot_gap_rad"] = max(g["rot_gap_rad"], _max(d))
        if k in ("state.klm.x", "state.klm.y", "state.klm.rho"):
            dm = torch.where(valid, d, torch.zeros_like(d))
            key = "rho_gap" if k.endswith("rho") else "keyline_gap_px"
            g[key] = max(g[key], _max(dm))
        rel = _max(_relative(d, p, r))
        g["leaf_gap"] = max(g["leaf_gap"], rel)
        if k.startswith("state.imu."):
            g["imu_filter_gap"] = max(g["imu_filter_gap"], rel)
    return g


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out = dict.fromkeys(NUMBERS, 0.0)
    for r in readings:
        for k, v in r.items():
            out[k] = max(out[k], v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number with a limit is within it."""
    return all(numbers[k] <= lim for k, lim in limits.items())

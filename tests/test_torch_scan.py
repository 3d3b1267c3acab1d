"""The port's pure `step`, `step_donated` and `step_scan` on the CPU, at
test_torch_step.py's SMALL shapes on its rendered tilted-plane sequence.

On the CPU `step_scan` runs its N donated steps in a Python loop, so it
must give the per-frame `step`'s floats bit for bit; against the JAX
package's per-frame step it is held to test_torch_step.py's tolerances.
(JAX's own step_scan is lax.scan over the same step, bit-identical to its
per-frame path, so it is not compiled here.) On the card the N steps are
one CUDA graph; chip_smoke.py holds it against the per-frame step there.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu.frontend.step import VOFrontend
from rebvo_tpu.io.render import render_plane_seq
from rebvo_tpu_torch.convert import params_from_jax
from rebvo_tpu_torch.frontend.step import VOFrontend as TorchFrontend
from tests.test_torch_step import SMALL, TILT, small_params

torch.set_num_threads(2)

N_SCAN = 8          # two chunks of 4


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*[_clone(sub) for sub in tree])


def _assert_same(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), (what, i)


@pytest.fixture(scope="module")
def seq():
    pos = np.zeros((N_SCAN + 1, 3))
    pos[:, 0] = np.arange(N_SCAN + 1) * 0.02
    frames = render_plane_seq(N_SCAN + 1, cam_positions=pos,
                              plane_normal=TILT, **SMALL)
    ts = np.asarray([i / 20.0 for i in range(1, N_SCAN + 1)], np.float32)
    p = small_params()
    fe = VOFrontend(p)
    fe.use_pallas = True      # the fused detector, run by the interpreter
    with pltpu.force_tpu_interpret_mode():
        st = fe.bootstrap(fe.init(), jnp.asarray(frames[0]),
                          jnp.asarray(0.0))
        jouts = []
        for i in range(N_SCAN):
            st, out = fe.step(st, jnp.asarray(frames[i + 1]),
                              jnp.asarray(ts[i]))
            jouts.append(out)
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    s0 = tfe.bootstrap(tfe.init(), frames[0], 0.0)
    st, touts = s0, []
    for i in range(N_SCAN):
        st, out = tfe.step(st, frames[i + 1], float(ts[i]))
        touts.append(out)
    return dict(frames=frames, ts=ts, tfe=tfe, s0=s0, final=st,
                touts=touts, jouts=jouts)


def test_step_leaves_its_input_unchanged(seq):
    """The pure step, as in JAX: stepping one state twice gives equal
    results, and the input state (its nav-log ring above all) is left as
    it was."""
    fe, s0 = seq["tfe"], seq["s0"]
    before = _clone(s0)
    a = fe.step(s0, seq["frames"][1], float(seq["ts"][0]))
    b = fe.step(s0, seq["frames"][1], float(seq["ts"][0]))
    _assert_same(a, b, "two steps of one state")
    _assert_same(before, s0, "input state")
    assert int(a[0].navlog_n) == int(s0.navlog_n) + 1
    assert not torch.equal(a[0].navlog, s0.navlog)


def test_step_donated_equals_step(seq):
    fe = seq["tfe"]
    a = fe.step(seq["s0"], seq["frames"][1], float(seq["ts"][0]))
    b = fe.step_donated(_clone(seq["s0"]), seq["frames"][1],
                        float(seq["ts"][0]))
    _assert_same(a, b, "step_donated")


def test_step_scan_equals_per_frame_step(seq):
    """Two chunks of 4 through step_scan give the per-frame step's final
    state and per-frame outputs bit for bit; the outputs are stacked on a
    leading axis of 4."""
    fe, frames, ts = seq["tfe"], seq["frames"], seq["ts"]
    st, o1 = fe.step_scan(_clone(seq["s0"]), frames[1:5], ts[:4])
    st, o2 = fe.step_scan(st, torch.as_tensor(frames[5:9]),
                          torch.as_tensor(ts[4:]))
    _assert_same(seq["final"], st, "final state")
    assert o1.nav.Pos.shape == (4, 3) and o1.W_X.shape == (4, 6, 6)
    for i, ref in enumerate(seq["touts"]):
        o = o1 if i < 4 else o2
        _assert_same(ref, type(o)(*[_pick(x, i % 4) for x in o]), i)


def _pick(tree, i):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*[_pick(sub, i) for sub in tree])


def test_step_scan_matches_jax_per_frame(seq):
    """step_scan against the JAX per-frame step: kl_num equal, klm_num
    within 1%, Pos within 1e-3 (test_torch_step.py's bars)."""
    fe, frames, ts = seq["tfe"], seq["frames"], seq["ts"]
    st, o1 = fe.step_scan(_clone(seq["s0"]), frames[1:5], ts[:4])
    _, o2 = fe.step_scan(st, frames[5:9], ts[4:])
    kl = torch.cat([o1.nav.kl_num, o2.nav.kl_num])
    klm = torch.cat([o1.nav.klm_num, o2.nav.klm_num])
    pos = torch.cat([o1.nav.Pos, o2.nav.Pos])
    for i, a in enumerate(seq["jouts"]):
        assert int(a.nav.kl_num) == int(kl[i]), i
        assert abs(int(a.nav.klm_num) - int(klm[i])) <= \
            0.01 * int(a.nav.klm_num), i
        np.testing.assert_allclose(np.asarray(a.nav.Pos), pos[i].numpy(),
                                   atol=1e-3, err_msg=str(i))


def test_step_scan_rejects_mismatched_timestamps(seq):
    fe = seq["tfe"]
    with pytest.raises(ValueError):
        fe.step_scan(_clone(seq["s0"]), seq["frames"][1:5], seq["ts"][:3])


@pytest.mark.parametrize("chunk", [4, 3])
def test_run_vo_chunk_writes_same_tum(tmp_path, chunk):
    """run_vo --chunk N (N frames per step_scan call, the tail one frame
    at a time) writes the TUM rows of the per-frame run: 9 frames are a
    bootstrap and 8 steps, two chunks of 4, or two of 3 and a tail of 2."""
    from rebvo_tpu_torch.apps import run_vo
    cfg = tmp_path / "small.cfg"
    cfg.write_text("&Camera\nImageWidth=188\nImageHeight=120\nZfX=100\n"
                   "ZfY=100\nPPx=94\nPPy=60\n&TPU\nKeylineMax=2048\n")
    rows = {}
    for name, extra in (("frame", []), ("chunk", ["--chunk", str(chunk)])):
        out = tmp_path / name
        run_vo.main(["--cpu", "--synthetic", "9", "--config", str(cfg),
                     "--out-dir", str(out)] + extra)
        with open(os.path.join(out, "rebvo_tray.txt")) as fh:
            rows[name] = [ln for ln in fh if ln.strip()]
    assert len(rows["frame"]) == 8
    assert rows["chunk"] == rows["frame"]

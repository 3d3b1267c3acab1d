"""The port's runtime_utils against the JAX package's on the CPU: a
checkpoint written by either package's save_state loads into the other's
state, and the next step from it matches the other package's next step
(test_torch_step.py's single-step bars).

At 188x120 on test_torch_step.py's rendered tilted-plane sequence, both
packages on the fused detector (the JAX side's Pallas kernel in the
interpreter, the port's plain version of its CUDA kernel), whose masks
agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rebvo_tpu import runtime_utils as jru
from rebvo_tpu.frontend.step import VOFrontend
from rebvo_tpu.io.render import render_plane_seq
from rebvo_tpu_torch import runtime_utils as tru
from rebvo_tpu_torch.convert import params_from_jax
from rebvo_tpu_torch.frontend.step import VOFrontend as TorchFrontend
from tests.test_torch_step import TILT, small_params

torch.set_num_threads(2)

TINY = dict(width=188, height=120, zf=100.0, cx=94.0, cy=60.0, z0=3.0)
N = 4      # bootstrap, two steps, the checkpoint, one step from it


@pytest.fixture(scope="module")
def seq():
    pos = np.zeros((N, 3))
    pos[:, 0] = np.arange(N) * 0.02
    frames = render_plane_seq(N, cam_positions=pos, plane_normal=TILT,
                              **TINY)
    p = small_params().replace(
        ImageWidth=TINY["width"], ImageHeight=TINY["height"],
        ZfX=TINY["zf"], ZfY=TINY["zf"], PPx=TINY["cx"], PPy=TINY["cy"],
        KeylineMax=2048, MaxPoints=2048, ReferencePoints=800,
        TrackPoints=2048, GlobalMatchThreshold=50)
    fe = VOFrontend(p)
    fe.use_pallas = True
    tfe = TorchFrontend(params_from_jax(p), device="cpu")
    return frames, fe, tfe


def _jax_run(fe, frames, state=None, start=0, stop=N):
    with pltpu.force_tpu_interpret_mode():
        st = state
        out = None
        for i in range(start, stop):
            f, t = jnp.asarray(frames[i]), jnp.asarray(i / 20.0)
            if st is None:
                st = fe.bootstrap(fe.init(), f, t)
            else:
                st, out = fe.step(st, f, t)
    return st, out


def _torch_run(tfe, frames, state=None, start=0, stop=N):
    st, out = state, None
    for i in range(start, stop):
        if st is None:
            st = tfe.bootstrap(tfe.init(), frames[i], i / 20.0)
        else:
            st, out = tfe.step(st, frames[i], i / 20.0)
    return st, out


def _leaves_equal(jstate, tstate):
    jl = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tl = dict(tru._leaves(tstate))
    assert [jru._path_str(p) for p, _ in jl] == list(tl)
    for p, v in jl:
        t = tl[jru._path_str(p)]
        assert np.asarray(v).dtype == t.numpy().dtype, jru._path_str(p)
        np.testing.assert_array_equal(np.asarray(v), t.numpy(),
                                      err_msg=jru._path_str(p))


def _same_step(js, jout, ts, tout):
    """test_torch_step.py::test_single_step_from_same_state's bars."""
    assert int(jout.nav.kl_num) == int(tout.nav.kl_num)
    assert abs(int(jout.nav.klm_num) - int(tout.nav.klm_num)) <= \
        0.005 * int(jout.nav.klm_num)
    assert bool(jout.nav.estimation_ok) and bool(tout.nav.estimation_ok)
    for f in ("Vel", "W0", "Pos", "Pose"):
        np.testing.assert_allclose(np.asarray(getattr(js, f)),
                                   getattr(ts, f).numpy(), atol=5e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(np.asarray(js.mask_img),
                                  ts.mask_img.numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(seq, tmp_path, writer):
    """bootstrap + 2 steps in the writing package, save_state, load_state
    into the other package's fresh state (every leaf equal, same keys and
    dtypes), then one step in each package from its own copy: the steps
    agree."""
    frames, fe, tfe = seq
    path = str(tmp_path / "ckpt.npz")
    if writer == "jax":
        js, _ = _jax_run(fe, frames, stop=N - 1)
        jru.save_state(path, js)
        ts = tru.load_state(path, tfe.init())
    else:
        ts, _ = _torch_run(tfe, frames, stop=N - 1)
        tru.save_state(path, ts)
        js = jru.load_state(path, fe.init())
    _leaves_equal(js, ts)
    js2, jout = _jax_run(fe, frames, js, N - 1, N)
    ts2, tout = _torch_run(tfe, frames, ts, N - 1, N)
    _same_step(js2, jout, ts2, tout)


def test_checkpoint_roundtrip_and_refusals(seq, tmp_path):
    """tests/test_aux.py's roundtrip on the port (deep leaves, dtypes),
    and a missing leaf or a wrong shape refused."""
    _, _, tfe = seq
    st = tfe.init()._replace(Pos=torch.tensor([1.0, 2.0, 3.0]),
                             frame_count=torch.tensor(7, dtype=torch.int32))
    path = str(tmp_path / "ckpt.npz")
    tru.save_state(path, st)
    st2 = tru.load_state(path, tfe.init())
    assert st2.Pos.tolist() == [1.0, 2.0, 3.0]
    assert int(st2.frame_count) == 7 and st2.frame_count.dtype == torch.int32
    np.testing.assert_array_equal(st2.imu.X7.numpy(), st.imu.X7.numpy())
    z = dict(np.load(path))
    z.pop("Pos")
    np.savez(str(tmp_path / "missing.npz"), **z)
    with pytest.raises(KeyError, match="Pos"):
        tru.load_state(str(tmp_path / "missing.npz"), tfe.init())
    z["Pos"] = np.zeros(4, np.float32)
    np.savez(str(tmp_path / "shape.npz"), **z)
    with pytest.raises(ValueError, match="Pos"):
        tru.load_state(str(tmp_path / "shape.npz"), tfe.init())

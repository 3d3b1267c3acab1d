"""The port's sharded BA and process group on the CPU: ba_solve_sharded
over in-process landmark blocks against the one-process ba_solve and
against the JAX package's ba_solve_sharded on a 4-device CPU mesh (with
tests/test_backend.py's bars), parallel/distributed's refusals, and a
2-process gloo run of apps/run_multihost in a subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rebvo_tpu.backend import ba as jba
from rebvo_tpu.parallel.mesh import data_mesh as jax_data_mesh
from rebvo_tpu_torch.backend import ba as tba
from rebvo_tpu_torch.io.trajectory import ate_rmse
from rebvo_tpu_torch.parallel import distributed as tdist

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
F, L, OBS_PER, ZFM, ITERS = 6, 240, 3, 300.0, 6


@pytest.fixture(scope="module")
def ring():
    """tests/test_ba_scale.py's ring problem at a small size (the same
    seed in both packages), its measurements with 0.1 px of noise (as
    tests/test_backend.py's problem, so the floor is the noise's cost and
    not float32 roundoff) and perturbed starting poses."""
    R_true, p_true, _, prob = tba.synth_ring_problem(F, L, OBS_PER, ZFM,
                                                     seed=5, device="cpu")
    rng = np.random.RandomState(1)
    O = prob.mx.shape[0]
    prob = prob._replace(
        mx=prob.mx + torch.as_tensor(rng.randn(O).astype(np.float32)) * 0.1,
        my=prob.my + torch.as_tensor(rng.randn(O).astype(np.float32)) * 0.1)
    p0 = (p_true + rng.uniform(-0.05, 0.05, p_true.shape)).astype(
        np.float32)
    return dict(R0=R_true, p0=p0, prob=prob)


def _check_bars(c_one, c_sh, p_one, p_sh):
    """tests/test_backend.py::test_ba_sharded_matches_single_device's bars:
    the initial cost within 1e-5, both floors under 1e-2 of the start and
    within 0.3 of each other, the similarity-aligned poses within 2e-3."""
    np.testing.assert_allclose(c_sh[0], c_one[0], rtol=1e-5)
    assert c_one[-1] < c_one[0] * 0.01
    assert c_sh[-1] < c_sh[0] * 0.01
    np.testing.assert_allclose(c_sh[-1], c_one[-1], rtol=0.3)
    assert ate_rmse(p_sh, p_one) < 2e-3


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_ba_matches_one_process(ring, n):
    """n landmark blocks in this process, their shares summed in block
    order, against ba_solve on the unpartitioned problem."""
    R0, p0 = torch.as_tensor(ring["R0"]), torch.as_tensor(ring["p0"])
    _, p1, _, c1 = tba.ba_solve(R0, p0, ring["prob"], ZFM, iters=ITERS)
    part = tba.partition_problem(ring["prob"], n)
    _, p2, rho2, c2 = tba.ba_solve_sharded(R0, p0, part, ZFM, n_shards=n,
                                           iters=ITERS)
    assert rho2.shape == part.rho.shape
    _check_bars(c1.numpy(), c2.numpy(), p1.numpy(), p2.numpy())


def test_sharded_ba_matches_jax_sharded(ring):
    """The port's 4 in-process blocks against the JAX package's
    ba_solve_sharded on a 4-device CPU mesh, from the same problem."""
    n = 4
    R0, p0 = ring["R0"], ring["p0"]
    part = tba.partition_problem(ring["prob"], n)
    _, p_t, _, c_t = tba.ba_solve_sharded(torch.as_tensor(R0),
                                          torch.as_tensor(p0), part, ZFM,
                                          n_shards=n, iters=ITERS)
    jprob = jba.BAProblem(*[jnp.asarray(x.numpy()) for x in ring["prob"]])
    jpart = jba.partition_problem(jprob, n)
    for x, y in zip(part, jpart):             # the same layout
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    _, p_j, _, c_j = jba.ba_solve_sharded(
        jnp.asarray(R0), jnp.asarray(p0), jpart,
        jnp.asarray(ZFM, jnp.float32), jax_data_mesh(n), iters=ITERS)
    _check_bars(np.asarray(c_j), c_t.numpy(), np.asarray(p_j), p_t.numpy())


def test_sharded_ba_refuses_uneven_blocks(ring):
    with pytest.raises(ValueError, match="partition_problem"):
        tba.ba_solve_sharded(torch.as_tensor(ring["R0"]),
                             torch.as_tensor(ring["p0"]),
                             tba.partition_problem(ring["prob"], 2), ZFM,
                             n_shards=7, iters=1)


@pytest.mark.parametrize("backend, n, match", [
    ("nccl", 1, "one CUDA device per rank"), ("mpi", 1, "backend")])
def test_initialize_refuses(backend, n, match):
    """nccl with more ranks than visible cards, or an unknown backend, is
    refused before any process group starts: no silent switch."""
    n += torch.cuda.device_count()
    with pytest.raises(ValueError, match=match):
        tdist.initialize("127.0.0.1:1", n, 0, backend)


def test_run_multihost_two_gloo_processes(tmp_path):
    """run_multihost --nprocs 2 --batch 2 --iters 4 --check-ba --cpu: two
    workers joined over gloo; the rank-coded all-reduce is right, the
    tiny batched step finite, and the sharded BA's cost trajectory within
    1e-3 of the one-process solve's. The subprocess has its own timeout
    (a hung group must not hang the suite)."""
    out = tmp_path / "scaling.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "rebvo_tpu_torch.apps.run_multihost",
         "--nprocs", "2", "--batch", "2", "--iters", "4", "--check-ba",
         "--cpu", "--timeout", "150", "--out", str(out)],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep == json.loads(out.read_text())
    (pt,) = rep["scaling"]
    assert pt["n_processes"] == 2 and pt["psum_ok"] and pt["pos_finite"]
    assert pt["ba_parity_err"] is not None and pt["ba_parity_err"] < 1e-3
    assert pt["global_fps"] > 0 and rep["backend"] == "gloo"

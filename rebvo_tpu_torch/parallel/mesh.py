"""Device meshes and multi-sequence batching (PyTorch counterpart of
rebvo_tpu/parallel/mesh.py).

The JAX package runs many independent sequences as one program:
`jit(shard_map(vmap(fn)))` over a 1-D ('data',) mesh. Here:

  * a mesh is a list of devices (`data_mesh`);
  * a sharded value is a list with one block per device, each block the
    device's run of the leading (sequence) axis (`shard_batch`;
    `replicate` copies a tree to every device, `gather` joins blocks);
  * `shard_sequences(fn, mesh)` is `torch.func.vmap(fn)` over each
    device's block. The one-sequence function keeps its one body, so a
    batched step equals B independent steps by construction; every op
    in it runs once over the lanes (K1 launches once over [B, H, W],
    kernels/cuda_scale_space.py). On a CUDA device the vmapped call is
    captured once per input signature as one CUDA graph, the analogue
    of the `jax.jit` around `shard_map(vmap(fn))`; on the CPU it runs
    eagerly.

Independent sequences need no communication, so a block never reads
another device's data.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from rebvo_tpu_torch import obs
from rebvo_tpu_torch.graphs import GraphCache, signature, tree_leaves, tree_map

Tensor = torch.Tensor


def data_mesh(n_devices: Optional[int] = None, backend: str = "cuda",
              allow_cpu_fallback: bool = False) -> List[torch.device]:
    """`n_devices` devices of `backend` (default: every CUDA device), in
    index order.

    Raises when fewer CUDA devices are visible than asked: a wrong
    accelerator count must never silently become a smaller mesh or
    another backend. `allow_cpu_fallback=True` opts in to n CPU shards
    instead, with a printed notice; it is meant for dry runs and tests,
    not for measurements. `backend="cpu"` asks for CPU shards."""
    if backend == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if backend != "cuda":
        raise ValueError(f"data_mesh: unknown backend {backend!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n_devices is None else n_devices
    if want > have or want == 0:
        if allow_cpu_fallback:
            n = max(want, 1)
            print(f"data_mesh: {have} CUDA device(s) < {n}; falling back to "
                  f"{n} CPU shards (allow_cpu_fallback=True)")
            return [torch.device("cpu")] * n
        raise ValueError(
            f"requested a {want}-device mesh but only {have} CUDA devices "
            f"are visible; pass allow_cpu_fallback=True to dry-run on CPU "
            f"shards instead")
    return [torch.device("cuda", i) for i in range(want)]


def shard_batch(tree, mesh: Sequence[torch.device]) -> list:
    """Split every leaf's leading axis into len(mesh) equal blocks and put
    block i on mesh[i]: a list of per-device trees."""
    n = len(mesh)
    B = tree_leaves(tree)[0].shape[0]
    if B % n:
        raise ValueError(f"shard_batch: batch {B} does not split evenly "
                         f"over {n} devices")
    per = B // n
    return [tree_map(lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d),
                     tree) for i, d in enumerate(mesh)]


def replicate(tree, mesh: Sequence[torch.device]) -> list:
    """A copy of `tree` on every device of the mesh."""
    return [tree_map(lambda x, d=d: x.to(d), tree) for d in mesh]


def gather(blocks: list):
    """The blocks of a sharded tree joined along the leading axis, on the
    CPU."""
    return tree_map(lambda *xs: torch.cat([x.cpu() for x in xs]), *blocks)


def stack_lanes(tree, n: int):
    """`n` copies of a one-sequence tree stacked on a new leading axis
    (the batched initial state)."""
    return tree_map(lambda a: a.expand((n,) + a.shape).clone(), tree)


def _plain_tuple(x) -> bool:
    """A tuple that is not a NamedTuple: the step's (state, output)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


class _BlockRunner:
    """vmap(fn) on one device's block; on a CUDA device, one CUDA graph
    per input signature (`graphs.GraphCache`), fn's first argument its
    carried state. Each call is one `obs.unit` over the block's lanes,
    numbered by `fn`'s frontend when `fn` is a bound method of one (its
    `frame_id`)."""

    def __init__(self, fn: Callable, device: torch.device):
        self.vfn = torch.func.vmap(fn)
        self.owner = getattr(fn, "__self__", None)
        self.device = device
        self.cache = GraphCache()

    def __call__(self, *args):
        leaves = tree_leaves(args)
        lanes = leaves[0].shape[0] if leaves and isinstance(
            leaves[0], Tensor) else 1
        with obs.unit(self.owner, 1, lanes):
            if self.device.type == "cpu":
                return self.vfn(*args)
            for x in leaves:
                if not isinstance(x, Tensor):
                    raise TypeError(
                        f"shard_sequences: every argument must be a tensor "
                        f"(got {type(x).__name__}); a Python value would "
                        f"be fixed into the CUDA graph at capture")
            # the caller holds clones of the last outputs, so its state is
            # never the static one: every input is copied in
            _, outs = self.cache(signature(args), args[0], args[1:],
                                 lambda st, inputs: self.vfn(st, *inputs),
                                 self._warmup)
            return outs

    def _warmup(self, state, inputs):
        """The state fn returns: alone, or first of a plain tuple."""
        res = self.vfn(state, *inputs)
        return res[0] if _plain_tuple(res) else res


def shard_sequences(fn, mesh: Sequence[torch.device]) -> Callable:
    """`vmap(fn)` over each device's block of the leading axis: the
    wrapper for a batch of independent sequences. `fn` is one function,
    or a list of one per device (a frontend is bound to its device:
    `[VOFrontend(p, device=d).step for d in mesh]`).

    The returned function takes, for each argument of `fn`, a sharded
    value (one block per device, as `shard_batch` gives) and returns the
    same: `fn`'s result per block, or, when `fn` returns a plain tuple
    (the step's (state, output)), a tuple of sharded values. On a CUDA
    device the first call per input signature syncs (it captures the
    graph); every later call copies the inputs into the graph's static
    buffers, replays it and returns clones of its outputs, without a
    host sync. Every argument must be a tensor there; the first is fn's
    carried state, whose static copy takes the layout of the state fn
    returns (`graphs.GraphCache`)."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * len(mesh)
    runners = [_BlockRunner(f, d) for f, d in zip(fns, mesh)]

    def run(*sharded):
        for a in sharded:
            if len(a) != len(runners):
                raise ValueError(f"shard_sequences: expected {len(runners)} "
                                 f"blocks per argument, got {len(a)}")
        outs = [r(*[a[i] for a in sharded]) for i, r in enumerate(runners)]
        if _plain_tuple(outs[0]):
            return tuple(list(x) for x in zip(*outs))
        return outs
    return run

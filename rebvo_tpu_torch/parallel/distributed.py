"""The multi-process layer (PyTorch counterpart of
rebvo_tpu/parallel/distributed.py).

The JAX package joins processes into a `jax.distributed` group whose
devices form one global mesh. Here the group is `torch.distributed`'s:
each rank computes on its own device and holds its own block of every
sharded array, and collectives (`all_reduce` in the sharded BA) sum
across ranks. The backend is the caller's explicit choice:

  * `nccl`: one CUDA device per rank (rank r on cuda:r); refused when
    there are more ranks than visible cards;
  * `gloo`: CPU tensors, and CUDA tensors when the ranks share a card
    (staged through the host: correct, not fast).

There is no silent switch from one to the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rebvo_tpu_torch.graphs import tree_map

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "gloo") -> None:
    """Join the process group: `coordinator_address` is host:port (or a
    tcp:// URL) of rank 0, every rank passes the same `num_processes`
    and its own `process_id`."""
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_processes > have:
            raise ValueError(f"initialize: nccl needs one CUDA device per "
                             f"rank; {num_processes} ranks, {have} visible "
                             f"(gloo carries ranks that share a card)")
        torch.cuda.set_device(process_id)
    url = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def global_data_mesh(device="cpu") -> list:
    """The device of every rank, in rank order: cuda:r under nccl, else
    `device` (ranks under gloo share it)."""
    n = dist.get_world_size()
    if dist.get_backend() == "nccl":
        return [torch.device("cuda", r) for r in range(n)]
    return [torch.device(device)] * n


def host_local_to_global(mesh, tree):
    """This rank's block of a tree sharded along the leading axis: each
    rank holds its own block (the local data), on its mesh device."""
    dev = mesh[dist.get_rank()]
    return tree_map(lambda x: torch.as_tensor(x).to(dev), tree)


def replicate_global(mesh, tree):
    """A tree identical on every rank: rank 0's values, broadcast."""
    dev = mesh[dist.get_rank()]

    def put(x):
        t = torch.as_tensor(x).to(dev).contiguous()
        dist.broadcast(t, src=0)
        return t
    return tree_map(put, tree)


def fetch_replicated(tree):
    """Host (numpy) copy of replicated values."""
    return tree_map(lambda a: a.detach().cpu().numpy(), tree)

"""The CUDA-graph runtime under the step: tree helpers, a graph's capture
and replay, and `GraphCache`, which owns a client's graphs and their
static buffers. Its clients, `frontend/step.VOFrontend.step_scan` and
`parallel/mesh.shard_sequences`, import it; it imports neither. A tree is
a nest of tuples, NamedTuples and lists of tensors (a state, outputs).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from rebvo_tpu_torch import obs


def tree_leaves(tree) -> list:
    """The leaves of a nest of tuples, NamedTuples and lists, in order
    (anything else is a leaf)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, *trees):
    """fn over the leaves of nests of tuples, NamedTuples and lists of
    one structure."""
    t = trees[0]
    if not isinstance(t, (tuple, list)):
        return fn(*trees)
    subs = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t)(*subs) if hasattr(t, "_fields") else type(t)(subs)


def stack_trees(trees):
    """Trees of one structure stacked leaf by leaf on a leading axis, as
    lax.scan stacks its outputs."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def copy_tree_(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst`. A source leaf
    that shares storage with another destination leaf is cloned first,
    so no copy reads a buffer that an earlier copy has overwritten."""
    pairs = [(d, x) for d, x in zip(tree_leaves(dst), tree_leaves(src))
             if d is not x]
    dst_mem = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, x.clone() if x.untyped_storage().data_ptr() in dst_mem
              else x) for d, x in pairs]
    for d, x in pairs:
        d.copy_(x)


def signature(tree) -> tuple:
    """Each leaf's shape and dtype, in order."""
    return tuple((tuple(x.shape), x.dtype) for x in tree_leaves(tree))


def empty_in_layout(tree, device):
    """Uninitialised buffers on `device` with the shapes, dtypes and
    strides of `tree`'s leaves. A leaf that is not dense (vmap expands a
    value that no lane changes: stride 0) takes a contiguous layout."""
    return tree_map(lambda x: torch.empty_like(x, device=device), tree)


class Captured(NamedTuple):
    """A CUDA graph of `capture_graph`."""

    graph: "torch.cuda.CUDAGraph"
    outs: object           # the graph's outputs, rewritten by each replay
    launches: tuple        # (kernel wrapper, its launches per replay)
    stages: tuple          # obs.Timeline of each step captured, in order


def capture_graph(fn, pool, warmup, prepare) -> Captured:
    """`fn()` captured as one CUDA graph in memory pool `pool`, PyTorch's
    recipe: `warmup()` first runs on a side stream (it creates the cuBLAS
    and cuSOLVER handles and loads the kernels; it must leave the graph's
    inputs as they were; its steps record no stage events), then
    `prepare()` on the caller's stream (it makes what the
    graph will read and write across replays, so that no such buffer
    belongs to the side stream), then the
    capture, under the span `graph.capture` (counted in
    `graph.captures`). The outputs are the graph's own tensors, rewritten
    by each replay; launches recorded by the capture are taken off the
    kernel wrappers' counts and listed as (wrapper, launches per replay)
    for `replay_graph` to add back; each captured step's stage events are
    nodes of the graph (`obs.Timeline`)."""
    from rebvo_tpu_torch.kernels.registry import WRAPPERS
    with obs.span("graph.capture"):
        dev = torch.cuda.current_device()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side), obs.quiet():
            warmup()
        main.wait_stream(side)
        prepare()
        before = [w.launches for w in WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        with obs.capture() as stages, torch.cuda.graph(graph, pool=pool):
            outs = fn()
        launches = []
        for w, n0 in zip(WRAPPERS, before):
            launches.append((w, w.launches - n0))
            w.launches = n0
    obs.count("graph.captures")
    return Captured(graph, outs, tuple(launches), tuple(stages))


def replay_graph(g: Captured, copy_in):
    """One call of a graph of `capture_graph`, inside the caller's
    `obs.unit`, in three spans: `copy_in()` (the inputs copied into the
    graph's static buffers) under `graph.copy_in`, the replay under
    `graph.replay` (counted in `graph.replays`, with the graph's kernel
    launches), and clones of the outputs, returned, under
    `graph.clone_out`. The captured steps' stage times are read when the
    next unit opens (`obs.replayed`)."""
    with obs.span("graph.copy_in"):
        copy_in()
    with obs.span("graph.replay"):
        g.graph.replay()
        for w, n in g.launches:
            w.launches += n
        obs.count("graph.replays")
    obs.replayed(g.stages)
    with obs.span("graph.clone_out"):
        return tree_map(torch.clone, g.outs)


class GraphCache:
    """One client's CUDA graphs, by the key it gives (its input signature),
    in one memory pool, with their static buffers: each graph's inputs,
    made at its capture, and the carried states, one per state signature.

    `cache(key, state, inputs, run, warmup)` captures `run(static_state,
    static_inputs)` at the first call for `key`, then replays it: it
    copies `inputs` in, and `state` unless it is the static state, and
    returns (the static state, clones of `run`'s outputs), on the device
    of the state's leaves. `run` may carry the state in place (it copies
    the new state into the static one) or return it among its outputs.

    The capture first runs `warmup(clone of state, static_inputs)`, which
    returns the state after a step or two; the static state takes that
    state's layout, not the caller's. A step returns some leaves in
    another layout than its input had (the VI filter's inverses,
    `imu.P7` and `imu.W_Bg`, come back column-major), and a kernel baked
    for one layout can round otherwise than the one an eager step picks
    for the other (cuBLAS's 7x7 `F @ P @ F.T`, an ulp apart), so the
    graph's first step must read its state as every later step does. A
    warm-up that returns no state of the state's signature leaves the
    caller's layout."""

    def __init__(self):
        # key -> (Captured, its static inputs, its static state)
        self.graphs: Dict[tuple, tuple] = {}
        self.states: Dict[tuple, object] = {}
        self.pool = None

    def __call__(self, key, state, inputs, run: Callable,
                 warmup: Callable):
        device = tree_leaves(state)[0].device
        with torch.cuda.device(device):
            if key not in self.graphs:
                self.graphs[key] = self._capture(state, inputs, run, warmup,
                                                 device)
            cap, static_in, static = self.graphs[key]

            def copy_in():
                copy_tree_(static_in, inputs)
                if state is not static:
                    copy_tree_(static, state)

            return static, replay_graph(cap, copy_in)

    def _capture(self, state, inputs, run, warmup, device) -> tuple:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        sig = signature(state)
        static_in = tree_map(lambda x: x.to(device, copy=True), inputs)
        warm = []

        def prepare():
            st = warm.pop()
            if sig not in self.states:
                self.states[sig] = empty_in_layout(
                    st if signature(st) == sig else state, device)

        cap = capture_graph(
            lambda: run(self.states[sig], static_in), self.pool,
            lambda: warm.append(warmup(tree_map(torch.clone, state),
                                       static_in)), prepare)
        return cap, static_in, self.states[sig]

"""The port's CUDA-graph runtime (`rebvo_tpu_torch/graphs.py`) on the
CPU: the tree copy that the graphs' static buffers take their inputs
through, the allocator of those buffers, and the layering that keeps the
runtime beneath its clients. The graphs themselves run on the card only
(tests/test_torch_vi_scan.py, marked `card`, and chip_smoke.py)."""

import ast
from pathlib import Path

import torch

from rebvo_tpu_torch.config import REBVOParameters
from rebvo_tpu_torch.frontend.step import ImuCarry
from rebvo_tpu_torch.graphs import copy_tree_, empty_in_layout, tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def test_copy_tree_clones_a_source_that_aliases_a_destination():
    """Sources that are each other's destinations (a swap, and a view of
    a destination leaf) are read before any copy writes them."""
    a = torch.arange(4.0)
    b = torch.arange(4.0) + 10
    c = torch.zeros(2)
    dst = (a, (b, c))
    src = (b, (a, a[1:3]))
    want = [b.clone(), a.clone(), a[1:3].clone()]
    copy_tree_(dst, src)
    for got, w in zip((a, b, c), want):
        assert torch.equal(got, w)


def test_empty_in_layout_keeps_every_leaf_layout():
    """Every leaf of a layout tree comes back with its shape, dtype and
    strides: a column-major [7,7] leaf like `imu.P7`, a transposed
    integer image, a scalar, a bool, a nest of NamedTuple and list; a
    leaf that is not dense (stride 0, as vmap expands a value no lane
    changes) comes back contiguous, so a copy into it is well defined."""
    imu = ImuCarry.make(REBVOParameters(), device="cpu")
    imu = imu._replace(P7=imu.P7.T.contiguous().T,
                       W_Bg=imu.W_Bg.T.contiguous().T)
    tree = (imu, [torch.zeros((5, 4), dtype=torch.int32).T,
                  torch.ones(()), torch.zeros(3, dtype=torch.bool)])
    assert imu.P7.stride() == (1, 7)
    back = empty_in_layout(tree, torch.device("cpu"))
    assert type(back[0]) is ImuCarry and isinstance(back[1], list)
    leaves_in, leaves_out = tree_leaves(tree), tree_leaves(back)
    assert len(leaves_in) == len(leaves_out) > 14
    for x, y in zip(leaves_in, leaves_out):
        assert (y.shape, y.dtype, y.stride(), y.device) == \
            (x.shape, x.dtype, x.stride(), x.device)
    wide = empty_in_layout([torch.zeros(3).expand(4, 3)], torch.device("cpu"))
    assert wide[0].shape == (4, 3) and wide[0].stride() == (3, 1)


def test_parallel_imports_nothing_of_the_frontend():
    """No module under rebvo_tpu_torch/parallel/ imports
    rebvo_tpu_torch.frontend, even lazily inside a function: the graph
    runtime they share lives beneath both."""
    bad = {}
    for path in sorted((ROOT / "rebvo_tpu_torch" / "parallel").rglob(
            "*.py")):
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # a relative import, resolved from rebvo_tpu_torch.parallel
                base = ".".join(["rebvo_tpu_torch", "parallel"][
                    :3 - node.level] + ([node.module] if node.module else [])
                ) if node.level else node.module
                names.append(base)
                names += [f"{base}.{a.name}" for a in node.names]
        hits = [n for n in names
                if n == "rebvo_tpu_torch.frontend"
                or n.startswith("rebvo_tpu_torch.frontend.")]
        if hits:
            bad[path.name] = hits
    assert not bad

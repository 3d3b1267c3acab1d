"""Runtime utilities: checkpoint/resume (PyTorch counterpart of
rebvo_tpu/runtime_utils.py).

Checkpointing covers the FULL VO state (keyline arrays, filter states,
pose), enabling true mid-run resume — a capability the reference lacks
(SURVEY.md §5: 'There is no mid-run resume of filter state'). The npz
keys are the JAX package's (each leaf's field names joined by "/", e.g.
"klm/rho" or "imu/windows/count"), so a checkpoint written by either
package loads into the other. The per-stage timing channel the
reference exposes via TIME_DEBUG + dtp0/dtp1 (rebvo.h:54-60,
rebvo_third_t.cpp:303-305) is `rebvo_tpu_torch.obs`: host spans, device
stage times and counters, dumped as a Chrome trace by
`run_vo --trace-out`.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Checkpoint / resume of NamedTuple state trees
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    """(path, tensor) for every leaf of a NamedTuple / tuple / dict tree,
    the path as the JAX package's tree paths name it."""
    if isinstance(tree, torch.Tensor):
        yield "/".join(prefix), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(prefix)} is "
                        f"{type(tree).__name__}, not a tensor")


def save_state(path: str, state) -> None:
    """Serialise a state tree of tensors to npz, keyed by tree path."""
    np.savez_compressed(path, **{
        k: v.detach().cpu().numpy() for k, v in _leaves(state)})


def _rebuild(tree, vals, prefix=()):
    if isinstance(tree, torch.Tensor):
        return vals["/".join(prefix)]
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], vals, prefix + (str(k),))
                for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, k), vals, prefix + (k,))
                            for k in tree._fields])
    return type(tree)(_rebuild(v, vals, prefix + (str(i),))
                      for i, v in enumerate(tree))


def load_state(path: str, template):
    """Restore a tree saved by save_state (either package's) into
    `template`'s structure, dtypes and devices."""
    z = np.load(path)
    vals = {}
    for key, tmpl in _leaves(template):
        if key not in z.files:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = z[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint leaf {key} shape {arr.shape} != "
                f"{tuple(tmpl.shape)}")
        vals[key] = torch.as_tensor(arr).to(dtype=tmpl.dtype,
                                            device=tmpl.device)
    return _rebuild(template, vals)

"""Array checkpointing for long batched runs.

The reference persists *models* to HDF5 (savePowerSystem/saveMeasurement,
powerSystem/save.jl, measurement/save.jl) but has no notion of resuming a
long computation — its studies are single solves. Here the unit of work is
a Monte-Carlo fleet: thousands of scenarios solved in device-sized chunks
over minutes to hours (SURVEY §5, checkpoint/resume row). A preempted
job must not lose the completed chunks, so the chunk loop checkpoints
results to disk and a restart resumes at the first missing chunk.

Design: plain HDF5 with atomic replace (write ``path.tmp``, ``os.replace``)
— crash-safe on POSIX, no partial files ever visible. Pytrees of array
leaves (dict/list/tuple nests) round-trip losslessly; tensors are brought
to the host once at save time (results, not live solver state). The
layout (``step``, ``meta_*`` attributes, a ``tree`` group) is the JAX
package's, so a file written by either package reads back in the other.
The functions import ``h5py`` when they run: a machine without it (the
card's) can import the module but not checkpoint.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


def _write_node(grp, key, node):
    import h5py  # local import: keep module import light

    if isinstance(node, dict):
        sub = grp.create_group(key)
        sub.attrs["kind"] = "dict"
        for k, v in node.items():
            _write_node(sub, str(k), v)
    elif isinstance(node, (list, tuple)):
        sub = grp.create_group(key)
        sub.attrs["kind"] = "list" if isinstance(node, list) else "tuple"
        for i, v in enumerate(node):
            _write_node(sub, str(i), v)
    elif isinstance(node, torch.Tensor):
        grp.create_dataset(key, data=node.detach().cpu().numpy())
    else:
        grp.create_dataset(key, data=np.asarray(node))


def _read_node(node):
    import h5py

    if isinstance(node, h5py.Dataset):
        val = node[()]
        return val
    kind = node.attrs.get("kind", "dict")
    if kind == "dict":
        return {k: _read_node(node[k]) for k in node}
    items = [_read_node(node[str(i)]) for i in range(len(node))]
    return items if kind == "list" else tuple(items)


def save_checkpoint(path: str, tree, step: int = 0, meta: Optional[dict] = None):
    """Atomically write a pytree of arrays (+ step counter and string/number
    metadata) to ``path``."""
    import h5py

    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.attrs["step"] = int(step)
        for k, v in (meta or {}).items():
            f.attrs["meta_" + k] = v
        _write_node(f, "tree", tree)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Read a checkpoint. Returns ``(step, tree, meta)`` or ``None`` if the
    file does not exist."""
    import h5py

    if not os.path.exists(path):
        return None
    with h5py.File(path, "r") as f:
        step = int(f.attrs["step"])
        meta = {k[5:]: f.attrs[k] for k in f.attrs if k.startswith("meta_")}
        tree = _read_node(f["tree"])
    return step, tree, meta


def checkpointed_map(fn: Callable, n_items: int, chunk: int, path: str,
                     every: int = 1):
    """Run ``fn(start, stop)`` over ``[0, n_items)`` in ``chunk``-sized
    slices, checkpointing completed results to ``path`` every ``every``
    chunks. On restart with the same arguments, completed chunks are NOT
    recomputed — the loop resumes at the first missing slice.

    ``fn`` must return a pytree of arrays for its slice (e.g. the
    ``(vm, va, iterations, converged)`` of a batched SE chunk). Returns
    the list of per-chunk results in slice order. The final state is
    always flushed, so a completed run leaves a checkpoint holding every
    chunk; delete ``path`` to force a fresh run.
    """
    starts = list(range(0, n_items, chunk))
    done: dict = {}
    loaded = load_checkpoint(path)
    if loaded is not None:
        _, tree, meta = loaded
        if int(meta.get("n_items", n_items)) != n_items or \
                int(meta.get("chunk", chunk)) != chunk:
            raise ValueError(
                f"checkpoint {path} was written for n_items="
                f"{meta.get('n_items')}, chunk={meta.get('chunk')}; "
                f"refusing to resume a different slicing — delete it or "
                f"use a fresh path")
        done = dict(tree)

    pending = [s for s in starts if str(s) not in done]
    since_flush = 0
    for s in pending:
        done[str(s)] = fn(s, min(s + chunk, n_items))
        since_flush += 1
        if since_flush >= every:
            save_checkpoint(path, done, step=len(done),
                            meta={"n_items": n_items, "chunk": chunk})
            since_flush = 0
    if since_flush or not pending:
        save_checkpoint(path, done, step=len(done),
                        meta={"n_items": n_items, "chunk": chunk})
    return [done[str(s)] for s in starts]

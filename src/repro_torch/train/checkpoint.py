"""Tree checkpointing: npz blobs + a JSON manifest (port of
``repro.train.checkpoint``, same layout).

Layout:  <dir>/<name>.npz   flat arrays keyed by tree path
         <dir>/<name>.json  keys + shapes/dtypes + user metadata

A tree is any nesting of dicts, NamedTuples, tuples and lists whose leaves
are tensors, numpy arrays or Python numbers; ``None`` leaves are skipped.
Tensors are saved through ``.cpu().numpy()`` (a bfloat16 one as float32,
which holds it exactly) and come back on the device and in the dtype of
the matching leaf of the ``like`` tree; numbers come back as the ``like``
leaf's Python type.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree`` in a fixed order: dict keys sorted,
    NamedTuple fields and sequence items in order."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str  # noqa: E731
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], join(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _items(getattr(tree, k), join(k))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _items(x, join(i))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            # numpy has no bfloat16: stored as float32 (exact), cast back to
            # the ``like`` leaf's dtype on restore, as the reference does
            leaf = leaf.to(torch.float32)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _rebuild(like, data, prefix: str = ""):
    join = (lambda k: f"{prefix}/{k}") if prefix else str  # noqa: E731
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], data, join(k)) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, k), data, join(k))
                            for k in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, data, join(i)) for i, x in enumerate(like))
    arr = data[prefix]
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(dtype=like.dtype, device=like.device)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def save_checkpoint(directory: str, name: str, tree,
                    metadata: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _items(tree)}
    npz_path = os.path.join(directory, f"{name}.npz")
    np.savez(npz_path, **flat)
    manifest = {
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(directory, f"{name}.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return npz_path


def restore_checkpoint(directory: str, name: str, like) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (shapes must match)."""
    with open(os.path.join(directory, f"{name}.json")) as f:
        manifest = json.load(f)
    like_keys = sorted(k for k, _ in _items(like))
    if like_keys != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(like_keys)
        raise ValueError(f"checkpoint structure mismatch: {sorted(missing)[:5]} ...")
    with np.load(os.path.join(directory, f"{name}.npz")) as npz:
        data = {k: npz[k] for k in npz.files}
    for k, leaf in _items(like):
        if tuple(data[k].shape) != tuple(np.shape(_to_numpy(leaf))):
            raise ValueError(f"checkpoint leaf {k} has shape {data[k].shape}, "
                             f"expected {tuple(np.shape(_to_numpy(leaf)))}")
    return _rebuild(like, data), manifest["metadata"]


def load_metadata(directory: str, name: str) -> Dict:
    """Read a checkpoint's user metadata without touching the arrays."""
    with open(os.path.join(directory, f"{name}.json")) as f:
        return json.load(f)["metadata"]


# ---------------------------------------------------------------------------
# dynamic-experiment snapshots (chaos transport crash-exact resume)
# ---------------------------------------------------------------------------
# One snapshot = the dynamic round loop's full carry (per-node models and
# momentum, the WFAgg-T ring buffers, the transport delivery ring and
# served-lag table, the previous round's slate, and the round counter —
# every per-round random stream (batches, attack noise, the corrupt bank)
# is seeded from that counter, so no generator state needs saving) PLUS
# the in-flight topology and fault schedule stacks.  Restoring both and
# re-entering the loop at the recorded round reproduces the uninterrupted
# trajectory bit-exactly; see repro_torch.dfl.engine.run_dynamic_experiment.

def save_experiment_checkpoint(directory: str, name: str, carry, sched,
                               metadata: Optional[Dict] = None) -> str:
    """Snapshot a dynamic experiment mid-run.

    ``carry`` is what the round loop carries between rounds; ``sched`` the
    tuple of full schedule stacks (topology + faults).  ``metadata`` must
    include ``round`` — the number of rounds already run, i.e. where the
    resumed loop re-enters.
    """
    if not metadata or "round" not in metadata:
        raise ValueError("experiment checkpoints need metadata['round'] "
                         "(rounds already run) to know where to resume")
    return save_checkpoint(directory, name,
                           {"carry": carry, "sched": list(sched)}, metadata)


def restore_experiment_checkpoint(directory: str, name: str,
                                  like_carry, like_sched
                                  ) -> Tuple[Any, tuple, Dict]:
    """Inverse of ``save_experiment_checkpoint``.

    Returns ``(carry, sched, metadata)`` restored into the structures of
    ``like_carry`` / ``like_sched`` (build both from the same config and
    schedules that produced the snapshot)."""
    tree, meta = restore_checkpoint(
        directory, name, {"carry": like_carry, "sched": list(like_sched)})
    return tree["carry"], tuple(tree["sched"]), meta

"""Checkpointing: a tree of tensors <-> one ``.npz`` (counterpart of
``repro/checkpoint/io.py``).

A tree is a nested dict, list or tuple whose leaves are tensors; a None
holds no leaf (as in the reference's trees).  Each leaf is stored under
its path, its keys and indices joined by "/"
(``server/params/downs.0.res.0.conv1.weight``; a list's entries by index),
as the reference names them, so either package reads the other's files.  ``__meta__`` is a JSON string with ``step``, ``keys`` (the leaves
in the tree's order, dict keys sorted as the reference's tree order sorts
them), ``treedef`` (the structure, every leaf written as ``"*"``) and
``dtypes`` (each leaf's dtype name).  Files are read with
``allow_pickle=False``.

Dtypes: every dtype numpy has round-trips bitwise (float32, int32, int64,
bool, ...).  bfloat16 is not a numpy dtype: its raw 16 bits are stored as
uint16 and ``dtypes`` names it ``bfloat16``, so the port reads it back
bitwise; the reference reads such a leaf as uint16.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

META = "__meta__"


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(node):
    """(key, child) pairs in tree order: a dict's keys sorted, a list's or
    tuple's by index."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node, key=str)]
    return [(str(i), v) for i, v in enumerate(node)]


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/0": leaf} in tree order."""
    if tree is None:
        return {}
    if not _is_node(tree):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in _children(tree):
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in _children(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None if tree is None else "*"


def _to_numpy(leaf: torch.Tensor):
    """(array, dtype name) of a leaf; bfloat16 as its raw bits."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_checkpoint(path: str, tree: Any, *,
                    step: Optional[int] = None) -> None:
    """Write ``tree`` to ``path`` (".npz" added when absent), with
    ``step`` in its metadata."""
    path = _npz(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in _flatten(tree).items():
        arrays[key], dtypes[key] = _to_numpy(leaf)
    if META in arrays:
        raise ValueError(f"a leaf may not be named {META!r}")
    meta = {"treedef": json.dumps(_structure(tree)), "step": step,
            "keys": list(arrays), "dtypes": dtypes}
    np.savez(path, **{META: json.dumps(meta)}, **arrays)


def _read_meta(data) -> dict:
    return json.loads(str(data[META]))


def restore_checkpoint(path: str, like: Any):
    """Read ``path`` (".npz" added when absent) into the structure of
    ``like``: each leaf takes ``like``'s leaf dtype and device.  Raises
    ``KeyError`` naming the first leaf of ``like`` the file lacks."""
    with np.load(_npz(path), allow_pickle=False) as data:
        dtypes = _read_meta(data).get("dtypes", {})
        restored = {}
        for key, leaf in _flatten(like).items():
            if key not in data.files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            restored[key] = _from_numpy(data[key], dtypes.get(key), leaf)
    return _unflatten(like, restored)


def _from_numpy(a: np.ndarray, stored: Optional[str],
                like_leaf: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a)
    if stored == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=like_leaf.device, dtype=like_leaf.dtype)


def _unflatten(like, flat: Dict[str, Any], prefix: str = ""):
    if like is None:
        return None
    if not _is_node(like):
        return flat[prefix]

    def sub(k):
        return f"{prefix}/{k}" if prefix else k
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, sub(str(k))) for k, v in like.items()}
    out = [_unflatten(v, flat, sub(str(i))) for i, v in enumerate(like)]
    return tuple(out) if isinstance(like, tuple) else out


def checkpoint_step(path: str) -> Optional[int]:
    """The ``step`` saved with ``path`` (".npz" added when absent); None
    when the file does not exist."""
    path = _npz(path)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        return _read_meta(data).get("step")

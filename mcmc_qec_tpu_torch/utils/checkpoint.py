"""Exact checkpoint/resume of sampler state.

Counterpart of ``mcmc_qec_tpu/utils/checkpoint.py`` without
``jax.tree_util``: a tree of nested dicts, lists, tuples (named tuples
included) and leaves (torch tensors, numpy arrays, Python scalars) is
flattened here, dict keys in sorted order and ``None`` as an empty subtree
(``jax.tree_util``'s order), into one ``.npz`` holding ``leaf_i`` and a
JSON ``meta``, replaced atomically; the caller's ``like`` gives the
structure back on load.  Tensors are
saved through ``.cpu().numpy()``; ``load_pytree`` gives each leaf back in
the form of the matching leaf of ``like`` (a tensor on its device and of
its dtype, else a numpy array), so a preempted run resumes exactly.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List[Any]) -> None:
    """Append ``tree``'s leaves to ``leaves`` in traversal order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], leaves)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, leaves)
    else:
        leaves.append(tree)


def _unflatten(like: Any, leaves) -> Any:
    """The tree of ``like``'s structure holding the next leaves."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(x, leaves) for x in like]
        if _is_namedtuple(like):
            return type(like)(*items)
        return type(like)(items)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    return arr


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any, meta: Dict[str, Any] | None = None) -> None:
    leaves: List[Any] = []
    _flatten(tree, leaves)
    payload = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    payload["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp + ".npz", path)


def load_pytree(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore a tree saved by ``save_pytree``; ``like`` provides the
    structure and each leaf's form (its leaf values are ignored)."""
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
    want: List[Any] = []
    _flatten(like, want)
    if len(want) != n:
        raise ValueError(f"{path} holds {n} leaves; the structure given has "
                         f"{len(want)}")
    return _unflatten(like, iter(leaves)), meta


class CheckpointManager:
    """Rolling checkpointer with a keep-last-k policy."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:012d}.npz")

    def save(self, step: int, tree: Any, meta: Dict[str, Any] | None = None) -> str:
        p = self.path(step)
        save_pytree(p, tree, {**(meta or {}), "step": step})
        self._gc()
        return p

    def _snapshots(self) -> List[str]:
        """Finished snapshots, oldest first.  A save cut short leaves its
        ``ckpt_<step>.npz.tmp.npz`` behind, which is never one of them."""
        return sorted(
            f for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and not f.endswith(".tmp.npz")
        )

    def latest(self) -> str | None:
        ckpts = self._snapshots()
        return os.path.join(self.directory, ckpts[-1]) if ckpts else None

    def restore_latest(self, like: Any):
        p = self.latest()
        if p is None:
            return None, None
        return load_pytree(p, like)

    def _gc(self) -> None:
        for f in self._snapshots()[: -self.keep]:
            os.remove(os.path.join(self.directory, f))

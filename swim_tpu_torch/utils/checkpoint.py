"""Checkpoint / resume of a tree of tensors on one device (port of
`save_placed` / `restore_placed` and `CheckpointManager` of
`swim_tpu/utils/checkpoint.py`).

Per-period randomness is derived from (root key, step), so a checkpoint
is the tree's arrays plus the root key (the port's (k0, k1) threefry
pair) and the step: resuming reproduces the uninterrupted trajectory.
A tree is nested tuples (NamedTuples included) whose leaves are torch
tensors, numpy arrays or None.  One `.npz` holds a leaf per entry; the
write goes to a temporary file first, so a crash never leaves a torn
checkpoint.  On one device a tree's leaves are whole arrays, so
`save_placed` writes the reference's `save` layout (`leaf_<i>`,
`__key_data`, `__step`); `CheckpointManager` rotates every-K-period
snapshots of it.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return x is None or not isinstance(x, (tuple, list))


def _flatten(tree: Any) -> list:
    if _is_leaf(tree):
        return [tree]
    return [leaf for sub in tree for leaf in _flatten(sub)]


def _unflatten(like: Any, leaves) -> Any:
    if _is_leaf(like):
        return next(leaves)
    kids = [_unflatten(sub, leaves) for sub in like]
    if isinstance(like, list):
        return kids
    return type(like)(*kids) if hasattr(like, "_fields") else tuple(kids)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_placed(path: str, tree: Any, root_key: tuple[int, int],
                step: int) -> None:
    """Write `tree`'s leaves, the root key and the step to `path`."""
    payload = {"__key_data": np.asarray(root_key, np.uint32),
               "__step": np.asarray(step, np.int64)}
    for i, x in enumerate(_flatten(tree)):
        payload[f"leaf_{i}"] = _host(x)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _restore_leaf(arr: np.ndarray, like) -> Any:
    """A None `like` takes the host array as it is; a tensor `like`
    gives a tensor of its dtype and shape on its device."""
    if like is None:
        return arr
    want = (torch.empty(0, dtype=like.dtype).numpy().dtype
            if isinstance(like, torch.Tensor) else np.asarray(like).dtype)
    if arr.dtype != want:
        raise ValueError(f"dtype mismatch: {arr.dtype} vs {want}")
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch: {arr.shape} vs "
                         f"{tuple(like.shape)} (checkpoint from a "
                         "different config?)")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def restore_placed(path: str, like: Any
                   ) -> tuple[Any, tuple[int, int], int]:
    """(tree, root_key, step).  `like` supplies the structure and, for
    each tensor leaf, its dtype, shape and device; a None leaf comes
    back as the saved host array."""
    leaves_like = _flatten(like)
    with np.load(path) as z:
        n_saved = sum(1 for k in z.files if k.startswith("leaf_"))
        if n_saved != len(leaves_like):
            raise ValueError(
                "checkpoint layout does not match the provided state "
                "structure (different config or engine?)")
        leaves = [_restore_leaf(z[f"leaf_{i}"], lk)
                  for i, lk in enumerate(leaves_like)]
        key = tuple(int(v) for v in z["__key_data"])
        step = int(z["__step"])
    return _unflatten(like, iter(leaves)), key, step


class CheckpointManager:
    """Every-K-period snapshots with bounded retention."""

    def __init__(self, directory: str, every: int, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, state: Any, root_key: tuple[int, int],
                   step: int) -> bool:
        if step == 0 or step % self.every:
            return False
        save_placed(os.path.join(self.directory, f"ckpt_{step:012d}.npz"),
                    state, root_key, step)
        self._gc()
        return True

    def _snaps(self) -> list[str]:
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("ckpt_") and f.endswith(".npz"))

    def latest(self) -> str | None:
        snaps = self._snaps()
        return os.path.join(self.directory, snaps[-1]) if snaps else None

    def _gc(self) -> None:
        for f in self._snaps()[:-self.keep]:
            os.remove(os.path.join(self.directory, f))

"""Checkpoint / resume of a tree of tensors on one device (port of
`save_placed` / `restore_placed` and `CheckpointManager` of
`swim_tpu/utils/checkpoint.py`).

Per-period randomness is derived from (root key, step), so a checkpoint
is the tree's arrays plus the root key (the port's (k0, k1) threefry
pair) and the step: resuming reproduces the uninterrupted trajectory.
A tree is nested tuples (NamedTuples included) whose leaves are torch
tensors, numpy arrays or None.  One `.npz` holds a leaf per entry; the
write goes to a temporary file first, so a crash never leaves a torn
checkpoint.  A whole leaf (one device) is stored as the reference's
`save` layout stores it (`leaf_<i>`); a placed leaf (a
parallel/mesh.py `Sharded`, the sharded engine's) as the reference's
`save_placed` stores it: one part per distinct shard in shard order
(`leaf_<i>_part_<j>`, with its [ndim, 2] index range in
`leaf_<i>_idx_<j>`), a replicated leaf as one part.  `restore_placed`
gives each leaf back as `like`'s is: a placed leaf block by block on
its shards' devices (from whole or differently split parts, stitched
first), a whole one stitched.  The root key and step are `__key_data`
and `__step`; `CheckpointManager` rotates every-K-period snapshots.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from swim_tpu_torch.parallel import mesh as pmesh


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


def _ranges(x: pmesh.Sharded) -> list[np.ndarray]:
    """The index range [ndim, 2] of each block of a placed leaf, in
    shard order (every block of a replicated leaf spans all of it)."""
    shape = x.shape
    out, lo = [], 0
    for blk in x.blocks:
        rng = np.asarray([[0, d] for d in shape],
                         np.int64).reshape(len(shape), 2)
        if x.axis is not None:
            hi = lo + blk.shape[x.axis]
            rng[x.axis] = (lo, hi)
            lo = hi
        out.append(rng)
    return out


def _parts(x: pmesh.Sharded) -> list[tuple[np.ndarray, np.ndarray]]:
    """(index range, host block) per distinct shard of a placed leaf, in
    shard order; a replicated leaf is one part."""
    pairs = list(zip(_ranges(x), x.blocks))
    if x.axis is None:
        pairs = pairs[:1]
    return [(rng, _host(blk)) for rng, blk in pairs]


def save_placed(path: str, tree: Any, root_key: tuple[int, int],
                step: int) -> None:
    """Write `tree`'s leaves (whole or placed), the root key and the
    step to `path`."""
    payload = {"__key_data": np.asarray(root_key, np.uint32),
               "__step": np.asarray(step, np.int64)}
    for i, x in enumerate(_flatten(tree)):
        if isinstance(x, pmesh.Sharded):
            for j, (rng, blk) in enumerate(_parts(x)):
                payload[f"leaf_{i}_idx_{j}"] = rng
                payload[f"leaf_{i}_part_{j}"] = blk
        else:
            payload[f"leaf_{i}"] = _host(x)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _stitch(parts: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """One host array from its parts by their index ranges."""
    shape = tuple(int(m) for m in
                  np.max(np.stack([r[:, 1] for r, _ in parts]), axis=0)) \
        if parts[0][0].size else ()
    out = np.empty(shape, parts[0][1].dtype)
    for rng, blk in parts:
        out[tuple(slice(int(a), int(b)) for a, b in rng)] = blk
    return out


def _restore_placed_leaf(parts: list, like: pmesh.Sharded) -> pmesh.Sharded:
    """A placed leaf like `like`: the saved blocks on its shards'
    devices when their ranges are like's, else the stitched array split
    as like is split."""
    saved = {rng.tobytes(): blk for rng, blk in parts}
    ranges = _ranges(like)
    if all(r.tobytes() in saved for r in ranges):
        arrs = [saved[r.tobytes()] for r in ranges]
    else:
        whole = _stitch(parts)
        arrs = [whole[tuple(slice(int(a), int(b)) for a, b in r)]
                for r in ranges]
    return pmesh.Sharded([_restore_leaf(np.array(a), b)
                          for a, b in zip(arrs, like.blocks)], like.axis)


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
    each tensor leaf, its dtype, shape and device (for a placed leaf,
    its split and its shards' devices); a None leaf comes back as the
    saved host array."""
    leaves_like = _flatten(like)
    with np.load(path) as z:
        nparts: dict[int, int] = {}
        for k in z.files:
            m = re.fullmatch(r"leaf_(\d+)(?:_part_(\d+))?", k)
            if m:
                i = int(m.group(1))
                j = int(m.group(2)) + 1 if m.group(2) is not None else 0
                nparts[i] = max(nparts.get(i, 0), j)
        if len(nparts) != len(leaves_like):
            raise ValueError(
                "checkpoint layout does not match the provided state "
                "structure (different config or engine?)")
        leaves = []
        for i, lk in enumerate(leaves_like):
            if nparts[i]:
                parts = [(z[f"leaf_{i}_idx_{j}"], z[f"leaf_{i}_part_{j}"])
                         for j in range(nparts[i])]
            else:
                arr = z[f"leaf_{i}"]
                parts = [(np.asarray([[0, d] for d in arr.shape],
                                     np.int64).reshape(arr.ndim, 2), arr)]
            if isinstance(lk, pmesh.Sharded):
                leaves.append(_restore_placed_leaf(parts, lk))
            else:
                leaves.append(_restore_leaf(_stitch(parts), lk))
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

"""Scatters and compaction without a host sync, shared by the engines.

The reference writes with `.at[idx].set(..., mode="drop")` and compacts
with `jnp.nonzero(size=..., fill_value=...)`.  PyTorch has no drop mode,
and `torch.nonzero` waits for the card to learn its output size, so:

  * `set_drop` sends out-of-range entries to a spare row that is cut
    off afterwards, `scatter_max` to the max's identity;
  * `first_true` scatters each True entry's index to its cumsum
    position in a buffer prefilled with the fill value (the surplus
    goes to a spare slot).

Callers keep the valid indices of a `set_drop` distinct, so every
result is deterministic.  Under `torch.func.vmap` (a batched study) an
in-place write needs a destination that carries the lane axis when its
values do: `set_drop` callers pass one (a fresh buffer made `_like` a
lane-carrying tensor), and `scatter_max` and `first_true`, whose
destination may be fresh, write out of place.
"""
from __future__ import annotations

import torch

from swim_tpu_torch.ops import u32


def set_drop(dst: torch.Tensor, idx: torch.Tensor, val, col=None):
    """dst[idx] = val (dst[idx, col] = val with `col`), dropping entries
    whose idx lies outside [0, len(dst)).  A Python `val` is filled into
    a tensor on dst's device first: PyTorch makes the value of
    `t[i] = scalar` on the host for a CUDA `t` and copies it over, which
    waits for the card."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    if not isinstance(val, torch.Tensor):
        val = torch.full((), val, dtype=dst.dtype, device=dst.device)
    i = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
    ix = (i,) if col is None else (i, col.to(torch.int64))
    return ext.index_put_(ix, val)[:n]


def scatter_max(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                unsigned: bool) -> torch.Tensor:
    """dst[idx] <- max(dst[idx], val) (a new tensor; u32 order on the
    carriers when `unsigned`); idx outside [0, len(dst)) drops (it adds
    the max identity at 0)."""
    valid = (idx >= 0) & (idx < dst.shape[0])
    v = u32.flip(val) if unsigned else val
    v = torch.where(valid, v, u32.SIGN)
    d = u32.flip(dst) if unsigned else dst
    d = d.scatter_reduce(0, torch.where(valid, idx, 0).to(torch.int64), v,
                         "amax")
    return u32.flip(d) if unsigned else d


def first_true(valid: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int32[size]: the ascending indices of the first `size` True
    entries of a 1-D bool vector, the rest `fill` (the reference's
    `jnp.nonzero(valid, size=size, fill_value=fill)`)."""
    m = valid.shape[0]
    pos = valid.to(torch.int32).cumsum(0, dtype=torch.int32) - 1
    slot = torch.where(valid & (pos < size), pos, size).to(torch.int64)
    buf = torch.full((size + 1,), fill, dtype=torch.int32,
                     device=valid.device)
    return buf.scatter(0, slot, torch.arange(m, dtype=torch.int32,
                                             device=valid.device))[:size]

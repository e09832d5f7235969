"""First-B piggyback selection (port of `swim_tpu/ops/selb.py`).

`select_first_b(win_masked, b)`: the mask of the first `b` set bits of
each node's window row, newest word (last column) first, LSB first
within a word.  A CUDA tensor goes to the hand-written kernel
(csrc/selb.cu, replacing the TPU kernel `_first_b_math` of
swim_tpu/ops/selb.py; bound by bytes: one read and one write of the
[N, WW] window, 96 MB at the 1M-node slice).  A block stages 128 rows
through shared memory with coalesced 16-byte loads and stores, at an
odd row stride free of bank conflicts; one thread per row walks its
words newest first with a running budget and cuts the overflowing word
at its budget-th set bit by a popcount binary ascent.  WW and b are
runtime arguments.  A CPU tensor goes to `select_first_b_plain`, the
budgeted extract loop of the reference's `_lax_twin`.  Any other device
raises; nothing falls back.
"""
from __future__ import annotations

import threading

import torch

from swim_tpu_torch import _kernels
from swim_tpu_torch.ops import u32

WORD = 32
launches = 0
_launch_lock = threading.Lock()


def _count_launch() -> None:
    """Add one launch, under a lock: the sharded engine launches from
    one thread per shard."""
    global launches
    with _launch_lock:
        launches += 1


def select_first_b_plain(win_masked: torch.Tensor, b: int) -> torch.Tensor:
    """The extract loop: per row, peel lowest set bits while the budget
    lasts, newest word first (in int64, where -m is exact)."""
    n, ww = win_masked.shape
    m_all = u32.to_u64(win_masked)
    budget = torch.full((n,), b, dtype=torch.int64, device=win_masked.device)
    taken = [None] * ww
    for w in range(ww - 1, -1, -1):
        m = m_all[:, w]
        acc = torch.zeros_like(m)
        for _ in range(min(b, WORD)):
            low = m & (-m)
            bitm = torch.where(budget > 0, low, 0)
            acc = acc | bitm
            m = m ^ bitm
            budget = budget - (bitm != 0).to(torch.int64)
        taken[w] = acc
    return u32.from_u64(torch.stack(taken, dim=-1))


def select_first_b(win_masked: torch.Tensor, b: int) -> torch.Tensor:
    """int32 carrier [N, WW] -> int32 carrier [N, WW]."""
    if win_masked.dtype != torch.int32 or win_masked.dim() != 2:
        raise ValueError("select_first_b wants an int32 [N, WW] carrier, "
                         f"got {win_masked.dtype} {tuple(win_masked.shape)}")
    if b < 0:
        raise ValueError(f"select_first_b: negative budget {b}")
    if win_masked.device.type == "cpu":
        return select_first_b_plain(win_masked, b)
    if win_masked.device.type != "cuda":
        raise ValueError(f"select_first_b: no kernel for device "
                         f"{win_masked.device}")
    if not win_masked.is_contiguous():
        raise ValueError("select_first_b: window must be contiguous")
    n, ww = win_masked.shape
    out = torch.empty_like(win_masked)
    _kernels.launch("selb", win_masked, win_masked.data_ptr(),
                    out.data_ptr(), n, ww, min(b, ww * WORD))
    _count_launch()
    return out

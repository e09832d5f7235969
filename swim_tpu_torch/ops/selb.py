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
raises; nothing falls back.  Both sit behind one `torch.library`
custom op whose vmap rule runs a batched study's P lanes, [P, N, WW],
as P*N rows in one call (the reference's `pallas_call` batching rule
gives its kernel the lane axis the same way).
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
    """The extract loop on all words at once: a word's budget is what
    the set bits of the newer words leave of `b`; each word then peels
    its lowest set bits while its budget lasts (in int64, where -m is
    exact)."""
    m = u32.to_u64(win_masked)
    cnt = u32.popcount(win_masked).to(torch.int64)
    newer = cnt.flip(-1).cumsum(-1).flip(-1) - cnt
    left = (b - newer).clamp(min=0)
    acc = torch.zeros_like(m)
    for _ in range(min(b, WORD)):
        low = m & (-m)
        bitm = torch.where(left > 0, low, 0)
        acc = acc | bitm
        m = m ^ bitm
        left = left - (bitm != 0).to(torch.int64)
    return u32.from_u64(acc)


def _launch(win_masked: torch.Tensor, b: int) -> torch.Tensor:
    """The kernel on a contiguous int32 [N, WW] CUDA carrier."""
    if not win_masked.is_contiguous():
        raise ValueError("select_first_b: window must be contiguous")
    n, ww = win_masked.shape
    out = torch.empty_like(win_masked)
    _kernels.launch("selb", win_masked, win_masked.data_ptr(),
                    out.data_ptr(), n, ww, min(b, ww * WORD))
    _count_launch()
    return out


@torch.library.custom_op("swim_tpu_torch::select_first_b", mutates_args=())
def _op(win_masked: torch.Tensor, b: int) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card."""
    if win_masked.device.type == "cpu":
        return select_first_b_plain(win_masked, b)
    return _launch(win_masked, b)


def _vmap_rule(info, in_dims, win_masked, b):
    """Lanes [P, N, WW] run as P*N rows in one launch: the kernel is
    row-local."""
    lanes = win_masked.movedim(in_dims[0], 0)
    out = _op(lanes.reshape(-1, lanes.shape[-1]), b)
    return out.reshape(lanes.shape), 0


_op.register_vmap(_vmap_rule)


def select_first_b(win_masked: torch.Tensor, b: int) -> torch.Tensor:
    """int32 carrier [N, WW] -> int32 carrier [N, WW]; under
    `torch.func.vmap` P lanes go to the kernel as one launch."""
    if win_masked.dtype != torch.int32 or win_masked.dim() != 2:
        raise ValueError("select_first_b wants an int32 [N, WW] carrier, "
                         f"got {win_masked.dtype} {tuple(win_masked.shape)}")
    if b < 0:
        raise ValueError(f"select_first_b: negative budget {b}")
    if win_masked.device.type not in ("cpu", "cuda"):
        raise ValueError(f"select_first_b: no kernel for device "
                         f"{win_masked.device}")
    return _op(win_masked, b)

"""Cold-ring flush plus view-query select (port of
`swim_tpu/ops/coldsel.py`).

    cold[flush_rows[w]] = flush_vals[w]                 (w < OW, in order)
    sel[q, i] = cold[q_rows[q, i], i]   for 0 <= q_rows[q, i] < RW, else 0

Both paths update `cold` in place (the reference aliases it the same
way) and return `(cold, sel)`.  A CUDA tensor goes to the hand-written
kernel (csrc/coldsel.cu, replacing the TPU kernel `_kernel` of
swim_tpu/ops/coldsel.py; bound by bytes: it touches only the OW flushed
rows and the Q queried words per column, where the TPU block walk
rewrote all 128 rows).  A thread owns 4 consecutive columns: flush_vals,
q_rows and sel move as 16-byte evict-first accesses, a group of four
queries is resolved before any of its cold loads is issued, the four
columns of a query share one 16-byte load when they name one row (on
the ring's period nearly all name row 0), a query on a flushed row is
answered from flush_vals, and the flush goes last.  With N % 4 != 0 or
an unaligned view it takes a 4-byte path, one column per thread.  A CPU
tensor goes to `cold_update_select_plain`, the reference's `_lax_twin`.
Any other device raises; nothing falls back.  Both sit behind one
`torch.library` custom op (it mutates `cold`) whose vmap rule runs a
batched study's P lanes in one call: the kernel takes the lane in its
grid's y axis, and an operand the lanes share is read with lane stride
0, never copied P times.
"""
from __future__ import annotations

import threading

import torch

from swim_tpu_torch import _kernels

launches = 0
_launch_lock = threading.Lock()


def _count_launch() -> None:
    """Add one launch, under a lock: the sharded engine launches from
    one thread per shard."""
    global launches
    with _launch_lock:
        launches += 1


def cold_update_select_plain(cold, flush_rows, flush_vals, q_rows):
    """The where-chain flush and one-hot select of the reference twin.
    `cold` may carry a leading lane axis [P, RW, N]; each other operand
    then has it too or is shared by every lane."""
    rw = cold.shape[-2]
    row_ids = torch.arange(rw, dtype=torch.int32, device=cold.device)[:, None]
    new = cold
    for w in range(flush_vals.shape[-2]):
        new = torch.where(row_ids == flush_rows[..., w, None, None],
                          flush_vals[..., w, None, :], new)
    valid = (q_rows >= 0) & (q_rows < rw)
    idx = q_rows.clamp(0, rw - 1).to(torch.int64)
    picked = new.gather(-2, idx.expand(new.shape[:-2] + idx.shape[-2:]))
    sel = torch.where(valid, picked, 0)
    cold.copy_(new)
    return cold, sel


def _check(cold, flush_rows, flush_vals, q_rows):
    rw, n = cold.shape
    ow = flush_rows.shape[0]
    for name, t, dt, shape in (
            ("cold", cold, torch.int32, (rw, n)),
            ("flush_rows", flush_rows, torch.int32, (ow,)),
            ("flush_vals", flush_vals, torch.int32, (ow, n)),
            ("q_rows", q_rows, torch.int32, (q_rows.shape[0], n))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"cold_update_select: {name} must be {dt} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != cold.device:
            raise ValueError(f"cold_update_select: {name} on {t.device}, "
                             f"cold on {cold.device}")


def _launch(cold, flush_rows, flush_vals, q_rows) -> torch.Tensor:
    """The kernel on contiguous CUDA operands: cold [RW, N] or lanes
    [P, RW, N]; an operand without the lane axis is read by every lane
    (lane stride 0)."""
    for t in (cold, flush_rows, flush_vals, q_rows):
        if not t.is_contiguous():
            raise ValueError("cold_update_select: inputs must be contiguous")
    rw, n = cold.shape[-2:]
    lanes = cold.shape[0] if cold.dim() == 3 else 1

    def stride(t, rank):
        return t[0].numel() if t.dim() > rank else 0

    sel = torch.empty(cold.shape[:-2] + (q_rows.shape[-2], n),
                      dtype=torch.int32, device=cold.device)
    _kernels.launch("coldsel", cold, cold.data_ptr(), flush_rows.data_ptr(),
                    flush_vals.data_ptr(), q_rows.data_ptr(), sel.data_ptr(),
                    n, rw, flush_rows.shape[-1], q_rows.shape[-2], lanes,
                    stride(flush_rows, 1), stride(flush_vals, 2),
                    stride(q_rows, 2))
    _count_launch()
    return sel


@torch.library.custom_op("swim_tpu_torch::cold_update_select",
                         mutates_args=("cold",))
def _op(cold: torch.Tensor, flush_rows: torch.Tensor,
        flush_vals: torch.Tensor, q_rows: torch.Tensor) -> torch.Tensor:
    """sel; `cold` updated in place.  The plain version on the CPU, the
    kernel on the card."""
    if cold.device.type == "cpu":
        return cold_update_select_plain(cold, flush_rows, flush_vals,
                                        q_rows)[1]
    return _launch(cold, flush_rows, flush_vals, q_rows)


def _vmap_rule(info, in_dims, cold, flush_rows, flush_vals, q_rows):
    """P lanes in one call: cold [P, RW, N] updated in place, each other
    operand [P, ...] or, where it is not batched, shared."""
    if in_dims[0] is None:
        raise ValueError("cold_update_select: batched flushes or queries "
                         "need a batched cold ring")
    lanes = cold.movedim(in_dims[0], 0)
    work = lanes.contiguous()
    rest = [t if d is None else t.movedim(d, 0).contiguous()
            for t, d in zip((flush_rows, flush_vals, q_rows), in_dims[1:])]
    sel = _op(work, *rest)
    if work is not lanes:
        lanes.copy_(work)
    return sel, 0


_op.register_vmap(_vmap_rule)


def cold_update_select(cold, flush_rows, flush_vals, q_rows):
    """cold int32[RW, N] (u32 carrier, updated in place), flush_rows
    int32[OW], flush_vals int32[OW, N], q_rows int32[Q, N] ->
    (cold, sel int32[Q, N]); under `torch.func.vmap` one launch for
    all lanes."""
    _check(cold, flush_rows, flush_vals, q_rows)
    if cold.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cold_update_select: no kernel for device "
                         f"{cold.device}")
    return cold, _op(cold, flush_rows, flush_vals, q_rows)

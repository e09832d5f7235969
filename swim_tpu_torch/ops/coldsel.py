"""Cold-ring flush plus view-query select (port of
`swim_tpu/ops/coldsel.py`).

    cold[flush_rows[w]] = flush_vals[w]                 (w < OW, in order)
    sel[q, i] = cold[q_rows[q, i], i]   for 0 <= q_rows[q, i] < RW, else 0

Both paths update `cold` in place (the reference aliases it the same
way) and return `(cold, sel)`.  A CUDA tensor goes to the hand-written
kernel (csrc/coldsel.cu, replacing the TPU kernel `_kernel` of
swim_tpu/ops/coldsel.py; bound by bytes: it touches only the OW flushed
rows and the Q queried words per column, 64 MB at the 1M-node slice,
where the TPU block walk rewrote all 128 rows; one thread per node
column).  A CPU tensor goes to `cold_update_select_plain`, the
reference's `_lax_twin`.  Any other device raises; nothing falls back.
"""
from __future__ import annotations

import torch

from swim_tpu_torch import _kernels

launches = 0


def cold_update_select_plain(cold, flush_rows, flush_vals, q_rows):
    """The where-chain flush and one-hot select of the reference twin."""
    rw = cold.shape[0]
    row_ids = torch.arange(rw, dtype=torch.int32, device=cold.device)[:, None]
    new = cold
    for w in range(flush_vals.shape[0]):
        new = torch.where(row_ids == flush_rows[w], flush_vals[w][None, :],
                          new)
    valid = (q_rows >= 0) & (q_rows < rw)
    picked = new.gather(0, q_rows.clamp(0, rw - 1).to(torch.int64))
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


def cold_update_select(cold, flush_rows, flush_vals, q_rows):
    """cold int32[RW, N] (u32 carrier, updated in place), flush_rows
    int32[OW], flush_vals int32[OW, N], q_rows int32[Q, N] ->
    (cold, sel int32[Q, N])."""
    global launches
    _check(cold, flush_rows, flush_vals, q_rows)
    if cold.device.type == "cpu":
        return cold_update_select_plain(cold, flush_rows, flush_vals, q_rows)
    if cold.device.type != "cuda":
        raise ValueError(f"cold_update_select: no kernel for device "
                         f"{cold.device}")
    for t in (cold, flush_rows, flush_vals, q_rows):
        if not t.is_contiguous():
            raise ValueError("cold_update_select: inputs must be contiguous")
    rw, n = cold.shape
    sel = torch.empty((q_rows.shape[0], n), dtype=torch.int32,
                      device=cold.device)
    fn = _kernels.lib("coldsel").coldsel_launch
    code = fn(cold.data_ptr(), flush_rows.data_ptr(), flush_vals.data_ptr(),
              q_rows.data_ptr(), sel.data_ptr(), n, rw, flush_rows.shape[0],
              q_rows.shape[0], _kernels.stream_of(cold))
    _kernels.check("coldsel", code)
    launches += 1
    return cold, sel

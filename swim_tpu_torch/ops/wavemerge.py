"""Fused multi-wave window OR-merge (port of `swim_tpu/ops/wavemerge.py`).

    win[i] |= OR_w (oks[w, i] ? sel[(i + offs[w]) mod N] : 0)
            | OR_q onehot(bcol[q, i]) * bval[q, i]

Both paths update `win` in place (the reference aliases it the same way)
and return it.  A CUDA tensor goes to the hand-written kernel
(csrc/wavemerge.cu, replacing the TPU kernel `_make_kernel` of
swim_tpu/ops/wavemerge.py; bound by bytes: win read and written, oks
read once and the sel rows some delivering wave needs, at most 158 MB
at the 1M-node slice).  A block owns a tile of receivers and packs
their ok bytes into one bit word each in shared memory; each thread
owns 16 bytes of the tile's rows (4 when WW % 4 != 0) and loads a
wave's shifted sel chunk only when its receiver takes that wave, so a
wave that no receiver of a warp takes costs no sel read.  Offsets are
read on the device and wrapped with floor semantics.  A CPU tensor goes
to `merge_waves_plain`, the reference's rolled-OR `_lax_twin`.  Any
other device raises; nothing falls back.
"""
from __future__ import annotations

import threading

import torch

from swim_tpu_torch import _kernels

MAX_WAVES = 32
launches = 0
_launch_lock = threading.Lock()


def _count_launch() -> None:
    """Add one launch, under a lock: the sharded engine launches from
    one thread per shard."""
    global launches
    with _launch_lock:
        launches += 1


def merge_waves_plain(win, sel, oks, offs, bcol, bval):
    """The rolled-OR formulation: one gather of sel per wave."""
    n, ww = win.shape
    ids = torch.arange(n, dtype=torch.int64, device=win.device)
    for w in range(oks.shape[0]):
        src = torch.remainder(ids + offs[w].to(torch.int64), n)
        win |= torch.where(oks[w][:, None], sel[src], 0)
    wids = torch.arange(ww, dtype=torch.int32, device=win.device)[None, :]
    for q in range(bcol.shape[0]):
        win |= torch.where(bcol[q][:, None] == wids, bval[q][:, None], 0)
    return win


def _check(win, sel, oks, offs, bcol, bval):
    n, ww = win.shape
    v, vb = oks.shape[0], bcol.shape[0]
    for name, t, dt, shape in (
            ("win", win, torch.int32, (n, ww)),
            ("sel", sel, torch.int32, (n, ww)),
            ("oks", oks, torch.bool, (v, n)),
            ("offs", offs, torch.int32, (v,)),
            ("bcol", bcol, torch.int32, (vb, n)),
            ("bval", bval, torch.int32, (vb, n))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"merge_waves: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != win.device:
            raise ValueError(f"merge_waves: {name} on {t.device}, win on "
                             f"{win.device}")
    if v > MAX_WAVES:
        raise ValueError(f"merge_waves: V={v} waves exceed {MAX_WAVES}")
    if sel.data_ptr() == win.data_ptr():
        raise ValueError("merge_waves: sel must not alias win")


def merge_waves(win, sel, oks, offs, bcol, bval):
    """win int32[N, WW] (u32 carrier, updated in place), sel int32[N, WW],
    oks bool[V, N] (by receiver), offs int32[V] (any sign), bcol
    int32[VB, N], bval int32[VB, N] (VB may be 0) -> win."""
    _check(win, sel, oks, offs, bcol, bval)
    if win.device.type == "cpu":
        return merge_waves_plain(win, sel, oks, offs, bcol, bval)
    if win.device.type != "cuda":
        raise ValueError(f"merge_waves: no kernel for device {win.device}")
    for t in (win, sel, oks, offs, bcol, bval):
        if not t.is_contiguous():
            raise ValueError("merge_waves: inputs must be contiguous")
    n, ww = win.shape
    _kernels.launch("wavemerge", win, win.data_ptr(), sel.data_ptr(),
                    oks.data_ptr(), offs.data_ptr(), bcol.data_ptr(),
                    bval.data_ptr(), n, ww, oks.shape[0], bcol.shape[0])
    _count_launch()
    return win

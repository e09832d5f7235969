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
other device raises; nothing falls back.  Both sit behind one
`torch.library` custom op (it mutates `win`) whose vmap rule runs a
batched study's P lanes in one call: the kernel takes the lane in its
grid's y axis, each lane's rolls wrap inside its own N rows, and an
operand the lanes share is read with lane stride 0.
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
    """The rolled-OR formulation: one gather of sel per wave.  `win` may
    carry a leading lane axis [P, N, WW]; each other operand then has it
    too or is shared by every lane, and each lane's rolls wrap inside
    its own N rows."""
    n, ww = win.shape[-2:]
    ids = torch.arange(n, dtype=torch.int64, device=win.device)
    lanes = win.shape[:-2]
    if lanes:
        lane_ids = torch.arange(lanes[0], device=win.device)[:, None]
        sel = sel.expand(win.shape)
    for w in range(oks.shape[-2]):
        src = torch.remainder(ids + offs[..., w, None].to(torch.int64), n)
        got = sel[lane_ids, src] if lanes else sel[src]
        win |= torch.where(oks[..., w, :, None], got, 0)
    wids = torch.arange(ww, dtype=torch.int32, device=win.device)
    for q in range(bcol.shape[-2]):
        win |= torch.where(bcol[..., q, :, None] == wids,
                           bval[..., q, :, None], 0)
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


def _launch(win, sel, oks, offs, bcol, bval) -> None:
    """The kernel on contiguous CUDA operands: win [N, WW] or lanes
    [P, N, WW]; an operand without the lane axis is read by every lane
    (lane stride 0)."""
    for t in (win, sel, oks, offs, bcol, bval):
        if not t.is_contiguous():
            raise ValueError("merge_waves: inputs must be contiguous")
    if sel.data_ptr() == win.data_ptr():
        raise ValueError("merge_waves: sel must not alias win")
    n, ww = win.shape[-2:]
    lanes = win.shape[0] if win.dim() == 3 else 1

    def stride(t, rank):
        return t[0].numel() if t.dim() > rank else 0

    _kernels.launch("wavemerge", win, win.data_ptr(), sel.data_ptr(),
                    oks.data_ptr(), offs.data_ptr(), bcol.data_ptr(),
                    bval.data_ptr(), n, ww, oks.shape[-2], bcol.shape[-2],
                    lanes, stride(sel, 2), stride(oks, 2), stride(offs, 1),
                    stride(bcol, 2), stride(bval, 2))
    _count_launch()


@torch.library.custom_op("swim_tpu_torch::merge_waves", mutates_args=("win",))
def _op(win: torch.Tensor, sel: torch.Tensor, oks: torch.Tensor,
        offs: torch.Tensor, bcol: torch.Tensor, bval: torch.Tensor) -> None:
    """`win` updated in place.  The plain version on the CPU, the kernel
    on the card."""
    if win.device.type == "cpu":
        if sel.data_ptr() == win.data_ptr():
            raise ValueError("merge_waves: sel must not alias win")
        merge_waves_plain(win, sel, oks, offs, bcol, bval)
    else:
        _launch(win, sel, oks, offs, bcol, bval)


def _vmap_rule(info, in_dims, win, sel, oks, offs, bcol, bval):
    """P lanes in one call: win [P, N, WW] updated in place, each other
    operand [P, ...] or, where it is not batched, shared."""
    if in_dims[0] is None:
        raise ValueError("merge_waves: batched waves need a batched win")
    lanes = win.movedim(in_dims[0], 0)
    work = lanes.contiguous()
    rest = [t if d is None else t.movedim(d, 0).contiguous()
            for t, d in zip((sel, oks, offs, bcol, bval), in_dims[1:])]
    _op(work, *rest)
    if work is not lanes:
        lanes.copy_(work)
    return None, None


_op.register_vmap(_vmap_rule)


def merge_waves(win, sel, oks, offs, bcol, bval):
    """win int32[N, WW] (u32 carrier, updated in place), sel int32[N, WW],
    oks bool[V, N] (by receiver), offs int32[V] (any sign), bcol
    int32[VB, N], bval int32[VB, N] (VB may be 0) -> win; under
    `torch.func.vmap` one launch for all lanes."""
    _check(win, sel, oks, offs, bcol, bval)
    if win.device.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_waves: no kernel for device {win.device}")
    _op(win, sel, oks, offs, bcol, bval)
    return win

"""Shared inputs of the port's kernel tests (numpy seeds, no JAX); it
holds no tests itself.

Imported by tests/test_torch_kernels.py (plain versions vs the JAX ops
on the CPU) and tests/test_torch_card.py (CUDA kernels vs plain
versions on the card, where JAX is not installed).
"""
from __future__ import annotations

import numpy as np
import torch


def carrier(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def u32s(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------------ inputs


def selb_input(seed, n, ww):
    rng = np.random.default_rng(seed)
    win = u32s(rng, (n, ww))
    win[rng.random((n, ww)) < 0.3] = 0
    win[0] = 0
    win[1 % n] = 0xFFFFFFFF
    win[2 % n, -1] = 0x80000000
    return win


def coldsel_input(seed, rw, n, ow, q, flush=None, quiet=False):
    """`quiet`: q_rows shaped like the ring period's: mostly row 0 (a
    missing slot clamps there) and -1, a few runs of neighbouring
    columns on one row, a few random rows."""
    rng = np.random.default_rng(seed)
    cold = u32s(rng, (rw, n))
    fr = (np.asarray(flush, np.int32) if flush is not None
          else rng.integers(0, rw, ow).astype(np.int32))
    fv = u32s(rng, (fr.shape[0], n))
    fv[:, 0] = 0x80000001
    qr = rng.integers(-2, rw + 2, (q, n)).astype(np.int32)
    if quiet:
        u = rng.random((q, n))
        run = (np.arange(n) // 3 % rw).astype(np.int32)
        qr = np.where(u < 0.9, 0, np.where(u < 0.95, -1,
                                           np.where(u < 0.98, run, qr)))
        qr = qr.astype(np.int32)
    return cold, fr, fv, qr


def wavemerge_input(seed, n, ww, v, vb, offs=None, density=0.4,
                    quiet=None):
    """`density`: ok probability, one for all waves or one per wave;
    `quiet`: a receiver range (lo, hi) that takes no wave at all."""
    rng = np.random.default_rng(seed)
    win = u32s(rng, (n, ww))
    sel = u32s(rng, (n, ww))
    oks = rng.random((v, n)) < np.reshape(density, (-1, 1))
    if quiet is not None:
        oks[:, quiet[0]:quiet[1]] = False
    if offs is None:
        offs = rng.integers(-2 * n, 2 * n, v)
    offs = np.asarray(offs, np.int32)
    bcol = rng.integers(-1, ww + 2, (vb, n)).astype(np.int32)
    bit = rng.integers(0, 32, (vb, n)).astype(np.uint32)
    bval = np.where(rng.random((vb, n)) < 0.3, np.uint32(1) << bit,
                    np.uint32(0)).astype(np.uint32)
    return win, sel, oks, offs, bcol, bval


# (n, ww, b); b=31 and b=33 on the full-word rows of selb_input end
# inside a word and one bit into the next word
SELB_CASES = [(257, 12, 6), (1000, 12, 0), (1000, 12, 1), (4096, 3, 32),
              (1000, 1, 6), (33, 12, 500), (1000, 5, 6), (1000, 16, 6),
              (777, 16, 31), (777, 16, 33)]
# (rw, n, ow, q, flush rows or None for random ones)
COLDSEL_CASES = [(128, 5000, 2, 4, None), (16, 300, 1, 3, None),
                 (34, 1000, 2, 4, None), (16, 300, 3, 4, [4, 4, 9]),
                 (8, 33, 2, 1, [7, 20])]
# main-path-shaped queries (coldsel_input(quiet=True)): N % 4 == 0 and
# not, row 0 flushed, more queries than the kernel's group of four,
# duplicate and out-of-range flush rows
COLDSEL_QUIET_CASES = [(128, 4096, 2, 4, None), (128, 4099, 2, 4, None),
                       (128, 2048, 2, 4, [0, 5]), (16, 1000, 2, 9, [3, 3]),
                       (16, 1001, 5, 6, [0, 15, 0, 16, 2]),
                       (128, 1002, 2, 4, [127, 0])]
# (n, ww, v, vb, offs).  The last three: the main path's shape of oks
# (two dense waves, twelve at 0.2%, a run of receivers that takes no
# wave); WW=3, the kernel's 4-byte path; N not a multiple of the
# kernel's tile (85 receivers at WW=12) with offsets whose wrap falls
# inside a tile, at its first and last receiver and on a tile boundary.
WAVE_CASES = [(1024, 12, 14, 0, None), (1000, 12, 14, 2, None),
              (1000, 12, 7, 2, [0, 999, -1, -1000, 1999, 1, 500]),
              (257, 4, 14, 0, None), (1, 12, 2, 1, [0, 5]),
              (5000, 12, 14, 0, None), (1000, 3, 14, 2, None),
              (1001, 12, 8, 1, [0, 1, -1, -85, 830, 2001, -2999, 84]),
              # the in-line delivery of wave scope: one wave at a time,
              # with and without a buddy row
              (1000, 12, 1, 0, [-7]), (1000, 12, 1, 1, [993]),
              (1500, 12, 1, 1, [-1499]), (257, 12, 1, 0, [0])]
# keyword arguments of wavemerge_input beyond the defaults, by case
WAVE_OPTS = {(5000, 12, 14, 0): dict(density=[0.99] * 2 + [0.002] * 12,
                                     quiet=(1200, 2100))}


def wave_case_input(n, ww, v, vb, offs):
    """wavemerge_input for one entry of WAVE_CASES."""
    return wavemerge_input(n + v + vb, n, ww, v, vb, offs,
                           **WAVE_OPTS.get((n, ww, v, vb), {}))


# the published studies' wider rings: ring_orig_words 4 (WW 24; RW 224
# in the sized 4M call, suspicion_mult 2, and 284 at the default 5) and
# 8 (WW 48, RW 512): (n, ww, b) for selb, (rw, n, ow, q, flush) for
# coldsel (random, duplicate and out-of-range flush rows), (n, ww, v,
# vb, offs) for wavemerge (one-wave and fused, VB 0 and 1)
WIDE_SELB = [(4099, 24, 6), (4096, 48, 6), (1000, 48, 400), (777, 24, 33)]
WIDE_COLDSEL = [(224, 4099, 4, 4, None), (284, 4096, 4, 4, [0, 283, 1, 0]),
                (512, 4096, 8, 4, None),
                (512, 1001, 8, 4, [0, 511, 510, 0, 3, 3, 600, -1])]
WIDE_WAVE = [(4099, 24, 1, 0, [-7]), (4096, 24, 1, 1, [4095]),
             (4099, 24, 14, 0, None), (4096, 24, 14, 1, None),
             (4096, 48, 1, 0, [1]), (1001, 48, 1, 1, [-1000]),
             (4096, 48, 14, 0, None), (1001, 48, 14, 1, None)]


def wide_wave_input(n, ww, v, vb, offs):
    """wavemerge_input for one entry of WIDE_WAVE."""
    return wavemerge_input(n + ww + v, n, ww, v, vb, offs)

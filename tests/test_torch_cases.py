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


def coldsel_input(seed, rw, n, ow, q, flush=None):
    rng = np.random.default_rng(seed)
    cold = u32s(rng, (rw, n))
    fr = (np.asarray(flush, np.int32) if flush is not None
          else rng.integers(0, rw, ow).astype(np.int32))
    fv = u32s(rng, (fr.shape[0], n))
    fv[:, 0] = 0x80000001
    qr = rng.integers(-2, rw + 2, (q, n)).astype(np.int32)
    return cold, fr, fv, qr


def wavemerge_input(seed, n, ww, v, vb, offs=None):
    rng = np.random.default_rng(seed)
    win = u32s(rng, (n, ww))
    sel = u32s(rng, (n, ww))
    oks = rng.random((v, n)) < 0.4
    if offs is None:
        offs = rng.integers(-2 * n, 2 * n, v)
    offs = np.asarray(offs, np.int32)
    bcol = rng.integers(-1, ww + 2, (vb, n)).astype(np.int32)
    bit = rng.integers(0, 32, (vb, n)).astype(np.uint32)
    bval = np.where(rng.random((vb, n)) < 0.3, np.uint32(1) << bit,
                    np.uint32(0)).astype(np.uint32)
    return win, sel, oks, offs, bcol, bval


SELB_CASES = [(257, 12, 6), (1000, 12, 0), (1000, 12, 1), (4096, 3, 32),
              (1000, 1, 6), (33, 12, 500)]
COLDSEL_CASES = [(128, 5000, 2, 4, None), (16, 300, 1, 3, None),
                 (34, 1000, 2, 4, None), (16, 300, 3, 4, [4, 4, 9]),
                 (8, 33, 2, 1, [7, 20])]
WAVE_CASES = [(1024, 12, 14, 0, None), (1000, 12, 14, 2, None),
              (1000, 12, 7, 2, [0, 999, -1, -1000, 1999, 1, 500]),
              (257, 4, 14, 0, None), (1, 12, 2, 1, [0, 5])]

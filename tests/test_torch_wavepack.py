"""The port's wave payloads (`swim_tpu_torch/ops/wavepack.py`) against
`swim_tpu.ops.wavepack`, byte for byte.

The same seeded numpy inputs go through both packages: `pack_bits` /
`unpack_bits` (bool vectors of lengths that do and do not fill a u32
word), `bundle_nbytes`, `pack_bundle` / `unpack_bundle` (a wave's
bundle: a bool ok chain, u8 partition ids, a u16 lane and a u16 buddy
column carried in int32 with their wire width given, and a u32 part),
and `pack_slots` / `unpack_slots` (first-B-selected windows at WW = 4,
whose slots fit u8, and WW = 12, u16).  Payloads must be equal byte for
byte, unpacked values equal to the reference's and to the inputs (the
round trips), the narrow dtypes the reference's.  Tolerance: exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swim_tpu.ops import selb as jselb
from swim_tpu.ops import wavepack as jwp
from swim_tpu_torch.ops import selb, wavepack

SIZES = [1, 31, 32, 33, 125, 512]


def _u32(a: np.ndarray) -> torch.Tensor:
    """A uint32 numpy array as the port's int32 carrier."""
    return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("s", SIZES)
def test_pack_bits_equals_reference(s):
    """pack_bits: the u32 words of the reference (pad bits 0); unpack_bits
    gives the flags back in both packages."""
    rng = np.random.default_rng(s)
    flags = rng.random(s) < 0.4
    want = np.asarray(jwp.pack_bits(jnp.asarray(flags)))
    got = wavepack.pack_bits(torch.from_numpy(flags))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got).view(np.uint32), want)
    back = wavepack.unpack_bits(got, s)
    np.testing.assert_array_equal(_np(back), flags)
    np.testing.assert_array_equal(
        np.asarray(jwp.unpack_bits(jnp.asarray(want), s)), _np(back))


def _bundle_parts(s: int, seed: int):
    """(reference parts, port parts, port itemsizes): ok flags, u8 pids,
    a u16 lane, a u16 column code, u8 bit codes and a u32 word."""
    rng = np.random.default_rng(seed)
    ok = rng.random(s) < 0.5
    pid = rng.integers(0, 256, s).astype(np.uint8)
    lane = rng.integers(0, 65536, s).astype(np.uint16)
    col = rng.integers(0, 65536, s).astype(np.uint16)
    code = rng.integers(0, 33, s).astype(np.uint8)
    word = rng.integers(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
    ref = [jnp.asarray(x) for x in (ok, pid, lane, col, code, word)]
    port = [torch.from_numpy(ok), torch.from_numpy(pid),
            torch.from_numpy(lane.astype(np.int32)),
            torch.from_numpy(col.astype(np.int32)),
            torch.from_numpy(code), _u32(word)]
    return ref, port, (None, None, 2, 2, None, 4)


@pytest.mark.parametrize("s", [1, 33, 125, 512])
def test_pack_bundle_equals_reference(s):
    """One wave's bundle: the same u8 payload, the same per-part bytes,
    and the parts back from both payloads."""
    ref, port, sizes = _bundle_parts(s, 100 + s)
    want = np.asarray(jwp.pack_bundle(ref))
    got = wavepack.pack_bundle(port, sizes)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), want)
    assert [wavepack.bundle_nbytes(x, sz) for x, sz in zip(port, sizes)] \
        == [jwp.bundle_nbytes(x) for x in ref]
    back = wavepack.unpack_bundle(got, port, sizes)
    want_back = jwp.unpack_bundle(jnp.asarray(want), ref)
    for p, b, w in zip(port, back, want_back):
        assert b.dtype == p.dtype and b.shape == p.shape
        np.testing.assert_array_equal(_np(b), _np(p))
        w = np.asarray(w)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        np.testing.assert_array_equal(_np(b), w.astype(_np(b).dtype))


@pytest.mark.parametrize("ww,b", [(4, 2), (4, 7), (12, 6), (12, 1)])
def test_pack_slots_equals_reference(ww, b):
    """First-B-selected windows (the reference's selection of a seeded
    window): the slot indices in the reference's dtype and values, empty
    entries its sentinel, and both unpack_slots give the window back."""
    rng = np.random.default_rng(ww * 100 + b)
    win = rng.integers(0, 2**32, (97, ww), dtype=np.uint64).astype(
        np.uint32)
    win[rng.random((97, ww)) < 0.6] = 0
    win[0] = 0
    sel_j = np.asarray(jax.jit(
        lambda w: jselb.select_first_b(w, b, impl="lax"))(jnp.asarray(win)))
    sel = selb.select_first_b_plain(_u32(win), b)
    np.testing.assert_array_equal(_np(sel).view(np.uint32), sel_j)
    want = np.asarray(jax.jit(lambda x: jwp.pack_slots(x, b))(
        jnp.asarray(sel_j)))
    got = wavepack.pack_slots(sel, b)
    wire = wavepack.slot_dtype(ww)
    assert got.dtype == wire.carrier
    assert np.dtype(want.dtype).itemsize == wire.itemsize
    np.testing.assert_array_equal(
        _np(got).astype(np.int64), want.astype(np.int64))
    np.testing.assert_array_equal(
        _np(wavepack.narrow_bytes(got, wire.itemsize)).reshape(-1),
        want.view(np.uint8).reshape(-1))
    back = wavepack.unpack_slots(got, ww)
    np.testing.assert_array_equal(_np(back), _np(sel))
    np.testing.assert_array_equal(
        np.asarray(jwp.unpack_slots(jnp.asarray(want), ww)),
        _np(back).view(np.uint32))


def test_narrow_and_widen_round_trip():
    """narrow_bytes / widen_bytes: an int32 carrier's low bytes and back,
    for every width, including the u32 sentinel -1."""
    x = torch.tensor([0, 1, 255, 256, 65535, -1, 2**31 - 1, -2**31],
                     dtype=torch.int32)
    for w, mask in ((1, 0xFF), (2, 0xFFFF), (4, 0xFFFFFFFF)):
        b = wavepack.narrow_bytes(x, w)
        assert b.dtype == torch.uint8 and b.shape == (8, w)
        back = wavepack.widen_bytes(b, torch.int32)
        want = (x.to(torch.int64) & mask)
        np.testing.assert_array_equal(
            (_np(back).astype(np.int64) & 0xFFFFFFFF), _np(want))

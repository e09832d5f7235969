"""The port's three kernel modules against the JAX ops, bit for bit.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX op (its jnp twin, and the Pallas kernel in
interpret mode at one small shape) and against the repo's independent
numpy references.  Cases: ragged N, offsets 0 / N-1 / negative, query
rows out of range, values with bit 31 set, VB = 0 and VB = 2.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_card.py.  Tolerance: exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import test_core_units
import test_wavemerge
import torch
from test_torch_cases import (
    COLDSEL_CASES, COLDSEL_QUIET_CASES, SELB_CASES, WAVE_CASES, as_u32,
    carrier, coldsel_input, selb_input, wave_case_input, wavemerge_input)

from swim_tpu.ops import coldsel as jcoldsel
from swim_tpu.ops import selb as jselb
from swim_tpu.ops import wavemerge as jwavemerge
from swim_tpu_torch.ops import coldsel, selb, wavemerge


# ---------------------------------------------------------------- selb


class TestSelectFirstB:
    @pytest.mark.parametrize("n,ww,b", SELB_CASES)
    def test_plain_matches_jax_and_numpy(self, n, ww, b):
        win = selb_input(n + b, n, ww)
        got = as_u32(selb.select_first_b(carrier(win), b))
        want = np.asarray(jselb.select_first_b(jnp.asarray(win), b,
                                               impl="lax"))
        np.testing.assert_array_equal(got, want)
        ref = test_core_units.TestSelectFirstB._reference(win, b)
        np.testing.assert_array_equal(got, ref)

    def test_plain_matches_pallas_interpret(self):
        win = selb_input(3, 300, 12)
        got = as_u32(selb.select_first_b(carrier(win), 6))
        want = np.asarray(jselb.select_first_b(jnp.asarray(win), 6,
                                               impl="pallas"))
        np.testing.assert_array_equal(got, want)

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError):
            selb.select_first_b(torch.zeros((4, 3), dtype=torch.int64), 2)
        with pytest.raises(ValueError):
            selb.select_first_b(torch.zeros((4,), dtype=torch.int32), 2)
        with pytest.raises(ValueError):
            selb.select_first_b(torch.zeros((4, 3), dtype=torch.int32), -1)


# ------------------------------------------------------------- coldsel


class TestColdUpdateSelect:
    @pytest.mark.parametrize("rw,n,ow,q,flush", COLDSEL_CASES)
    def test_plain_matches_jax(self, rw, n, ow, q, flush):
        self.check(coldsel_input(rw * n + ow, rw, n, ow, q, flush))

    @pytest.mark.parametrize("rw,n,ow,q,flush", COLDSEL_QUIET_CASES)
    def test_plain_matches_jax_on_main_path_shapes(self, rw, n, ow, q,
                                                   flush):
        args = coldsel_input(rw * n + ow, rw, n, ow, q, flush, quiet=True)
        assert (args[3] == 0).mean() > 0.85
        self.check(args)

    @staticmethod
    def check(args):
        cold, fr, fv, qr = args
        rw, n = cold.shape
        tc = carrier(cold)
        new, sel = coldsel.cold_update_select(tc, carrier(fr), carrier(fv),
                                              carrier(qr))
        assert new is tc                       # updated in place
        want_new, want_sel = jcoldsel.cold_update_select(
            jnp.asarray(cold), jnp.asarray(fr), jnp.asarray(fv),
            jnp.asarray(qr), impl="lax")
        np.testing.assert_array_equal(as_u32(new), np.asarray(want_new))
        np.testing.assert_array_equal(as_u32(sel), np.asarray(want_sel))
        # independent numpy reference
        ref = cold.copy()
        for w in range(fr.shape[0]):
            if 0 <= fr[w] < rw:
                ref[fr[w]] = fv[w]
        ok = (qr >= 0) & (qr < rw)
        ref_sel = np.where(ok, ref[np.clip(qr, 0, rw - 1),
                                   np.arange(n)[None, :]], 0)
        np.testing.assert_array_equal(as_u32(new), ref)
        np.testing.assert_array_equal(as_u32(sel), ref_sel)

    def test_plain_matches_pallas_interpret(self):
        cold, fr, fv, qr = coldsel_input(9, 16, 300, 2, 4)
        _, sel = coldsel.cold_update_select(carrier(cold), carrier(fr),
                                            carrier(fv), carrier(qr))
        _, want = jcoldsel.cold_update_select(
            jnp.asarray(cold), jnp.asarray(fr), jnp.asarray(fv),
            jnp.asarray(qr), impl="pallas")
        np.testing.assert_array_equal(as_u32(sel), np.asarray(want))

    def test_rejects_mismatched_shapes(self):
        cold = torch.zeros((8, 10), dtype=torch.int32)
        fr = torch.zeros((2,), dtype=torch.int32)
        with pytest.raises(ValueError):
            coldsel.cold_update_select(cold, fr,
                                       torch.zeros((2, 9), dtype=torch.int32),
                                       torch.zeros((1, 10), dtype=torch.int32))
        with pytest.raises(ValueError):
            coldsel.cold_update_select(cold, fr.to(torch.int64),
                                       torch.zeros((2, 10), dtype=torch.int32),
                                       torch.zeros((1, 10), dtype=torch.int32))


# ------------------------------------------------------------ wavemerge


class TestMergeWaves:
    @pytest.mark.parametrize("n,ww,v,vb,offs", WAVE_CASES)
    def test_plain_matches_jax_and_numpy(self, n, ww, v, vb, offs):
        win, sel, oks, offs, bcol, bval = wave_case_input(n, ww, v, vb, offs)
        tw = carrier(win)
        got = wavemerge.merge_waves(tw, carrier(sel), torch.from_numpy(oks),
                                    carrier(offs), carrier(bcol),
                                    carrier(bval))
        assert got is tw                       # updated in place
        want = np.asarray(jwavemerge.merge_waves(
            jnp.asarray(win), jnp.asarray(sel), jnp.asarray(oks),
            jnp.asarray(offs), jnp.asarray(bcol), jnp.asarray(bval),
            impl="lax"))
        np.testing.assert_array_equal(as_u32(got), want)
        ref = test_wavemerge._numpy_ref(win, sel, oks, offs, bcol, bval)
        np.testing.assert_array_equal(as_u32(got), ref)

    def test_plain_matches_pallas_interpret(self):
        win, sel, oks, offs, bcol, bval = wavemerge_input(
            5, 1024, 12, 14, 2, [0, 1, 1023, 1024, -1, -1024, 2047, 512, 513,
                                 511, 3, 5, 7, 1023])
        got = wavemerge.merge_waves(carrier(win), carrier(sel),
                                    torch.from_numpy(oks), carrier(offs),
                                    carrier(bcol), carrier(bval))
        want = np.asarray(jwavemerge.merge_waves(
            jnp.asarray(win), jnp.asarray(sel), jnp.asarray(oks),
            jnp.asarray(offs), jnp.asarray(bcol), jnp.asarray(bval),
            impl="pallas", block_t=256))
        np.testing.assert_array_equal(as_u32(got), want)

    def test_rejects_bad_input(self):
        win = torch.zeros((10, 4), dtype=torch.int32)
        e = torch.zeros((0, 10), dtype=torch.int32)
        oks = torch.zeros((33, 10), dtype=torch.bool)
        with pytest.raises(ValueError, match="exceed"):
            wavemerge.merge_waves(win, win.clone(), oks,
                                  torch.zeros(33, dtype=torch.int32), e, e)
        with pytest.raises(ValueError, match="alias"):
            wavemerge.merge_waves(win, win, oks[:2],
                                  torch.zeros(2, dtype=torch.int32), e, e)

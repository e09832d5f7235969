"""The port on a CUDA card: kernels against their plain versions.

Every test here needs the card and skips without one.  The file imports
no JAX (the card's machine has none): run it there without the repo's
conftest, which imports JAX,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py

  * each CUDA kernel equals its plain PyTorch version bitwise, on the
    cases of tests/test_torch_kernels.py, and counts its launches;
  * a run on the card equals the same run on the CPU (plain versions);
  * the card reproduces golden.GOLDEN_DIGEST.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_cases import (
    COLDSEL_CASES, SELB_CASES, WAVE_CASES, carrier, coldsel_input,
    selb_input, wavemerge_input)

from swim_tpu_torch import SwimConfig, convert, golden
from swim_tpu_torch.models import ring
from swim_tpu_torch.ops import coldsel, selb, wavemerge
from swim_tpu_torch.sim import faults

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("n,ww,b", SELB_CASES)
def test_selb_kernel_matches_plain(cuda, n, ww, b):
    win = carrier(selb_input(n + b, n, ww), cuda)
    before = selb.launches
    got = selb.select_first_b(win, b)
    assert selb.launches == before + 1
    assert torch.equal(got, selb.select_first_b_plain(win, b))


@pytest.mark.parametrize("rw,n,ow,q,flush", COLDSEL_CASES)
def test_coldsel_kernel_matches_plain(cuda, rw, n, ow, q, flush):
    cold, fr, fv, qr = (carrier(a, cuda) for a in
                        coldsel_input(rw * n + ow, rw, n, ow, q, flush))
    before = coldsel.launches
    got = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
    assert coldsel.launches == before + 1
    want = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,ww,v,vb,offs", WAVE_CASES)
def test_wavemerge_kernel_matches_plain(cuda, n, ww, v, vb, offs):
    win, sel, oks, offs, bcol, bval = wavemerge_input(n + v + vb, n, ww, v,
                                                      vb, offs)
    args = [carrier(sel, cuda), torch.from_numpy(oks).to(cuda),
            carrier(offs, cuda), carrier(bcol, cuda), carrier(bval, cuda)]
    before = wavemerge.launches
    got = wavemerge.merge_waves(carrier(win, cuda), *args)
    assert wavemerge.launches == before + 1
    want = wavemerge.merge_waves_plain(carrier(win, cuda), *args)
    assert torch.equal(got, want)


def test_card_run_equals_cpu_run(cuda):
    n, periods = 1500, 12
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    runs = {}
    for dev in ("cpu", cuda):
        plan = faults.with_loss(faults.with_crashes(
            faults.none(n, dev), [5, 77, 600], [1, 2, 3]), 0.05)
        runs[str(dev)] = convert.state_to_numpy(
            ring.run(cfg, ring.init_state(cfg, dev), plan, 3, periods))
    for f in ring.RingState._fields:
        np.testing.assert_array_equal(runs[str(cuda)][f], runs["cpu"][f],
                                      err_msg=f)


def test_card_run_gives_the_golden_digest(cuda):
    assert golden.digest(golden.golden_run(cuda)) == golden.GOLDEN_DIGEST

"""The port's Lifeguard paths against `swim_tpu.models.ring`, bit for bit.

The Lifeguard cases of tests/test_torch_ring.py (its helpers do the
stepping and the comparison): local health (LHA) with thinning, the
buddy system's forced bits in the fused merge (VB = 1 + k rows) and in
the in-line delivery (one row per buddy wave), and dynamic suspicion
timeouts, in period and wave scope and past 32 waves.  Each case asserts
that a health score left 0 and, where the suspect is alive to receive
it, that a buddy bit was forced.  Tolerance: exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)
from test_torch_ring import (
    LIFEGUARD_STEP_CASES, case_id, check_run_parity, check_step_parity,
    warm_jax)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import rumor as jrumor
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.models import rumor

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", autouse=True)
def _compiled():
    """The JAX compiles of the cases below, started together."""
    warm_jax(LIFEGUARD_STEP_CASES, ["lg_period", "lg_wave"])


@pytest.mark.parametrize("cfg_name,name,n,periods,seed", LIFEGUARD_STEP_CASES,
                         ids=[case_id(c) for c in LIFEGUARD_STEP_CASES])
def test_step_parity(cfg_name, name, n, periods, seed, monkeypatch):
    check_step_parity(cfg_name, name, n, periods, seed, monkeypatch)


@pytest.mark.parametrize("cfg_name", ["lg_period", "lg_wave"])
@pytest.mark.parametrize("seed", [0, 9])
def test_run_parity(cfg_name, seed):
    check_run_parity(cfg_name, seed)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=32), dict(n_nodes=1_000_000), dict(n_nodes=4096,
                                                    k_indirect=8),
    dict(n_nodes=500, sentinels=9, suspicion_max_mult=6.0),
    dict(n_nodes=64, k_indirect=1, sentinels=1, suspicion_mult=3.0)],
    ids=["n32", "n1m", "k8", "sentinels9", "k1"])
def test_dynamic_timeout_table_matches_jax(kw):
    want = np.asarray(jrumor.dynamic_timeout_table(
        JaxSwimConfig(lifeguard=True, **kw)))
    cfg = SwimConfig(lifeguard=True, **kw)
    got = rumor.dynamic_timeout_table(cfg, torch.device("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == cfg.suspicion_max_periods
    assert int(got.min()) >= cfg.suspicion_periods
    assert rumor.dynamic_timeout_table(cfg, torch.device("cpu")) is got

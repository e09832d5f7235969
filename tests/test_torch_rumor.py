"""The port's rumor engine against `swim_tpu.models.rumor`, bit for bit.

  * `draw_period_rumor` equals the JAX package's draws (the nine base
    uniforms and the resample stream);
  * from the same initial state and the same RumorRandomness, the port's
    `step` gives the JAX package's RumorState after every period, in all
    12 fields, for: crashes, loss 0.2, a partition, late joiners and a
    FaultProgram (gray and flapping link segments); Lifeguard with buddy
    and dynamic suspicion; round-robin targets; n = 2 and n = 3 (no
    proxies); a crash-only run with a small rumor capacity (budget
    overflow, slot reuse) long enough for DEAD rumors to retire into
    `gone_key`; max_piggyback = 24 (the top-k selection); the JAX step
    runs with its telemetry tap, the port's without and with it: both
    states equal, and the eight EngineFrame fields equal the JAX frame,
    every period;
  * the row-chunked reductions with the chunk shrunk to a few rows give
    the unchunked states;
  * `view_matrix` and `opinion_of` against the JAX functions (`run`
    from a seed is held to the JAX `run` by tests/test_torch_golden.py).

The JAX engine runs as plain XLA on the CPU, one period at a time (one
compile per configuration, shared through module-scoped fixtures).
Tolerance: exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import (check_port_trajectory, crash_loss_plan,
                                faults_plan, jax_trajectory, np_fields,
                                one_torch_thread)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import rumor as jrumor
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import rumor
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PERIODS = 30

CASES = {
    "faults": (dict(n_nodes=200), lambda: faults_plan(200, PERIODS),
               PERIODS),
    "lifeguard": (dict(n_nodes=200, lifeguard=True),
                  lambda: crash_loss_plan(200, 0.2), PERIODS),
    "round_robin": (dict(n_nodes=160, target_selection="round_robin"),
                    lambda: crash_loss_plan(160, 0.1), PERIODS),
    "n2": (dict(n_nodes=2), lambda: crash_loss_plan(2, 0.3, ([1], [9])),
           PERIODS),
    "n3": (dict(n_nodes=3), lambda: crash_loss_plan(3, 0.2, ([2], [5])),
           PERIODS),
    # crash-only, 10 crashes into 12 slots: the budget overflows, slots
    # are reused, and the DEAD rumors retire into gone_key
    "small_capacity_retire": (
        dict(n_nodes=64, rumor_capacity=12),
        lambda: crash_loss_plan(64, 0.0, (list(range(3, 53, 5)),
                                          [1 + i % 4 for i in range(10)])),
        40),
    "piggyback24": (dict(n_nodes=200, max_piggyback=24),
                    lambda: crash_loss_plan(200, 0.2), PERIODS),
}


def rnd_from(d):
    return convert.rumor_randomness_from_numpy(
        {"base": np_fields(d.base), "resample_u": d.resample_u}, "cpu")


@pytest.fixture(scope="module")
def trajectories():
    """name -> (cfg_kw, plan, JAX trajectory), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg_kw, build, periods = CASES[name]
            plan = build()
            cache[name] = (cfg_kw, plan, jax_trajectory(
                jrumor, jrumor.draw_period_rumor, cfg_kw, plan, periods))
        return cache[name]
    return get


def port_run(name, trajectories):
    cfg_kw, plan, traj = trajectories(name)
    return traj, check_port_trajectory(rumor, rumor.RumorState, rnd_from,
                                       cfg_kw, plan, traj)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rumor_step_matches_the_reference_every_period(name, trajectories):
    traj, last = port_run(name, trajectories)
    got = convert.state_to_numpy(last)
    # the case has teeth: rumors were originated
    assert any((s["subject"] >= 0).any() for s in traj["states"]), name
    if name == "small_capacity_retire":
        assert int(got["overflow"]) > 0
        allocated = sum(int(((s["birth"] == t) & (s["subject"] >= 0)).sum())
                        for t, s in enumerate(traj["states"]))
        assert allocated > 12                   # slots were reused
        assert (got["gone_key"] >> 31).sum() == 10
    if name == "lifeguard":
        assert any(int(s["lha"].max()) > 0 for s in traj["states"])


def test_chunked_reductions_equal_unchunked(trajectories, monkeypatch):
    """ROW_CHUNK and KNOW_GROUP shrunk to a few rows (chunks and groups
    that do not divide N): the same states, every period, with buddy
    witnesses over N(1 + k) messages."""
    monkeypatch.setattr(rumor, "ROW_CHUNK", 7)
    monkeypatch.setattr(rumor, "KNOW_GROUP", 3)
    port_run("lifeguard", trajectories)


@pytest.mark.parametrize("seed,step,n,k", [(0, 0, 200, 3), (9, 77, 5, 1)])
def test_draw_period_rumor_matches_the_reference(seed, step, n, k):
    want = jrumor.draw_period_rumor(jax.random.key(seed), step,
                                    JaxSwimConfig(n_nodes=n, k_indirect=k))
    got = rumor.draw_period_rumor(threefry.key(seed), step,
                                  SwimConfig(n_nodes=n, k_indirect=k), "cpu")
    np.testing.assert_array_equal(got.resample_u.numpy(),
                                  np.asarray(want.resample_u))
    for f in got.base._fields:
        np.testing.assert_array_equal(getattr(got.base, f).numpy(),
                                      np.asarray(getattr(want.base, f)), f)


def test_views_match_the_reference(trajectories):
    """view_matrix and opinion_of on a mid-run state with suspicions,
    deaths and tombstones."""
    cfg_kw, _, traj = trajectories("small_capacity_retire")
    mid = traj["states"][20]
    jcfg, cfg = JaxSwimConfig(**cfg_kw), SwimConfig(**cfg_kw)
    jst = jrumor.RumorState(**{f: jnp.asarray(v) for f, v in mid.items()})
    st = convert.state_from_numpy(mid, "cpu", rumor.RumorState)
    np.testing.assert_array_equal(
        convert._to_numpy(rumor.view_matrix(cfg, st), True),
        np.asarray(jrumor.view_matrix(jcfg, jst)))
    subj = np.random.default_rng(0).integers(0, cfg.n_nodes, cfg.n_nodes)
    want = jrumor.opinion_of(jst, jnp.asarray(subj, jnp.int32))
    got = rumor.opinion_of(st, torch.from_numpy(subj.astype(np.int32)))
    np.testing.assert_array_equal(convert._to_numpy(got[0], True),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

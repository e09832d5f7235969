"""The port's dense engine against `swim_tpu.models.dense`, bit for bit.

  * `draw_period` equals the JAX package's draws for the same key;
  * `round_robin_target` equals the JAX op and the Python twin;
  * from the same initial state and the same PeriodRandomness, the port's
    `step` gives the JAX package's DenseState after every period, in all
    five fields, for: crashes, loss 0.2, a partition, late joiners and a
    FaultProgram (gray and flapping link segments); Lifeguard with buddy;
    round-robin targets; n = 2 and n = 3 (no proxies).  The JAX step
    runs with its telemetry tap, the port's without and with it: both
    states equal, and the eight EngineFrame fields equal the JAX frame,
    every period.  (`run` from a
    seed is held to the JAX `run` by tests/test_torch_golden.py.)

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
from swim_tpu.models import dense as jdense
from swim_tpu.ops import sampling as jsampling
from swim_tpu.utils import prng as jprng
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import dense
from swim_tpu_torch.ops import sampling
from swim_tpu_torch.utils import prng, threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PERIODS = 30

CASES = {
    "faults": (dict(n_nodes=48), lambda: faults_plan(48, PERIODS)),
    "lifeguard": (dict(n_nodes=48, lifeguard=True),
                  lambda: crash_loss_plan(48, 0.2)),
    "round_robin": (dict(n_nodes=40, target_selection="round_robin"),
                    lambda: crash_loss_plan(40, 0.1)),
    "n2": (dict(n_nodes=2), lambda: crash_loss_plan(2, 0.3, ([1], [9]))),
    "n3": (dict(n_nodes=3), lambda: crash_loss_plan(3, 0.2, ([2], [5]))),
}


def rnd_from(d):
    return convert.period_randomness_from_numpy(np_fields(d), "cpu")


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    cfg_kw, build = CASES[request.param]
    plan = build()
    traj = jax_trajectory(jdense, jprng.draw_period, cfg_kw, plan, PERIODS)
    return request.param, cfg_kw, plan, traj


def test_dense_step_matches_the_reference_every_period(case):
    name, cfg_kw, plan, traj = case
    last = check_port_trajectory(dense, dense.DenseState, rnd_from, cfg_kw,
                                 plan, traj)
    # the case has teeth: suspicions were raised and gossiped
    key = convert.state_to_numpy(last)["key"]
    assert ((key & 1) == 1).any() or (key >> 31).any(), name
    if name == "lifeguard":
        assert any(int(s["lha"].max()) > 0 for s in traj["states"])
    if name == "faults":       # a crash was confirmed DEAD somewhere
        assert (key >> 31).any()


@pytest.mark.parametrize("seed,step,n,k", [(0, 0, 48, 3), (7, 123, 5, 1),
                                           (2**31 - 1, 9, 33, 4)])
def test_draw_period_matches_the_reference(seed, step, n, k):
    want = jprng.draw_period(jax.random.key(seed), step,
                             JaxSwimConfig(n_nodes=n, k_indirect=k))
    got = prng.draw_period(threefry.key(seed), step,
                           SwimConfig(n_nodes=n, k_indirect=k), "cpu")
    for f in prng.PeriodRandomness._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("n,epoch,pos", [(40, 0, 0), (40, 3, 38),
                                         (2, 5, 0), (1001, 77, 500)])
def test_round_robin_target_matches_the_reference(n, epoch, pos):
    ids = np.arange(n, dtype=np.int32)
    ep = np.full(n, epoch, np.int32)
    ps = np.full(n, pos, np.int32)
    want = np.asarray(jsampling.round_robin_target(
        jnp.asarray(ids), jnp.asarray(ep), jnp.asarray(ps), n))
    got = sampling.round_robin_target(torch.from_numpy(ids),
                                      torch.from_numpy(ep),
                                      torch.from_numpy(ps), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert [sampling.py_round_robin_target(i, epoch, pos, n)
            for i in range(n)] == want.tolist()
    assert (got != ids).all()

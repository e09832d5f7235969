"""The port's ring engine against `swim_tpu.models.ring`, bit for bit.

Step-by-step parity: JAX's `draw_period_ring` draws each period's
randomness, it is carried across (convert.randomness_from_numpy), both
engines step, and all 14 RingState fields must be equal after every
period.  The port follows the engine, not the oracle, so stale freed
table slots and every `cold` column are compared too.  All configs use
`ring_sel_scope="period"` (the ported slice).  Whole-run parity holds
the port's own threefry against `ring.run(..., jax.random.key(seed))`.
Tolerance: exact.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.sim import faults as jfaults
from swim_tpu.types import Status, key_status
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import ring
from swim_tpu_torch.sim import faults


def np_fields(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def assert_same_state(port: ring.RingState, ref, where: str):
    got = convert.state_to_numpy(port)
    for f in jring.RingState._fields:
        want = np.asarray(getattr(ref, f))
        assert got[f].dtype == want.dtype, f"{f} dtype @ {where}"
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{f} @ {where}")


def jax_plan(name: str, n: int):
    none = jfaults.none(n)
    if name == "crash":
        return jfaults.with_crashes(none, [5], [2])
    if name == "loss":
        return jfaults.with_loss(none, 0.08)
    if name == "partition":
        return jfaults.with_partition(jfaults.with_loss(none, 0.05),
                                      jfaults.halves(n), 3, 9)
    if name == "join":
        plan = jfaults.with_joins(none, [20, 21], [5])
        plan = jfaults.with_crashes(plan, [3, 20], [9])
        return jfaults.with_joins(plan, [22], [12])
    if name == "wide":
        plan = jfaults.with_crashes(none, [5, 77, 600, 1499], [2, 2, 4, 6])
        return jfaults.with_loss(plan, 0.05)
    raise KeyError(name)


# (name, n, periods, seed): the crash lifecycle / loss / partition / join
# patterns of tests/test_ring.py, plus one N >= 1024 not a power of two
CASES = [("crash", 32, 26, 7), ("loss", 32, 30, 3), ("partition", 24, 16, 4),
         ("join", 24, 24, 5), ("wide", 1500, 20, 11)]


def step_both(name, n, periods, seed):
    jcfg = JaxSwimConfig(n_nodes=n, ring_sel_scope="period")
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    jplan = jax_plan(name, n)
    plan = convert.plan_from_numpy(np_fields(jplan), "cpu")
    key = jax.random.key(seed)
    jstep = jax.jit(lambda s, r: jring.step(jcfg, s, jplan, r))
    jdraw = jax.jit(lambda t: jring.draw_period_ring(key, t, jcfg))
    js = jring.init_state(jcfg)
    ts = ring.init_state(cfg, "cpu")
    for t in range(periods):
        rnd = jdraw(t)
        js = jstep(js, rnd)
        ts = ring.step(cfg, ts, plan,
                       convert.randomness_from_numpy(np_fields(rnd), "cpu"))
        assert_same_state(ts, js, f"{name} period {t}")
    return js, ts


@pytest.mark.parametrize("name,n,periods,seed", CASES)
def test_step_parity(name, n, periods, seed):
    js, _ = step_both(name, n, periods, seed)
    gone = np.asarray(js.gone_key)
    if name == "crash":
        assert key_status(int(gone[5])) == Status.DEAD
    if name == "join":
        assert key_status(int(gone[3])) == Status.DEAD
        assert key_status(int(gone[22])) != Status.DEAD


@pytest.mark.parametrize("seed", [0, 9])
def test_run_parity(seed):
    """run(seed) == ring.run(key(seed)), with the port's own threefry;
    two chunks of a run equal the run in one piece."""
    n, periods = 64, 20
    jcfg = JaxSwimConfig(n_nodes=n, ring_sel_scope="period")
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    jplan = jfaults.with_loss(jfaults.with_crashes(jfaults.none(n), [9, 40],
                                                   [1, 3]), 0.1)
    plan = convert.plan_from_numpy(np_fields(jplan), "cpu")
    want = jring.run(jcfg, jring.init_state(jcfg), jplan,
                     jax.random.key(seed), periods)
    got = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, seed, periods)
    assert_same_state(got, want, f"run seed {seed}")
    half = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, seed, 7)
    rest = ring.run(cfg, half, plan, seed, periods - 7)
    assert_same_state(rest, want, f"chunked run seed {seed}")


def test_state_round_trips_from_jax():
    """A mid-run JAX state carried across keeps stepping in lockstep."""
    n = 48
    jcfg = JaxSwimConfig(n_nodes=n, ring_sel_scope="period")
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    jplan = jfaults.with_loss(jfaults.with_crashes(jfaults.none(n), [4],
                                                   [1]), 0.1)
    mid = jring.run(jcfg, jring.init_state(jcfg), jplan, jax.random.key(2),
                    6)
    ts = convert.state_from_numpy(np_fields(mid), "cpu")
    assert_same_state(ts, mid, "converted")
    plan = convert.plan_from_numpy(np_fields(jplan), "cpu")
    want = jring.run(jcfg, mid, jplan, jax.random.key(2), 6)
    assert_same_state(ring.run(cfg, ts, plan, 2, 6), want, "resumed")


def test_engine_runs_on_cpu():
    n = 40
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    plan = faults.with_crashes(faults.none(n, "cpu"), [3], [1])
    eng = ring.RingEngine(cfg, plan, seed=4, device="cpu")
    eng.run(5)
    eng.run(1)
    want = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 4, 6)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(eng.state, f), getattr(want, f)), f
    assert int(eng.state.step) == 6


@pytest.mark.parametrize("kw", [
    dict(ring_sel_scope="wave"), dict(ring_probe="pull"),
    dict(lifeguard=True), dict(ring_scalar_wire="packed"),
    dict(telemetry=True), dict(k_indirect=8)])
def test_out_of_slice_configs_raise(kw):
    cfg = SwimConfig(n_nodes=16, **{"ring_sel_scope": "period", **kw})
    plan = faults.none(16, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ring.RingEngine(cfg, plan, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 0, 1)


@pytest.mark.parametrize("arg", ["ext", "tap", "prof", "program"])
def test_out_of_slice_arguments_raise(arg):
    cfg = SwimConfig(n_nodes=16, ring_sel_scope="period")
    plan = faults.none(16, "cpu")
    state = ring.init_state(cfg, "cpu")
    rnd = ring.draw_period_ring((0, 0), 0, cfg, "cpu")
    kw = {} if arg == "program" else {arg: object()}
    if arg == "program":
        plan = (plan, "segments")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ring.step(cfg, state, plan, rnd, **kw)

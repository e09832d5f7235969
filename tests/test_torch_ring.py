"""The port's ring engine against `swim_tpu.models.ring`, bit for bit.

Step-by-step parity: JAX's `draw_period_ring` draws each period's
randomness, it is carried across (convert.randomness_from_numpy), both
engines step, and all 14 RingState fields must be equal after every
period.  The JAX step runs with its telemetry tap (its state is the
untapped one, as the reference pins); the port steps without the tap
(the kernels' plain versions, `plain=True`) and with it (through the
kernel wrappers), both states must equal the JAX state and the eight
EngineFrame fields the JAX frame.  The port follows the engine, not the oracle, so stale freed
table slots and every `cold` column are compared too.  The configs:
period scope (one selection a period, waves fused), wave scope (the
default: a selection and a delivery per wave), `k_indirect=8` (period
scope past 32 waves, delivered in-line), and Lifeguard with and without
buddy and dynamic suspicion, in both scopes (those cases run from
tests/test_torch_lifeguard.py).  The Lifeguard cases assert that a
buddy bit was forced and that a health score left 0, so they have
teeth.  Whole-run parity holds the port's own threefry against
`ring.run(..., jax.random.key(seed))`.  Tolerance: exact.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from torch_engine_cases import (assert_same_frame, jax_tapped_step,
                                one_torch_thread)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.sim import faults as jfaults
from swim_tpu.types import Status, key_status
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs.engine import frame_from_tap
from swim_tpu_torch.ops import wavemerge
from swim_tpu_torch.sim import faults

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
    if name == "lossy":     # probes fail even through eight proxies
        return jfaults.with_loss(none, 0.35)
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


# config name -> SwimConfig keywords beyond n_nodes
CONFIGS = {
    "period": dict(ring_sel_scope="period"),
    "wave": {},
    "k8": dict(ring_sel_scope="period", k_indirect=8),
    "lg_period": dict(ring_sel_scope="period", lifeguard=True),
    "lg_wave": dict(lifeguard=True),
    "lg_nobuddy": dict(ring_sel_scope="period", lifeguard=True, buddy=False),
    "lg_static": dict(ring_sel_scope="period", lifeguard=True,
                      dynamic_suspicion=False),
    "lg_k8": dict(ring_sel_scope="period", lifeguard=True, k_indirect=8),
}

# (name, n, periods, seed): the crash lifecycle / loss / partition / join
# patterns of tests/test_ring.py, plus one N >= 1024 not a power of two
CASES = [("crash", 32, 26, 7), ("loss", 32, 30, 3), ("partition", 24, 16, 4),
         ("join", 24, 24, 5), ("wide", 1500, 20, 11)]
_BY_NAME = {c[0]: c for c in CASES + [("lossy", 32, 24, 6)]}
# (config, plan case); the period-scope cases keep their bare ids
STEP_CASES = ([("period",) + c for c in CASES]
              + [("wave",) + c for c in CASES]
              + [("k8",) + _BY_NAME[nm] for nm in ("crash", "lossy")])
# the Lifeguard cases run in tests/test_torch_lifeguard.py
LIFEGUARD_STEP_CASES = [
    (cf,) + _BY_NAME[nm]
    for cf, names in (("lg_period", ("crash", "loss", "partition", "wide")),
                      ("lg_wave", ("loss", "wide")),
                      ("lg_nobuddy", ("crash", "loss")),
                      ("lg_static", ("crash", "loss")),
                      ("lg_k8", ("crash", "lossy")))
    for nm in names]


def case_id(case):
    tail = "-".join(str(x) for x in case[1:])
    return tail if case[0] == "period" else f"{case[0]}-{tail}"


@functools.lru_cache(maxsize=None)
def jax_draw(jcfg):
    """JAX's `draw_period_ring` for `jcfg`, jitted with the key and the
    period as arguments (one compile per config)."""
    return jax.jit(lambda key, t: jring.draw_period_ring(key, t, jcfg))


def step_both(cfg_name, name, n, periods, seed, monkeypatch):
    """Step both engines in lockstep, the port without and with the tap;
    returns (JAX state, port state, stats) with the forced buddy bits
    delivered (counted on the tapped step) and the largest health score
    seen over the run."""
    kw = CONFIGS[cfg_name]
    jcfg = JaxSwimConfig(n_nodes=n, **kw)
    cfg = SwimConfig(n_nodes=n, **kw)
    jplan = jax_plan(name, n)
    plan = convert.plan_from_numpy(np_fields(jplan), "cpu")
    key = jax.random.key(seed)
    jtapped = jax_tapped_step(jring, jcfg)
    jdraw = jax_draw(jcfg)
    js = jring.init_state(jcfg)
    ts = ring.init_state(cfg, "cpu")
    stats = dict(forced=0, forced_rows=0, merges=0, lha_max=0)
    real_merge = wavemerge.merge_waves

    def spy(win, sel, oks, offs, bcol, bval):
        stats["forced"] += int((bval != 0).sum())
        stats["forced_rows"] = max(stats["forced_rows"], bval.shape[0])
        stats["merges"] += 1
        return real_merge(win, sel, oks, offs, bcol, bval)

    monkeypatch.setattr(wavemerge, "merge_waves", spy)
    for t in range(periods):
        rnd = jdraw(key, t)
        js, jframe = jtapped(js, jplan, rnd)
        trnd = convert.randomness_from_numpy(np_fields(rnd), "cpu")
        where = f"{cfg_name} {name} period {t}"
        plain = ring.step(cfg, ts._replace(cold=ts.cold.clone()), plan, trnd,
                          plain=True)
        tap = {}
        ts = ring.step(cfg, ts, plan, trnd, tap=tap)
        assert_same_state(plain, js, f"{where} (untapped)")
        assert_same_state(ts, js, where)
        assert_same_frame(frame_from_tap(tap, "cpu"), jframe, where)
        stats["lha_max"] = max(stats["lha_max"], int(ts.lha.max()))
    return js, ts, stats


@pytest.mark.parametrize("cfg_name,name,n,periods,seed", STEP_CASES,
                         ids=[case_id(c) for c in STEP_CASES])
def test_step_parity(cfg_name, name, n, periods, seed, monkeypatch):
    check_step_parity(cfg_name, name, n, periods, seed, monkeypatch)


def check_step_parity(cfg_name, name, n, periods, seed, monkeypatch):
    js, _, stats = step_both(cfg_name, name, n, periods, seed, monkeypatch)
    gone = np.asarray(js.gone_key)
    if name == "crash":
        assert key_status(int(gone[5])) == Status.DEAD
    if name == "join":
        assert key_status(int(gone[3])) == Status.DEAD
        assert key_status(int(gone[22])) != Status.DEAD
    kw = CONFIGS[cfg_name]
    k = kw.get("k_indirect", 3)
    fused = kw.get("ring_sel_scope") == "period" and k <= 7
    assert stats["merges"] == periods * (1 if fused else 2 + 4 * k)
    if kw.get("lifeguard"):
        assert stats["lha_max"] > 0, "no health score left 0"
        if kw.get("buddy", True):
            assert stats["forced_rows"] == (1 + k if fused else 1)
            if name != "crash":     # a crashed suspect receives nothing
                assert stats["forced"] > 0, "no buddy bit was forced"
        else:
            assert stats["forced_rows"] == 0
    else:
        assert stats["lha_max"] == 0 and stats["forced_rows"] == 0


RUN_CASES = [(cf, seed) for cf in ("period", "wave") for seed in (0, 9)]


@pytest.mark.parametrize(
    "cfg_name,seed", RUN_CASES,
    ids=[str(sd) if cf == "period" else f"{cf}-{sd}" for cf, sd in RUN_CASES])
def test_run_parity(cfg_name, seed):
    """run(seed) == ring.run(key(seed)), with the port's own threefry;
    two chunks of a run equal the run in one piece."""
    check_run_parity(cfg_name, seed)


def check_run_parity(cfg_name, seed):
    n, periods = 64, 20
    jcfg = JaxSwimConfig(n_nodes=n, **CONFIGS[cfg_name])
    cfg = SwimConfig(n_nodes=n, **CONFIGS[cfg_name])
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
    if CONFIGS[cfg_name].get("lifeguard"):
        assert int(got.lha.max()) > 0 or int(got.inc_self.max()) > 0


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
    dict(profiling=True), dict(ring_scalar_wire="packed", profiling=True),
    dict(telemetry=True, profiling=True)], ids=["kw1", "kw3", "kw4"])
def test_out_of_slice_configs_raise(kw):
    """The profiling tap raises naming its ROADMAP item; the packed wire
    and telemetry, which run, do not lift the refusal."""
    cfg = SwimConfig(n_nodes=16, **{"ring_sel_scope": "period", **kw})
    plan = faults.none(16, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ring.RingEngine(cfg, plan, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 0, 1)


@pytest.mark.parametrize("arg", ["ext", "tap", "prof", "program"])
def test_out_of_slice_arguments_raise(arg):
    """prof raises naming its ROADMAP item, also beside a tap (which
    runs); a FaultProgram under pull-uniform probing raises as the
    reference does.  `ext`, ported since, runs: a batch with a
    suspicion, a death and an empty slot gives the JAX step's state in
    all 14 fields (tolerance 0)."""
    probe = "pull" if arg == "program" else "rotor"
    cfg = SwimConfig(n_nodes=16, ring_sel_scope="period", ring_probe=probe)
    plan = faults.none(16, "cpu")
    state = ring.init_state(cfg, "cpu")
    rnd = ring.draw_period_ring((0, 0), 0, cfg, "cpu")
    if arg == "ext":
        jcfg = JaxSwimConfig(n_nodes=16, ring_sel_scope="period")
        jrnd = jring.draw_period_ring(jax.random.key(0), 0, jcfg)
        jext = jring.ExtOriginations(
            subject=np.array([3, 9, -1], np.int32),
            key=np.array([1, 1 << 31, 0], np.uint32),
            origin=np.array([5, 2, 0], np.int32),
            hearer=np.array([7, 2, 0], np.int32))
        want = jax.jit(functools.partial(jring.step, jcfg))(
            jring.init_state(jcfg), jfaults.none(16), jrnd, ext=jext)
        got = ring.step(cfg, state, plan,
                        convert.randomness_from_numpy(np_fields(jrnd), "cpu"),
                        ext=convert.ext_from_numpy(np_fields(jext), "cpu"))
        assert_same_state(got, want, "ext")
        assert int((got.subject >= 0).sum()) == 2
        return
    kw, match = {
        "prof": ({"prof": object()}, "ROADMAP.*instruments"),
        "tap": ({"tap": {}, "prof": object()}, "ROADMAP.*instruments"),
        "program": ({}, "pull-uniform")}[arg]
    if arg == "program":
        plan = faults.with_segment(faults.as_program(plan, capacity=1), 0,
                                   start=0, end=4, kind="gray", level=0.5)
    with pytest.raises(NotImplementedError, match=match):
        ring.step(cfg, state, plan, rnd, **kw)


def test_program_runs_and_empty_program_is_the_plain_plan():
    """A FaultProgram runs through the engine entry points, and one with
    zero segments gives the plain plan's run exactly."""
    n = 32
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    plan = faults.with_crashes(faults.none(n, "cpu"), [4], [1])
    want = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 3, 6)
    got = ring.run(cfg, ring.init_state(cfg, "cpu"),
                   faults.as_program(plan), 3, 6)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    prog = faults.with_segment(faults.as_program(plan, capacity=1), 0,
                               start=0, end=6, kind="send_loss", level=0.9)
    eng = ring.RingEngine(cfg, prog, seed=3, device="cpu")
    lossy = eng.run(6)
    assert not torch.equal(lossy.win, want.win)

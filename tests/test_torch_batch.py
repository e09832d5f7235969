"""Batched fault-program studies: `faults.ProgramBatch` against the
reference's arrays, and every lane of `experiments._run_study_batch`
equal to its serial run.

  * `pad_program`, `stack_programs` and `lane_program` give the arrays of
    `swim_tpu.sim.faults` for the same programs, and refuse what they
    refuse; `to_numpy` gives the reference's dtypes;
  * every lane of a P = 3 batch (programs with 0, 1 and 2 segments, so
    padding is exercised, each with its own threefry key and telemetry
    on) equals the serial study of its unpadded program, leaf for leaf,
    on the dense, rumor and ring engines; a P = 1 batch equals its
    serial run, and padding to an explicit capacity is invisible;
  * the ring batch (Lifeguard, period scope, telemetry) equals the JAX
    `_run_study_batch` on the same programs and keys, lane by lane:
    state, track, series and frames;
  * `shard` is refused (ValueError), as in the reference; a `ringshard`
    batch (the sharded ring engine, 8 shards) equals the ring batch lane
    for lane; a lane count that differs from the key count is refused.

The serial studies under programs are held to the JAX package by
tests/test_torch_program.py, test_torch_dense.py and
test_torch_rumor.py; the dense and rumor batches are held to those
serial runs here.  Tolerance: exact.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.sim import experiments as jexperiments
from swim_tpu.sim import faults as jfaults
from swim_tpu.sim import runner as jrunner
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.sim import experiments, faults, runner
from swim_tpu_torch.utils import threefry
from swim_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, T = 32, 6
LOSS = dict(kind="link_loss", start=1, end=5, level=0.4, domain=2)
GRAY = dict(kind="gray", start=2, end=6, level=0.3, domain=1)
LANE_EVENTS = [[], [LOSS], [dict(LOSS, level=0.15), GRAY]]


def program(mod, plan, events, n=N, capacity=None):
    prog = mod.as_program(plan, np.arange(n) % 4,
                          capacity=len(events) if capacity is None
                          else capacity)
    for slot, ev in enumerate(events):
        prog = mod.with_segment(prog, slot, **ev)
    return prog


def port_program(events, n=N, capacity=None):
    plan = faults.with_loss(faults.with_crashes(
        faults.none(n, "cpu"), [3, n - 5], [1, 3]), 0.05)
    return program(faults, plan, events, n, capacity)


def jax_program(events, n=N, capacity=None):
    plan = jfaults.with_loss(jfaults.with_crashes(
        jfaults.none(n), [3, n - 5], [1, 3]), 0.05)
    return program(jfaults, plan, events, n, capacity)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def assert_same_program(port, ref):
    """Every leaf of a (stacked) FaultProgram equal to the reference's,
    u32 levels through their carriers."""
    for a, b in zip(leaves(port), leaves(ref)):
        want = np.asarray(b)
        got = a.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_program_batch_matches_the_reference():
    progs = [port_program(ev) for ev in LANE_EVENTS]
    jprogs = [jax_program(ev) for ev in LANE_EVENTS]
    batch = faults.stack_programs(progs)
    jbatch = jfaults.stack_programs(jprogs)
    assert batch.size == jbatch.size == 3
    assert tuple(batch.program.seg_kind.shape) == (3, 2)
    assert tuple(batch.program.base.crash_step.shape) == (3, N)
    assert_same_program(batch.program, jbatch.program)
    for p in range(3):
        assert_same_program(faults.lane_program(batch, p),
                            jfaults.lane_program(jbatch, p))
    wide = faults.stack_programs(progs, capacity=5)
    assert_same_program(wide.program,
                        jfaults.stack_programs(jprogs, capacity=5).program)
    padded = faults.pad_program(progs[1], 3)
    assert faults.pad_program(progs[1], 1) is progs[1]
    assert_same_program(padded, jfaults.pad_program(jprogs[1], 3))
    assert int(padded.seg_kind[1:].abs().sum()) == 0
    assert padded.seg_domain[1:].tolist() == [-1, -1]
    for bad in (dict(progs=[]), dict(progs=progs, capacity=1),
                dict(progs=[progs[0], port_program([], n=N + 4)])):
        with pytest.raises(ValueError):
            faults.stack_programs(**bad)
    with pytest.raises(IndexError):
        faults.lane_program(batch, 3)
    with pytest.raises(ValueError):
        faults.pad_program(progs[2], 1)
    got = faults.to_numpy(progs[1].base)
    want = jfaults.to_numpy(jprogs[1].base)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def assert_lane_equals(lane, serial, what):
    a, b = leaves(lane), leaves(serial)
    assert len(a) == len(b), f"{what}: structure"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


ENGINE_CFGS = {
    "dense": dict(telemetry=True),
    "rumor": dict(telemetry=True, lifeguard=True),
    "ring": dict(telemetry=True, lifeguard=True, ring_sel_scope="period"),
}


@pytest.mark.parametrize("engine", sorted(ENGINE_CFGS))
def test_lanes_equal_their_serial_runs(engine):
    cfg = SwimConfig(n_nodes=N, **ENGINE_CFGS[engine])
    progs = [port_program(ev) for ev in LANE_EVENTS]
    keys = [threefry.key(100 + p) for p in range(3)]
    batched = experiments._run_study_batch(cfg, progs, keys, T, engine,
                                           device="cpu")
    assert batched.telemetry.waves_delivered.shape == (3, T)
    assert batched.series.dead_views.shape == (3, T)
    for p in range(3):
        serial = experiments._run_study(cfg, progs[p], keys[p], T, engine,
                                        torch.device("cpu"))
        assert_lane_equals(runner.lane_result(batched, p), serial,
                           f"{engine} lane {p}")
    # the lanes differ: the programs changed the runs
    assert not torch.equal(batched.series.suspect_views[0],
                           batched.series.suspect_views[2])


def test_ring_batch_matches_the_reference():
    kw = dict(n_nodes=N, **ENGINE_CFGS["ring"])
    cfg, jcfg = SwimConfig(**kw), JaxSwimConfig(**kw)
    batched = experiments._run_study_batch(
        cfg, [port_program(ev) for ev in LANE_EVENTS],
        [threefry.key(100 + p) for p in range(3)], T, "ring", device="cpu")
    want = jexperiments._run_study_batch(
        jcfg, [jax_program(ev) for ev in LANE_EVENTS],
        [jax.random.key(100 + p) for p in range(3)], T, "ring")
    for p in range(3):
        lane, ref = runner.lane_result(batched, p), jrunner.lane_result(
            want, p)
        for part in ("state", "track", "series", "telemetry"):
            got_nt, ref_nt = getattr(lane, part), getattr(ref, part)
            got = (convert.state_to_numpy(got_nt) if part == "state"
                   else convert.tuple_to_numpy(got_nt))
            assert tuple(got) == ref_nt._fields, f"lane {p} {part}"
            for f in ref_nt._fields:
                exp = np.asarray(getattr(ref_nt, f))
                assert got[f].dtype == exp.dtype, f"lane {p} {part}.{f}"
                np.testing.assert_array_equal(
                    got[f], exp, err_msg=f"lane {p} {part}.{f}")
    assert int(batched.telemetry.waves_delivered.min()) > 0


def test_p1_and_explicit_capacity_padding_are_invisible():
    cfg = SwimConfig(n_nodes=N, lifeguard=True, ring_sel_scope="period")
    prog = port_program([LOSS])
    key = threefry.key(9)
    serial = experiments._run_study(cfg, prog, key, T, "ring",
                                    torch.device("cpu"))
    assert serial.telemetry is None
    for cap in (None, 4):
        batched = experiments._run_study_batch(cfg, [prog], [key], T, "ring",
                                               capacity=cap, device="cpu")
        assert batched.telemetry is None
        assert_lane_equals(runner.lane_result(batched, 0), serial,
                           f"capacity {cap}")
    states = runner.batch_states([convert.state_from_numpy(
        convert.state_to_numpy(serial.state), "cpu")] * 2)
    assert states.win.shape == (2,) + tuple(serial.state.win.shape)
    with pytest.raises(ValueError, match="empty"):
        runner.batch_states([])


def test_refused_engines_and_key_counts():
    cfg = SwimConfig(n_nodes=N)
    progs = [port_program([LOSS])]
    with pytest.raises(ValueError, match="fault-program"):
        experiments._run_study_batch(cfg, progs, [threefry.key(0)], T,
                                     "shard", device="cpu")
    keys = [threefry.key(0)]
    got = experiments._run_study_batch(cfg, progs, keys, T, "ringshard",
                                       device="cpu")
    want = experiments._run_study_batch(cfg, progs, keys, T, "ring",
                                        device="cpu")
    assert len(leaves(got)) == len(leaves(want)) > 0
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="root keys"):
        experiments._run_study_batch(cfg, progs * 2, [threefry.key(0)], T,
                                     "ring", device="cpu")

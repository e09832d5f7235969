"""Batches of the sharded ring and of partitioned studies as one step a
period over the lane axis, on 8 CPU shard slots: the placed trees with a
lane axis (`mesh.split(..., lanes)`, `Sharded.lead`), the collectives'
lane forms, and `ring_shard.ShardedStep` / `partition.PartitionedStep`
on lane-stacked placed trees, crossing a batched study's vmap.

  * The port's `ringshard` batch equals the JAX package's
    `_run_study_batch(..., "ringshard")` on the 8 virtual devices of
    tests/conftest.py, lane by lane: state, track, series and telemetry.
    The geometry is the reference's `TestShardedBatchedParity`: N = 32,
    5 periods, its three programs and keys, P = 3, telemetry on.  Each
    lane also equals the port's serial `ringshard` study, and the batch
    makes one sharded step a period.
  * The collectives (permute of a tensor and of a tuple, stack,
    stack_many, psum, pmax, one operand the lanes share), called under
    each shard thread's vmap on lane-stacked blocks, equal their
    per-lane calls, with one rendezvous each for all lanes.
  * A batched sharded period (the default wave scope, N = 64, P = 3)
    makes one lane's rendezvous.  Under a TorchDispatchMode entered in
    every shard thread (the step's `around`), it dispatches at most
    SHARD_LANE_OPS more non-view aten ops than one lane's sharded
    period, and its lanes equal the serial period's.
  * The partitioned dense (telemetry off), rumor and ring two-lane
    batches (8 CPU slots counted as 8 devices) equal their serial
    partitioned lanes.  Each
    makes one partitioned step and one lane's rendezvous a period.
  * Placed lane-stacked trees: `batch_states` and `lane_result` of
    placed states, a placement with a lane axis, and `Sharded.whole`
    and `shape`.

PyTorch's vmap fallback is an error throughout: an op without a
batching rule would run lane by lane.  Tolerance: exact.  The port's
ops run on one thread.
"""
from __future__ import annotations

import collections
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_engine_cases import one_torch_thread

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.sim import experiments as jexperiments
from swim_tpu.sim import runner as jrunner
from swim_tpu.sim import scenario as jscenario
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import ring
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import partition, ring_shard
from swim_tpu_torch.sim import experiments, faults, runner, scenario
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")
assert one_torch_thread

D, P = 8, 3
# the reference's TestShardedBatchedParity
N, T = 32, 5
RING_KW = dict(suspicion_mult=1.0, k_indirect=1, max_piggyback=2,
               ring_window_periods=2, ring_view_c=2, telemetry=True,
               lifeguard=True, buddy=True, ring_probe="rotor",
               ring_sel_scope="period", ring_scalar_wire="packed")
EV_LOSS = {"kind": "link_loss", "start": 1, "end": 5, "level": 0.4,
           "domain": 2}
EV_GRAY = {"kind": "gray", "start": 2, "end": 6, "level": 0.3,
           "domain": 1}
LANE_EVENTS = ([], [EV_LOSS], [dict(EV_LOSS, level=0.2), EV_GRAY])
# non-view aten ops a batched sharded period may dispatch in its shard
# threads beyond one lane's sharded period: the batching rules' lane
# index ramps and copies, as tests/test_torch_lanes.py's LANE_OPS, on
# each of the D shards
SHARD_LANE_OPS = 150 * D
VIEWS = {"view", "_unsafe_view", "unsqueeze", "squeeze", "permute",
         "select", "slice", "expand", "alias", "t", "transpose",
         "as_strided", "detach", "lift_fresh", "unbind", "split",
         "diagonal", "view_as", "_reshape_alias", "movedim"}


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """The vmap fallback's warning as an error (the shard threads'
    too: the warning filters are the process's)."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def cpu_mesh() -> pmesh.Mesh:
    return pmesh.make_mesh(devices=["cpu"] * D)


def leaves(tree) -> list:
    """The tensors of a tree (lists, NamedTuples, placed leaves' blocks
    in shard order)."""
    return torch.utils._pytree.tree_leaves(tree)


def assert_same(got, want, what):
    a, b = leaves(got), leaves(want)
    assert len(a) == len(b), f"{what}: structure"
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:      # telemetry off
            assert x is y, f"{what}: leaf {i}"
            continue
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


def assert_result(got, want, what):
    """Every part of a port study result equal to the JAX one's."""
    for part in ("state", "track", "series", "telemetry"):
        g_nt, w_nt = getattr(got, part), getattr(want, part)
        g = (convert.state_to_numpy(g_nt) if part == "state"
             else convert.tuple_to_numpy(g_nt))
        assert tuple(g) == w_nt._fields, f"{what} {part}"
        for f in w_nt._fields:
            exp = np.asarray(getattr(w_nt, f))
            assert g[f].dtype == exp.dtype, f"{what} {part}.{f}"
            np.testing.assert_array_equal(g[f], exp,
                                          err_msg=f"{what} {part}.{f}")


def spec(mod, events):
    return mod.Scenario(name="t", n=N, periods=T, domains="blocks:4",
                        events=list(events))


@pytest.fixture(scope="module")
def reference():
    """The JAX package's ringshard batch on the 8 virtual devices."""
    return jax.block_until_ready(jexperiments._run_study_batch(
        JaxSwimConfig(n_nodes=N, **RING_KW),
        [jscenario.compile_program(spec(jscenario, ev))
         for ev in LANE_EVENTS],
        [jax.random.key(40 + i) for i in range(P)], T, "ringshard"))


@pytest.fixture
def spmd_calls(monkeypatch):
    """The number of shard-thread runs (`mesh.run_spmd` calls): one per
    sharded or partitioned step."""
    calls = []
    real = pmesh.run_spmd
    monkeypatch.setattr(pmesh, "run_spmd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def test_ringshard_batch_equals_the_jax_batch_and_its_serial_lanes(
        reference, spmd_calls):
    cfg = SwimConfig(n_nodes=N, **RING_KW)
    progs = [scenario.compile_program(spec(scenario, ev), "cpu")
             for ev in LANE_EVENTS]
    keys = [threefry.key(40 + i) for i in range(P)]
    got = experiments._run_study_batch(cfg, progs, keys, T, "ringshard",
                                       device="cpu")
    assert len(spmd_calls) == T
    assert got.telemetry.waves_delivered.shape == (P, T)
    assert not isinstance(got.state.win, pmesh.Sharded)
    for p in range(P):
        lane = runner.lane_result(got, p)
        assert_result(lane, jrunner.lane_result(reference, p), f"lane {p}")
        assert_same(lane, experiments._run_study(cfg, progs[p], keys[p], T,
                                                 "ringshard", "cpu"),
                    f"lane {p} against its serial study")
    assert not torch.equal(got.series.suspect_views[0],
                           got.series.suspect_views[2])


def test_collectives_on_lanes_equal_per_lane_calls():
    mesh = cpu_mesh()
    gen = torch.Generator().manual_seed(5)
    xs = torch.randint(-99, 99, (D, P, 6), generator=gen, dtype=torch.int32)
    ys = torch.randint(0, 2, (D, P, 3, 2), generator=gen).bool()
    shared = torch.arange(4, dtype=torch.int32)

    def exchanges(rank, coll, x, y):
        srcs = ((rank + 1) % D, (rank - 3) % D)
        rolled = coll.permute(rank, x, srcs)
        pairs = coll.permute(rank, (x, y), srcs[:1])[0]
        return (*rolled, *pairs, coll.stack(rank, x),
                *coll.stack_many(rank, (x, y.to(torch.int32))),
                coll.psum(rank, x), coll.pmax(rank, x),
                coll.psum(rank, shared + rank),
                coll.psum(rank, x)[:4] + coll.pmax(rank, shared))

    mesh.rendezvous = 0
    got = pmesh.run_spmd(mesh, lambda r, c: torch.func.vmap(
        lambda x, y: exchanges(r, c, x, y))(xs[r], ys[r]))
    batched = mesh.rendezvous
    for p in range(P):
        mesh.rendezvous = 0
        want = pmesh.run_spmd(mesh, lambda r, c, p=p: exchanges(
            r, c, xs[r, p], ys[r, p]))
        assert mesh.rendezvous == batched == 9
        for r in range(D):
            for i, (g, w) in enumerate(zip(got[r], want[r], strict=True)):
                assert g.dtype == w.dtype and torch.equal(g[p], w), (p, r, i)


class OpCount(TorchDispatchMode):
    """Non-view aten ops dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def _count(step, modes):
    step.around = lambda rank: modes[rank]


def test_a_batched_sharded_period_is_one_lanes_period():
    n = 64
    cfg = SwimConfig(n_nodes=n, telemetry=True)
    plan = faults.with_loss(faults.with_crashes(
        faults.none(n, "cpu"), [3, n - 5], [1, 3]), 0.05)
    progs = [faults.with_segment(faults.as_program(
        plan, np.arange(n) % 4, capacity=1), 0, kind="gray", start=1, end=5,
        level=0.1 * (p + 1), domain=1) for p in range(P)]
    keys = [threefry.key(5 + p) for p in range(P)]
    mesh, state, plans, step = ring_shard.start(
        cfg, faults.stack_programs(progs).program, "cpu")
    assert state.win.lead == 1 and state.win.shape[:2] == (P, n)
    track = runner.StudyTrack(*(torch.full((P, n), runner.NEVER,
                                           dtype=torch.int32)
                                for _ in range(3)))
    draws = list(ring.period_draws(cfg, keys, 0, 2, "cpu"))
    period = runner.batch_period(cfg, "ring", draws[0][0], step)
    state, track, _, _ = period(state, track, plans, *draws[0])
    modes = [OpCount() for _ in range(D)]
    _count(step, modes)
    mesh.rendezvous = 0
    out = period(state, track, plans, *draws[1])
    rendezvous = mesh.rendezvous
    batched = sum(sum(m.ops.values()) for m in modes)
    bops = sum((m.ops for m in modes), collections.Counter())

    one = [runner.lane_result(t, 0) for t in (state, track, plans)]
    rnd1 = next(ring.period_draws(cfg, keys[0], 1, 1, "cpu"))[0]
    modes = [OpCount() for _ in range(D)]
    _count(step, modes)
    mesh.rendezvous = 0
    want = runner.ring_study_period(
        cfg, one[0], one[1], pmesh.assemble(faults.base_of(one[2])), rnd1,
        runner.make_stepper(cfg, one[2], ring.step, step), draws[1][1])
    serial = sum(sum(m.ops.values()) for m in modes)
    assert mesh.rendezvous == rendezvous > 0
    step.around = None
    assert_same([runner.lane_result(out[0], 0), runner.lane_result(
        out[1], 0), [x[0] for x in out[2]], runner.lane_result(out[3], 0)],
        [want[0], want[1], list(want[2]), want[3]], "lane 0")
    assert serial > 1000
    assert batched <= serial + SHARD_LANE_OPS, (
        batched, serial, (bops - sum((m.ops for m in modes),
                                     collections.Counter())).most_common(12))


N_PART, T_PART = 64, 4
PART_CFGS = {
    "dense": dict(n_nodes=N_PART, lifeguard=True),
    "rumor": dict(n_nodes=N_PART, rumor_capacity=64, telemetry=True,
                  lifeguard=True),
    "ring": dict(n_nodes=N_PART, telemetry=True, ring_sel_scope="period",
                 suspicion_mult=1.0, k_indirect=1, max_piggyback=2,
                 ring_window_periods=2, ring_view_c=2),
}


@pytest.fixture
def partitioned(monkeypatch):
    """make_mesh() is 8 CPU slots, counted as 8 devices."""
    mesh = cpu_mesh()
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: mesh)
    monkeypatch.setattr(partition, "partitions", lambda m: True)
    return mesh


@pytest.mark.parametrize("engine", sorted(PART_CFGS))
def test_a_partitioned_batch_is_one_step_a_period(partitioned, spmd_calls,
                                                  engine):
    cfg = SwimConfig(**PART_CFGS[engine])
    plan = faults.with_loss(faults.with_crashes(
        faults.none(N_PART, "cpu"), [5, 23, 41], [1, 2, 3]), 0.1)
    progs = [faults.with_segment(faults.as_program(
        plan, np.arange(N_PART) % 4, capacity=2), 0, **ev)
        for ev in (EV_LOSS, EV_GRAY)]
    keys = [threefry.key(7 + p) for p in range(2)]
    partitioned.rendezvous = 0
    got = experiments._run_study_batch(cfg, progs, keys, T_PART, engine)
    rendezvous, calls = partitioned.rendezvous, len(spmd_calls)
    assert calls == T_PART and not isinstance(got.state.step, pmesh.Sharded)
    for p in range(2):
        partitioned.rendezvous = 0
        want = experiments._run_study(cfg, progs[p], keys[p], T_PART, engine)
        assert partitioned.rendezvous == rendezvous > 0
        assert_same(runner.lane_result(got, p), want, f"{engine} lane {p}")
    assert len(spmd_calls) == 3 * T_PART
    assert not torch.equal(got.series.suspect_views[0],
                           got.series.suspect_views[1])


def test_placed_trees_carry_a_lane_axis():
    mesh = cpu_mesh()
    cfg = SwimConfig(n_nodes=N)
    states = [ring.init_state(cfg, "cpu")._replace(
        inc_self=torch.arange(N, dtype=torch.int32) * (p + 1))
        for p in range(P)]
    whole = runner.batch_states(states)
    stacked, _ = ring_shard.place(cfg, mesh, whole, faults.stack_programs(
        [faults.as_program(faults.none(N, "cpu"), np.arange(N) % 2)] * P
    ).program, lanes=1)
    per_lane = runner.batch_states([ring_shard.place(
        cfg, mesh, s, faults.none(N, "cpu"))[0] for s in states])
    for placed in (stacked, per_lane):
        assert placed.cold.axis == 1 and placed.cold.lead == 1
        assert placed.cold.blocks[0].shape == (P,) + tuple(
            whole.cold.shape[1:2]) + (N // D,)
        assert placed.cold.shape == tuple(whole.cold.shape)
        assert placed.step.axis is None and placed.step.shape == (P,)
        assert_same(pmesh.assemble(placed), whole, "assembled")
        for p in range(P):
            lane = runner.lane_result(placed, p)
            assert lane.inc_self.lead == 0
            assert_same(pmesh.assemble(lane), states[p], f"lane {p}")
    with pytest.raises(ValueError, match="split"):
        pmesh.split(torch.zeros((P, N + 1)), mesh, 0, lanes=1)

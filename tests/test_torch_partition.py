"""The dense, ring and rumor studies partitioned over every device
(`swim_tpu_torch/parallel/partition.py`) against the JAX package's
GSPMD studies on the 8 virtual CPU devices of tests/conftest.py.

The port's partitioned path runs here on 8 shard slots of the CPU
(`make_mesh(devices=["cpu"] * 8)`), counted as 8 devices (the
`partitioned` fixture): `experiments._run_study` and `_run_study_batch`
then take the partitioned step with its collectives, as on 8 cards.
Bitwise, with no tolerance, against the JAX package's `_run_study` /
`_run_study_batch` (state, track, series and telemetry frames):

  * dense at N = 64 with telemetry (Lifeguard and buddy, crashes, loss,
    a partition, late joiners and a program's segments), against the
    JAX batch's lane of the same program and key;
  * rumor at N = 64 with a join schedule and a FaultProgram with a gray
    and a flapping link segment (Lifeguard, buddy, telemetry);
  * a two-lane dense batch of FaultPrograms;
  * the ring, routed through ring_shard's step;
  * N % 8 != 0: both packages refuse to place it (ValueError).

The router: with `make_mesh()` holding two distinct devices (the CPU
and `meta`, the stand-in of tests/test_torch_multidevice.py) the
studies, the batches and `simulate` take the partitioned step, and
`simulate` reports 2 devices; with one device (8 slots of it) they take
the one-device path, bitwise the named-device run, and `simulate`
reports 1.  A named device never partitions.  The port's ops run on one
thread; the JAX studies compile once each, at module scope.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from torch_engine_cases import (faults_plan, one_torch_thread, port_plan,
                                run_together)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.sim import experiments as jexperiments
from swim_tpu.sim import faults as jfaults
from swim_tpu.sim import runner as jrunner
from swim_tpu_torch import SwimConfig, cli, convert
from swim_tpu_torch import device as devmod
from swim_tpu_torch.models import rumor
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import partition, ring_shard
from swim_tpu_torch.sim import experiments, faults, runner
from swim_tpu_torch.utils import threefry
from swim_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")
assert one_torch_thread

D, N, T = 8, 64, 6
META = torch.device("meta")
MIXED = ["cpu", "meta"] * (D // 2)
SMALL_GEOM = dict(suspicion_mult=1.0, k_indirect=1, max_piggyback=2,
                  ring_window_periods=2, ring_view_c=2)
CFGS = {
    "dense": dict(n_nodes=N, telemetry=True, lifeguard=True),
    "rumor": dict(n_nodes=N, rumor_capacity=64, telemetry=True,
                  lifeguard=True),
    "ring": dict(n_nodes=N, telemetry=True, ring_sel_scope="period",
                 **SMALL_GEOM),
}
LOSS = dict(kind="link_loss", start=1, end=5, level=0.4, domain=2)
GRAY = dict(kind="gray", start=2, end=6, level=0.3, domain=1)


def lane_programs():
    """Two dense lanes: crashes, loss, a partition and late joiners, and
    a link segment, or a weaker one and a gray segment."""
    plan = jfaults.with_crashes(jfaults.none(N), [5, 23, 41], [1, 2, 3])
    plan = jfaults.with_partition(jfaults.with_loss(plan, 0.2),
                                  jfaults.halves(N), 3, 5)
    plan = jfaults.with_joins(plan, [N - 1, N - 2], [2, 4])
    progs = []
    for events in ([LOSS], [dict(LOSS, level=0.15), GRAY]):
        prog = jfaults.as_program(plan, np.arange(N) % 4, capacity=2)
        for slot, ev in enumerate(events):
            prog = jfaults.with_segment(prog, slot, **ev)
        progs.append(prog)
    return progs


PLANS = {"dense": lambda: lane_programs()[1],
         "rumor": lambda: faults_plan(N, T),
         "ring": lambda: jfaults.with_crashes(jfaults.none(N), [5, 23, 41],
                                              [0, 1, 2])}
SEEDS = {"dense": 8, "rumor": 3, "ring": 3}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's GSPMD studies on the 8 virtual devices, their
    compiles started together; the serial dense study is the batch's
    lane 1 (bitwise its serial run, by the reference's contract), which
    spares a compile."""
    def batch():
        return jexperiments._run_study_batch(
            JaxSwimConfig(**CFGS["dense"]), lane_programs(),
            [jax.random.key(7 + p) for p in range(2)], T, "dense")

    def study(eng):
        return lambda: jexperiments._run_study(
            JaxSwimConfig(**CFGS[eng]), PLANS[eng](),
            jax.random.key(SEEDS[eng]), T, eng)

    out = run_together({"batch": batch, "rumor": study("rumor"),
                        "ring": study("ring")})
    out["dense"] = jrunner.lane_result(out["batch"], 1)
    return out


@pytest.fixture
def partitioned(monkeypatch):
    """make_mesh() is 8 CPU slots, counted as 8 devices."""
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: mesh)
    monkeypatch.setattr(partition, "partitions", lambda m: True)
    return mesh


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


@pytest.mark.parametrize("engine", sorted(CFGS))
def test_partitioned_study_equals_the_gspmd_study(reference, partitioned,
                                                  monkeypatch, engine):
    steps = []
    real = partition.build_step
    monkeypatch.setattr(partition, "build_step",
                        lambda *a, **kw: steps.append(a[2]) or real(*a,
                                                                    **kw))
    partitioned.copied_bytes = 0
    got = experiments._run_study(SwimConfig(**CFGS[engine]),
                                 port_plan(PLANS[engine]()),
                                 threefry.key(SEEDS[engine]), T, engine)
    assert steps == [engine]
    assert_result(got, reference[engine], engine)
    assert int(got.telemetry.waves_delivered.min()) > 0
    assert not isinstance(got.state.step, pmesh.Sharded)
    if engine == "ring":
        assert isinstance(partition.build_step(
            SwimConfig(**CFGS[engine]), partitioned, "ring"),
            ring_shard.ShardedStep)


def test_partitioned_dense_batch_equals_the_gspmd_batch(reference,
                                                        partitioned):
    got = experiments._run_study_batch(
        SwimConfig(**CFGS["dense"]),
        [port_plan(p) for p in lane_programs()],
        [threefry.key(7 + p) for p in range(2)], T, "dense")
    for p in range(2):
        assert_result(runner.lane_result(got, p),
                      jrunner.lane_result(reference["batch"], p),
                      f"lane {p}")
    assert not torch.equal(got.series.suspect_views[0],
                           got.series.suspect_views[1])


def test_an_uneven_split_is_refused_as_the_reference_refuses_it(
        partitioned):
    n = N - 4
    with pytest.raises(ValueError):
        jexperiments._run_study(JaxSwimConfig(n_nodes=n), jfaults.none(n),
                                jax.random.key(0), 2, "dense")
    for engine in sorted(CFGS):
        with pytest.raises(ValueError, match="divide"):
            experiments._run_study(SwimConfig(n_nodes=n),
                                   faults.none(n, "cpu"), threefry.key(0), 2,
                                   engine)


def test_a_placed_state_splits_rows_and_replicates_the_rest():
    cfg = SwimConfig(**CFGS["rumor"])
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    state, plan = partition.place(
        cfg, mesh, "rumor", rumor.init_state(cfg, "cpu"),
        port_plan(faults_plan(N, T)))
    assert state.knows.axis == 0 and state.knows.blocks[0].shape == (
        N // D, cfg.rumor_slots)
    assert state.subject.axis is None and plan.base.crash_step.axis is None
    assert plan.domain_id.blocks[3].shape == (N,)
    with pytest.raises(ValueError, match="no partitioned"):
        partition.build_step(cfg, mesh, "shard")


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class _Routed(Exception):
    pass


@pytest.fixture
def card_is_the_cpu(monkeypatch):
    """The default device (None) resolves to the CPU."""
    real = devmod.resolve
    monkeypatch.setattr(devmod, "resolve",
                        lambda device=None: real("cpu" if device is None
                                                 else device))


@pytest.fixture
def meta_reads_as_zeros(monkeypatch):
    """A meta block read on the CPU (a collective's fetch, an assembled
    tensor) reads as zeros of its shape."""
    real_fetch, real_whole = pmesh.Collectives._fetch, pmesh.Sharded.whole

    def fetch(self, post, dev):
        x = post.value
        if x.device == META and dev.type == "cpu":
            return torch.zeros(x.shape, dtype=x.dtype)
        return real_fetch(self, post, dev)

    def whole(self):
        return real_whole(pmesh.Sharded(
            [torch.zeros(b.shape, dtype=b.dtype) if b.device == META else b
             for b in self.blocks], self.axis))

    monkeypatch.setattr(pmesh.Collectives, "_fetch", fetch)
    monkeypatch.setattr(pmesh.Sharded, "whole", whole)
    # meta has no kernel: the ring's shards run the plain versions
    real = ring_shard.mapped_step
    monkeypatch.setattr(ring_shard, "mapped_step",
                        lambda cfg, mesh, plain=False: real(cfg, mesh, True))


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("engine", sorted(CFGS))
def test_the_router_partitions_over_two_devices_only(monkeypatch,
                                                     card_is_the_cpu,
                                                     engine):
    cfg = SwimConfig(n_nodes=N)
    plan = faults.with_crashes(faults.none(N, "cpu"), [5], [1])
    progs = [faults.as_program(plan, np.arange(N) % 2, capacity=0)] * 2
    keys = [threefry.key(1), threefry.key(2)]
    seen = []

    def spy(cfg, eng, plan, mesh=None):
        seen.append((eng, mesh))
        raise _Routed

    monkeypatch.setattr(partition, "start", spy)
    mixed = pmesh.make_mesh(devices=MIXED)
    assert partition.partitions(mixed)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: mixed)
    with pytest.raises(_Routed):
        experiments._run_study(cfg, plan, keys[0], 2, engine)
    with pytest.raises(_Routed):
        experiments._run_study_batch(cfg, progs, keys, 2, engine)
    assert seen == [(engine, mixed)] * 2

    one = pmesh.Mesh(["cpu"] * D)
    assert not partition.partitions(one)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: one)
    got = experiments._run_study(cfg, plan, keys[0], 2, engine)
    want = experiments._run_study(cfg, plan, keys[0], 2, engine, "cpu")
    batch = experiments._run_study_batch(cfg, progs, keys, 2, engine)
    batch_cpu = experiments._run_study_batch(cfg, progs, keys, 2, engine,
                                             device="cpu")
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: mixed)
    named = experiments._run_study(cfg, plan, keys[0], 2, engine, "cpu")
    assert len(seen) == 2
    for a, b in ((got, want), (batch, batch_cpu), (named, want)):
        assert all(torch.equal(x, y)
                   for x, y in zip(_leaves(a), _leaves(b), strict=True))


def _simulate(capsys, engine: str, *device) -> dict:
    scope = ["--sel-scope", "period"] if engine == "ring" else []
    assert cli.main([*device, "simulate", "--nodes", str(N), "--periods",
                     "2", "--crash-fraction", "0.05", "--engine", engine,
                     *scope]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("engine", sorted(CFGS))
def test_simulate_reports_the_devices_it_partitions_over(
        monkeypatch, capsys, card_is_the_cpu, meta_reads_as_zeros, engine):
    starts = []
    real = partition.start
    monkeypatch.setattr(partition, "start",
                        lambda *a, **kw: starts.append(a[1]) or real(*a,
                                                                     **kw))
    mixed = pmesh.make_mesh(devices=MIXED[:2])
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: mixed)
    assert _simulate(capsys, engine)["devices"] == 2
    assert starts == [engine]
    one = pmesh.Mesh(["cpu"] * D)
    monkeypatch.setattr(pmesh, "make_mesh", lambda *a, **kw: one)
    got = _simulate(capsys, engine)
    want = _simulate(capsys, engine, "--device", "cpu")
    assert starts == [engine] and got["devices"] == want["devices"] == 1
    for out in (got, want):
        del out["seconds"], out["periods_per_sec"]
    assert got == want

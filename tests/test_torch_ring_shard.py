"""The port's sharded ring engine (`swim_tpu_torch/parallel/`) against
the JAX package, bit for bit, with D = 8 shards.

  * Against `swim_tpu.parallel.ring_shard.mapped_step` on the 8-device
    virtual mesh (tests/conftest.py), at the reduced geometry of the
    reference's own sharded tests (SMALL_GEOM): period scope with
    Lifeguard and buddy on the window wire; the same on the compact ICI
    wire with the packed scalar wire;
    and pull-uniform probing with telemetry and profiling, whose
    EngineFrame and phase markers (sums over the shards) must equal the
    JAX sharded step's.  All 14 state fields after every period.
  * Against JAX's single-program `ring.step` with its tap: the crash
    lifecycle at the default geometry (period scope), loss and join
    churn and a partition in wave scope, and Lifeguard with buddy under
    a FaultProgram (gray and flapping link segments); the port's frame
    (telemetry on) against the JAX frame every period.  The reference
    pins its sharded step to this single-program step the same way.
  * `build_run` against stepping `mapped_step` and against `ring.run`;
    `state_shardings` against the reference's placement rule;
    `first_true_nodes` on edge cases against the single-device
    compaction; a shard that raises makes the step raise within a few
    seconds; the kernels' launch counters lose no count under 8
    threads.
  * The exchanges of one period (`ShardedStep.record`) against
    `obs/ici.trace_ici_bytes(cfg, 8)` for the window, compact and packed
    wires (the bill also charges the compacted branch of the
    reference's sentinel-probe `lax.cond`, which neither layout of the
    port runs: that one term is taken out); the compact wire moves u8 /
    u16 slot payloads, the packed wire one u8 bundle a wave, and no
    exchange holds a node-sized block but pull's ring pass.
  * Placed checkpoints: one part per shard (one for a replicated leaf),
    restored on 8 shards, on 4 and whole.  The studies:
    `detection_study(engine="ringshard")` equals `engine="ring"`, and a
    ringshard streaming study stopped after its first snapshot and
    resumed from it equals the run straight through, its restored state
    placed as the template is.

Tolerance: exact.  The port's ops run on one thread.
"""
from __future__ import annotations

import functools
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch_engine_cases import (assert_same_frame, jax_tapped_step,
                                np_fields, one_torch_thread, port_plan)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.parallel import mesh as jmesh
from swim_tpu.parallel import ring_shard as jring_shard
from swim_tpu.sim import faults as jfaults
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs import ici
from swim_tpu_torch.obs.engine import EngineFrame
from swim_tpu_torch.ops import coldsel, scatter, selb, wavemerge, wavepack
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import ring_shard
from swim_tpu_torch.sim import experiments, faults, runner

pytestmark = pytest.mark.usefixtures("one_torch_thread")
assert one_torch_thread

D = 8
N = 64
SMALL_GEOM = dict(suspicion_mult=1.0, k_indirect=1, max_piggyback=2,
                  ring_window_periods=2, ring_view_c=2)


def cpu_mesh(d: int = D) -> pmesh.Mesh:
    return pmesh.make_mesh(devices=["cpu"] * d)


def assert_same_state(port_placed, want, where: str) -> None:
    """A placed port state, assembled, against a JAX state (sharded or
    not): all 14 fields, dtype and values."""
    got = convert.state_to_numpy(pmesh.assemble(port_placed))
    for f in jring.RingState._fields:
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype, f"{f} dtype @ {where}"
        np.testing.assert_array_equal(got[f], w, err_msg=f"{f} @ {where}")


def crash_loss(n: int):
    return jfaults.with_loss(jfaults.with_crashes(jfaults.none(n), [5, 40],
                                                  [2, 6]), 0.1)


@functools.lru_cache(maxsize=None)
def jax_sharded(jcfg):
    """(mesh, JAX's jitted sharded step) for `jcfg`: one compile each."""
    mesh = jmesh.make_mesh(D)
    return mesh, jring_shard.build_step(jcfg, mesh)


@functools.lru_cache(maxsize=None)
def jax_draw(jcfg):
    return jax.jit(lambda key, t: jring.draw_period_ring(key, t, jcfg))


def port_rnd(rnd):
    """A JAX RingRandomness as the port's, on the CPU."""
    d = {f: np.asarray(getattr(rnd, f)) for f in rnd._fields if f != "pull"}
    d["pull"] = None if rnd.pull is None else np_fields(rnd.pull)
    return convert.randomness_from_numpy(d, "cpu")


def port_arm(kw: dict, plan):
    cfg = SwimConfig(n_nodes=N, **kw)
    mesh = cpu_mesh()
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                              port_plan(plan))
    return {"cfg": cfg, "state": st, "plan": pl,
            "step": ring_shard.mapped_step(cfg, mesh)}


def step_arm(arm, rnd, t):
    out = arm["step"](arm["state"], arm["plan"], rnd,
                      ring.rotor_offsets(arm["cfg"], t))
    extras = ()
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        out, *extras = out
    arm["state"] = out
    return extras


# (JAX config keywords, port arms' extra keywords, periods, seed)
MAPPED_CASES = {
    "window_lifeguard": (dict(ring_sel_scope="period", lifeguard=True),
                         [{}], 4, 9),
    "compact_packed": (dict(ring_sel_scope="period", lifeguard=True,
                            ring_ici_wire="compact",
                            ring_scalar_wire="packed"), [{}], 4, 9),
    "pull_telemetry_profiling": (dict(ring_probe="pull", telemetry=True,
                                      profiling=True), [{}], 4, 13),
}


@pytest.mark.parametrize("case", list(MAPPED_CASES))
def test_sharded_step_equals_jax_mapped_step(case):
    """The port's sharded step (D = 8 threads) against JAX's shard_map
    step on 8 devices, from the same placed state and randomness: every
    field after every period, and under telemetry and profiling the
    frame and the phase markers too."""
    jkw, port_kws, periods, seed = MAPPED_CASES[case]
    jkw = {**SMALL_GEOM, **jkw}
    jcfg = JaxSwimConfig(n_nodes=N, **jkw)
    plan = crash_loss(N)
    mesh, jstep = jax_sharded(jcfg)
    jstate, jplan = jring_shard.place(jcfg, mesh, jring.init_state(jcfg),
                                      plan)
    arms = [port_arm({**jkw, **kw}, plan) for kw in port_kws]
    draw = jax_draw(jcfg)
    key = jax.random.key(seed)
    suspects = 0
    for t in range(periods):
        rnd = draw(key, t)
        out = jstep(jstate, jplan, rnd)
        jextras = ()
        if type(out) is tuple:
            out, *jextras = out
        jstate = out
        suspects += int((np.asarray(jstate.rkey) & 1).sum())
        trnd = port_rnd(rnd)
        for kw, arm in zip(port_kws, arms):
            extras = step_arm(arm, trnd, t)
            where = f"{case} {kw} period {t}"
            assert_same_state(arm["state"], jstate, where)
            assert len(extras) == len(jextras)
            if jcfg.telemetry:
                assert_same_frame(extras[0], jextras[0], where)
            if jcfg.profiling:
                np.testing.assert_array_equal(
                    extras[-1].numpy(), np.asarray(jextras[-1]),
                    err_msg=f"markers @ {where}")
    assert suspects > 0, "nothing was suspected"


def wide_plan(n: int):
    return jfaults.with_crashes(jfaults.none(n), [5, 40], [2, 7])


def churn_plan(n: int):
    plan = jfaults.with_loss(jfaults.none(n), 0.08)
    return plan._replace(join_step=plan.join_step.at[13].set(4))


def partition_plan(n: int):
    return jfaults.with_partition(jfaults.none(n), [1] * 16 + [0] * 48, 3, 9)


def program_plan(n: int):
    plan = jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(n), [5, 40], [2, 6]), 0.05)
    prog = jfaults.as_program(plan, np.arange(n) % 3, capacity=2)
    prog = jfaults.with_segment(prog, 0, start=0, end=12, kind="gray",
                                level=0.3, domain=1)
    return jfaults.with_segment(prog, 1, start=1, end=12, kind="link_loss",
                                level=0.4, domain=2, period=4, on=2)


# (config keywords, [(plan function, periods, seed)])
SINGLE_CASES = {
    "crash_lifecycle_default_geometry": (
        dict(ring_sel_scope="period"), [(wide_plan, 6, 7)]),
    "churn_and_partition_wave": (
        dict(SMALL_GEOM), [(churn_plan, 6, 3), (partition_plan, 7, 5)]),
    "lifeguard_buddy_program": (
        dict(ring_sel_scope="period", lifeguard=True, **SMALL_GEOM),
        [(program_plan, 6, 11)]),
}


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_sharded_step_equals_single_program(case):
    """The port's sharded step with its tap against JAX's single-program
    `ring.step` with its tap: every field and the EngineFrame after
    every period, per plan (the plans share one JAX compile)."""
    kw, plans = SINGLE_CASES[case]
    jcfg = JaxSwimConfig(n_nodes=N, **kw)
    jstep = jax_tapped_step(jring, jcfg)
    draw = jax_draw(jcfg)
    for build, periods, seed in plans:
        plan = build(N)
        arm = port_arm({**kw, "telemetry": True}, plan)
        js = jring.init_state(jcfg)
        key = jax.random.key(seed)
        suspects = 0
        for t in range(periods):
            rnd = draw(key, t)
            js, jframe = jstep(js, plan, rnd)
            (frame,) = step_arm(arm, port_rnd(rnd), t)
            where = f"{case} {build.__name__} period {t}"
            assert_same_state(arm["state"], js, where)
            assert_same_frame(frame, jframe, where)
            suspects += int((np.asarray(js.rkey) & 1).sum())
        assert suspects > 0, f"{build.__name__}: nothing was suspected"


def test_build_run_equals_stepwise_and_one_device():
    """build_run over 4 periods (with its stacked telemetry) equals
    stepping mapped_step period by period and the single-device
    `ring.run`."""
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period", telemetry=True,
                     **SMALL_GEOM)
    plan = faults.with_crashes(faults.none(N, "cpu"), [9], [1])
    mesh = cpu_mesh()
    periods = 4
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"), plan)
    run_state, frames = ring_shard.build_run(cfg, mesh, periods)(st, pl, 11)
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"), plan)
    step = ring_shard.mapped_step(cfg, mesh)
    stepped = []
    for rnd, shifts in ring.period_draws(cfg, (0, 11), 0, periods, "cpu"):
        st, frame = step(st, pl, rnd, shifts)
        stepped.append(frame)
    want = ring.run(cfg.replace(telemetry=False),
                    ring.init_state(cfg, "cpu"), plan, 11, periods)
    for f in ring.RingState._fields:
        a = getattr(pmesh.assemble(run_state), f)
        assert torch.equal(a, getattr(pmesh.assemble(st), f)), f
        assert torch.equal(a, getattr(want, f)), f
    assert isinstance(frames, EngineFrame)
    for f in EngineFrame._fields:
        assert torch.equal(getattr(frames, f),
                           torch.stack([getattr(x, f) for x in stepped])), f
    assert int(run_state.step.blocks[3]) == periods


def _node_axis(sharding):
    """The position of the node axis in a JAX sharding's spec, or None."""
    spec = tuple(sharding.spec)
    return spec.index(jmesh.NODE_AXIS) if jmesh.NODE_AXIS in spec else None


def test_state_shardings_follow_the_reference_rule():
    """parallel/mesh.py's placement rule against the reference's, leaf
    for leaf: a RingState (its SHARD_AXES puts cold's node axis last; at
    n = 16 its replicated tables are longer than the node axis) and a
    FaultPlan (node axis inferred); a SHARD_AXES state without n is
    refused in both packages; shard_state's blocks assemble to the
    state."""
    n = 16
    jcfg = JaxSwimConfig(n_nodes=n)
    jstate = jring.init_state(jcfg)
    mesh, jm = cpu_mesh(), jmesh.make_mesh(D)
    want = jmesh.state_shardings(jstate, jm, n=n)
    state = convert.state_from_numpy(np_fields(jstate), "cpu")
    got = pmesh.state_shardings(state, mesh, n=n)
    assert tuple(got) == tuple(_node_axis(x) for x in want)
    assert got.cold == 1 and got.win == 0 and got.subject is None
    jplan = jfaults.with_crashes(jfaults.none(n), [3], [1])
    got_plan = pmesh.state_shardings(port_plan(jplan), mesh)
    assert tuple(got_plan) == tuple(
        _node_axis(x) for x in jmesh.state_shardings(jplan, jm))
    for mod, st, m in ((pmesh, state, mesh), (jmesh, jstate, jm)):
        with pytest.raises(ValueError, match="SHARD_AXES"):
            mod.state_shardings(st, m)
    placed = pmesh.shard_state(state, mesh, n=n)
    assert [b.shape for b in placed.cold.blocks] == [(state.cold.shape[0],
                                                      n // D)] * D
    for f in ring.RingState._fields:
        assert torch.equal(getattr(pmesh.assemble(placed), f),
                           getattr(state, f)), f


@pytest.mark.parametrize("trues,k", [
    ([], 5), ([3, 17, 63], 8), (list(range(0, 64, 3)), 5),
    (list(range(64)), 64), ([1, 62], 100), (list(range(8, 24)), 12)],
    ids=["none", "fewer-than-k", "more-than-k", "all", "k-beyond-n",
         "k-beyond-s"])
def test_first_true_nodes_edge_cases(trues, k):
    """ShardOps.first_true_nodes on 8 shards equals the single-device
    compaction: ascending ids, missing entries n, whatever the count of
    true entries against k and against the shard's S = 8 rows."""
    valid = torch.zeros(N, dtype=torch.bool)
    valid[trues] = True
    want = scatter.first_true(valid, k, N)
    cfg = SwimConfig(n_nodes=N)
    mesh = cpu_mesh()
    s = N // D

    def body(rank, coll):
        ops = ring_shard.ShardOps(cfg, D, rank, coll, "cpu")
        return ops.first_true_nodes(valid[rank * s:(rank + 1) * s], k)

    for got in pmesh.run_spmd(mesh, body):
        assert torch.equal(got, want), (got, want)


def test_a_raising_shard_releases_the_others():
    """A shard that raises between collectives, and a sharded step whose
    shard 5 holds a malformed block: the error comes out of the call
    within seconds, and every shard thread has ended."""
    mesh = cpu_mesh()

    def body(rank, coll):
        x = torch.tensor([rank])
        for i in range(50):
            coll.psum(rank, x)
            if rank == 3 and i == 2:
                raise ValueError("shard 3 fails")
        return rank

    before = threading.active_count()
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 3 fails"):
        pmesh.run_spmd(mesh, body)
    assert time.monotonic() - t0 < 5.0
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period", **SMALL_GEOM)
    plan = faults.none(N, "cpu")
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"), plan)
    st.win.blocks[5] = st.win.blocks[5][:, :1].contiguous()
    rnd = ring.draw_period_ring((0, 0), 0, cfg, "cpu")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        ring_shard.mapped_step(cfg, mesh)(st, pl, rnd,
                                          ring.rotor_offsets(cfg, 0))
    assert time.monotonic() - t0 < 5.0
    assert threading.active_count() == before


@pytest.mark.parametrize("mod", [selb, coldsel, wavemerge],
                         ids=["selb", "coldsel", "wavemerge"])
def test_launch_counters_are_thread_safe(mod):
    """D threads bump a kernel's launch counter through its wrapper's
    counting path, with a switch interval short enough to interleave
    them: the total is exact."""
    per = 20_000
    old = mod.launches
    mod.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [mod._count_launch() for _ in range(per)])
            for _ in range(D)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert mod.launches == D * per
    finally:
        sys.setswitchinterval(interval)
        mod.launches = old


# wire -> config keywords (n = 1024, so S = 128)
WIRES = {
    "window": {},
    "compact": dict(ring_sel_scope="period", ring_ici_wire="compact"),
    "packed": dict(ring_sel_scope="period", ring_ici_wire="compact",
                   ring_scalar_wire="packed", **SMALL_GEOM),
    "pull": dict(ring_probe="pull", **SMALL_GEOM),
}


def recorded_period(cfg):
    n = cfg.n_nodes
    mesh = cpu_mesh()
    plan = faults.with_crashes(faults.none(n, "cpu"), [5], [0])
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"), plan)
    step = ring_shard.mapped_step(cfg, mesh)
    step.record = []
    step(st, pl, ring.draw_period_ring((0, 0), 0, cfg, "cpu"),
         ring.rotor_offsets(cfg, 0))
    return step.record


@pytest.mark.parametrize("wire", list(WIRES))
def test_exchange_bytes_equal_the_bill(wire):
    """Shard 0's exchanges in one period: their bytes, summed per label,
    are obs/ici.trace_ici_bytes(cfg, 8)'s breakdown (less the compacted
    sentinel branch the port does not run) for the rotor wires; every
    recorded byte has a label; the compact wire ships the slot indices
    as u8 / u16 bytes, the packed wire one u8 bundle a wave; no exchange
    holds a node-sized block, and only pull passes the ring."""
    n = 1024
    cfg = SwimConfig(n_nodes=n, **WIRES[wire])
    rec = recorded_period(cfg)
    tally: dict = {}
    for e in rec:
        assert e["bytes"] == sum(e["terms"].values()) > 0
        assert "roll" not in e["terms"], f"an unlabelled roll: {e}"
        for k, v in e["terms"].items():
            tally[k] = tally.get(k, 0) + v
        assert n not in e["shape"], f"a node-sized exchange: {e}"
    assert ("ring_pass" in tally) == (wire == "pull")
    if wire == "pull":
        return
    want = dict(ici.trace_ici_bytes(cfg, D)["breakdown"])
    g = ring.geometry(cfg)
    rows = g.rw * ring.WORD
    cap = min(ici.SENTINEL_QUERY_CAP, rows)
    if cap < rows:
        want["knows_psum"] -= 4 * cap * cfg.sentinels * g.c
    assert tally == want
    s = n // D
    waves = 2 + 4 * cfg.k_indirect
    sel = [e for e in rec if "roll_sel_waves" in e["terms"]]
    assert len(sel) == waves
    if wire == "window":
        assert all(e["dtype"] == "int32" and e["shape"] == (s, g.ww)
                   for e in sel)
        return
    width = wavepack.slot_dtype(g.ww).itemsize
    assert width == (2 if wire == "compact" else 1)
    b = min(cfg.max_piggyback, g.ww * ring.WORD)
    assert all(e["dtype"] == "uint8" and e["shape"] == (s, b, width)
               for e in sel)
    bundles = [e for e in rec if "roll_ok_waves" in e["terms"]]
    if wire == "packed":
        assert len(bundles) == waves
        assert all(e["dtype"] == "uint8" and len(e["shape"]) == 1
                   and "roll_pid_waves" in e["terms"] for e in bundles)
    else:
        assert all(e["dtype"] == "bool" for e in bundles)


def test_placed_checkpoint_round_trips_across_meshes(tmp_path):
    """save_placed of a state placed on 8 shards writes one part per
    shard of each node-axis leaf and one part of each replicated leaf;
    restore_placed gives it back block for block on 8 shards, stitched
    and split again on 4, and whole for a whole template."""
    from swim_tpu_torch.utils import checkpoint

    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period", **SMALL_GEOM)
    plan = faults.with_crashes(faults.none(N, "cpu"), [5], [0])
    whole = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 4, 3)
    placed = pmesh.shard_state(whole, cpu_mesh(), n=N)
    path = str(tmp_path / "placed.npz")
    checkpoint.save_placed(path, placed, (1, 2), 3)
    with np.load(path) as z:
        parts = [k for k in z.files if "_part_" in k]
    node_leaves = sum(x.axis is not None for x in placed)
    assert len(parts) == D * node_leaves + len(placed) - node_leaves
    for like in (pmesh.shard_state(ring.init_state(cfg, "cpu"),
                                   cpu_mesh(), n=N),
                 pmesh.shard_state(ring.init_state(cfg, "cpu"),
                                   cpu_mesh(4), n=N),
                 ring.init_state(cfg, "cpu")):
        got, key, step = checkpoint.restore_placed(path, like)
        assert key == (1, 2) and step == 3
        for f in ring.RingState._fields:
            g = getattr(got, f)
            if isinstance(getattr(like, f), pmesh.Sharded):
                assert len(g.blocks) == len(getattr(like, f).blocks)
            assert torch.equal(pmesh.assemble(g), getattr(whole, f)), f


def test_detection_study_ringshard_equals_ring():
    """detection_study(engine="ringshard") == engine="ring" (the study
    default, pull-uniform), but for the engine's name."""
    kw = dict(n=64, periods=6, seed=3, crash_fraction=0.05,
              device="cpu")
    a = experiments.detection_study(engine="ringshard", **kw)
    b = experiments.detection_study(engine="ring", **kw)
    assert a.pop("engine") == "ringshard" and b.pop("engine") == "ring"
    assert a == b
    assert a["crashed"] > 0 and a["suspect_detected"] > 0


class _Preempted(RuntimeError):
    pass


class _DyingCheckpointer(runner.StudyCheckpointer):
    """Dies right after its first snapshot lands."""

    def save(self, *a, **kw):
        raise _Preempted(super().save(*a, **kw))


def test_stream_checkpoint_resume_is_bitwise(tmp_path):
    """A ringshard streaming study (the compact and packed wires) saved
    per shard, stopped after its first snapshot and resumed from it:
    milestones, series and the placed state equal the run straight
    through; the restored state is placed as its template."""
    n, periods, every = 64, 8, 4
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period",
                     ring_ici_wire="compact", ring_scalar_wire="packed",
                     **SMALL_GEOM)
    plan0 = faults.with_crashes(faults.none(n, "cpu"), [5, 23, 41],
                                [2, 3, 5])
    mesh = cpu_mesh()
    key = (0, 11)

    def study(ckpt=None, chunk=0):
        st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                                  plan0)
        return runner.run_study_ring_stream(
            cfg, st, pl, key, periods, ring_shard.mapped_step(cfg, mesh),
            chunk=chunk, ckpt=ckpt), pl

    ref, plan = study(chunk=every)
    with pytest.raises(_Preempted):
        study(ckpt=_DyingCheckpointer(str(tmp_path), every=every))
    ck = runner.StudyCheckpointer(str(tmp_path), every=every)
    assert ck.latest().endswith("study_000000000004.npz")
    like, _ = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"), plan0)
    r_state, _, _, _, step_no = ck.restore(like)
    assert step_no == every
    for got, want in zip(r_state, like):
        assert isinstance(got, pmesh.Sharded) and got.axis == want.axis
        assert [b.shape for b in got.blocks] == \
            [b.shape for b in want.blocks]
    res, _ = study(ckpt=ck)
    for part in ("track", "series"):
        for f in getattr(ref, part)._fields:
            assert torch.equal(getattr(getattr(ref, part), f),
                               getattr(getattr(res, part), f)), (part, f)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(pmesh.assemble(ref.state), f),
                           getattr(pmesh.assemble(res.state), f)), f
    crash, milestones = runner.study_milestones(ref, plan, periods)
    assert crash.size == 3 and (milestones["suspect"] < 2**31 - 1).any()

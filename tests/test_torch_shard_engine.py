"""The port's exchange-sharded rumor engine
(`swim_tpu_torch/parallel/shard_engine.py`) against the JAX package, bit
for bit, with D = 8 shards on the CPU.

  * Against JAX's `shard_engine.build_step` on the 8-device virtual mesh
    (tests/conftest.py), one configuration (n = 64, R = 128) under
    crashes and loss 0.2 through suspicion expiry, confirmation and
    retirement: lossless (`exchange_slack` None = D), and at
    `exchange_slack=1`, where the response waves overflow their slots
    (`overflow` > 0) and the engine leaves the single-device one.  Only
    the second run can show a fault of the compaction: its tuples, its
    fills and its order decide which messages survive.
  * Lossless against JAX's single-device `rumor.step`: Lifeguard with
    buddy and dynamic suspicion (the forced-rumor channel of W1 and W4),
    and round-robin targets under a partition.
  * `build_run` against stepping; `place`'s layout; join plans and
    FaultPrograms with segments refused with the reference's messages
    (a zero-segment program unwraps); the sharded engine reproduces
    golden.ENGINE_DIGESTS["rumor"].
  * The studies: `suspicion_sweep` and `lifeguard_ablation` with
    engine="shard" give the rumor engine's results but for the engine's
    name (detection and fp_sweep: tests/test_torch_study.py); telemetry
    with "shard" raises ValueError; a scenario spec naming "shard" is
    refused as by the reference.

Tolerance: exact, all 12 RumorState fields after every period.  The
port's ops run on one thread.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread, port_plan

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import rumor as jrumor
from swim_tpu.parallel import mesh as jmesh
from swim_tpu.parallel import shard_engine as jshard
from swim_tpu.sim import faults as jfaults
from swim_tpu.sim import scenario as jscenario
from swim_tpu.utils import prng as jprng
from swim_tpu_torch import SwimConfig, convert, golden
from swim_tpu_torch.models import rumor
from swim_tpu_torch.ops import lattice
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import shard_engine
from swim_tpu_torch.sim import experiments, faults, scenario
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")
assert one_torch_thread

D = 8
N = 64
LIFECYCLE = dict(n_nodes=N, rumor_capacity=128)


def lifecycle_plan():
    """Node 9 crashes at period 1 under loss 0.2."""
    return jfaults.with_loss(jfaults.with_crashes(jfaults.none(N), [9], [1]),
                             0.2)


def cpu_mesh() -> pmesh.Mesh:
    return pmesh.make_mesh(devices=["cpu"] * D)


def draws(cfg, seed: int, t: int):
    """Period t's draws from threefry.key(seed), for the port and, the
    same arrays, for the JAX engine (the port's draw is the reference's
    bit for bit: tests/test_torch_rumor.py)."""
    rnd = rumor.draw_period_rumor(threefry.key(seed), t, cfg, "cpu")
    return rnd, jrumor.RumorRandomness(
        base=jprng.PeriodRandomness(*(jnp.asarray(x.numpy())
                                      for x in rnd.base)),
        resample_u=jnp.asarray(rnd.resample_u.numpy()))


def assert_same_state(port_placed, want, where: str):
    """A placed port state, assembled, against a JAX state: all 12
    fields, dtype and values."""
    got = convert.state_to_numpy(pmesh.assemble(port_placed))
    for f in rumor.RumorState._fields:
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype, f"{f} dtype @ {where}"
        np.testing.assert_array_equal(got[f], w, err_msg=f"{f} @ {where}")


def port_sharded(cfg_kw: dict, plan, slack=None):
    cfg = SwimConfig(**cfg_kw)
    mesh = cpu_mesh()
    st, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cpu"),
                                port_plan(plan))
    return cfg, st, pl, shard_engine.build_step(cfg, mesh, slack)


@pytest.mark.parametrize("slack", [None, 1], ids=["lossless", "slack1"])
def test_sharded_step_matches_the_jax_sharded_step(slack):
    """One JAX configuration for both slacks (build_step's cache keys on
    it): every field after every period equal to JAX's shard_map step.
    Lossless, a suspicion is confirmed; at slack 1 messages are dropped
    and counted, and the state leaves the single-device engine's."""
    jcfg = JaxSwimConfig(**LIFECYCLE)
    plan = lifecycle_plan()
    mesh = jmesh.make_mesh(D)
    jstep = jshard.build_step(jcfg, mesh, slack)
    jst, jpl = jshard.place(jcfg, mesh, jrumor.init_state(jcfg), plan)
    cfg, st, pl, step = port_sharded(LIFECYCLE, plan, slack)
    single = rumor.init_state(cfg, "cpu")
    single_plan = port_plan(plan)
    left_single = False
    for t in range(18 if slack is None else 10):
        rnd, jrnd = draws(cfg, 7, t)
        jst = jstep(jst, jpl, jrnd)
        st = step(st, pl, rnd)
        assert_same_state(st, jst, f"slack {slack}, period {t}")
        single = rumor.step(cfg, single, single_plan, rnd)
        whole = pmesh.assemble(st)
        left_single |= any(not torch.equal(getattr(whole, f),
                                           getattr(single, f))
                           for f in rumor.RumorState._fields)
    whole = pmesh.assemble(st)
    if slack is None:
        assert not left_single and int(whole.overflow) == 0
        dead = lattice.is_dead(whole.gone_key)[9] or bool(
            (lattice.is_dead(whole.rkey) & (whole.subject == 9)).any())
        assert dead
    else:
        assert int(whole.overflow) > 0 and left_single


def rr_partition_plan():
    plan = jfaults.with_loss(jfaults.none(N), 0.1)
    return jfaults.with_partition(plan, jfaults.halves(N), 2, 8)


SINGLE_CASES = {
    "lifeguard_buddy": (dict(N=N, kw=dict(rumor_capacity=128, lifeguard=True,
                                          dynamic_suspicion=True,
                                          buddy=True)),
                        lambda: jfaults.with_loss(jfaults.with_crashes(
                            jfaults.none(N), [5, 33], [2]), 0.15), 16, 3),
    "round_robin_partition": (dict(N=N, kw=dict(
        rumor_capacity=128, target_selection="round_robin")),
        rr_partition_plan, 12, 11),
}


@pytest.mark.parametrize("name", sorted(SINGLE_CASES))
def test_lossless_sharded_step_matches_the_jax_rumor_step(name):
    spec, build, periods, seed = SINGLE_CASES[name]
    cfg_kw = dict(n_nodes=spec["N"], **spec["kw"])
    jcfg = JaxSwimConfig(**cfg_kw)
    plan = build()
    jstep = jax.jit(lambda s, r: jrumor.step(jcfg, s, plan, r))
    jst = jrumor.init_state(jcfg)
    cfg, st, pl, step = port_sharded(cfg_kw, plan)
    originated = 0
    for t in range(periods):
        rnd, jrnd = draws(cfg, seed, t)
        jst = jstep(jst, jrnd)
        st = step(st, pl, rnd)
        assert_same_state(st, jst, f"{name}, period {t}")
        originated += int((np.asarray(jst.subject) >= 0).sum())
    assert originated > 0


def test_build_run_matches_stepping():
    cfg = SwimConfig(n_nodes=N, rumor_capacity=128)
    plan = faults.with_crashes(faults.none(N, "cpu"), [4], [0])
    mesh = cpu_mesh()
    st, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cpu"), plan)
    run = shard_engine.build_run(cfg, mesh, 8)(st, pl, threefry.key(5))
    step = shard_engine.build_step(cfg, mesh)
    key = threefry.key(5)
    for t in range(8):
        st = step(st, pl, rumor.draw_period_rumor(key, t, cfg, "cpu"))
    want = rumor.run(cfg, rumor.init_state(cfg, "cpu"), plan, 5, 8)
    for f in rumor.RumorState._fields:
        assert torch.equal(pmesh.assemble(getattr(run, f)), getattr(want, f))
        assert torch.equal(pmesh.assemble(getattr(st, f)), getattr(want, f))
    assert int(want.step) == 8 and int((want.subject >= 0).sum()) > 0


def test_place_splits_the_node_axis_and_replicates_the_rest():
    cfg = SwimConfig(n_nodes=N, rumor_capacity=128)
    st, pl = shard_engine.place(cfg, cpu_mesh(), rumor.init_state(cfg, "cpu"),
                                faults.none(N, "cpu"))
    for f in rumor.RumorState._fields:
        leaf = getattr(st, f)
        assert leaf.axis == (0 if f in ("knows", "inc_self", "lha") else None)
        assert len({b.data_ptr() for b in leaf.blocks}) == D   # own storage
    assert st.knows.blocks[0].shape == (N // D, 128)
    assert all(leaf.axis is None for leaf in pl)
    with pytest.raises(ValueError, match="must divide the mesh size"):
        shard_engine.place(SwimConfig(n_nodes=60), cpu_mesh(),
                           rumor.init_state(SwimConfig(n_nodes=60), "cpu"),
                           faults.none(60, "cpu"))


def refused_plans():
    joins = jfaults.with_joins(jfaults.none(N), [N - 1], [3])
    prog = jfaults.with_segment(
        jfaults.as_program(jfaults.none(N), np.arange(N) % 2, capacity=1), 0,
        start=0, end=4, kind="gray", level=0.3, domain=1)
    return {"joins": joins, "program": prog}


@pytest.mark.parametrize("kind", ["joins", "program"])
def test_join_plans_and_programs_are_refused_as_by_the_reference(kind):
    plan = refused_plans()[kind]
    jcfg = JaxSwimConfig(n_nodes=N)
    with pytest.raises(NotImplementedError) as want:
        jshard.place(jcfg, jmesh.make_mesh(D), jrumor.init_state(jcfg), plan)
    cfg = SwimConfig(n_nodes=N)
    mesh = cpu_mesh()
    with pytest.raises(NotImplementedError) as got:
        shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cpu"),
                           port_plan(plan))
    assert str(got.value) == str(want.value)
    # a run checks the plan once at its start
    st, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cpu"),
                                faults.none(N, "cpu"))
    if kind == "joins":
        pl = pl._replace(join_step=pmesh.split(
            port_plan(plan).join_step, mesh, None))
        with pytest.raises(NotImplementedError) as run_err:
            shard_engine.build_run(cfg, mesh, 1)(st, pl, 0)
        assert str(run_err.value) == str(want.value)
    else:
        with pytest.raises(NotImplementedError) as step_err:
            shard_engine.build_step(cfg, mesh)(
                st, port_plan(plan),
                rumor.draw_period_rumor(threefry.key(0), 0, cfg, "cpu"))
        assert str(step_err.value) == str(want.value)
    # a program without segments is its base plan
    empty = faults.as_program(faults.none(N, "cpu"), np.zeros(N, np.int64),
                              capacity=0)
    _, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cpu"),
                               empty)
    assert isinstance(pl, faults.FaultPlan)


def test_sharded_engine_gives_the_golden_rumor_digest():
    got = golden.engine_run("cpu", "rumor", sharded=True)
    assert golden.digest(got) == golden.ENGINE_DIGESTS["rumor"]


@pytest.mark.parametrize("study,args", [
    (experiments.suspicion_sweep, dict(n=64, mults=(1.0,), periods=6,
                                       crash_fraction=0.05)),
    (experiments.lifeguard_ablation, dict(n=64, periods=4,
                                          crash_fraction=0.05))],
    ids=["suspicion_sweep", "lifeguard_ablation"])
def test_shard_studies_equal_the_rumor_studies(study, args):
    got = study(device="cpu", engine="shard", **args)
    want = study(device="cpu", engine="rumor", **args)
    assert got.pop("engine") == "shard" and want.pop("engine") == "rumor"
    assert got == want


def test_shard_refusals_outside_its_engine():
    """Telemetry has no tap on this engine (the reference fails unpacking
    its frame): a ValueError; batches and scenario specs refuse "shard"
    as the reference does."""
    with pytest.raises(ValueError, match="no telemetry tap"):
        experiments.detection_study(n=64, periods=2, engine="shard",
                                    telemetry=True, device="cpu")
    cfg = SwimConfig(n_nodes=N)
    with pytest.raises(ValueError, match="fault-program"):
        experiments._run_study_batch(
            cfg, [faults.empty_program(N, "cpu")], [threefry.key(0)], 2,
            "shard", device="cpu")
    spec = dict(name="s", n=64, periods=2, engine="shard")
    with pytest.raises(ValueError) as want:
        jscenario.validate(jscenario.Scenario(**spec))
    with pytest.raises(ValueError) as got:
        scenario.validate(scenario.Scenario(**spec))
    assert str(got.value) == str(want.value)

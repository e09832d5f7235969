"""The port's study runners against `swim_tpu.sim`, bit for bit.

  * `with_random_crashes` gives the reference's crash plan for the same
    key (threefry uniform and randint reproduced);
  * `live_knower_counts` against the JAX census, with pair budgets small
    enough that the chunks split the node axis;
  * `run_study_ring` and `run_study_ring_stream` (track, series, final
    state) against the JAX runners, at the shapes and on the placed
    inputs `detection_study` compiles (so JAX reuses one compile for
    both), and the census of the full-track run's final state;
  * chunked == one-shot == resumed from a `StudyCheckpointer`, and the
    two ValueError refusals of a resume;
  * `detection_study` and one point of `suspicion_sweep` give the JAX
    package's dicts; `shard` raises naming its ROADMAP item,
    `ringshard` gives the ring engine's studies, and the profiling flag
    leaves every study as it is;
  * the dense and rumor runners (`run_study`, `run_study_rumor`: track,
    series, final state) against the JAX runners, fed the placed inputs
    the studies compile for (one compile each); `pick_engine`; the
    four studies' dicts with `engine="auto"` (dense) and `"rumor"`;
    streaming only for the ring engine;
  * the `study` golden digest from the JAX package and from the port.

Tolerance: exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)
from torch_engine_cases import run_together

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import dense as jdense
from swim_tpu.models import ring as jring
from swim_tpu.models import rumor as jrumor
from swim_tpu.parallel import mesh as jpmesh
from swim_tpu.sim import experiments as jexperiments
from swim_tpu.sim import faults as jfaults
from swim_tpu.sim import runner as jrunner
from swim_tpu_torch import SwimConfig, convert, golden
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.sim import experiments, faults, runner
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the shapes of detection_study(n=1000, periods=12, engine="ring")
N, PERIODS, CHUNK = 1000, 12, 5
PULL = dict(ring_probe="pull")


def np_fields(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def assert_same(port_nt, ref_nt, what):
    got = convert.tuple_to_numpy(port_nt)
    for f in ref_nt._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref_nt, f)),
                                      err_msg=f"{what}.{f}")


def study_plans(seed=1):
    """A study plan in both packages: random crashes plus loss."""
    jplan = jfaults.with_loss(jfaults.with_random_crashes(
        jfaults.none(N), jax.random.key(seed), 0.02, 2, 6), 0.05)
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(N, "cpu"), threefry.key(seed), 0.02, 2, 6), 0.05)
    return jplan, plan


@pytest.mark.parametrize("seed,n,fraction,start,end", [
    (0, 1000, 0.01, 2, 50), (1, 4096, 0.05, 2, 20), (7, 333, 0.5, 0, 1),
    (12345, 70_000, 0.001, 5, 70_005), (3, 64, 0.0, 2, 3)])
def test_random_crashes_match_the_reference(seed, n, fraction, start, end):
    want = jfaults.with_random_crashes(jfaults.none(n), jax.random.key(seed),
                                       fraction, start, end)
    got = faults.with_random_crashes(faults.none(n, "cpu"),
                                     threefry.key(seed), fraction, start, end)
    np.testing.assert_array_equal(got.crash_step.numpy(),
                                  np.asarray(want.crash_step))
    if fraction:
        assert int((got.crash_step < faults.NEVER).sum()) > 0


def test_live_knower_counts_match_the_reference(studies):
    """The census of the JAX study's final state (12 pull periods)."""
    jcfg = JaxSwimConfig(n_nodes=N, **PULL)
    cfg = SwimConfig(n_nodes=N, **PULL)
    js = jax.device_get(studies["jfull"].state)
    ts = convert.state_from_numpy(np_fields(js), "cpu")
    up = np.random.default_rng(2).random(N) < 0.8
    want = np.asarray(jring.live_knower_counts(jcfg, js, jnp.asarray(up)))
    assert want.max() > 0
    for budget in (1 << 23, 3 * N, N // 2, 37):
        got = ring.live_knower_counts(cfg, ts, torch.from_numpy(up),
                                      pair_budget=budget)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"pair_budget={budget}")
    np.testing.assert_array_equal(
        convert._to_numpy(ring.resolved_words(cfg, ts), True),
        np.asarray(jring.resolved_words(jcfg, js)))


@pytest.fixture(scope="module")
def jax_runs():
    """The module's JAX runs with compiles of their own, started
    together (`run_together`); the cases' own calls then find the
    compiles done: both ring runners on one study (the full-track run on
    placed inputs, as detection_study compiles it), the rotor-probe
    suspicion sweep point, the golden streaming study, and the dense and
    rumor studies' two configurations (vanilla and Lifeguard)."""
    jcfg = JaxSwimConfig(n_nodes=N, **PULL)
    jplan, _ = study_plans()
    kw = dict(n=SMALL, periods=SMALL_PERIODS, crash_fraction=0.1)
    return run_together({
        "jfull": lambda: jrunner.run_study_ring(
            jcfg, *placed(jring.init_state(jcfg), jplan, N),
            jax.random.key(0), PERIODS),
        "jstream": lambda: jrunner.run_study_ring_stream(
            jcfg, jring.init_state(jcfg), jplan, jax.random.key(0), PERIODS,
            chunk=CHUNK),
        "sweep": lambda: jexperiments.suspicion_sweep(
            n=N, mults=(3.0,), periods=PERIODS, engine="ring"),
        "golden": jax_golden_study,
        "dense": lambda: jexperiments.lifeguard_ablation(engine="auto", **kw),
        "rumor": lambda: jexperiments.lifeguard_ablation(engine="rumor",
                                                         **kw)})


def placed(state, plan, n):
    """A JAX state and plan placed on the 8-device mesh as the JAX
    package's studies place them (`experiments._run_study`), so a runner
    called on them shares the studies' compile."""
    mesh = jpmesh.make_mesh()
    return (jpmesh.shard_state(state, mesh, n=n),
            jpmesh.shard_state(plan, mesh, n=n))


@pytest.fixture(scope="module")
def studies(jax_runs):
    """The JAX and port results of both runners on one study."""
    cfg = SwimConfig(n_nodes=N, **PULL)
    _, plan = study_plans()
    return dict(
        plan=plan, jfull=jax_runs["jfull"], jstream=jax_runs["jstream"],
        full=runner.run_study_ring(cfg, ring.init_state(cfg, "cpu"), plan,
                                   threefry.key(0), PERIODS),
        stream=runner.run_study_ring_stream(
            cfg, ring.init_state(cfg, "cpu"), plan, threefry.key(0),
            PERIODS, chunk=CHUNK))


def test_run_study_ring_matches_the_reference(studies):
    j, t = studies["jfull"], studies["full"]
    assert_same(t.track, j.track, "track")
    assert_same(t.series, j.series, "series")
    got = convert.state_to_numpy(t.state)
    for f in jring.RingState._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j.state, f)),
                                      err_msg=f)
    # the study has teeth: crashes were suspected and views counted
    assert int((t.track.first_suspect < runner.NEVER).sum()) > 0
    assert int(t.series.suspect_views.max()) > 0


def test_run_study_ring_stream_matches_the_reference(studies):
    j, t = studies["jstream"], studies["stream"]
    assert isinstance(t.track, runner.CompactTrack)
    assert_same(t.track, j.track, "compact track")
    assert_same(t.series, j.series, "series")
    got = convert.state_to_numpy(t.state)
    for f in jring.RingState._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j.state, f)),
                                      err_msg=f)
    # the compact track is the full one restricted to crashed subjects
    plan = studies["plan"]
    crash, ms = runner.study_milestones(studies["full"], plan, PERIODS)
    crash_c, ms_c = runner.study_milestones(t, plan, PERIODS)
    np.testing.assert_array_equal(crash, crash_c)
    for k in ms:
        np.testing.assert_array_equal(ms[k], ms_c[k])
    assert (runner.detection_summary(t, plan, PERIODS)
            == jrunner.detection_summary(j, None, PERIODS))


class Stop(Exception):
    pass


def test_chunked_oneshot_and_resumed_streams_are_equal(studies, tmp_path):
    cfg = SwimConfig(n_nodes=N, **PULL)
    plan = studies["plan"]
    chunked = studies["stream"]
    one = runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"),
                                       plan, threefry.key(0), PERIODS)
    calls = [0]

    def stopping(st, p, rnd):
        calls[0] += 1
        if calls[0] > 2 * CHUNK:
            raise Stop
        return ring.step(cfg, st, p, rnd)

    ck = runner.StudyCheckpointer(str(tmp_path), every=CHUNK, keep=1)
    with pytest.raises(Stop):
        runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"), plan,
                                     threefry.key(0), PERIODS,
                                     step_fn=stopping, ckpt=ck)
    assert ck.latest().endswith(f"study_{2 * CHUNK:012d}.npz")
    assert len(ck._snaps()) == 1
    resumed = runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"),
                                           plan, threefry.key(0), PERIODS,
                                           ckpt=ck)
    for other in (one, resumed):
        for part in ("track", "series", "state"):
            a, b = getattr(chunked, part), getattr(other, part)
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (part, f)
    # the refusals: a checkpoint beyond the study, another subject list
    with pytest.raises(ValueError, match="beyond"):
        runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"), plan,
                                     threefry.key(0), 2 * CHUNK - 1, ckpt=ck)
    other_plan = faults.with_crashes(plan, [N - 1], [3])
    with pytest.raises(ValueError, match="subject list"):
        runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"),
                                     other_plan, threefry.key(0), PERIODS,
                                     ckpt=ck)


def test_detection_study_and_suspicion_sweep_match_the_reference(jax_runs):
    want = jexperiments.detection_study(n=N, periods=PERIODS, engine="ring")
    got = experiments.detection_study(n=N, periods=PERIODS, engine="ring",
                                      device="cpu")
    assert got == want
    assert got["ring_probe"] == "pull" and got["suspect_detected"] > 0
    want = jax_runs["sweep"]
    got = experiments.suspicion_sweep(n=N, mults=(3.0,), periods=PERIODS,
                                      engine="ring", device="cpu")
    assert got == want


@pytest.mark.parametrize("kw,match", [
    (dict(engine="shard"), "ROADMAP"),
    (dict(engine="rumor", profiling=True), "ROADMAP"),
    (dict(engine="ringshard"), "ROADMAP"),
    (dict(engine="ring", telemetry=True, profiling=True), "instruments"),
    (dict(engine="dense", flight_record="x.jsonl", telemetry=True,
          profiling=True), "instruments")])
def test_studies_outside_the_port_raise(kw, match, tmp_path):
    """`ringshard` and `shard`, refused until the sharded engines were
    ported, give the ring (rumor) engine's studies but for the engine's
    name.  The profiling flag, refused until the profiler was ported,
    runs beside telemetry and the flight recorder on every engine and
    gives the study without it (the dump's path aside)."""
    if kw.get("engine") in ("ringshard", "shard"):
        sharded = kw["engine"]
        single = {"ringshard": "ring", "shard": "rumor"}[sharded]
        for study, args in ((experiments.detection_study,
                             dict(n=64, periods=2)),
                            (experiments.fp_sweep,
                             dict(n=64, losses=(0.0,), periods=2))):
            got = study(device="cpu", engine=sharded, **args)
            want = study(device="cpu", engine=single, **args)
            assert got.pop("engine") == sharded
            assert want.pop("engine") == single
            assert got == want
        return
    if not kw.get("profiling"):
        with pytest.raises(NotImplementedError, match=match):
            experiments.detection_study(n=64, periods=2, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match=match):
            experiments.fp_sweep(n=64, losses=(0.0,), periods=2,
                                 device="cpu", **kw)
        return
    off = {k: v for k, v in kw.items() if k != "profiling"}
    if "flight_record" in kw:
        kw = {**kw, "flight_record": str(tmp_path / "on.jsonl")}
        off = {**off, "flight_record": str(tmp_path / "off.jsonl")}
    got, want = (experiments.detection_study(n=64, periods=2, device="cpu",
                                             **a) for a in (kw, off))
    assert got.pop("flight_record", None) == kw.get("flight_record")
    assert want.pop("flight_record", None) == off.get("flight_record")
    assert got == want
    if "flight_record" not in kw:
        assert (experiments.fp_sweep(n=64, losses=(0.0,), periods=2,
                                     device="cpu", **kw)
                == experiments.fp_sweep(n=64, losses=(0.0,), periods=2,
                                        device="cpu", **off))


def jax_golden_study():
    c = golden.STUDY_CRASHES
    jcfg = JaxSwimConfig(n_nodes=golden.GOLDEN_N, **golden.STUDY_CONFIG)
    jplan = jfaults.with_loss(jfaults.with_random_crashes(
        jfaults.none(golden.GOLDEN_N), jax.random.key(c["seed"]),
        c["fraction"], c["start"], c["end"]), golden.GOLDEN_LOSS)
    return jrunner.run_study_ring_stream(
        jcfg, jring.init_state(jcfg), jplan,
        jax.random.key(golden.GOLDEN_SEED), golden.GOLDEN_PERIODS,
        chunk=golden.STUDY_CHUNK)


def test_golden_study_digest(jax_runs):
    j = jax_runs["golden"]
    assert golden.study_digest(np_fields(j.state), np_fields(j.track),
                               np_fields(j.series)) == \
        golden.GOLDEN_DIGEST_STUDY
    # carried across, the reference's result hashes the same
    assert golden.study_digest(
        convert.state_from_numpy(np_fields(j.state), "cpu"),
        convert.tuple_from_numpy(runner.CompactTrack, np_fields(j.track),
                                 "cpu"),
        convert.tuple_from_numpy(runner.PeriodSeries, np_fields(j.series),
                                 "cpu")) == golden.GOLDEN_DIGEST_STUDY
    t = golden.golden_study("cpu")
    assert golden.study_digest(t.state, t.track, t.series) == \
        golden.GOLDEN_DIGEST_STUDY
    # the digest pins a study that detected and confirmed crashes
    assert int((t.track.first_dead_view < runner.NEVER).sum()) > 0
    assert int(t.series.dead_views.max()) > 0


# ------------------------------------------------------- dense and rumor

SMALL, SMALL_PERIODS = 64, 14


def small_plans(n=SMALL, seed=2):
    jplan = jfaults.with_loss(jfaults.with_random_crashes(
        jfaults.none(n), jax.random.key(seed), 0.1, 1, 6), 0.1)
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n, "cpu"), threefry.key(seed), 0.1, 1, 6), 0.1)
    return jplan, plan


def test_pick_engine_matches_the_reference():
    for n in (2, 1000, experiments.DENSE_MAX, experiments.DENSE_MAX + 1,
              1_000_000):
        for engine in ("auto", "ring", "dense", "rumor"):
            assert (experiments.pick_engine(n, engine)
                    == jexperiments.pick_engine(n, engine))
    assert experiments.pick_engine(1000) == "dense"
    assert experiments.pick_engine(100_000) == "rumor"


@pytest.mark.parametrize("engine", ["dense", "rumor"])
def test_dense_and_rumor_runners_match_the_reference(engine, jax_runs):
    jplan, plan = small_plans()
    jcfg, cfg = JaxSwimConfig(n_nodes=SMALL), SwimConfig(n_nodes=SMALL)
    # placed as test_studies_match_the_reference's studies place them:
    # one compile for both
    if engine == "dense":
        j = jrunner.run_study(jcfg, *placed(jdense.init_state(jcfg), jplan,
                                            SMALL),
                              jax.random.key(0), SMALL_PERIODS)
        t = runner.run_study(cfg, dense.init_state(cfg, "cpu"), plan,
                             threefry.key(0), SMALL_PERIODS)
        cls = dense.DenseState
    else:
        j = jrunner.run_study_rumor(jcfg, *placed(jrumor.init_state(jcfg),
                                                  jplan, SMALL),
                                    jax.random.key(0), SMALL_PERIODS)
        t = runner.run_study_rumor(cfg, rumor.init_state(cfg, "cpu"), plan,
                                   threefry.key(0), SMALL_PERIODS)
        cls = rumor.RumorState
    assert_same(t.track, j.track, "track")
    assert_same(t.series, j.series, "series")
    got = convert.state_to_numpy(t.state)
    for f in cls._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j.state, f)),
                                      err_msg=f)
    assert int((t.track.first_suspect < runner.NEVER).sum()) > 0
    assert int(t.series.dead_views.max()) > 0
    assert (runner.detection_summary(t, plan, SMALL_PERIODS)
            == jrunner.detection_summary(j, jplan, SMALL_PERIODS))


@pytest.mark.parametrize("engine", ["auto", "rumor"])
def test_studies_match_the_reference(engine, jax_runs):
    """The four studies as their users call them, at a small n: "auto"
    picks the dense engine there."""
    kw = dict(n=SMALL, periods=SMALL_PERIODS, engine=engine)
    crash = dict(crash_fraction=0.1)
    calls = [
        ("detection_study", dict(kw)),
        ("fp_sweep", dict(kw, losses=(0.0, 0.2))),
        # mult 5.0 is the default: the JAX runner's compile is shared
        ("suspicion_sweep", dict(kw, mults=(5.0,), **crash)),
        ("lifeguard_ablation", dict(kw, **crash))]
    for name, args in calls:
        want = getattr(jexperiments, name)(**args)
        got = getattr(experiments, name)(device="cpu", **args)
        assert got == want, name
        assert got["engine"] == ("dense" if engine == "auto" else "rumor")
    assert got["arms"]["lifeguard"]["crashed"] > 0


def test_only_the_ring_engine_streams(monkeypatch):
    """stream="auto" turns streaming on for the ring engine only; an
    explicit stream with the dense or rumor engine raises, as in the
    reference."""
    monkeypatch.setattr(experiments, "STREAM_AUTO_NODES", 32)
    kw = dict(n=SMALL, periods=4, device="cpu")
    out = experiments.detection_study(engine="dense", **kw)
    assert "stream" not in out and out["engine"] == "dense"
    assert experiments.detection_study(engine="ring", **kw)["stream"]
    for engine in ("dense", "rumor"):
        with pytest.raises(ValueError, match="streaming"):
            experiments.detection_study(engine=engine, stream=True, **kw)
        with pytest.raises(ValueError, match="checkpointing"):
            experiments.detection_study(engine=engine, checkpoint_dir="x",
                                        **kw)
    with pytest.raises(ValueError, match="ring engines only"):
        experiments.lifeguard_ablation(engine="rumor", budget_arms=True,
                                       **kw)

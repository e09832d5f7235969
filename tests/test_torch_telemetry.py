"""The port's telemetry track against `swim_tpu`, bit for bit.

  * `recorded_ring_run` (period scope, the kernel wrappers) against the
    JAX `recorded_ring_run`: final state and every period's
    EngineFrame, and the state equal to a tap-off `ring.run`;
  * each study runner's `telemetry` (the period-stacked EngineFrame)
    against the JAX runner's with `telemetry=True`: dense, rumor and
    ring (full track, pull, as the detection study runs it); track and
    series as well;
  * the streaming ring runner's frames over chunks equal a one-shot
    run's, field for field; checkpointing with telemetry is refused,
    as in the reference; a `step_fn` override returns (state, frame)
    under telemetry; telemetry off leaves `telemetry` None.

The per-step frames of every engine path are held to the JAX frames by
the parity cases of tests/test_torch_ring.py, test_torch_lifeguard.py,
test_torch_pull.py, test_torch_program.py, test_torch_dense.py and
test_torch_rumor.py.  Tolerance: exact.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import dense as jdense
from swim_tpu.models import ring as jring
from swim_tpu.models import rumor as jrumor
from swim_tpu.obs import engine as jengine
from swim_tpu.sim import faults as jfaults
from swim_tpu.sim import runner as jrunner
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.obs import engine
from swim_tpu_torch.obs.engine import EngineFrame
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, PERIODS = 48, 10


def plans(n=N, seed=3):
    """Random crashes plus loss, in both packages."""
    jplan = jfaults.with_loss(jfaults.with_random_crashes(
        jfaults.none(n), jax.random.key(seed), 0.1, 1, 5), 0.1)
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n, "cpu"), threefry.key(seed), 0.1, 1, 5), 0.1)
    return jplan, plan


def assert_same_tuple(port_nt, ref_nt, what):
    """Every field of a NamedTuple of tensors equal to the reference's,
    dtype included (u32 state fields through convert)."""
    if isinstance(port_nt, (ring.RingState, dense.DenseState,
                            rumor.RumorState)):
        got = convert.state_to_numpy(port_nt)
    else:
        got = convert.tuple_to_numpy(port_nt)
    for f in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, f))
        assert got[f].dtype == want.dtype, f"{what}.{f} dtype"
        np.testing.assert_array_equal(got[f], want, err_msg=f"{what}.{f}")


def test_recorded_ring_run_matches_the_reference():
    kw = dict(n_nodes=N, ring_sel_scope="period")
    jcfg, cfg = JaxSwimConfig(**kw), SwimConfig(**kw)
    jplan, plan = plans()
    want = jengine.recorded_ring_run(jcfg, jring.init_state(jcfg), jplan,
                                     jax.random.key(5), PERIODS)
    got = engine.recorded_ring_run(cfg, ring.init_state(cfg, "cpu"), plan,
                                   threefry.key(5), PERIODS)
    assert isinstance(got.frames, EngineFrame)
    assert_same_tuple(got.frames, want.frames, "frames")
    assert_same_tuple(got.state, want.state, "state")
    assert int(got.step) == PERIODS
    plain = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 5, PERIODS)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(plain, f), getattr(got.state, f)), f
    # the frames have teeth: the waves delivered and probes failed
    assert int(got.frames.waves_delivered.min()) > 0
    assert int(got.frames.probes_failed.sum()) > 0
    assert int(got.frames.sel_slots_selected.max()) > 0


RUNNERS = {
    "dense": (jrunner.run_study, jdense, runner.run_study, dense),
    "rumor": (jrunner.run_study_rumor, jrumor, runner.run_study_rumor,
              rumor),
    "ring": (jrunner.run_study_ring, jring, runner.run_study_ring, ring),
}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_telemetry_matches_the_reference(name):
    jrun, jmod, run, mod = RUNNERS[name]
    kw = dict(n_nodes=N, telemetry=True)
    if name == "ring":
        kw["ring_probe"] = "pull"
    jcfg, cfg = JaxSwimConfig(**kw), SwimConfig(**kw)
    jplan, plan = plans()
    want = jrun(jcfg, jmod.init_state(jcfg), jplan, jax.random.key(1),
                PERIODS)
    got = run(cfg, mod.init_state(cfg, "cpu"), plan, threefry.key(1),
              PERIODS)
    assert isinstance(got.telemetry, EngineFrame)
    assert all(x.shape == (PERIODS,) for x in got.telemetry)
    assert_same_tuple(got.telemetry, want.telemetry, "telemetry")
    assert_same_tuple(got.track, want.track, "track")
    assert_same_tuple(got.series, want.series, "series")
    assert_same_tuple(got.state, want.state, "state")
    assert int(got.telemetry.waves_delivered.sum()) > 0


def test_streaming_frames_equal_one_shot():
    cfg = SwimConfig(n_nodes=N, telemetry=True, ring_probe="pull")
    _, plan = plans()
    full = runner.run_study_ring(cfg, ring.init_state(cfg, "cpu"), plan,
                                 threefry.key(2), PERIODS)
    one = runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"),
                                       plan, threefry.key(2), PERIODS)
    chunked = runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"),
                                           plan, threefry.key(2), PERIODS,
                                           chunk=3)
    for other in (one, chunked):
        for f in EngineFrame._fields:
            assert torch.equal(getattr(other.telemetry, f),
                               getattr(full.telemetry, f)), f
        assert torch.equal(other.series.dead_views, full.series.dead_views)
    assert int(full.telemetry.probes_failed.sum()) > 0


def test_checkpoint_with_telemetry_raises(tmp_path):
    cfg = SwimConfig(n_nodes=N, telemetry=True, ring_probe="pull")
    _, plan = plans()
    ck = runner.StudyCheckpointer(str(tmp_path), every=3)
    with pytest.raises(ValueError, match="telemetry"):
        runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cpu"), plan,
                                     threefry.key(2), PERIODS, ckpt=ck)


def test_step_fn_override_and_telemetry_off():
    """Under telemetry a `step_fn` returns (state, frame) and the runner
    stacks its frames; with telemetry off `telemetry` is None."""
    _, plan = plans()
    cfg = SwimConfig(n_nodes=N, telemetry=True)
    calls = []

    def step_fn(st, p, rnd):
        tap = {}
        st = ring.step(cfg, st, p, rnd, tap=tap)
        calls.append(1)
        return st, engine.frame_from_tap(tap, "cpu")

    got = runner.run_study_ring(cfg, ring.init_state(cfg, "cpu"), plan,
                                threefry.key(4), 4, step_fn=step_fn)
    want = runner.run_study_ring(cfg, ring.init_state(cfg, "cpu"), plan,
                                 threefry.key(4), 4)
    assert len(calls) == 4
    for f in EngineFrame._fields:
        assert torch.equal(getattr(got.telemetry, f),
                           getattr(want.telemetry, f)), f
    off = SwimConfig(n_nodes=N)
    res = runner.run_study_ring(off, ring.init_state(off, "cpu"), plan,
                                threefry.key(4), 4)
    assert res.telemetry is None
    assert torch.equal(res.series.suspect_views, want.series.suspect_views)
    frame = engine.frame_from_tap({"probes_failed": torch.tensor(
        3, dtype=torch.int32)}, "cpu")
    assert [int(x) for x in frame] == [0, 0, 0, 0, 0, 3, 0, 0]
    assert all(x.dtype == torch.int32 for x in engine.empty_frame("cpu"))

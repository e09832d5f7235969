"""The port against the JAX package at the one-chip scale ladder's sizes.

bench.py's `ringp` tier runs the ring at 4M, 10M and 16M nodes, and
the streaming detection study runs at 10M and 16M; chip_smoke.py's
`scale` phase runs them on the card.  Here, without running a period:
the geometry and the rotor offsets at each size, bench_ring's crash
plan and the study's crash set at 16M, the memory wall's off-card tree
bytes against the reference's `jax.eval_shape` trees, one period's
draws at 4M, and the census cut into chunks of `chunk_words` rows and
along the node axis.  The slow tests recompute the ladder's anchors
(golden.GOLDEN_DIGEST_SCALE, GOLDEN_DIGEST_SCALE_STUDY) through both
packages on the CPU.
"""
from __future__ import annotations

import contextlib
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.obs import memwall as jmemwall
from swim_tpu.sim import experiments as jexperiments
from swim_tpu.sim import faults as jfaults
from swim_tpu.sim import runner as jrunner
from swim_tpu_torch import SwimConfig, convert, golden
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs import memwall
from swim_tpu_torch.sim import experiments, runner
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LADDER = (4_000_000, 10_000_000, 16_000_000)
TOP = LADDER[-1]
# the reference's 10M and 16M study command: 12 periods, crash fraction
# 0.00001; at 16M it crashes 133 nodes (memwall's off-card track
# holds round(n * fraction) = 160 slots)
STUDY_PERIODS, STUDY_FRACTION, TOP_STUDY_CRASHES = 12, 1e-5, 133
SCOPES = {"ringp": dict(ring_sel_scope="period"), "wave": {},
          "pull": dict(ring_probe="pull")}
DERIVED = ("log_n", "retransmit_limit", "suspicion_periods",
           "suspicion_max_periods", "gossip_window", "rumor_slots")


@contextlib.contextmanager
def torch_threads(k: int = 4):
    """The port's draws over 16M counters on a few threads: their ops
    are large enough to gain from them, unlike the module's small ones."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(k, os.cpu_count() or 1))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def configs(n: int, **kw):
    return SwimConfig(n_nodes=n, **kw), JaxSwimConfig(n_nodes=n, **kw)


CENSUS_N = 256
# (chunk_words, pair_budget): one-row chunks cut along the node axis
# (16M's shape), 3-row chunks whose last segment is one node, and
# chunks longer than the ring
CENSUS_CASES = [(None, 100), (3, 256), (500, 1 << 23)]
DRAW_T = 2


def census_input(chunk_words, pair_budget):
    """(port state, up, reference state) of a random window and ring at
    CENSUS_N nodes, step 37."""
    cfg = SwimConfig(n_nodes=CENSUS_N, ring_probe="pull")
    g = ring.geometry(cfg)
    rng = np.random.default_rng(19)
    arrays = convert.state_to_numpy(ring.init_state(cfg, "cpu"))
    arrays["win"] = rng.integers(0, 2**32, (CENSUS_N, g.ww), dtype=np.uint32)
    arrays["cold"] = rng.integers(0, 2**32, (g.rw, CENSUS_N),
                                  dtype=np.uint32)
    arrays["step"] = np.asarray(37, np.int32)
    up = rng.random(CENSUS_N) < 0.7
    js = jring.RingState(**{f: jnp.asarray(a) for f, a in arrays.items()})
    return convert.state_from_numpy(arrays, "cpu"), up, js


def jax_offsets(n: int, steps):
    """The reference's [s_off, q_off...] of each period at n nodes,
    jitted on the step: jit drops the unused draws."""
    jcfg = JaxSwimConfig(n_nodes=n)

    @jax.jit
    def offsets(t):
        rnd = jring.draw_period_ring(jax.random.key(0), t, jcfg)
        return rnd.s_off, rnd.q_off
    out = []
    for t in steps:
        s_off, q_off = offsets(jnp.int32(t))
        out.append([int(s_off)] + [int(q) for q in np.asarray(q_off)])
    return out


def offset_steps(n: int):
    """Periods at the start, around the first epoch's end (the shuffle's
    key changes every N - 1 periods) and in the third epoch."""
    return (0, 1, 2, 7, n - 3, n - 2, n - 1, n, 2 * (n - 1) + 5)


def jax_jobs() -> dict:
    """The reference's side of every case below."""
    def bench_plan():
        return np.asarray(jfaults.with_random_crashes(
            jfaults.none(TOP), jax.random.key(1),
            golden.SCALE_CRASH_FRACTION, 0, golden.SCALE_PERIODS).crash_step)

    def study_set():
        plan = jfaults.with_random_crashes(
            jfaults.none(TOP), jax.random.key(1), STUDY_FRACTION, 2,
            max(3, STUDY_PERIODS // 2))
        return np.asarray(jrunner.compact_track_init(
            plan, STUDY_PERIODS).subjects)

    def draws():
        jcfg = JaxSwimConfig(n_nodes=LADDER[0], **SCOPES["ringp"])
        rnd = jax.jit(lambda: jring.draw_period_ring(jax.random.key(0),
                                                     DRAW_T, jcfg))()
        return {f: np.asarray(getattr(rnd, f))
                for f in rnd._fields if f != "pull"}

    def census(case):
        _, up, js = census_input(*case)
        jcfg = JaxSwimConfig(n_nodes=CENSUS_N, ring_probe="pull")
        return np.asarray(jring.live_knower_counts(
            jcfg, js, jnp.asarray(up), chunk_words=case[0],
            pair_budget=case[1]))

    jobs = {"bench_plan": bench_plan, "study_set": study_set,
            "draws": draws}
    jobs.update({("offsets", n): functools.partial(jax_offsets, n,
                                                   offset_steps(n))
                 for n in LADDER})
    jobs.update({("census", c): functools.partial(census, c)
                 for c in CENSUS_CASES})
    return jobs


@pytest.fixture(scope="module")
def ref():
    """The reference's results by name, computed on a thread pool
    started with the module's first case, beside the port's work (XLA
    and PyTorch's large ops both let go of the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(fn) for name, fn in jax_jobs().items()}
        yield lambda name: futs[name].result()


@pytest.fixture(scope="module")
def top_bench_plan(ref):
    """bench_ring's crash periods at 16M, by the port on the CPU."""
    with torch_threads():
        return golden.scale_plan(TOP, "cpu").crash_step.numpy()


def test_bench_ring_plan_at_16m_matches_the_reference(ref, top_bench_plan):
    """bench_ring's plan (0.1% crashing in [0, 3)) at 16M: the same
    crash period for every node."""
    np.testing.assert_array_equal(top_bench_plan, ref("bench_plan"))
    crashed = np.flatnonzero(top_bench_plan < golden.SCALE_PERIODS)
    assert 15_000 < crashed.size < 17_000


def test_study_crash_set_at_16m_matches_the_reference(ref, top_bench_plan):
    """The detection study's crash set at 16M: the same node ids, all of
    them in bench_ring's crash set (both take their hits from key 1's
    uniforms)."""
    with torch_threads():
        plan = experiments._crash_plan(TOP, 0, STUDY_FRACTION,
                                       STUDY_PERIODS, torch.device("cpu"))
    got = runner.compact_track_init(plan, STUDY_PERIODS).subjects.numpy()
    np.testing.assert_array_equal(got, ref("study_set"))
    assert got.size == TOP_STUDY_CRASHES
    assert (top_bench_plan[got] < golden.SCALE_PERIODS).all()


def test_ringp_draws_at_4m_match_the_reference(ref):
    """One period's randomness of the ladder's 4M ringp run, every
    field bitwise."""
    cfg = SwimConfig(n_nodes=LADDER[0], **SCOPES["ringp"])
    with torch_threads():
        got = ring.draw_period_ring(threefry.key(0), DRAW_T, cfg, "cpu")
    assert got.pull is None
    for f, w in ref("draws").items():
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(g.view(w.dtype) if g.dtype != w.dtype
                                      else g, w, err_msg=f)


@pytest.mark.parametrize("scope", SCOPES)
@pytest.mark.parametrize("n", LADDER)
def test_geometry_matches_the_reference(n, scope):
    cfg, jcfg = configs(n, **SCOPES[scope])
    want = {k: int(v) for k, v in jring.geometry(jcfg)._asdict().items()}
    assert ring.geometry(cfg)._asdict() == want
    for name in DERIVED:
        assert getattr(cfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("n", LADDER)
def test_rotor_offsets_match_the_reference(n, ref):
    cfg = SwimConfig(n_nodes=n)
    got = [ring.rotor_offsets(cfg, t) for t in offset_steps(n)]
    assert got == ref(("offsets", n))
    assert all(1 <= o < n for offs in got for o in offs)


@pytest.mark.parametrize("n,variant", [(10_000_000, "stream"),
                                       (16_000_000, "stream"),
                                       (16_000_000, "stacked")])
def test_memwall_tree_bytes_match_the_reference(n, variant):
    """memwall's rows of bench.py's memwall tier, off the card: the
    state, carry and argument bytes of the reference's shape trees."""
    rep = memwall.study_memory_analysis(n, variant=variant, device="cpu")
    jcfg = JaxSwimConfig(n_nodes=n, ring_probe="pull")
    state = jax.eval_shape(lambda: jring.init_state(jcfg))
    plan = jax.eval_shape(lambda: jfaults.none(n))
    crashes = max(1, round(n * STUDY_FRACTION))
    i32 = jax.ShapeDtypeStruct((crashes,), "int32")
    track = jrunner.CompactTrack(i32, i32, i32, i32, i32)
    stream = variant == "stream"
    assert rep["measured"] is False and rep["crashes"] == crashes
    assert rep["state_bytes"] == jmemwall._tree_bytes(state)
    assert rep["carry_bytes"] == jmemwall._tree_bytes(
        (state, track) if stream else state)
    assert rep["argument_bytes"] == jmemwall._tree_bytes(
        (state, track, plan) if stream else (state, plan))


@pytest.mark.parametrize("case", CENSUS_CASES)
def test_census_chunk_words_match_the_reference(case, ref, monkeypatch):
    """live_knower_counts with the reference's `chunk_words` and
    `pair_budget`: chunks of that many word rows, cut along the node
    axis to the budget where they exceed it, as the reference cuts
    them; the counts equal the reference's census and the uncut one."""
    chunk_words, pair_budget = case
    cfg = SwimConfig(n_nodes=CENSUS_N, ring_probe="pull")
    st, up, _ = census_input(*case)
    shapes, counts = [], ring._lane_counts
    monkeypatch.setattr(ring, "_lane_counts", lambda w, a: shapes.append(
        tuple(w.shape)) or counts(w, a))
    got = ring.live_knower_counts(cfg, st, torch.from_numpy(up),
                                  chunk_words=chunk_words,
                                  pair_budget=pair_budget).numpy()
    rows = chunk_words or max(1, pair_budget // CENSUS_N)
    g = ring.geometry(cfg)
    assert max(r for r, _ in shapes) == min(rows, g.rw)
    cut = [c for r, c in shapes if c < CENSUS_N]
    assert all(r * c <= pair_budget for r, c in shapes) if cut else \
        rows * CENSUS_N <= pair_budget
    monkeypatch.undo()
    want = ref(("census", case))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ring.live_knower_counts(cfg, st, torch.from_numpy(up)).numpy())
    assert want.max() > 0


@pytest.mark.slow
def test_scale_anchor_through_both_packages():
    """GOLDEN_DIGEST_SCALE: bench_ring's 4M ringp run, 3 periods, by the
    JAX package and by the port on the CPU (several GB each)."""
    n = golden.SCALE_N
    jcfg = JaxSwimConfig(n_nodes=n, ring_sel_scope="period")
    plan = jfaults.with_random_crashes(
        jfaults.none(n), jax.random.key(1), golden.SCALE_CRASH_FRACTION, 0,
        golden.SCALE_PERIODS)
    js = jring.run(jcfg, jring.init_state(jcfg), plan, jax.random.key(0),
                   golden.SCALE_PERIODS)
    assert golden.digest({f: np.asarray(getattr(js, f))
                          for f in js._fields}) == golden.GOLDEN_DIGEST_SCALE
    del js
    assert golden.digest(golden.scale_run("cpu")) == \
        golden.GOLDEN_DIGEST_SCALE


@pytest.mark.slow
def test_scale_study_anchor_through_both_packages():
    """GOLDEN_DIGEST_SCALE_STUDY: the 1M streaming pull study, by the
    JAX package (about 18.7 GB of XLA:CPU temporaries) and by the
    port on the CPU."""
    n, periods = golden.SCALE_STUDY_N, golden.SCALE_STUDY_PERIODS
    jcfg = JaxSwimConfig(n_nodes=n, **golden.STUDY_CONFIG)
    jplan = jfaults.with_random_crashes(
        jfaults.none(n), jax.random.key(1), golden.SCALE_STUDY_FRACTION, 2,
        max(3, periods // 2))
    res = jexperiments._run_study(jcfg, jplan, jax.random.key(0), periods,
                                  "ring", stream=True)

    def arrays(nt):
        return {f: np.asarray(getattr(nt, f)) for f in nt._fields}
    assert golden.study_digest(arrays(res.state), arrays(res.track),
                               arrays(res.series)) == \
        golden.GOLDEN_DIGEST_SCALE_STUDY
    del res
    res = golden.scale_study("cpu")
    assert golden.study_digest(res.state, res.track, res.series) == \
        golden.GOLDEN_DIGEST_SCALE_STUDY

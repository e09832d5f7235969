"""The port's phase profiler (obs/prof.py, the engines' `prof` seam,
utils/roofline.py) against the JAX package's, bitwise.

  * `profiled_ring_run`'s int32[T, 6] markers equal the reference's in
    period scope, wave scope, pull, Lifeguard with buddy and under a
    FaultProgram, and its final state equals `ring.run`'s (profiling
    on/off parity);
  * the dense and rumor steps with a marker-mode probe (beside a tap)
    give the reference's markers every period and an unchanged state;
  * each prefix's captured live set equals the reference's captured
    arrays (ring with Lifeguard and buddy in period scope, dense,
    rumor);
  * `phases_for`, `ring_traffic`, `phase_hbm_model` and
    `phase_ici_model(cfg, 8)` equal the reference's;
  * `profile_ring`'s report has the reference's keys and byte models,
    coverage >= 95%,
    null achieved bytes and the H100's 3,350 GB/s;
  * `classify_op` on the port's kernel names, `top_ops_from_trace` on a
    synthetic Chrome trace;
  * `SwimConfig(profiling=True)` runs on all three engines and equals
    the default run.

Inputs come from seeds (the JAX package's plan constructors, carried
through numpy); one JAX compile per config, at 64-256 nodes.  Tolerance
0.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from torch_engine_cases import (faults_plan, np_fields,  # noqa: F401
                                one_torch_thread, port_plan)

from swim_tpu import SwimConfig as JSwimConfig
from swim_tpu.models import dense as jdense
from swim_tpu.models import ring as jring
from swim_tpu.models import rumor as jrumor
from swim_tpu.obs import prof as jprof
from swim_tpu.sim import faults as jfaults
from swim_tpu.utils import roofline as jroofline
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.obs import prof
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import roofline, threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 256
PERIODS = 4
SEED = 3

# wave scope at k = 1 (six waves): the default's fourteen waves triple
# the JAX compile of its unrolled wave loop
RUN_CASES = {
    "period": dict(ring_sel_scope="period"),
    "wave": dict(k_indirect=1),
    "pull": dict(ring_probe="pull"),
    "lifeguard": dict(ring_sel_scope="period", lifeguard=True),
    "program": dict(ring_sel_scope="period"),
}


def jax_plan(case: str):
    if case == "program":
        return faults_plan(N, PERIODS)
    return jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(N), [3, 100, 200], [1, 2, 4]),
        0.1)


def np_tree(x):
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same_arrays(got: dict, want: dict, what: str):
    """Port arrays (int32 carriers) against the reference's by name and
    bytes: a u32 array's carrier holds its bit pattern."""
    assert set(got) == set(want), what
    for k in want:
        g, w = np_tree(got[k]), np_tree(want[k])
        assert g.shape == w.shape, (what, k)
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and np.array_equal(g, w), (what, k)


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_profiled_ring_run_markers_equal_reference(case):
    cfg_kw = RUN_CASES[case]
    jcfg = JSwimConfig(n_nodes=N, **cfg_kw)
    cfg = SwimConfig(n_nodes=N, **cfg_kw)
    jplan = jax_plan(case)
    want = jprof.profiled_ring_run(jcfg, jring.init_state(jcfg), jplan,
                                   jax.random.key(SEED), PERIODS)
    got = prof.profiled_ring_run(cfg, ring.init_state(cfg, "cpu"),
                                 port_plan(jplan), SEED, PERIODS)
    assert got.markers.dtype == torch.int32
    assert tuple(got.markers.shape) == (PERIODS, len(prof.PHASES))
    assert np.array_equal(got.markers.numpy(), np.asarray(want.markers))
    assert int(got.step) == PERIODS
    assert_same_arrays({f: getattr(got.state, f) for f in got.state._fields},
                       {f: getattr(want.state, f)
                        for f in want.state._fields}, case)


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_profiled_ring_run_state_equals_run(case):
    cfg = SwimConfig(n_nodes=N, **RUN_CASES[case])
    plan = port_plan(jax_plan(case))
    got = prof.profiled_ring_run(cfg, ring.init_state(cfg, "cpu"), plan,
                                 SEED, PERIODS)
    want = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, SEED, PERIODS)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(got.state, f), getattr(want, f)), f
    # plain=True is the same program on the CPU
    plain = prof.profiled_ring_run(cfg, ring.init_state(cfg, "cpu"), plan,
                                   SEED, PERIODS, plain=True)
    assert torch.equal(plain.markers, got.markers)


# ---- dense and rumor: markers beside a tap, then the prefixes ----------

# (nodes, JAX module, port module, draw, Lifeguard): rumor without
# Lifeguard, whose buddy path doubles the JAX compile of four programs
ENGINES = {
    "dense": (64, jdense, dense, "draw_period", True),
    "rumor": (256, jrumor, rumor, "draw_period_rumor", False),
}


def _jax_draw(jmod, name, key, t, jcfg):
    if name == "draw_period":
        from swim_tpu.utils.prng import draw_period
        return draw_period(key, t, jcfg)
    return getattr(jmod, name)(key, t, jcfg)


def _port_draw(mod, name, key, t, cfg):
    if name == "draw_period":
        from swim_tpu_torch.utils.prng import draw_period
        return draw_period(key, t, cfg, "cpu")
    return getattr(mod, name)(key, t, cfg, "cpu")


def _jax_step_all(jmod, jcfg, phases):
    """One jit: the marker-mode step beside a tap, then every prefix."""
    def fn(st, plan, rnd):
        pr = jprof.PhaseProbe()
        nxt = jmod.step(jcfg, st, plan, rnd, tap={}, prof=pr)
        pre = {}
        for ph in phases:
            q = jprof.PhaseProbe(until=ph)
            pre[ph] = jmod.step(jcfg, st, plan, rnd, tap={}, prof=q)
        return nxt, pr.marker_vector(), pre
    return jax.jit(fn)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_markers_and_prefixes_equal_reference(engine):
    """Three periods: the port's marker vector (telemetry_tap cut beside
    the tap) equals the reference's, the state equals the step's
    without a probe, and each prefix returns the reference's live
    set."""
    n, jmod, mod, draw, lg = ENGINES[engine]
    jcfg = JSwimConfig(n_nodes=n, lifeguard=lg)
    cfg = SwimConfig(n_nodes=n, lifeguard=lg)
    jplan = jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(n), [1, n // 2], [0, 1]), 0.2)
    plan = port_plan(jplan)
    phases = ("select", "merge", "commit")
    jfn = _jax_step_all(jmod, jcfg, phases)
    jst = jmod.init_state(jcfg)
    st = mod.init_state(cfg, "cpu")
    jkey, key = jax.random.key(SEED), threefry.key(SEED)
    for t in range(3):
        jnext, jmarkers, jpre = jfn(jst, jplan, _jax_draw(jmod, draw, jkey,
                                                          t, jcfg))
        rnd = _port_draw(mod, draw, key, t, cfg)
        pr = prof.PhaseProbe()
        nxt = mod.step(cfg, st, plan, rnd, tap={}, prof=pr)
        assert np.array_equal(pr.marker_vector().numpy(),
                              np.asarray(jmarkers)), (engine, t)
        assert (pr.marker_vector() != 0).tolist()[-1] == bool(
            np.asarray(jmarkers)[-1] != 0)
        bare = mod.step(cfg, st, plan, rnd)
        for f in bare._fields:
            assert torch.equal(getattr(nxt, f), getattr(bare, f)), f
        for ph in phases:
            got = mod.step(cfg, st, plan, rnd, tap={},
                           prof=prof.PhaseProbe(until=ph))
            assert_same_arrays(got, jpre[ph], f"{engine}:{ph}:{t}")
        jst, st = jnext, nxt


def test_ring_prefix_captures_equal_reference():
    """Every phase of the fused cut order (select, ppermute, pack,
    merge, commit) returns the reference's captured arrays, with
    Lifeguard's buddy rows in `pack`, from a state three periods into a
    run (the port's run, carried to the reference through numpy)."""
    kw = dict(ring_sel_scope="period", lifeguard=True)
    jcfg, cfg = JSwimConfig(n_nodes=N, **kw), SwimConfig(n_nodes=N, **kw)
    jplan = jax_plan("lifeguard")
    plan = port_plan(jplan)
    phases = tuple(p for p in prof.phases_for(cfg) if p != "telemetry_tap")
    assert phases == ("select", "ppermute", "pack", "merge", "commit")
    assert prof.phases_for(cfg) == jprof.phases_for(jcfg)
    st0 = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, SEED, 3)
    jst = jring.RingState(**convert.state_to_numpy(st0))
    jrnd = jring.draw_period_ring(jax.random.key(SEED), 3, jcfg)

    def fn(st, rnd):
        return {ph: jring.step(jcfg, st, jplan, rnd, tap={},
                               prof=jprof.PhaseProbe(until=ph))
                for ph in phases}
    want = jax.jit(fn)(jst, jrnd)
    rnd = convert.randomness_from_numpy(np_fields(jrnd), "cpu")
    for ph in phases:
        st = st0._replace(cold=st0.cold.clone())
        pr = prof.PhaseProbe(until=ph)
        got = ring.step(cfg, st, plan, rnd, tap={}, prof=pr)
        assert_same_arrays(got, want[ph], ph)
        # prefix mode folds no marker: the reference's are dead code
        assert pr.markers == {}, ph
    assert {"bcol", "bval"} <= set(want["pack"])


# ---- byte models ---------------------------------------------------------

MODEL_CASES = [
    dict(ring_sel_scope="period"), dict(k_indirect=1),
    dict(ring_probe="pull"),
    dict(ring_sel_scope="period", ring_scalar_wire="packed", lifeguard=True),
    dict(ring_sel_scope="period", k_indirect=8),
]


@pytest.mark.parametrize("kw", MODEL_CASES,
                         ids=[f"m{i}" for i in range(len(MODEL_CASES))])
def test_byte_models_equal_reference(kw):
    n = 4096
    jcfg, cfg = JSwimConfig(n_nodes=n, **kw), SwimConfig(n_nodes=n, **kw)
    assert prof.phases_for(cfg) == jprof.phases_for(jcfg)
    assert roofline.ring_traffic(cfg) == jroofline.ring_traffic(jcfg)
    assert prof.phase_hbm_model(cfg) == jprof.phase_hbm_model(jcfg)
    assert prof.phase_ici_model(cfg, 8) == jprof.phase_ici_model(jcfg, 8)
    want = jroofline.ceiling_periods_per_sec(jcfg, hbm_gbps=3350.0)
    assert roofline.ceiling_periods_per_sec(cfg) == want
    assert roofline.HBM_GBPS == 3350.0


# the reference's report keys (swim_tpu/obs/prof.py profile_ring); a
# phase row carries achieved_gbps and hbm_ceiling_frac only where XLA
# reports achieved bytes, which no port report has
REPORT_KEYS = {
    "nodes", "platform_actual", "phases_active", "step_ms", "pps",
    "coverage_pct", "contract_coverage_pct", "phases", "xla_bytes_step",
    "roofline", "ici_model_devices", "reps", "settle", "anchor_cfg"}
ROOFLINE_KEYS = {"hbm_gbps", "ici_gbps", "ceiling_fused_pps",
                 "ceiling_unfused_pps", "bytes_fused", "bytes_unfused"}
ANCHOR_KEYS = {"ring_probe", "ring_sel_scope", "k_indirect",
               "ring_window_periods", "ring_view_c", "lifeguard",
               "telemetry_tap_included"}
ROW_KEYS = {"phase", "ms", "fraction", "hbm_model_fused_bytes",
            "hbm_model_unfused_bytes", "xla_bytes", "ici_model_bytes",
            "verdict"}


@pytest.fixture(scope="module")
def port_report():
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period")
    return prof.profile_ring(cfg, settle=1, reps=2, device="cpu")


def test_profile_ring_report_matches_reference_keys(port_report):
    rep = port_report
    assert set(rep) == REPORT_KEYS
    assert set(rep["roofline"]) == ROOFLINE_KEYS
    assert set(rep["anchor_cfg"]) == ANCHOR_KEYS
    assert all(set(r) == ROW_KEYS for r in rep["phases"])
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period")
    assert rep["phases_active"] == list(jprof.phases_for(
        JSwimConfig(n_nodes=N, ring_sel_scope="period")))
    assert [r["phase"] for r in rep["phases"]] == list(prof.phases_for(cfg))
    hbm = jprof.phase_hbm_model(JSwimConfig(n_nodes=N,
                                            ring_sel_scope="period"))
    assert [(r["hbm_model_fused_bytes"], r["hbm_model_unfused_bytes"])
            for r in rep["phases"]] == [
        (int(hbm[p][0]), int(hbm[p][1])) for p in rep["phases_active"]]
    assert rep["coverage_pct"] >= 95.0
    assert rep["platform_actual"] == "cpu"
    assert rep["xla_bytes_step"] is None
    assert all(r["xla_bytes"] is None and r["verdict"] == "n/a"
               for r in rep["phases"])
    assert rep["roofline"]["hbm_gbps"] == 3350.0
    assert rep["roofline"]["ici_gbps"] is None
    assert all(r["ms"] >= 0 for r in rep["phases"])
    assert "coverage" in prof.render_report(rep)


def test_profile_artifact_round_trip(port_report, tmp_path):
    path = prof.save_artifact(port_report, str(tmp_path / "p.json"))
    assert prof.load_artifact(path) == json.loads(json.dumps(port_report))
    assert prof.load_artifact(str(tmp_path / "missing.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert prof.load_artifact(str(tmp_path / "bad.json")) is None


@pytest.mark.parametrize("name, phase", [
    ("selb_kernel(unsigned int const*, unsigned int*, long long, int, "
     "int, bool)", "select"),
    ("wavemerge_kernel(unsigned int*, unsigned int const*, unsigned "
     "char const*, int const*, int, int, long long)", "merge"),
    ("void coldsel_kernel<4>(unsigned int*, int const*, unsigned int "
     "const*, int const*, long long, int, int, int)", "commit"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<long, "
     "at::native::func_wrapper_t<long, at::native::sum_functor>>>",
     "select"),
    ("void at::native::index_elementwise_kernel<128, 4>", "ppermute"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>",
     "commit"),
    ("void at::native::vectorized_elementwise_kernel<4, BitwiseOrFunctor>",
     None),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", None),
    ("void at::native::roll_cuda_kernel<int>", "ppermute"),
])
def test_classify_op_on_port_kernel_names(name, phase):
    got, note = prof.classify_op(name)
    assert got == phase and note


def test_top_ops_from_synthetic_trace(tmp_path):
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "selb_kernel(...)",
         "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "selb_kernel(...)",
         "dur": 41.0},
        {"ph": "X", "cat": "kernel", "name": "wavemerge_kernel(...)",
         "dur": 77.0},
        {"ph": "X", "cat": "kernel", "name": "void coldsel_kernel<4>(...)",
         "dur": 17.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 9.0},
        {"ph": "i", "cat": "kernel", "name": "selb_kernel(...)"},
    ]
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "host.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    top = prof.top_ops_from_trace(str(tmp_path), top_k=2)
    assert top["total_us"] == 175.0
    assert [(o["op"], o["calls"], o["phase_guess"]) for o in top["ops"]] \
        == [("selb_kernel(...)", 2, "select"),
            ("wavemerge_kernel(...)", 1, "merge")]
    assert top["ops"][0]["self_us"] == 81.0
    with pytest.raises(FileNotFoundError):
        prof.top_ops_from_trace(str(tmp_path / "empty"))
    text = prof.render_report({**{"nodes": 1, "platform_actual": "cuda",
                                  "step_ms": 1.0, "pps": 1.0,
                                  "phases": [], "roofline": {}},
                               "top_ops": top})
    assert "selb_kernel" in text


def test_phase_probe_rejects_unknown_phase():
    with pytest.raises(ValueError, match="unknown phase"):
        prof.PhaseProbe(until="nope")
    with pytest.raises(ValueError, match="unknown phase"):
        jprof.PhaseProbe(until="nope")


@pytest.mark.parametrize("engine", ["ring", "dense", "rumor"])
def test_profiling_config_runs_and_equals_default(engine):
    """The repair: `SwimConfig(profiling=True)` runs on every engine and
    gives the default run, as the reference does on one device."""
    mod = {"ring": ring, "dense": dense, "rumor": rumor}[engine]
    n = 64
    kw = dict(ring_sel_scope="period") if engine == "ring" else {}
    on = SwimConfig(n_nodes=n, profiling=True, **kw)
    off = SwimConfig(n_nodes=n, **kw)
    plan = faults.with_loss(faults.with_crashes(faults.none(n, "cpu"),
                                                [2, 9], [1, 3]), 0.1)
    got = mod.run(on, mod.init_state(on, "cpu"), plan, 1, 5)
    want = mod.run(off, mod.init_state(off, "cpu"), plan, 1, 5)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    eng_cls = {"ring": ring.RingEngine, "dense": dense.DenseEngine,
               "rumor": rumor.RumorEngine}[engine]
    eng = eng_cls(on, plan, seed=1, device="cpu")
    eng.run(5)
    for f in got._fields:
        assert torch.equal(getattr(eng.state, f), getattr(want, f)), f


def test_fold_takes_the_reference_branches():
    """u32 carriers fold their low 15 bits; int32 sums wrap modulo 2**32
    as the reference's int32 sum does; floats count their nonzeros."""
    import jax.numpy as jnp

    big = np.full(256, 2**31 - 7, np.int32)
    assert int(prof._fold(torch.from_numpy(big))) == int(jprof._fold(
        jnp.asarray(big)))
    u = np.arange(300, dtype=np.uint32) * np.uint32(0x9E3779B9)
    assert int(prof._fold(torch.from_numpy(u.view(np.int32)), u32=True)) \
        == int(jprof._fold(jnp.asarray(u)))
    f = np.array([0.0, 1.5, -2.0, 0.0], np.float32)
    assert int(prof._fold(torch.from_numpy(f))) == int(jprof._fold(
        jnp.asarray(f)))
    b = np.array([True, False, True])
    assert int(prof._fold(torch.from_numpy(b))) == int(jprof._fold(
        jnp.asarray(b)))

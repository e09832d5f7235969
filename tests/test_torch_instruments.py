"""The port's instruments beside the reference's, byte for byte.

  * obs/expo.py: `render_build_info`, `render_prometheus` and
    `render_health` over the registries of a scripted SimCluster (both
    packages run the same script), `render_profile` over a port profile
    report and one with achieved bytes, `render_memwall` (but its help
    texts, which the port words for its own measurement),
    `render_sessions` and `render_serve_trace`;
  * obs/trend.py: `collect`, `summarize`, `check`, `render` and `main`
    over a tmp_path of BENCH_r*.json and bench_results captures;
  * utils/checkpoint.py `CheckpointManager`: the same files, retention
    and contents as the reference's;
  * obs/memwall.py on the CPU: the reference's state and carry bytes,
    nothing measured;
  * a `BridgeServer(metrics_port=0)` scrape after a scripted external
    core equals the reference's, line for line, with the same profile
    artifact behind the swim_prof_* gauges;
  * utils/profiling.py: `StepTimer` counts completed laps only, and
    `trace` writes a Chrome trace the profiler's parser reads.
Tolerance: exact.
"""
from __future__ import annotations

import json
import urllib.request

import jax
import numpy as np
import pytest
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JSwimConfig
from swim_tpu.bridge import BridgeServer as JBridgeServer
from swim_tpu.bridge import ExternalNodeHost as JExternalNodeHost
from swim_tpu.core.cluster import SimCluster as JSimCluster
from swim_tpu.models import ring as jring
from swim_tpu.obs import expo as jexpo
from swim_tpu.obs import health as jhealth
from swim_tpu.obs import memwall as jmemwall
from swim_tpu.obs import prof as jprof
from swim_tpu.obs import trend as jtrend
from swim_tpu.sim import faults as jfaults
from swim_tpu.utils import checkpoint as jcheckpoint
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.bridge import BridgeServer, ExternalNodeHost
from swim_tpu_torch.core.cluster import SimCluster
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs import expo, health, memwall, prof, trend
from swim_tpu_torch.utils import checkpoint, threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def scripted_cluster(cluster_cls, cfg):
    """8 nodes under loss: settle, kill node 3, run on."""
    c = cluster_cls(cfg, seed=5, loss=0.05)
    c.start()
    c.run(8.0)
    c.kill(3)
    c.run(20.0)
    return c


@pytest.fixture(scope="module")
def clusters():
    return (scripted_cluster(SimCluster, SwimConfig(n_nodes=8)),
            scripted_cluster(JSimCluster, JSwimConfig(n_nodes=8)))


def test_render_prometheus_and_health_equal_reference(clusters):
    port, ref = clusters
    pairs = [({"node": str(n.id)}, n.registry) for n in port.nodes]
    jpairs = [({"node": str(n.id)}, n.registry) for n in ref.nodes]
    got = expo.render_prometheus(pairs, build_labels={"nodes": "8"})
    want = jexpo.render_prometheus(jpairs, build_labels={"nodes": "8"})
    assert got == want
    assert "swim_build_info{version=" in got and "_total{node=" in got
    assert "_bucket{node=" in got
    assert expo.render_build_info() == jexpo.render_build_info()
    assert expo.render_build_info({"a": 'q"\\\n'}, "x") \
        == jexpo.render_build_info({"a": 'q"\\\n'}, "x")
    findings = health.evaluate_registries(n.registry for n in port.nodes)
    jfindings = jhealth.evaluate_registries(n.registry for n in ref.nodes)
    got = expo.render_health(findings, {"cluster": "a"})
    assert got == jexpo.render_health(jfindings, {"cluster": "a"})
    # a firing rule renders 1 and sets the status
    kw = dict(rule="node_probe_failure_rate", severity="warn", period=-1,
              value=0.5, threshold=0.2, message="m")
    f, jf = health.Finding(**kw), jhealth.Finding(**kw)
    assert expo.render_health([f]) == jexpo.render_health([jf])
    assert "swim_health_status 1" in expo.render_health([f])


PROFILE_WITH_BYTES = {
    "nodes": 65536, "platform_actual": "tpu", "step_ms": 1.5,
    "coverage_pct": 98.25,
    "phases": [
        {"phase": "select", "ms": 0.5, "fraction": 0.3333,
         "hbm_model_fused_bytes": 10, "hbm_model_unfused_bytes": 20,
         "xla_bytes": 30, "ici_model_bytes": 40, "verdict": "floor"},
        {"phase": "merge", "ms": 1, "fraction": 0.6667,
         "hbm_model_fused_bytes": 11, "hbm_model_unfused_bytes": 21,
         "xla_bytes": None, "ici_model_bytes": 0, "verdict": "n/a"}],
}


def test_render_profile_equals_reference():
    cfg = SwimConfig(n_nodes=256, ring_sel_scope="period")
    rep = prof.profile_ring(cfg, settle=1, reps=1, device="cpu")
    for r in (rep, PROFILE_WITH_BYTES):
        got = expo.render_profile(r, {"job": "x"})
        assert got == jexpo.render_profile(r, {"job": "x"})
    assert 'platform="cpu"' in expo.render_profile(rep)
    assert "swim_prof_phase_xla_bytes{" not in expo.render_profile(rep)
    assert set(prof.PROF_GAUGES) == set(jprof.PROF_GAUGES)


MEMWALL = {"n": 1_000_000, "platform": "cuda", "variant": "stream",
           "engine": "ring", "state_bytes": 572184332,
           "hbm_budget_bytes": 85_000_000_000, "argument_bytes": 5,
           "output_bytes": 6, "temp_bytes": 7, "alias_bytes": 0,
           "total_bytes": 18, "fits_budget": True}


def test_render_memwall_equals_reference_but_help():
    assert list(memwall.MEM_GAUGES) == list(jmemwall.MEM_GAUGES)
    for r in (MEMWALL, {"n": 4, "state_bytes": 1, "hbm_budget_bytes": 0}):
        assert memwall.gauge_values(r) == jmemwall.gauge_values(r)
        got = expo.render_memwall(r, {"k": "v"}).splitlines()
        want = jexpo.render_memwall(r, {"k": "v"}).splitlines()
        assert len(got) == len(want)
        assert [g for g in got if not g.startswith("# HELP")] \
            == [w for w in want if not w.startswith("# HELP")]
        assert [g.split()[2] for g in got if g.startswith("# HELP")] \
            == [w.split()[2] for w in want if w.startswith("# HELP")]


def test_memwall_cpu_reports_tree_bytes_only():
    got = memwall.study_memory_analysis(4096, periods=12, device="cpu")
    cfg = JSwimConfig(n_nodes=4096, ring_probe="pull")
    state_sd = jax.eval_shape(lambda: jring.init_state(cfg))
    assert got["state_bytes"] == jmemwall._tree_bytes(state_sd)
    assert got["measured"] is False and got["platform"] == "cpu"
    assert got["carry_bytes"] == got["state_bytes"] + 5 * 4 * got["crashes"]
    plan_bytes = jmemwall._tree_bytes(
        jax.eval_shape(lambda: jfaults.none(4096)))
    assert got["argument_bytes"] == got["carry_bytes"] + plan_bytes
    # the sharded engine's row: 8 shards, each its S = N/8 node-axis
    # rows and its own copy of the replicated tables
    sh = memwall.study_memory_analysis(4096, periods=12, device="cpu",
                                       engine="ringshard")
    rcfg = JSwimConfig(n_nodes=4096, ring_probe="pull")
    rsd = jax.eval_shape(lambda: jring.init_state(rcfg))
    node = sum(jmemwall._tree_bytes(getattr(rsd, f)) for f in
               ("win", "cold", "inc_self", "lha", "gone_key"))
    rep = got["state_bytes"] - node
    assert sh["shards"] == 8 and sh["measured"] is False
    assert sh["shard_state_bytes"] == node // 8 + rep
    assert sh["state_bytes"] == node + 8 * rep
    assert sh["crashes"] == got["crashes"]
    with pytest.raises(ValueError, match="stream"):
        memwall.study_memory_analysis(64, device="cpu", engine="ringshard",
                                      variant="stacked")
    with pytest.raises(ValueError, match="variant"):
        memwall.study_memory_analysis(64, device="cpu", variant="x")


SESSIONS = {"nodes": 1_000_000, "admitted": 12, "evicted": 2, "active": 10,
            "mirror_bytes_per_period": 1024, "mirror_spill_slots": 3,
            "sessions": [{"row": 4, "clock_lag_periods": 0},
                         {"row": 9, "clock_lag_periods": 2.5}]}
SERVE_SUMMARY = {"nodes": 1_000_000, "unattributed_ms": 0.125,
                 "period_ms": {"mean": 20.5},
                 "phases": {"evict_scan": {"mean_ms": 0.1, "p99_ms": 0.2,
                                           "fraction": 0.01},
                            "engine_step": {"mean_ms": 18, "p99_ms": 30,
                                            "fraction": 0.9}}}


def test_render_sessions_and_serve_trace_equal_reference():
    for r in (SESSIONS, {**SESSIONS, "sessions": []}):
        assert expo.render_sessions(r, {"hub": "a"}) \
            == jexpo.render_sessions(r, {"hub": "a"})
    for s in (SERVE_SUMMARY, {"phases": {}}):
        assert expo.render_serve_trace(s) == jexpo.render_serve_trace(s)


def write_bench_repo(root):
    for rnd, pps, peak, p99 in ((1, 40.0, 1000, 5.0), (2, 41.5, 900, 6.0),
                                (3, 30.0, 1200, 4.0)):
        (root / f"BENCH_r{rnd:02d}.json").write_text(json.dumps({"parsed": {
            "platform": "gpu", "ring_periods_per_sec": pps,
            "ring_nodes": 1_000_000, "memwall_peak_bytes": peak,
            "memwall_nodes": 4096, "serve_p99_ms": p99, "serve_sessions":
            1000 + rnd, "serve_nodes": 65536, "note": "x"}}))
    (root / "BENCH_r04.json").write_text("{torn")
    (root / "bench_results").mkdir()
    (root / "bench_results" / "bench_all_a.json").write_text(json.dumps({
        "captured_at": "2026-10-01T00:00:00", "result": {
            "platform": "gpu", "ring_periods_per_sec": 39.0,
            "ring_nodes": 1_000_000}}))


def test_trend_equals_reference(tmp_path, capsys):
    write_bench_repo(tmp_path)
    repo = str(tmp_path)
    assert trend.collect(repo) == jtrend.collect(repo)
    for th in (0.10, 0.5):
        got, want = trend.summarize(repo, th), jtrend.summarize(repo, th)
        assert got == want
        assert trend.check(trend.series(trend.collect(repo)), th) \
            == jtrend.check(jtrend.series(jtrend.collect(repo)), th)
        assert trend.render(got) == jtrend.render(want)
    assert not trend.summarize(repo)["ok"]
    for argv in (["--repo", repo, "--json", "--check"], ["--repo", repo]):
        rc = trend.main(argv)
        out = capsys.readouterr().out
        assert (rc, out) == (jtrend.main(argv), capsys.readouterr().out)


def test_checkpoint_manager_equals_reference(tmp_path):
    cfg = SwimConfig(n_nodes=64)
    jcfg = JSwimConfig(n_nodes=64)
    port = checkpoint.CheckpointManager(str(tmp_path / "p"), every=3, keep=2)
    ref = jcheckpoint.CheckpointManager(str(tmp_path / "r"), every=3,
                                        keep=2)
    state = ring.init_state(cfg, "cpu")
    jstate = jring.init_state(jcfg)
    for step in range(0, 13):
        assert port.maybe_save(state, threefry.key(7), step) \
            == ref.maybe_save(jstate, jax.random.key(7), step)
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "r").iterdir())
    assert names == ["ckpt_000000000009.npz", "ckpt_000000000012.npz"]
    assert port.latest().endswith("ckpt_000000000012.npz")
    with np.load(port.latest()) as a, np.load(ref.latest()) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            want = b[k]
            got = a[k].view(want.dtype) if want.dtype == np.uint32 else a[k]
            assert np.array_equal(got, want), k
    back, key, step = checkpoint.restore_placed(port.latest(), state)
    assert (key, step) == (threefry.key(7), 12)
    assert checkpoint.CheckpointManager(str(tmp_path / "e"), 1).latest() \
        is None


def scrape_after_script(server_cls, host_cls, cfg) -> list[str]:
    """8 in-process nodes, an external core joins and kills node 3; the
    server's /metrics text afterwards."""
    server = server_cls(cfg, n_internal=8, seed=3, metrics_port=0)
    server.start()
    host = host_cls(server.address, quantum=0.25)
    try:
        host.add_node(cfg, 100, seeds=[0], seed=100)
        host.run(3.0)
        host.kill(3)
        host.run(6.0)
        h, p = server.metrics_address
        with urllib.request.urlopen(f"http://{h}:{p}/metrics",
                                    timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            return resp.read().decode().splitlines()
    finally:
        host.close()
        server.close()
        server.join()


def test_bridge_metrics_scrape_equals_reference(tmp_path, monkeypatch):
    path = str(tmp_path / "profile_phases.json")
    prof.save_artifact(PROFILE_WITH_BYTES, path)
    monkeypatch.setattr(prof, "default_artifact_path", lambda: path)
    monkeypatch.setattr(jprof, "default_artifact_path", lambda: path)
    got = scrape_after_script(BridgeServer, ExternalNodeHost,
                              SwimConfig(n_nodes=9))
    want = scrape_after_script(JBridgeServer, JExternalNodeHost,
                               JSwimConfig(n_nodes=9))
    assert got[:3] == want[:3]          # swim_build_info
    assert got[3:] == want[3:]
    text = "\n".join(got)
    assert "swim_prof_step_ms{" in text and "swim_health_status" in text
    assert any(line.startswith("swim_") and "_total{node=" in line
               and not line.endswith(" 0") for line in got)


def test_step_timer_and_trace(tmp_path):
    """StepTimer counts completed laps only (a body that raises adds
    nothing), as the reference's; `trace` writes a Chrome trace that
    top_ops_from_trace reads (no GPU kernels on the CPU)."""
    import torch

    from swim_tpu.utils.profiling import StepTimer as JStepTimer
    from swim_tpu_torch.utils import profiling

    for timer in (profiling.StepTimer(), JStepTimer()):
        with timer.lap(periods=5) as lap:
            lap["result"] = torch.ones(3) if isinstance(
                timer, profiling.StepTimer) else np.ones(3)
        with pytest.raises(RuntimeError):
            with timer.lap(periods=7):
                raise RuntimeError("failed lap")
        assert timer.periods == 5 and timer.seconds > 0
        assert set(timer.summary()) == {"periods", "seconds",
                                        "periods_per_sec"}
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    top = prof.top_ops_from_trace(str(tmp_path / "tr"))
    assert top["trace"].endswith(profiling.TRACE_FILE)
    assert top["ops"] == [] and top["total_us"] == 0.0

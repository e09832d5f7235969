"""Serve-path tracing of the port (swim_tpu_torch/obs/servetrace.py,
obs/trace.py, analyze.summarize_serve) on the CPU.

The 18 cases of tests/test_servetrace.py on the port's hub
(`device="cpu"`): coercion; the phase timeline tiles the period wall;
a traced 4,096-node hub run covers >= 90% of its wall with the five
phases; tracing is bitwise free (traced and untraced hubs give equal
sha256 state digests, quiet and under a gossip storm); the spill
surface; serve spans through the JSONL sink into the analyzer; the
overlap math of `summarize_serve`; the gauge surface; a small
`trace_overhead`.  `summarize_serve` and the gauge values must equal
the JAX package's on the same inputs (tolerance 0: equal dicts).
"""
from __future__ import annotations

import json
import time

import pytest
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu.obs import analyze as janalyze
from swim_tpu.obs import expo as jexpo
from swim_tpu.obs import servetrace as jservetrace
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.core import codec
from swim_tpu_torch.obs import analyze
from swim_tpu_torch.obs.health import HEALTH_RULES
from swim_tpu_torch.obs.servetrace import (PHASES, SERVE_TRACE_GAUGES,
                                           ServeTrace, coerce, gauge_values)
from swim_tpu_torch.obs.trace import JsonlSink
from swim_tpu_torch.serve.hub import ServeHub
from swim_tpu_torch.serve.load import state_digest
from swim_tpu_torch.types import MsgKind, Status

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEOM = dict(k_indirect=1, ring_window_periods=3, suspicion_mult=2.0,
            ring_view_c=2, ring_sel_scope="period")
N = 256


def make_hub(n=N, **kw):
    return ServeHub(SwimConfig(n_nodes=n, **GEOM), frontend="socket",
                    device="cpu", **kw)


def gossip_datagram(row: int, subject: int, n_nodes: int) -> bytes:
    """One encoded PING carrying one SUSPECT opinion from `row`."""
    msg = codec.Message(
        kind=MsgKind.PING, sender=row, probe_seq=1,
        gossip=(codec.WireUpdate(member=subject, status=Status.SUSPECT,
                                 incarnation=0, addr=("sim", subject),
                                 origin=row),))
    return codec.encode(msg)


def one_period_trace() -> ServeTrace:
    tr = ServeTrace()
    tr.begin(0)
    for name in PHASES:
        tr.lap(name)
    tr.end()
    return tr


class TestCoercion:
    def test_off_states(self):
        assert coerce(None) is None
        assert coerce(False) is None

    def test_on_states(self):
        tr = coerce(True)
        assert isinstance(tr, ServeTrace)
        assert coerce(tr) is tr

    def test_garbage_rejected(self):
        with pytest.raises(TypeError):
            coerce("yes")


class TestPhaseTimeline:
    def test_contiguous_laps_tile_the_wall(self):
        tr = ServeTrace()
        for period in range(3):
            tr.begin(period)
            for name in PHASES:
                time.sleep(0.001)
                tr.lap(name)
            tr.end()
        frames = tr.frames()
        assert [f["period"] for f in frames] == [0, 1, 2]
        for f in frames:
            assert [p[0] for p in f["phases"]] == list(PHASES)
            for (_, _, e0), (_, b1, _) in zip(f["phases"],
                                              f["phases"][1:]):
                assert e0 == b1
            assert f["phases"][0][1] == f["t0"]
            assert f["phases"][-1][2] == f["t1"]
        s = tr.summary()
        assert s["periods"] == 3
        assert s["unattributed_ms"] == 0.0
        assert set(s["phases"]) == set(PHASES)
        assert s["period_ms"]["mean"] > 0.0
        assert PHASES == jservetrace.PHASES

    def test_frame_ring_is_bounded(self):
        tr = ServeTrace(frame_capacity=2)
        for period in range(5):
            tr.begin(period)
            for name in PHASES:
                tr.lap(name)
            tr.end()
        assert [f["period"] for f in tr.frames()] == [3, 4]
        assert tr.summary()["periods"] == 5

    def test_gauge_values_cover_the_registry(self):
        s = one_period_trace().summary()
        vals = gauge_values(s)
        assert set(vals) == set(SERVE_TRACE_GAUGES)
        assert vals == jservetrace.gauge_values(s)
        assert SERVE_TRACE_GAUGES == jservetrace.SERVE_TRACE_GAUGES


class TestHubTracing:
    def test_phase_coverage_on_a_real_hub(self):
        periods = 4
        hub = make_hub(n=4096, reserved_rows=[1, 2], ack_grace=99,
                       trace=True)
        try:
            row = hub.attach()
            hub._on_session_datagram(None, row, (row + 1) % 4096,
                                     gossip_datagram(row, 77, 4096))
            hub.step_periods(periods)
            tr = hub.trace
            frames = tr.frames()
            assert len(frames) == periods
            for f in frames:
                assert [p[0] for p in f["phases"]] == list(PHASES)
            s = tr.summary()
            attributed = sum(p["total_ms"] for p in s["phases"].values())
            wall = s["period_ms"]["total"]
            assert wall > 0.0
            assert attributed / wall >= 0.90
            outcomes = {d["outcome"] for d in tr.span_dicts()}
            assert "gossip_flushed" in outcomes
        finally:
            hub.close()


class TestTracedParity:
    def test_tracing_is_bitwise_free_quiet_and_storm(self):
        periods = 3
        rows = [0, 1, 2, 3]

        def run(traced: bool, storm: bool) -> str:
            hub = make_hub(reserved_rows=rows, seed=7, ack_grace=99,
                           trace=traced)
            try:
                for _ in rows:
                    hub.attach()
                for t in range(periods):
                    if storm:
                        for row in rows:
                            dg = gossip_datagram(row, 100 + t, N)
                            hub._on_session_datagram(None, row,
                                                     (row + 1) % N, dg)
                            hub._on_session_datagram(None, row,
                                                     (row + 1) % N, dg)
                    hub.step_periods(1)
                return state_digest(hub.state)
            finally:
                hub.close()

        assert run(False, storm=False) == run(True, storm=False)
        d_off = run(False, storm=True)
        assert d_off == run(True, storm=True)
        assert d_off != run(False, storm=False)


class TestSpillSurface:
    def test_single_spill_period_is_counted_but_silent(self):
        hub = make_hub(reserved_rows=[3], ack_grace=99)
        try:
            row = hub.attach()
            cap = hub.ext_capacity
            for i in range(2 * cap):
                hub._on_session_datagram(None, row, (row + 1) % N,
                                         gossip_datagram(row, i % 200, N))
            hub.step_periods(1)
            rep = hub.report()
            assert rep["mirror_spill_slots"] == cap
            assert rep["mirror_spill_periods"] == 1
            assert not [f for f in hub.findings()
                        if f.rule == "ext_mirror_overflow"]
            hub.step_periods(1)
            rep = hub.report()
            assert rep["mirror_spill_slots"] == cap
            assert rep["mirror_spill_periods"] == 1
        finally:
            hub.close()

    def test_persistent_spill_fires_overflow_finding(self):
        assert HEALTH_RULES["ext_mirror_overflow"][0] == "warn"
        hub = make_hub(reserved_rows=[3], ack_grace=99)
        try:
            row = hub.attach()
            cap = hub.ext_capacity
            for i in range(3 * cap):
                hub._on_session_datagram(None, row, (row + 1) % N,
                                         gossip_datagram(row, i % 200, N))
            hub.step_periods(2)
            rep = hub.report()
            assert rep["mirror_spill_slots"] == 3 * cap
            assert rep["mirror_spill_periods"] == 2
            hits = [f for f in hub.findings()
                    if f.rule == "ext_mirror_overflow"]
            assert len(hits) == 1
            assert hits[0].severity == "warn"
            assert hits[0].threshold == float(cap)
        finally:
            hub.close()


class TestSpanRoundTrip:
    def test_serve_spans_reach_the_offline_analyzer(self, tmp_path):
        path = str(tmp_path / "serve_spans.jsonl")
        sink = JsonlSink(path)
        tr = ServeTrace(sink=sink)
        t0 = tr.now()
        echo = tr.datagram_span(t0, op=6)
        echo.event(t0 + 0.001, "send")
        tr.emit(echo.finish(t0 + 0.001, "echo_reply"))
        g = tr.datagram_span(t0, op=3, row=5)
        g.event(t0 + 0.0005, "queued")
        g.event(t0 + 0.002, "flush")
        tr.emit(g.finish(t0 + 0.002, "gossip_flushed"))
        h = tr.datagram_span(t0, op=1)
        h.event(t0 + 0.0002, "queued")
        h.event(t0 + 0.0008, "handled")
        tr.emit(h.finish(t0 + 0.001, "admit"))
        sink.close()

        assert analyze.sniff(path) == "spans"
        report = analyze.analyze(path)
        assert report == janalyze.analyze(path)
        serve = report["serve"]
        assert serve["total"] == 3
        assert serve["outcomes"] == {"echo_reply": 1,
                                     "gossip_flushed": 1, "admit": 1}
        assert serve["queue_wait_mean_ms"] > 0.0
        assert serve["flush_delay_mean_ms"] > 0.0
        rows = [json.loads(line) for line in open(path)]
        assert all(r["kind"] == "serve" for r in rows)
        assert {r["subject"] for r in rows} == {6, 3, 1}


class TestAttributionMath:
    FRAME = {"period": 0, "t0": 1.0, "t1": 1.012,
             "phases": [["engine_step", 1.0, 1.010],
                        ["mirror_fanout", 1.010, 1.012]]}

    @staticmethod
    def both(frames, windows, **kw):
        """The port's report, held equal to the reference's."""
        rep = analyze.summarize_serve(frames, windows, **kw)
        assert rep == janalyze.summarize_serve(frames, windows, **kw)
        return rep

    def test_known_overlap_decomposes_exactly(self):
        windows = [(1.002, 1.006)] * 10     # 4 ms each, all tail
        rep = self.both([self.FRAME], windows)
        assert rep["kind"] == "serve_trace"
        assert rep["attributed"] is True
        assert rep["coverage_pct"] == 100.0
        assert rep["p99_attribution_ms"]["engine_step"] == \
            pytest.approx(4.0, abs=1e-6)
        assert rep["p99_attribution_ms"]["mirror_fanout"] == 0.0
        assert rep["unattributed_ms"] == pytest.approx(0.0, abs=1e-6)

    def test_straddling_window_splits_between_phases(self):
        windows = [(1.008, 1.012)] * 4      # 2 ms step + 2 ms fanout
        summary = one_period_trace().summary()
        rep = self.both([self.FRAME], windows, phase_summary=summary)
        assert rep["p99_attribution_ms"]["engine_step"] == \
            pytest.approx(2.0, abs=1e-6)
        assert rep["p99_attribution_ms"]["mirror_fanout"] == \
            pytest.approx(2.0, abs=1e-6)
        assert rep["attributed"] is True

    def test_uncovered_tail_flips_the_contract_flag(self):
        windows = [(2.0, 2.004)] * 5
        rep = self.both([self.FRAME], windows)
        assert rep["attributed"] is False
        assert rep["coverage_pct"] == 0.0
        assert rep["unattributed_ms"] == pytest.approx(4.0, abs=1e-6)

    def test_degenerate_inputs_fail_closed(self):
        rep = self.both([], [])
        assert rep["attributed"] is False
        assert "reason" in rep


class TestGaugeSurface:
    def test_render_serve_trace_exposition(self):
        """The port has no exposition renderer yet: the reference's
        renders the port's summary with every gauge and phase label."""
        summary = one_period_trace().summary()
        summary["nodes"] = 4096
        text = jexpo.render_serve_trace(summary)
        for name in SERVE_TRACE_GAUGES:
            assert name in text
        assert 'phase="engine_step"' in text
        assert 'nodes="4096"' in text

    def test_session_spill_gauge(self):
        from swim_tpu_torch.serve.hub import SESSION_GAUGES
        from swim_tpu_torch.serve.hub import gauge_values as session_gauges

        assert "swim_session_mirror_spill_slots" in SESSION_GAUGES
        rep = {"nodes": 8, "admitted": 1, "evicted": 0, "active": 1,
               "mirror_bytes_per_period": 16, "mirror_spill_slots": 9,
               "sessions": []}
        assert session_gauges(rep)[
            "swim_session_mirror_spill_slots"] == 9.0


class TestOverheadHarnessSmoke:
    def test_trace_overhead_small(self):
        from swim_tpu_torch.serve import load as serve_load

        res = serve_load.trace_overhead(n_nodes=512, sessions=8,
                                        periods=2, reps=1, device="cpu")
        assert res["ok_parity"], res
        assert res["digest_off"] == res["digest_on"]
        assert res["pps_on"] > 0.0 and res["pps_off"] > 0.0
        assert "serve_unattributed_ms" in res
        assert res["contract_pct"] == 5.0

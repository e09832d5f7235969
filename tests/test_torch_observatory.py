"""The port's health monitor, flight recorder and analyzer against
`swim_tpu.obs`, and `detection_study`'s telemetry against the JAX
package's.

  * the HealthMonitor rule scenarios of tests/test_observatory.py (and
    the scenario-fed gray and flap rules), fed the same rows through
    both packages: equal findings, gauges, summaries and dump reasons
    after every row; `evaluate_registries` on the same registries;
  * FlightRecorder: round trip through a dump, the last K periods kept,
    the unknown-key guard, a foreign JSONL refused by `load` and by
    `analyze.sniff`, the health wiring (error finding -> dump reason);
  * `detection_study(telemetry=True)` in both packages: a ring study
    with `flight_record` (on demand) and a rumor study whose overflow
    fires an error finding (the automatic dump into the working
    directory): equal result dicts and byte-identical dumps; the port's
    `analyze`, `error_findings` and `render_report` of the dump equal
    the reference's, and the dump alone reproduces the detection
    summary;
  * `summarize_serve` raises, naming its ROADMAP item.

Tolerance: exact.
"""
from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu.obs import analyze as janalyze
from swim_tpu.obs import health as jhealth
from swim_tpu.sim import experiments as jexperiments
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.obs import analyze, health
from swim_tpu_torch.obs.engine import EngineFrame
from swim_tpu_torch.obs.recorder import FlightRecorder
from swim_tpu_torch.sim import experiments
from swim_tpu_torch.utils import metrics

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# monitor keywords and the rows fed to it, one scenario each
SCENARIOS = {
    "false_dead": (dict(window=4), [{"false_dead_views": 0},
                                    {"false_dead_views": 2}]),
    "overflow_growth": (dict(window=4), [{"overflow": 5}, {"overflow": 5},
                                         {"overflow": 9}]),
    "index_overflow_growth": (dict(window=3), [{"index_overflow": 1},
                                               {"index_overflow": 4}]),
    "stalled": (dict(window=3),
                [{"waves_delivered": 0, "win_occupancy": 7}] * 3
                + [{"waves_delivered": 5, "win_occupancy": 7}]),
    "probe_steady": (dict(window=8, n_nodes=100),
                     [{"probes_failed": 50}] * 8),
    "probe_burst_error": (dict(window=8, n_nodes=100),
                          [{"probes_failed": 1}] * 6
                          + [{"probes_failed": 80}]),
    "probe_burst_warn": (dict(window=8, n_nodes=10_000),
                         [{"probes_failed": 1}] * 6
                         + [{"probes_failed": 30}]),
    "saturation_decay": (dict(window=4),
                         [{"sel_rows_saturated": 0}] * 3
                         + [{"sel_rows_saturated": 40}] * 5),
    "gray_undetected": (dict(window=3),
                        [{"gray_nodes": 4, "probes_failed": 0}] * 4),
    "flap_false_dead": (dict(window=4, thresholds={"saturation_min": 2}),
                        [{"flap_active": 1, "false_dead_views": 0},
                         {"flap_active": 0, "false_dead_views": 3},
                         {"sel_rows_saturated": 9}]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_health_monitor_matches_the_reference(name):
    kw, rows = SCENARIOS[name]
    mine, ref = health.HealthMonitor(**kw), jhealth.HealthMonitor(**kw)
    for t, row in enumerate(rows):
        mine.observe(t, row)
        ref.observe(t, row)
        assert [f.to_dict() for f in mine.findings()] == \
            [f.to_dict() for f in ref.findings()], t
        assert mine.gauges() == ref.gauges(), t
        assert mine.summary() == ref.summary(), t
        assert mine.worst() == ref.worst()
        assert mine.auto_dump_reason() == ref.auto_dump_reason()
    if name != "probe_steady":       # every other scenario fires
        assert mine.findings()
    assert set(mine.gauges()) == set(health.HEALTH_RULES) | {"status"}
    assert health.HEALTH_RULES == jhealth.HEALTH_RULES
    assert health.DEFAULT_THRESHOLDS == jhealth.DEFAULT_THRESHOLDS


def test_findings_and_registry_rules_match_the_reference():
    f = health.Finding("overflow_growth", "error", 7, 16.0, 0.0, "grew")
    assert health.Finding.from_dict(json.loads(json.dumps(f.to_dict()))) == f
    fs = [health.Finding("saturation_spike", "warn", 3, 9, 1, "w"), f]
    assert [x.rule for x in health.sort_findings(fs)] == \
        [x.rule for x in jhealth.sort_findings(
            [jhealth.Finding(**x.to_dict()) for x in fs])]

    def registry(**counts):
        return types.SimpleNamespace(counters={
            k: types.SimpleNamespace(value=v) for k, v in counts.items()})

    regs = [registry(probes=30, probe_failures=20),
            registry(decode_errors=2, probes=0)]
    mine = [x.to_dict() for x in health.evaluate_registries(regs)]
    assert mine == [x.to_dict() for x in jhealth.evaluate_registries(regs)]
    assert [x["rule"] for x in mine] == ["node_decode_errors",
                                         "node_probe_failure_rate"]
    assert health.evaluate_registries([registry(probes=5)]) == []


def test_flight_recorder_round_trip(tmp_path):
    rec = FlightRecorder(capacity=4)
    for t in range(6):          # overflows: keeps the last 4
        rec.record(t, {"waves_delivered": 10 * t, "probes_failed": 1})
    assert len(rec) == 4
    path = rec.dump(str(tmp_path / "f.jsonl"), reason="anomaly")
    header, frames = FlightRecorder.load(path)
    assert header["kind"] == "swim_tpu_flight_recorder"
    assert header["reason"] == "anomaly"
    assert header["fields"] == list(EngineFrame._fields)
    assert list(frames.period) == [2, 3, 4, 5]
    d = metrics.series_digest(frames)
    assert d["waves_delivered_peak"] == d["waves_delivered_final"] == 50
    assert d["probes_failed_sum"] == 4
    # stacked tensors, with an aux series, record as one row a period
    stacked = EngineFrame(*(torch.arange(3, dtype=torch.int32) + i
                            for i in range(8)))
    rec = FlightRecorder(cfg=SwimConfig(n_nodes=64), capacity=8)
    rec.record_stacked(stacked, start_period=5,
                       aux={"false_dead_views": np.array([0, 0, 1])})
    header, frames = FlightRecorder.load(rec.dump(str(tmp_path / "s.jsonl")))
    assert header["cfg"]["n_nodes"] == 64
    assert header["fields"][-1] == "false_dead_views"
    assert list(frames.period) == [5, 6, 7]
    assert list(frames.probes_failed) == [5, 6, 7]
    assert list(frames.false_dead_views) == [0, 0, 1]


def test_recorder_guards_and_health_wiring(tmp_path):
    rec = FlightRecorder(capacity=2)
    with pytest.raises(KeyError, match="waves_deliverd"):
        rec.record(0, {"waves_deliverd": 3})
    rec.record(0, {"false_dead_views": 9})
    assert len(rec) == 1 and rec.auto_dump_reason() is None
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)
    foreign = tmp_path / "x.jsonl"
    foreign.write_text('{"kind": "something_else"}\n')
    with pytest.raises(ValueError, match="flight_recorder"):
        FlightRecorder.load(str(foreign))
    with pytest.raises(ValueError, match="neither"):
        analyze.sniff(str(foreign))
    rec = FlightRecorder(cfg=SwimConfig(n_nodes=64), capacity=8,
                         monitor=health.HealthMonitor(window=4))
    rec.record(0, {"waves_delivered": 3, "false_dead_views": 0})
    assert rec.auto_dump_reason() is None
    rec.record(1, {"waves_delivered": 0, "false_dead_views": 2})
    assert rec.auto_dump_reason() == "health:false_dead_views"
    header, frames = FlightRecorder.load(rec.dump(
        str(tmp_path / "f.jsonl"), reason=rec.auto_dump_reason()))
    assert header["reason"] == "health:false_dead_views"
    assert header["health"]["findings"][0]["severity"] == "error"
    assert list(frames.false_dead_views) == [0, 2]


# name -> detection_study keywords (both packages); flight_record is
# filled with a path for "ring", left out for "rumor" (automatic dump)
STUDIES = {
    "ring": dict(n=128, periods=16, engine="ring", suspicion_mult=1.0,
                 k_indirect=1, max_piggyback=2, ring_window_periods=2,
                 ring_view_c=2),
    "rumor": dict(n=64, periods=12, engine="rumor", crash_fraction=0.3,
                  rumor_capacity=8),
}


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_detection_study_dump_matches_the_reference(name, tmp_path,
                                                    monkeypatch):
    kw = dict(STUDIES[name], telemetry=True)
    mine, ref = tmp_path / "port", tmp_path / "ref"
    mine.mkdir()
    ref.mkdir()
    if name == "ring":
        got = experiments.detection_study(
            device="cpu", flight_record=str(mine / "fr.jsonl"), **kw)
        want = jexperiments.detection_study(
            flight_record=str(ref / "fr.jsonl"), **kw)
        assert got.pop("flight_record") == str(mine / "fr.jsonl")
        assert want.pop("flight_record") == str(ref / "fr.jsonl")
    else:
        monkeypatch.chdir(mine)
        got = experiments.detection_study(device="cpu", **kw)
        monkeypatch.chdir(ref)
        want = jexperiments.detection_study(**kw)
        assert got["flight_record"] == want["flight_record"] \
            == "flight_record.jsonl"
        (mine / got["flight_record"]).rename(mine / "fr.jsonl")
        (ref / want["flight_record"]).rename(ref / "fr.jsonl")
    assert got == want
    assert (mine / "fr.jsonl").read_bytes() == (ref / "fr.jsonl").read_bytes()
    path = str(mine / "fr.jsonl")
    report = analyze.analyze(path)
    want_report = janalyze.analyze(path)
    assert report == want_report
    assert analyze.error_findings(report) == \
        janalyze.error_findings(want_report)
    assert analyze.render_report(report, title=name) == \
        janalyze.render_report(want_report, title=name)
    assert analyze.analyze_paths([path]) == report
    # the dump alone reproduces the study's detection summary
    det = report["detection"]
    assert det["crashed"] == got["crashed"] > 0
    assert all(val == got[key] for key, val in det.items())
    assert report["health"]["worst"] == got["health"]["worst"]
    assert got["telemetry"]["waves_delivered_sum"] > 0
    if name == "rumor":
        assert analyze.error_findings(report)
        assert FlightRecorder.load(path)[0]["reason"].startswith("health:")


def test_spans_and_serve_summaries(tmp_path):
    rows = [{"kind": "probe", "start": 0.0, "end": 0.5, "outcome": "ack",
             "events": [[0.1, "ping-req"]]},
            {"kind": "probe", "start": 1.0, "end": None, "outcome": "fail",
             "events": []},
            {"kind": "suspicion", "start": 1.0, "end": 3.0,
             "outcome": "refuted", "events": []}]
    assert analyze.analyze_spans(rows) == janalyze.analyze_spans(rows)
    path = tmp_path / "spans.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    report = analyze.analyze(str(path))
    assert report == janalyze.analyze(str(path))
    assert report["probes"]["indirect_rescues"] == 1
    assert analyze.render_report(report) == janalyze.render_report(report)
    with pytest.raises(NotImplementedError, match="ROADMAP.*serving"):
        analyze.summarize_serve([], [])

"""Analyzers over telemetry artifacts (port of `swim_tpu/obs/analyze.py`):
json and numpy only.

  * detection: `summarize_detection` (what sim/runner.py
    `detection_summary` delegates to), `latency_cdf` and `detection_law`
    (with uniform probing, first detection is geometric with mean
    e/(e-1) periods at large N);
  * flight-recorder dumps (obs/recorder.py): dissemination progress
    from `waves_delivered`, piggyback-budget pressure from the selection
    statistics against B, the probe-failure series, the health rules
    replayed over the rows, and the detection summary recomputed from
    the milestones the dump header embeds (`analyze_frames`);
  * trace-span JSONL: probe outcomes, RTT percentiles, suspicion
    refute rates (`analyze_spans`);
  * `analyze` / `analyze_paths` dispatch on a file's shape,
    `error_findings` collects error-severity findings and
    `render_report` draws a report for a terminal;
  * serve: `summarize_serve` decomposes the load harness's echo-RTT
    tail into the serving hub's period phases (obs/servetrace.py).
"""
from __future__ import annotations

import json
import math
from typing import Any, Iterable, Mapping

import numpy as np

from swim_tpu_torch.obs import health as health_mod

NEVER = 2**31 - 1                     # sim/runner.py's not-yet sentinel
E_OVER_E_MINUS_1 = math.e / (math.e - 1)
RECORDER_KIND = "swim_tpu_flight_recorder"
SPAN_KINDS = ("probe", "suspicion", "serve")

# the serving layer's period phases, in order (rendered by
# render_report for a serve report)
SERVE_PHASES = ("evict_scan", "inject_coalesce", "engine_step",
                "s_off_get", "mirror_fanout")
SERVE_COVERAGE_CONTRACT_PCT = 90.0


def summarize_detection(crash_step: np.ndarray,
                        milestones: Mapping[str, np.ndarray],
                        false_dead_final: int | None = None) -> dict:
    """Latency distribution per milestone for crashed subjects:
    `crash_step[i]` is subject i's crash period, each milestones array
    the period the milestone fired (NEVER = not yet)."""
    crash = np.asarray(crash_step, np.int64)
    out: dict[str, Any] = {"crashed": int(crash.size)}
    if not crash.size:
        return out
    for name, arr in milestones.items():
        arr = np.asarray(arr, np.int64)
        lat = arr - crash
        ok = arr != NEVER
        out[f"{name}_detected"] = int(ok.sum())
        if ok.any():
            lat_ok = lat[ok] + 1  # period t event => latency in (0, t+1]
            out[f"{name}_latency_mean"] = float(lat_ok.mean())
            out[f"{name}_latency_p50"] = float(np.percentile(lat_ok, 50))
            out[f"{name}_latency_p99"] = float(np.percentile(lat_ok, 99))
    if false_dead_final is not None:
        out["false_dead_views_final"] = int(false_dead_final)
    return out


def latency_cdf(crash_step, first_detect, max_points: int = 32) -> list:
    """Detection-latency CDF as `[latency, fraction_detected]` steps
    over crashed subjects (undetected subjects never reach 1.0)."""
    crash = np.asarray(crash_step, np.int64)
    arr = np.asarray(first_detect, np.int64)
    if not crash.size:
        return []
    ok = arr != NEVER
    lat = np.sort(arr[ok] + 1 - crash[ok])
    vals, counts = np.unique(lat, return_counts=True)
    frac = np.cumsum(counts) / crash.size
    pts = [[int(v), round(float(f), 4)] for v, f in zip(vals, frac)]
    if len(pts) > max_points:     # keep ends + even interior subsample
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = [pts[i] for i in idx]
    return pts


def detection_law(crash_step, first_suspect, n_nodes: int | None,
                  probe: str | None = None) -> dict:
    """Mean first-detection latency against the geometric law: a
    crashed member escapes every live prober with probability
    (1 - 1/(N-1))^(N-1), so first detection is Geometric(p) with mean
    1/p, about e/(e-1) periods.  `law_applies` is False for the rotor
    probe (deterministic bounded detection); the ratio is still
    reported."""
    crash = np.asarray(crash_step, np.int64)
    arr = np.asarray(first_suspect, np.int64)
    ok = arr != NEVER
    out: dict[str, Any] = {
        "e_over_e_minus_1": E_OVER_E_MINUS_1,
        "law_applies": probe in (None, "pull"),
        "samples": int(ok.sum()),
    }
    if probe is not None:
        out["probe"] = probe
    if n_nodes and n_nodes > 2:
        p = 1.0 - (1.0 - 1.0 / (n_nodes - 1)) ** (n_nodes - 1)
        out["expected_mean"] = 1.0 / p
    else:
        out["expected_mean"] = E_OVER_E_MINUS_1
    if ok.any():
        mean = float((arr[ok] + 1 - crash[ok]).mean())
        out["latency_mean"] = mean
        out["mean_vs_law"] = mean / out["expected_mean"]
    return out


# ----------------------------------------------------- frame-dump analyzers

class DisseminationAnalyzer:
    """Infection-curve progress from `waves_delivered`."""

    def __init__(self):
        self.deliveries: list[int] = []

    def feed(self, row: Mapping[str, Any]) -> None:
        self.deliveries.append(int(row.get("waves_delivered", 0)))

    def summary(self) -> dict:
        d = np.asarray(self.deliveries, np.int64)
        out = {"periods": int(d.size), "delivered_total": int(d.sum())}
        if d.size and d.sum():
            cum = np.cumsum(d)
            frac = cum / cum[-1]
            out["delivered_mean"] = float(d.mean())
            out["delivered_peak"] = int(d.max())
            out["peak_period"] = int(d.argmax())
            for q in (0.5, 0.9):
                out[f"periods_to_{int(q * 100)}pct"] = int(
                    np.argmax(frac >= q))
            # a healthy infection curve front-loads: its last quarter
            # should carry little of the total traffic
            tail = d[3 * d.size // 4:]
            out["tail_quarter_share"] = round(
                float(tail.sum() / d.sum()), 4)
        return out


class PiggybackAnalyzer:
    """Budget-pressure trend from the selection statistics vs B."""

    def __init__(self, budget: int | None = None):
        self.budget = budget
        self.saturated: list[int] = []
        self.slots_max: list[int] = []
        self.selected: list[int] = []

    def feed(self, row: Mapping[str, Any]) -> None:
        self.saturated.append(int(row.get("sel_rows_saturated", 0)))
        self.slots_max.append(int(row.get("sel_slots_max", 0)))
        self.selected.append(int(row.get("sel_slots_selected", 0)))

    @staticmethod
    def _trend(arr: np.ndarray) -> str:
        if arr.size < 4:
            return "flat"
        half = arr.size // 2
        a, b = float(arr[:half].mean()), float(arr[half:].mean())
        ref = max(abs(a), 1.0)
        if b - a > 0.25 * ref:
            return "rising"
        if a - b > 0.25 * ref:
            return "falling"
        return "flat"

    def summary(self) -> dict:
        sat = np.asarray(self.saturated, np.int64)
        smax = np.asarray(self.slots_max, np.int64)
        sel = np.asarray(self.selected, np.int64)
        out: dict[str, Any] = {
            "saturated_peak": int(sat.max()) if sat.size else 0,
            "saturated_mean": float(sat.mean()) if sat.size else 0.0,
            "saturation_trend": self._trend(sat),
            "slots_max_peak": int(smax.max()) if smax.size else 0,
            "slots_selected_total": int(sel.sum()),
        }
        if self.budget:
            out["budget"] = int(self.budget)
            out["headroom_slots"] = int(self.budget) - out["slots_max_peak"]
        return out


class ProbeFrameAnalyzer:
    """Probe-failure series from the engine tap."""

    def __init__(self):
        self.failed: list[int] = []

    def feed(self, row: Mapping[str, Any]) -> None:
        self.failed.append(int(row.get("probes_failed", 0)))

    def summary(self) -> dict:
        f = np.asarray(self.failed, np.int64)
        return {
            "failed_total": int(f.sum()),
            "failed_peak": int(f.max()) if f.size else 0,
            "failing_periods": int((f > 0).sum()),
            "first_failure_period": (int(np.argmax(f > 0))
                                     if (f > 0).any() else None),
        }


# ------------------------------------------------------------ span analyzer

def analyze_spans(rows: Iterable[Mapping[str, Any]]) -> dict:
    """Per-probe outcome breakdown + suspicion analytics from trace
    spans (obs/trace.py JSONL schema)."""
    probe_outcomes: dict[str, int] = {}
    events: dict[str, int] = {}
    rtts: list[float] = []
    susp_outcomes: dict[str, int] = {}
    susp_durations: list[float] = []
    serve_outcomes: dict[str, int] = {}
    serve_queue_waits: list[float] = []
    serve_flush_delays: list[float] = []
    serve_echo_durs: list[float] = []
    indirect_rescues = 0
    n = 0
    for r in rows:
        n += 1
        dur = (r["end"] - r["start"]
               if r.get("end") is not None else None)
        for _, name in r.get("events", ()):
            events[name] = events.get(name, 0) + 1
        if r.get("kind") == "serve":
            out = r.get("outcome") or "open"
            serve_outcomes[out] = serve_outcomes.get(out, 0) + 1
            marks = {name: t for t, name in r.get("events", ())}
            if "queued" in marks and "handled" in marks:
                serve_queue_waits.append(marks["handled"]
                                         - marks["queued"])
            if "queued" in marks and "flush" in marks:
                serve_flush_delays.append(marks["flush"]
                                          - marks["queued"])
            if out == "echo_reply" and dur is not None:
                serve_echo_durs.append(float(dur))
            continue
        if r.get("kind") == "probe":
            out = r.get("outcome") or "open"
            probe_outcomes[out] = probe_outcomes.get(out, 0) + 1
            if out == "ack" and dur is not None:
                rtts.append(float(dur))
            if out == "ack" and any(name == "ping-req"
                                    for _, name in r.get("events", ())):
                indirect_rescues += 1
        elif r.get("kind") == "suspicion":
            out = r.get("outcome") or "open"
            susp_outcomes[out] = susp_outcomes.get(out, 0) + 1
            if dur is not None:
                susp_durations.append(float(dur))
    report: dict[str, Any] = {"spans": n}
    probes = sum(probe_outcomes.values())
    if probes:
        report["probes"] = {
            "total": probes,
            "outcomes": dict(sorted(probe_outcomes.items())),
            "failure_rate": round(
                probe_outcomes.get("fail", 0) / probes, 4),
            "indirect_rescues": indirect_rescues,
            "events": dict(sorted(events.items())),
        }
        if rtts:
            arr = np.asarray(rtts)
            report["probes"]["rtt_mean_s"] = float(arr.mean())
            report["probes"]["rtt_p99_s"] = float(np.percentile(arr, 99))
    susps = sum(susp_outcomes.values())
    if susps:
        refuted = susp_outcomes.get("refuted", 0)
        report["suspicions"] = {
            "total": susps,
            "outcomes": dict(sorted(susp_outcomes.items())),
            # every refuted suspicion was a false positive caught in
            # time — the paper's suspicion-mechanism claim, measured
            "false_positive_rate": round(refuted / susps, 4),
        }
        if susp_durations:
            arr = np.asarray(susp_durations)
            report["suspicions"]["duration_mean_s"] = float(arr.mean())
    serves = sum(serve_outcomes.values())
    if serves:
        serve: dict[str, Any] = {
            "total": serves,
            "outcomes": dict(sorted(serve_outcomes.items())),
        }
        # stage separations — the span schema's whole point: queue wait
        # (bounded work queue) and coalesce-batching delay (gossip
        # waiting for its ExtOriginations flush period) vs device time
        for key, vals in (("queue_wait", serve_queue_waits),
                          ("flush_delay", serve_flush_delays),
                          ("echo", serve_echo_durs)):
            if vals:
                arr = np.asarray(vals) * 1e3
                serve[f"{key}_mean_ms"] = round(float(arr.mean()), 4)
                serve[f"{key}_p99_ms"] = round(
                    float(np.percentile(arr, 99)), 4)
        report["serve"] = serve
    return report


# --------------------------------------------------------- serve attribution

def summarize_serve(frames: Iterable[Mapping[str, Any]],
                    echo_windows: Iterable[Iterable[float]],
                    phase_summary: Mapping[str, Any] | None = None,
                    contract_pct: float = SERVE_COVERAGE_CONTRACT_PCT,
                    ) -> dict:
    """Decompose the measured echo-RTT tail into serve-path phases.

    `frames` are obs/servetrace.py period frames — absolute
    `[name, t_begin, t_end]` phase intervals on the shared monotonic
    clock.  `echo_windows` are the load harness's CLIENT-side
    `[t_send, t_recv]` stamps per echo sample, same clock (loopback,
    one host).  A tail echo is slow because the frontend drain sat
    behind whatever the engine thread was doing, so the overlap of its
    wall window with the phase intervals IS the attribution — measured,
    not modeled.  The p99 tail (samples at/above the p99 RTT) must be
    >=`contract_pct` covered by named phases or the report says
    `attributed: false` and the residual stays `unattributed` —
    never silently re-binned.
    """
    frames = list(frames)
    windows = [(float(w[0]), float(w[1])) for w in echo_windows]
    rtts_ms = np.asarray([(e - b) * 1e3 for b, e in windows], np.float64)
    report: dict[str, Any] = {
        "kind": "serve_trace",
        "periods": len(frames),
        "phase_names": list(SERVE_PHASES),
        "contract_pct": float(contract_pct),
    }
    if phase_summary is not None:
        report["phases"] = dict(phase_summary.get("phases") or {})
        report["period_ms"] = dict(phase_summary.get("period_ms") or {})
    if not len(rtts_ms) or not frames:
        report.update({"echo": {"samples": int(len(rtts_ms))},
                       "coverage_pct": 0.0, "attributed": False,
                       "reason": "no echo windows or no traced frames"})
        return report
    p50, p99, p999 = (float(np.percentile(rtts_ms, q))
                      for q in (50.0, 99.0, 99.9))
    report["echo"] = {"samples": int(len(rtts_ms)),
                      "p50_ms": round(p50, 3), "p99_ms": round(p99, 3),
                      "p999_ms": round(p999, 3)}
    tail = [(b, e) for (b, e) in windows if (e - b) * 1e3 >= p99]
    intervals = [(name, float(pb), float(pe))
                 for f in frames for name, pb, pe in f.get("phases", ())]
    per_phase = {name: 0.0 for name in SERVE_PHASES}
    tail_wall = 0.0
    for b, e in tail:
        tail_wall += e - b
        for name, pb, pe in intervals:
            ov = min(e, pe) - max(b, pb)
            if ov > 0.0:
                per_phase[name] = per_phase.get(name, 0.0) + ov
    n_tail = len(tail)
    mean_tail_ms = tail_wall / n_tail * 1e3
    decomp = {name: round(per_phase[name] / n_tail * 1e3, 4)
              for name in per_phase}
    attributed_ms = sum(decomp.values())
    decomp["unattributed"] = round(
        max(0.0, mean_tail_ms - attributed_ms), 4)
    coverage = (100.0 * attributed_ms / mean_tail_ms
                if mean_tail_ms > 0 else 0.0)
    report.update({
        "tail": {"spans": n_tail, "threshold_ms": round(p99, 3),
                 "mean_ms": round(mean_tail_ms, 3)},
        "p99_attribution_ms": decomp,
        "unattributed_ms": decomp["unattributed"],
        "coverage_pct": round(min(coverage, 100.0), 2),
        "attributed": coverage >= contract_pct,
    })
    return report


# ------------------------------------------------------------- entry points

def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def sniff(path: str) -> str:
    """`"recorder"` | `"spans"` by the first JSONL line's shape."""
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            first = json.loads(line)
            if first.get("kind") == RECORDER_KIND:
                return "recorder"
            if first.get("kind") in SPAN_KINDS:
                return "spans"
            break
    raise ValueError(f"{path}: neither a flight-recorder dump nor a "
                     "trace-span JSONL")


def analyze_frames(header: Mapping[str, Any],
                   rows: Iterable[Mapping[str, Any]],
                   window: int = 16) -> dict:
    """Analyzer pass over recorder rows: paper metrics + replayed
    health findings.  `header` is the dump's self-describing first
    line (config snapshot, optional embedded study section)."""
    cfg = header.get("cfg") or {}
    n = cfg.get("n_nodes")
    monitor = health_mod.HealthMonitor(window=window, n_nodes=n)
    dis = DisseminationAnalyzer()
    pig = PiggybackAnalyzer(budget=cfg.get("max_piggyback"))
    prb = ProbeFrameAnalyzer()
    periods = 0
    for row in rows:
        periods += 1
        for a in (dis, pig, prb):
            a.feed(row)
        monitor.observe(int(row.get("period", periods - 1)), row)
    report: dict[str, Any] = {
        "kind": "flight_recorder",
        "reason": header.get("reason"),
        "periods": periods,
        "dissemination": dis.summary(),
        "piggyback": pig.summary(),
        "probes": prb.summary(),
        "health": monitor.summary(),
    }
    if n:
        report["n_nodes"] = n
    study = header.get("study")
    if study:
        crash = np.asarray(study["crash_step"], np.int64)
        # milestone key names match runner.detection_summary's output
        # keys (suspect_latency_mean, ...) — byte-identical summaries
        milestones = {name: np.asarray(study[src], np.int64)
                      for name, src in (("suspect", "first_suspect"),
                                        ("dead_view", "first_dead_view"),
                                        ("disseminated", "disseminated"))
                      if src in study}
        report["detection"] = summarize_detection(
            crash, milestones, study.get("false_dead_views_final"))
        if "suspect" in milestones:
            report["detection_law"] = detection_law(
                crash, milestones["suspect"], study.get("n", n),
                study.get("probe", cfg.get("ring_probe")))
            report["detection_cdf"] = latency_cdf(
                crash, milestones["suspect"])
    return report


def analyze(path: str, window: int = 16) -> dict:
    """Dispatch on file shape; returns one typed report dict."""
    kind = sniff(path)
    rows = read_jsonl(path)
    if kind == "recorder":
        return analyze_frames(rows[0], rows[1:], window=window)
    report = analyze_spans(rows)
    report["kind"] = "trace_spans"
    return report


def analyze_paths(paths: Iterable[str], window: int = 16) -> dict:
    """Merge reports for a dump + spans pair (or any mix): recorder
    reports land under `"engine"`, span reports under `"nodes"`."""
    merged: dict[str, Any] = {}
    for path in paths:
        report = analyze(path, window=window)
        key = ("engine" if report["kind"] == "flight_recorder"
               else "nodes")
        merged.setdefault(key, {})[path] = report
    # single-file calls stay flat for convenience
    flat: dict[str, Any] = {}
    for group in merged.values():
        if len(group) == 1 and len(merged) == 1:
            return next(iter(group.values()))
    return merged


def error_findings(report: Mapping[str, Any]) -> list[dict]:
    """Every error-severity finding in a (possibly merged) report —
    what a check of an artifact gates on."""
    out: list[dict] = []

    def walk(node):
        if isinstance(node, Mapping):
            for f in (node.get("health") or {}).get("findings", ()):
                if f.get("severity") == "error":
                    out.append(f)
            for k, v in node.items():
                if k != "health":
                    walk(v)

    walk(report)
    return out


# ---------------------------------------------------------------- rendering

def _fmt_val(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_report(report: Mapping[str, Any], title: str = "") -> str:
    """Human-readable terminal view of an analyzer report."""
    lines: list[str] = []
    if title:
        lines.append(f"== {title} ==")

    def section(name, d, indent="  "):
        if not d:
            return
        lines.append(f"{name}:")
        for k, v in d.items():
            if isinstance(v, Mapping):
                lines.append(f"{indent}{k}: " + ", ".join(
                    f"{kk}={_fmt_val(vv)}" for kk, vv in v.items()))
            elif isinstance(v, list):
                lines.append(f"{indent}{k}: {v}")
            else:
                lines.append(f"{indent}{k}: {_fmt_val(v)}")

    if report.get("kind") == "flight_recorder":
        head = f"flight recorder · {report.get('periods', 0)} periods"
        if report.get("n_nodes"):
            head += f" · n={report['n_nodes']}"
        if report.get("reason"):
            head += f" · reason={report['reason']}"
        lines.append(head)
        for key in ("detection", "detection_law", "dissemination",
                    "piggyback", "probes"):
            section(key, report.get(key))
        if report.get("detection_cdf"):
            pts = report["detection_cdf"]
            lines.append("detection_cdf (latency→frac): " + " ".join(
                f"{p[0]}:{p[1]:.2f}" for p in pts[:12]))
        health = report.get("health") or {}
        lines.append(f"health: {health.get('worst', 'ok')}")
        for f in health.get("findings", ()):
            lines.append(f"  [{f['severity']}] {f['rule']}: "
                         f"{f['message']}")
    elif report.get("kind") == "trace_spans":
        lines.append(f"trace spans · {report.get('spans', 0)} spans")
        section("probes", report.get("probes"))
        section("suspicions", report.get("suspicions"))
        section("serve", report.get("serve"))
    elif report.get("kind") == "serve_trace":
        # two shapes share the kind: summarize_serve's flat report and
        # serve/load.run_trace's payload, which nests it under
        # "attribution" — render from whichever level carries it
        att = report.get("attribution") or report
        head = (f"serve trace · {report.get('periods', 0)} periods · "
                f"{(att.get('echo') or {}).get('samples', 0)} echo "
                f"samples")
        lines.append(head)
        section("echo", att.get("echo"))
        section("tail", att.get("tail"))
        decomp = att.get("p99_attribution_ms") or {}
        if decomp:
            lines.append("p99 attribution (ms):")
            for name, ms in decomp.items():
                lines.append(f"  {name}: {_fmt_val(ms)}")
        section("period_ms", att.get("period_ms"))
        for key in ("coverage_pct", "contract_pct"):
            if key in att:
                lines.append(f"{key}: {_fmt_val(att[key])}")
        ok = att.get("attributed")
        lines.append("attribution: "
                     + ("ok (>= contract)" if ok else "UNATTRIBUTED"))
        if att.get("reason"):
            lines.append(f"  reason: {att['reason']}")
    else:   # merged multi-file report
        for group, sub in report.items():
            for path, rep in sub.items():
                lines.append(render_report(rep, title=f"{group}: {path}"))
    return "\n".join(lines)

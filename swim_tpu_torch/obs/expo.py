"""Prometheus text exposition (format 0.0.4) for node registries (port
of `swim_tpu/obs/expo.py`; its output is the reference's, byte for byte,
for the same inputs, but for `render_memwall`'s help texts).

`render_prometheus` takes `(labels, registry)` pairs — the bridge server
passes one pair per in-process node with `{"node": "<id>"}` — and
renders every declared counter and histogram with HELP/TYPE metadata.
Counters follow the `_total` suffix convention; histograms emit
cumulative `_bucket{le=...}` series plus `_sum`/`_count`.  Every render
also emits one `swim_build_info` gauge (version + optional config
labels) so scrapes are self-describing about what produced them.

`render_health` renders obs/health.py findings as `swim_health_<rule>`
gauges (1 = firing, 0 = quiet, every declared rule always present so
the series never churn) plus an overall `swim_health_status` gauge
(0 ok / 1 warn / 2 error) — appended to `/metrics` by the bridge
server.  Label values are escaped per the text-format spec (backslash,
double-quote, newline).

`render_audit` renders an analysis/audit.py report as swim_audit_*
gauges; a total the audit could not measure (null in the report, such
as `undonated_bytes`: eager PyTorch has no alias table) renders as the
text format's `NaN`, never as 0.
"""

from __future__ import annotations

from typing import Iterable

from swim_tpu_torch import __version__
from swim_tpu_torch.obs.health import HEALTH_RULES, Finding, severity_rank
from swim_tpu_torch.obs.registry import MetricsRegistry

NAMESPACE = "swim"


def _escape(value: object) -> str:
    """Label-value escaping per text format 0.0.4: backslash first,
    then double-quote and newline (raw interpolation previously
    produced unparseable exposition for values containing any)."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (not quotes)."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(labels: dict[str, str], extra: dict[str, str]
                | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in merged.items())
    return "{" + inner + "}"


def _fmt_float(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def render_build_info(build_labels: dict[str, str] | None = None,
                      namespace: str = NAMESPACE) -> list[str]:
    labels = {"version": __version__, **(build_labels or {})}
    full = f"{namespace}_build_info"
    return [f"# HELP {full} swim-tpu build/config info (value is "
            "always 1; the labels carry the information)",
            f"# TYPE {full} gauge",
            f"{full}{_fmt_labels(labels)} 1"]


def render_prometheus(registries: Iterable[tuple[dict[str, str],
                                                 MetricsRegistry]],
                      namespace: str = NAMESPACE,
                      build_labels: dict[str, str] | None = None) -> str:
    pairs = list(registries)
    lines: list[str] = render_build_info(build_labels, namespace)

    counter_names: list[str] = []
    hist_names: list[str] = []
    for _, reg in pairs:
        for name in reg.counters:
            if name not in counter_names:
                counter_names.append(name)
        for name in reg.histograms:
            if name not in hist_names:
                hist_names.append(name)

    for name in counter_names:
        full = f"{namespace}_{name}_total"
        helped = False
        for labels, reg in pairs:
            c = reg.counters.get(name)
            if c is None:
                continue
            if not helped:
                lines.append(f"# HELP {full} {_escape_help(c.help)}")
                lines.append(f"# TYPE {full} counter")
                helped = True
            lines.append(f"{full}{_fmt_labels(labels)} {c.value}")

    for name in hist_names:
        full = f"{namespace}_{name}"
        helped = False
        for labels, reg in pairs:
            h = reg.histograms.get(name)
            if h is None:
                continue
            if not helped:
                lines.append(f"# HELP {full} {_escape_help(h.help)}")
                lines.append(f"# TYPE {full} histogram")
                helped = True
            cum = h.cumulative()
            for ub, count in zip(h.buckets, cum):
                lines.append(f"{full}_bucket"
                             f"{_fmt_labels(labels, {'le': _fmt_float(ub)})}"
                             f" {count}")
            lines.append(f"{full}_bucket"
                         f"{_fmt_labels(labels, {'le': '+Inf'})} {cum[-1]}")
            lines.append(f"{full}_sum{_fmt_labels(labels)} "
                         f"{_fmt_float(h.sum)}")
            lines.append(f"{full}_count{_fmt_labels(labels)} {h.count}")

    return "\n".join(lines) + "\n"


def render_health(findings: Iterable[Finding],
                  labels: dict[str, str] | None = None,
                  namespace: str = NAMESPACE) -> str:
    """Current health as gauges.  EVERY rule in HEALTH_RULES renders
    (0 when quiet) so the series set is stable across scrapes; firing
    rules render 1.  `swim_health_status` carries the worst firing
    severity as a number (0 ok / 1 warn / 2 error)."""
    labels = labels or {}
    firing = {f.rule: f for f in findings}
    lines: list[str] = []
    for rule, (severity, help_text) in HEALTH_RULES.items():
        full = f"{namespace}_health_{rule}"
        lines.append(f"# HELP {full} {_escape_help(help_text)} "
                     f"(max severity: {severity})")
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full}{_fmt_labels(labels)} "
                     f"{1 if rule in firing else 0}")
    status = max((severity_rank(f.severity) for f in firing.values()),
                 default=0)
    full = f"{namespace}_health_status"
    lines.append(f"# HELP {full} Worst currently-firing health rule "
                 "severity (0 ok / 1 warn / 2 error)")
    lines.append(f"# TYPE {full} gauge")
    lines.append(f"{full}{_fmt_labels(labels)} {status}")
    return "\n".join(lines) + "\n"


def render_profile(report: dict,
                   labels: dict[str, str] | None = None) -> str:
    """The latest obs/prof.py phase-attribution report as swim_prof_*
    gauges (names pinned in prof.PROF_GAUGES).  Per-phase series
    carry a `phase` label; modeled HBM bytes carry `bracket`
    (fused/unfused roofline model).  Reports are point-in-time
    artifacts, so every series also carries the capture's nodes and
    platform as labels: a 65k CPU profile and a 1M card profile never
    alias.  The help texts are the reference's (`xla_bytes` is null in
    the port's reports, so that gauge has no series)."""
    from swim_tpu_torch.obs.prof import PROF_GAUGES

    base = {**(labels or {}),
            "nodes": str(report.get("nodes", "?")),
            "platform": str(report.get("platform_actual", "?"))}
    help_txt = {
        "swim_prof_phase_ms": "Measured per-phase step time "
        "(prefix-differenced, device-synced), ms",
        "swim_prof_phase_fraction": "Phase share of the measured step "
        "wall time",
        "swim_prof_phase_model_bytes": "Modeled HBM bytes per phase "
        "(utils/roofline.py terms; bracket=fused/unfused)",
        "swim_prof_phase_xla_bytes": "Achieved bytes per phase (XLA "
        "cost-analysis prefix delta)",
        "swim_prof_phase_ici_bytes": "Modeled per-chip ICI bytes per "
        "phase (obs/ici.py collective tally)",
        "swim_prof_step_ms": "Measured full step time, ms",
        "swim_prof_coverage_pct": "Phase attribution coverage of the "
        "measured step wall time, percent",
    }
    lines: list[str] = []

    def _head(full: str) -> None:
        lines.append(f"# HELP {full} {_escape_help(help_txt[full])}")
        lines.append(f"# TYPE {full} gauge")

    rows = report.get("phases", [])
    for name, field in (("swim_prof_phase_ms", "ms"),
                        ("swim_prof_phase_fraction", "fraction")):
        _head(name)
        for row in rows:
            lines.append(f"{name}"
                         f"{_fmt_labels(base, {'phase': row['phase']})} "
                         f"{_fmt_float(row[field])}")
    _head("swim_prof_phase_model_bytes")
    for row in rows:
        for bracket in ("fused", "unfused"):
            extra = {"phase": row["phase"], "bracket": bracket}
            lines.append(
                "swim_prof_phase_model_bytes"
                f"{_fmt_labels(base, extra)}"
                f" {row[f'hbm_model_{bracket}_bytes']}")
    _head("swim_prof_phase_xla_bytes")
    for row in rows:
        if row.get("xla_bytes") is not None:
            lines.append(
                "swim_prof_phase_xla_bytes"
                f"{_fmt_labels(base, {'phase': row['phase']})} "
                f"{row['xla_bytes']}")
    _head("swim_prof_phase_ici_bytes")
    for row in rows:
        lines.append(
            "swim_prof_phase_ici_bytes"
            f"{_fmt_labels(base, {'phase': row['phase']})} "
            f"{row['ici_model_bytes']}")
    _head("swim_prof_step_ms")
    lines.append(f"swim_prof_step_ms{_fmt_labels(base)} "
                 f"{_fmt_float(report.get('step_ms', 0.0))}")
    _head("swim_prof_coverage_pct")
    lines.append(f"swim_prof_coverage_pct{_fmt_labels(base)} "
                 f"{_fmt_float(report.get('coverage_pct', 0.0))}")
    assert set(help_txt) == set(PROF_GAUGES)
    return "\n".join(lines) + "\n"


def render_memwall(report: dict,
                   labels: dict[str, str] | None = None) -> str:
    """One obs/memwall.py memory report as swim_mem_* gauges (names
    pinned in memwall.MEM_GAUGES).  Like profile reports these are
    point-in-time artifacts, so every series carries the analyzed shape
    (nodes), platform, program variant and engine as labels."""
    from swim_tpu_torch.obs.memwall import MEM_GAUGES, gauge_values

    base = {**(labels or {}),
            "nodes": str(report.get("n", "?")),
            "platform": str(report.get("platform", "?")),
            "variant": str(report.get("variant", "?")),
            "engine": str(report.get("engine", "?"))}
    lines: list[str] = []
    values = gauge_values(report)
    for full, help_text in MEM_GAUGES.items():
        lines.append(f"# HELP {full} {_escape_help(help_text)}")
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full}{_fmt_labels(base)} "
                     f"{_fmt_float(values[full])}")
    assert set(values) == set(MEM_GAUGES)
    return "\n".join(lines) + "\n"


def render_sessions(report: dict,
                    labels: dict[str, str] | None = None) -> str:
    """One serve/hub.py session-stats report as swim_session_* gauges
    (names pinned in hub.SESSION_GAUGES).  Counters and the mirror-byte
    rate render as plain gauges; per-session clock lag renders one
    series per attached session with a `session` label (the reserved
    row id), falling back to the worst lag when the report carries no
    per-session table — either way the NAME set is exactly
    SESSION_GAUGES, so the lint and scrape stability hold."""
    from swim_tpu_torch.serve.hub import SESSION_GAUGES, gauge_values

    base = {**(labels or {}),
            "nodes": str(report.get("nodes", "?"))}
    lines: list[str] = []
    values = gauge_values(report)
    per_session = report.get("sessions") or []
    for full, help_text in SESSION_GAUGES.items():
        lines.append(f"# HELP {full} {_escape_help(help_text)}")
        lines.append(f"# TYPE {full} gauge")
        if full == "swim_session_clock_lag_periods" and per_session:
            for s in per_session:
                lines.append(
                    f"{full}"
                    f"{_fmt_labels(base, {'session': str(s.get('row', '?'))})}"
                    f" {_fmt_float(s.get('clock_lag_periods', 0))}")
        else:
            lines.append(f"{full}{_fmt_labels(base)} "
                         f"{_fmt_float(values[full])}")
    assert set(values) == set(SESSION_GAUGES)
    return "\n".join(lines) + "\n"


def render_serve_trace(summary: dict,
                       labels: dict[str, str] | None = None) -> str:
    """One obs/servetrace.py phase summary as swim_serve_* gauges
    (names pinned in servetrace.SERVE_TRACE_GAUGES).  Per-phase
    series carry a `phase` label (the five ServeHub._period phases);
    the period wall and the unattributed residual render as plain
    gauges.  Like the profile gauges these are point-in-time, so every
    series carries the traced shape (nodes) when the summary knows it."""
    from swim_tpu_torch.obs.servetrace import (SERVE_TRACE_GAUGES,
                                               gauge_values)

    base = {**(labels or {}),
            "nodes": str(summary.get("nodes", "?"))}
    lines: list[str] = []
    values = gauge_values(summary)
    phases = summary.get("phases") or {}
    per_phase_field = {"swim_serve_phase_ms": "mean_ms",
                       "swim_serve_phase_p99_ms": "p99_ms",
                       "swim_serve_phase_fraction": "fraction"}
    for full, help_text in SERVE_TRACE_GAUGES.items():
        lines.append(f"# HELP {full} {_escape_help(help_text)}")
        lines.append(f"# TYPE {full} gauge")
        field = per_phase_field.get(full)
        if field and phases:
            for name, row in phases.items():
                lines.append(
                    f"{full}{_fmt_labels(base, {'phase': str(name)})} "
                    f"{_fmt_float(row.get(field, 0.0))}")
        else:
            lines.append(f"{full}{_fmt_labels(base)} "
                         f"{_fmt_float(values[full])}")
    assert set(values) == set(SERVE_TRACE_GAUGES)
    return "\n".join(lines) + "\n"



def render_audit(report: dict,
                 labels: dict[str, str] | None = None) -> str:
    """One analysis/audit.py contract report as swim_audit_* gauges
    (names pinned in audit.AUDIT_GAUGES).  Point-in-time like the
    memwall gauges; series carry the audited shapes and the platform as
    labels so audits at different arms never alias.  A null total (not
    measured) renders `NaN`."""
    from swim_tpu_torch.analysis.audit import AUDIT_GAUGES, gauge_values

    base = {**(labels or {}),
            "wire_nodes": str(report.get("wire_n", "?")),
            "retrace_nodes": str(report.get("retrace_n", "?")),
            "platform": str(report.get("platform", "?"))}
    lines: list[str] = []
    values = gauge_values(report)
    for full, help_text in AUDIT_GAUGES.items():
        lines.append(f"# HELP {full} {_escape_help(help_text)}")
        lines.append(f"# TYPE {full} gauge")
        v = values[full]
        lines.append(f"{full}{_fmt_labels(base)} "
                     f"{'NaN' if v is None else _fmt_float(v)}")
    assert set(values) == set(AUDIT_GAUGES)
    return "\n".join(lines) + "\n"

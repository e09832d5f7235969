"""Streaming protocol-health rules over telemetry frames and registries
(port of `swim_tpu/obs/health.py`: host Python, copied so that the port
imports nothing of the JAX package).

`HealthMonitor` is a sliding-window rules engine: feed it one row per
protocol period (an `EngineFrame` dict, optionally extended with the
study runners' `false_dead_views` counter and the fault-schedule gauges
`gray_nodes` / `flap_active`) and it evaluates the rule table below
against the last `window` rows, producing severity-ranked `Finding`
records.  It only sees scalars that already crossed to the host.

  * `FlightRecorder(monitor=...)` (obs/recorder.py) feeds every recorded
    row through the monitor, embeds its findings in the dump header,
    and `auto_dump_reason()` turns any error-severity finding into a
    `"health:<rule>"` dump reason (sim/experiments.py uses this).
  * `evaluate_registries` runs the real-node rules over anything with
    `.counters[name].value` (the node registries of the host protocol
    layer, `core/`, through `obs/registry.py`).

The rules for real nodes, sessions and ExtOriginations fire only on the
rows and registries that those layers bring; the table is whole, so a
report lists every rule as the reference's does.

Rule severities in HEALTH_RULES are the MAXIMUM a rule can emit; rules
with escalation (probe_failure_burst) fire `warn` at the base threshold
and `error` only past the mass-failure threshold.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable, Mapping

SEVERITIES = ("info", "warn", "error")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# rule name -> (max severity, help text).  Names must be valid
# Prometheus metric suffixes: the exposition renders each as a
# `swim_health_<rule>` gauge (scripts/check_metrics_registry.py lints
# the derived names against this table).
HEALTH_RULES: dict[str, tuple[str, str]] = {
    "false_dead_views": (
        "error",
        "A live node is viewed DEAD — the protocol's never-event"),
    "stalled_dissemination": (
        "error",
        "Transmissible candidates pending but zero wave deliveries for "
        "a full window"),
    "overflow_growth": (
        "error",
        "Origination-budget overflow grew inside the window (membership "
        "updates were dropped)"),
    "probe_failure_burst": (
        "error",
        "Probe failures spiked vs the window baseline (error past the "
        "mass-failure threshold)"),
    "index_overflow_growth": (
        "warn",
        "View-index overflow grew inside the window (ring engines)"),
    "saturation_spike": (
        "warn",
        "Piggyback-budget saturation jumped vs the window baseline"),
    "node_probe_failure_rate": (
        "warn",
        "Aggregate real-node probe failure rate above threshold"),
    "node_decode_errors": (
        "error",
        "Real-node wire codec dropped datagrams (decode errors)"),
    "gray_undetected": (
        "warn",
        "Gray-degraded nodes present for a full window but zero probe "
        "failures — the detector is blind to the degradation"),
    "flap_false_dead": (
        "error",
        "False-dead views grew while links were flapping (healthy nodes "
        "declared dead by link churn)"),
    "session_evicted": (
        "warn",
        "A bridge/hub session was evicted (disconnect or stall): its "
        "reserved rows were crash-gated and now die organically"),
    "ext_mirror_overflow": (
        "warn",
        "Session gossip spilled past the fixed-capacity ExtOriginations "
        "batch for consecutive periods (injections run late — raise "
        "EXT_CAPACITY or shed gossip load)"),
}

# default thresholds; override per-monitor via HealthMonitor(thresholds=)
DEFAULT_THRESHOLDS = {
    "probe_burst_min": 8,        # absolute floor before a burst can fire
    "probe_burst_mult": 3.0,     # latest vs prior-window median multiplier
    "probe_burst_error_frac": 0.05,   # error past max(64, frac*n) failures
    "saturation_min": 8,         # absolute floor before a spike can fire
    "saturation_mult": 4.0,      # latest vs prior-window mean multiplier
    "node_probe_fail_rate": 0.5,  # fraction of probes failing
    "node_probe_min": 20,        # min probes before the rate rule applies
}


@dataclasses.dataclass
class Finding:
    """One fired health rule, ready for dump headers and reports."""

    rule: str
    severity: str       # "info" | "warn" | "error"
    period: int         # period the finding anchored to (-1: aggregate)
    value: float        # the measured quantity that fired the rule
    threshold: float    # the limit it crossed
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Finding":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)})


def severity_rank(severity: str) -> int:
    return _RANK[severity]


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """Severity-ranked (error first), then by magnitude."""
    return sorted(findings,
                  key=lambda f: (-_RANK[f.severity], -f.value, f.rule))


class HealthMonitor:
    """Sliding-window rules engine over per-period telemetry rows.

    `observe(period, row)` pushes one period and re-evaluates every
    frame rule on the window.  Findings accumulate (worst instance per
    rule is kept); `gauges()` reflects only what fired on the LATEST
    window — a transient spike leaves a finding but its gauge drops
    back to 0 once the window slides past it.
    """

    def __init__(self, window: int = 16, n_nodes: int | None = None,
                 thresholds: dict[str, float] | None = None):
        if window < 2:
            raise ValueError("health monitor needs window >= 2")
        self.window = window
        self.n_nodes = n_nodes
        self.thresholds = {**DEFAULT_THRESHOLDS, **(thresholds or {})}
        self._rows: collections.deque[dict] = collections.deque(
            maxlen=window)
        self._findings: dict[str, Finding] = {}
        self._active: dict[str, str] = {}   # rule -> severity, last eval

    # ------------------------------------------------------------- feeding

    def observe(self, period: int, row: Mapping[str, Any]) -> None:
        self._rows.append({k: int(v) for k, v in row.items()
                           if isinstance(v, (int, float))})
        self._evaluate(int(period))

    def check_registries(self, registries: Iterable[Any]) -> list[Finding]:
        """Evaluate the real-node rules; records and returns findings."""
        found = evaluate_registries(registries, self.thresholds)
        for rule in ("node_probe_failure_rate", "node_decode_errors"):
            self._active.pop(rule, None)
        for f in found:
            self._record(f)
            self._active[f.rule] = f.severity
        return found

    # ------------------------------------------------------------- results

    def findings(self) -> list[Finding]:
        return sort_findings(self._findings.values())

    def worst(self) -> str | None:
        fs = self.findings()
        return fs[0].severity if fs else None

    def auto_dump_reason(self) -> str | None:
        """`"health:<rule>"` for the top error-severity finding, else
        None — the FlightRecorder auto-dump contract."""
        for f in self.findings():
            if f.severity == "error":
                return f"health:{f.rule}"
        return None

    def gauges(self) -> dict[str, float]:
        """Current health as `{rule: 1.0 if firing now else 0.0}` over
        EVERY declared rule, plus `status` (0 ok / 1 warn / 2 error for
        the worst currently-firing rule) — the `swim_health_*` gauge
        set rendered by obs/expo.py:render_health."""
        out = {rule: 1.0 if rule in self._active else 0.0
               for rule in HEALTH_RULES}
        worst = max((_RANK[s] for s in self._active.values()), default=0)
        out["status"] = float(worst)
        return out

    def summary(self) -> dict:
        """JSON-able digest for study outputs and analyzer reports."""
        fs = self.findings()
        return {
            "worst": fs[0].severity if fs else "ok",
            "counts": {s: sum(1 for f in fs if f.severity == s)
                       for s in SEVERITIES if any(f.severity == s
                                                  for f in fs)},
            "findings": [f.to_dict() for f in fs],
        }

    # ------------------------------------------------------------ internals

    def _record(self, f: Finding) -> None:
        cur = self._findings.get(f.rule)
        if (cur is None or _RANK[f.severity] > _RANK[cur.severity]
                or (f.severity == cur.severity and f.value > cur.value)):
            self._findings[f.rule] = f

    def _evaluate(self, period: int) -> None:
        rows = list(self._rows)
        latest = rows[-1]
        th = self.thresholds
        fired: dict[str, Finding] = {}

        def fire(rule, severity, value, threshold, message):
            fired[rule] = Finding(rule, severity, period, float(value),
                                  float(threshold), message)

        fd = latest.get("false_dead_views", 0)
        if fd > 0:
            fire("false_dead_views", "error", fd, 0,
                 f"{fd} live node(s) viewed DEAD at period {period}")

        if len(rows) >= 2:
            for rule, field, sev in (
                    ("overflow_growth", "overflow", "error"),
                    ("index_overflow_growth", "index_overflow", "warn")):
                delta = latest.get(field, 0) - rows[0].get(field, 0)
                if delta > 0:
                    fire(rule, sev, delta, 0,
                         f"{field} grew by {delta} over the last "
                         f"{len(rows)} periods")

        full = len(rows) == self.window
        # scenario rules: the scenario runner (sim/scenario.py) injects
        # per-period `gray_nodes` / `flap_active` gauges recomputed from
        # the compiled FaultProgram, so these rules see the INTENDED
        # fault schedule next to the protocol's observed reaction.
        if full and all(r.get("gray_nodes", 0) > 0 for r in rows) \
                and sum(r.get("probes_failed", 0) for r in rows) == 0:
            fire("gray_undetected", "warn", latest.get("gray_nodes", 0),
                 0,
                 f"{latest.get('gray_nodes', 0)} gray-degraded node(s) "
                 f"for {self.window} periods with zero probe failures")

        if len(rows) >= 2 and any(r.get("flap_active", 0) > 0
                                  for r in rows):
            fd_delta = (latest.get("false_dead_views", 0)
                        - rows[0].get("false_dead_views", 0))
            if fd_delta > 0:
                fire("flap_false_dead", "error", fd_delta, 0,
                     f"false-dead views grew by {fd_delta} while links "
                     f"were flapping")

        if full and all(r.get("waves_delivered", 0) == 0 for r in rows) \
                and all(r.get("win_occupancy", 0) > 0 for r in rows):
            fire("stalled_dissemination", "error",
                 latest.get("win_occupancy", 0), 0,
                 f"{latest.get('win_occupancy', 0)} transmissible "
                 f"candidates pending but zero deliveries for "
                 f"{self.window} periods")

        prior = rows[:-1]
        if prior:
            pf = latest.get("probes_failed", 0)
            med = sorted(r.get("probes_failed", 0) for r in prior)[
                len(prior) // 2]
            limit = th["probe_burst_mult"] * max(med, 1)
            if pf >= th["probe_burst_min"] and pf > limit:
                mass = max(64.0, th["probe_burst_error_frac"]
                           * (self.n_nodes or 0))
                sev = "error" if pf >= mass else "warn"
                fire("probe_failure_burst", sev, pf, limit,
                     f"{pf} probe failures at period {period} vs "
                     f"window median {med}")

            sat = latest.get("sel_rows_saturated", 0)
            base = sum(r.get("sel_rows_saturated", 0)
                       for r in prior) / len(prior)
            limit = th["saturation_mult"] * max(base, 1.0)
            if sat >= th["saturation_min"] and sat > limit:
                fire("saturation_spike", "warn", sat, limit,
                     f"{sat} senders saturated the piggyback budget at "
                     f"period {period} vs window mean {base:.1f}")

        for rule in ("false_dead_views", "stalled_dissemination",
                     "overflow_growth", "probe_failure_burst",
                     "index_overflow_growth", "saturation_spike",
                     "gray_undetected", "flap_false_dead"):
            if rule in fired:
                self._active[rule] = fired[rule].severity
                self._record(fired[rule])
            else:
                self._active.pop(rule, None)


def evaluate_registries(registries: Iterable[Any],
                        thresholds: dict[str, float] | None = None
                        ) -> list[Finding]:
    """Real-node rules over typed MetricsRegistry instances (duck-typed:
    anything with `.counters[name].value`).  Stateless — the bridge
    server calls this per scrape."""
    th = {**DEFAULT_THRESHOLDS, **(thresholds or {})}

    def total(name):
        return sum(reg.counters[name].value for reg in regs
                   if name in reg.counters)

    regs = list(registries)
    findings: list[Finding] = []
    decode = total("decode_errors")
    if decode > 0:
        findings.append(Finding(
            "node_decode_errors", "error", -1, float(decode), 0,
            f"{decode} datagrams dropped by the wire codec"))
    probes = total("probes")
    failures = total("probe_failures")
    if probes >= th["node_probe_min"]:
        rate = failures / probes
        if rate > th["node_probe_fail_rate"]:
            findings.append(Finding(
                "node_probe_failure_rate", "warn", -1, rate,
                th["node_probe_fail_rate"],
                f"{failures}/{probes} probes failed "
                f"({rate:.0%} > {th['node_probe_fail_rate']:.0%})"))
    return sort_findings(findings)

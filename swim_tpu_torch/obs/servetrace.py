"""Serve-path tracing: phase timelines + datagram spans for the hub
(port of `swim_tpu/obs/servetrace.py`).

Gated like the node tracers (`ServeHub(trace=...)`, default off: a
`None` check on the hot path, nothing allocated when off):

  PHASE TIMELINE.  `ServeTrace.begin/lap/end` bracket one `_period()`
    call into the five named PHASES (contiguous laps, so the phases
    tile the period wall by construction).  Each period lands as one
    frame (absolute `[name, t_begin, t_end]` intervals on the shared
    monotonic clock) in a bounded ring, plus running log-bucketed
    per-phase histograms that survive ring eviction.
  DATAGRAM SPANS.  `datagram_span` mints obs/trace.py Spans of the
    `"serve"` kind (node = session row, subject = wire opcode).  The
    hub marks "queued" at work-queue put, "handled" at worker dequeue,
    "flush" at the period whose batch carries a gossip update, and
    "send" at DELIVER/ECHO reply, so work-queue wait and coalesce
    delay are separated from device time.  Finished spans collect in
    a bounded ring and optionally forward to any `TraceSink`.
  ATTRIBUTION INPUT.  `frames()` and the load harness's client-side
    echo windows (the same clock: time.monotonic at both ends of the
    loopback) are what `obs/analyze.py:summarize_serve` overlaps to
    decompose the echo-RTT tail into per-phase milliseconds.

The engine thread owns begin/lap/end; frontend and worker threads
append finished spans (atomic deque ops).  Tracing reads clocks and
appends to host buffers only, so a traced hub's engine state equals an
untraced one's bit for bit.  In the port the `engine_step` lap ends at
a CUDA synchronize (the card's work, not its dispatch), and `s_off_get`
reads the host's copy of the probe offset.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Any

from swim_tpu_torch.obs.trace import Span, TraceSink

# The five phases of ServeHub._period, in execution order.  Laps are
# contiguous (each phase ends where the next begins), so per-frame
# coverage of the period wall is total by construction; analyze.py's
# >=90% contract guards the echo-RTT attribution, not this tiling.
PHASES = (
    "evict_scan",        # stale-session scan + evict enqueue
    "inject_coalesce",   # gossip batch slice + staging + one H2D copy
    "engine_step",       # rnd draw + step (device-synced edge)
    "s_off_get",         # the period's rotor offset (host value)
    "mirror_fanout",     # per-session mirrored pings + socket sends
)

# Log-bucketed duration histogram edges, ms: 1us .. ~134s doubling.
HIST_EDGES_MS = tuple(0.001 * 2 ** k for k in range(28))

SERVE_TRACE_GAUGES: dict[str, str] = {
    "swim_serve_phase_ms":
        "Mean per-period serve-path phase time, ms (phase label; the "
        "five ServeHub._period phases)",
    "swim_serve_phase_p99_ms":
        "p99 per-period phase time, ms (phase label; histogram-edge "
        "resolution from the running log-bucketed histogram)",
    "swim_serve_phase_fraction":
        "Phase share of total attributed period time",
    "swim_serve_period_ms":
        "Mean period wall time across traced periods, ms",
    "swim_serve_unattributed_ms":
        "Mean per-period wall time not covered by the five phases, ms "
        "(should be ~0: laps are contiguous)",
}


def coerce(trace: Any) -> "ServeTrace | None":
    """`ServeHub(trace=...)` coercion: None/False off, True -> a fresh
    ServeTrace, a ServeTrace instance passes through."""
    if trace is None or trace is False:
        return None
    if trace is True:
        return ServeTrace()
    if isinstance(trace, ServeTrace):
        return trace
    raise TypeError(f"trace must be None/bool/ServeTrace, got {trace!r}")


class ServeTrace:
    """Bounded period-frame ring + running phase histograms + span ring.

    One instance per hub.  The engine thread drives begin/lap/end; any
    thread may emit finished datagram spans (`emit` is a deque append —
    atomic under the GIL — plus an optional sink forward)."""

    def __init__(self, frame_capacity: int = 1024,
                 span_capacity: int = 8192,
                 sink: TraceSink | None = None):
        if frame_capacity < 1 or span_capacity < 1:
            raise ValueError("servetrace capacities must be >= 1")
        self.sink = sink
        self._frames: collections.deque[dict] = collections.deque(
            maxlen=frame_capacity)
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=span_capacity)
        self._hist = {p: [0] * (len(HIST_EDGES_MS) + 1) for p in PHASES}
        self._sums = {p: 0.0 for p in PHASES}
        self._wall_sum = 0.0
        self._periods = 0
        self._cur: dict | None = None
        self._t_last = 0.0

    # ------------------------------------------------------------ clock

    @staticmethod
    def now() -> float:
        """The shared attribution clock.  time.monotonic, NOT
        perf_counter: the load harness stamps its client-side echo
        windows with time.monotonic, and overlap attribution needs
        both ends on one timebase."""
        return time.monotonic()

    # ---------------------------------------------------- phase timeline

    def begin(self, period: int) -> None:
        t = self.now()
        self._cur = {"period": int(period), "t0": t, "phases": []}
        self._t_last = t

    def lap(self, name: str) -> None:
        """Close the current phase at `name` (contiguous: the next lap
        starts where this one ends)."""
        t = self.now()
        self._cur["phases"].append([name, self._t_last, t])
        self._t_last = t

    def end(self) -> None:
        cur, self._cur = self._cur, None
        if cur is None:
            return
        cur["t1"] = self._t_last
        wall_ms = (cur["t1"] - cur["t0"]) * 1e3
        cur["wall_ms"] = round(wall_ms, 6)
        self._frames.append(cur)
        self._periods += 1
        self._wall_sum += wall_ms
        for name, b, e in cur["phases"]:
            dur_ms = (e - b) * 1e3
            self._sums[name] += dur_ms
            self._hist[name][bisect.bisect_right(HIST_EDGES_MS,
                                                 dur_ms)] += 1

    # ------------------------------------------------------------- spans

    def datagram_span(self, t_start: float, op: int,
                      row: int = -1) -> Span:
        """A `"serve"` span for one datagram: node = session row (-1
        pre-admission), subject = wire opcode, start = frontend receipt."""
        return Span(kind="serve", node=int(row), subject=int(op),
                    start=t_start)

    def emit(self, span: Span) -> None:
        self._spans.append(span)
        if self.sink is not None:
            self.sink.emit(span)

    # ----------------------------------------------------------- outputs

    def frames(self) -> list[dict]:
        """The retained period frames (JSON-ready), oldest first."""
        return [dict(f) for f in self._frames]

    def span_dicts(self) -> list[dict]:
        return [s.to_dict() for s in list(self._spans)]

    def _phase_p99_ms(self, name: str) -> float:
        counts = self._hist[name]
        total = sum(counts)
        if not total:
            return 0.0
        target = 0.99 * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return float(HIST_EDGES_MS[min(i, len(HIST_EDGES_MS) - 1)])
        return float(HIST_EDGES_MS[-1])

    def summary(self) -> dict:
        """Running per-phase stats over every traced period (not just
        the retained ring) — the expo.render_serve_trace input."""
        n = self._periods
        attributed = sum(self._sums.values())
        phases = {}
        for name in PHASES:
            total = self._sums[name]
            phases[name] = {
                "total_ms": round(total, 3),
                "mean_ms": round(total / n, 4) if n else 0.0,
                "p99_ms": round(self._phase_p99_ms(name), 4),
                "fraction": round(total / attributed, 4) if attributed
                else 0.0,
            }
        mean_wall = self._wall_sum / n if n else 0.0
        return {
            "kind": "serve_phase_summary",
            "periods": n,
            "phase_names": list(PHASES),
            "phases": phases,
            "period_ms": {"mean": round(mean_wall, 4),
                          "total": round(self._wall_sum, 3)},
            "unattributed_ms": round(
                max(0.0, (self._wall_sum - attributed) / n) if n else 0.0,
                4),
            "hist_edges_ms": list(HIST_EDGES_MS),
            "hist": {name: list(self._hist[name]) for name in PHASES},
            "spans": len(self._spans),
        }

    def dump_frames(self, path: str, extra: dict | None = None) -> str:
        """Write the frame ring as self-describing JSONL (the
        obs/recorder.py header-line convention, via its shared
        `write_jsonl`)."""
        from swim_tpu_torch.obs.recorder import write_jsonl

        header = dict(extra or {})
        header.update({"kind": "swim_tpu_serve_trace_frames",
                       "version": 1,
                       "phase_names": list(PHASES),
                       "periods": self._periods,
                       "retained": len(self._frames)})
        return write_jsonl(path, header, self.frames())


def gauge_values(summary: dict) -> dict[str, float]:
    """SERVE_TRACE_GAUGES scalar fallbacks from one `summary()` dict
    (per-phase series render with a `phase` label in expo; the scalar
    collapses to the slowest phase, mirroring render_sessions' worst-
    session fallback)."""
    phases = summary.get("phases") or {}
    worst_mean = max((float(p.get("mean_ms", 0.0))
                      for p in phases.values()), default=0.0)
    worst_p99 = max((float(p.get("p99_ms", 0.0))
                     for p in phases.values()), default=0.0)
    worst_frac = max((float(p.get("fraction", 0.0))
                      for p in phases.values()), default=0.0)
    return {
        "swim_serve_phase_ms": worst_mean,
        "swim_serve_phase_p99_ms": worst_p99,
        "swim_serve_phase_fraction": worst_frac,
        "swim_serve_period_ms":
            float((summary.get("period_ms") or {}).get("mean", 0.0)),
        "swim_serve_unattributed_ms":
            float(summary.get("unattributed_ms", 0.0)),
    }

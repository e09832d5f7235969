"""Typed counter/histogram registry for real nodes (port of
`swim_tpu/obs/registry.py`).

Every counter a node increments is DECLARED here (name and help text),
so an exposition can render HELP/TYPE metadata.  `stats_view()` returns
a MutableMapping backed by the typed counters, so `node.stats["probes"]
+= 1`, `utils.metrics.aggregate_nodes` and sums over `n.stats` work
unchanged, while an UNDECLARED key raises KeyError instead of minting
an untyped counter.
"""

from __future__ import annotations

from collections.abc import MutableMapping

NODE_COUNTERS: dict[str, str] = {
    "probes": "Protocol probes initiated",
    "probe_failures": "Probe rounds that ended with no direct or relayed ack",
    "suspicions": "Suspicion timers started",
    "refutations": "Self-suspicions refuted with an incarnation bump",
    "deaths_declared": "Suspicions expired into a DEAD declaration",
    "messages_in": "Datagrams received",
    "messages_out": "Datagrams sent",
    "decode_errors": "Datagrams dropped by the wire codec",
}

# Bucket upper bounds in seconds (+Inf is implicit).  Sized for the
# stock 1 s protocol period: probe RTTs land in the sub-period buckets,
# suspicion lifetimes in the multi-period tail.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0)

NODE_HISTOGRAMS: dict[str, tuple[str, tuple[float, ...]]] = {
    "probe_rtt_seconds":
        ("Round-trip time of acked direct probes", DEFAULT_BUCKETS),
    "suspicion_duration_seconds":
        ("Suspicion-timer lifetime from start to refute/confirm",
         DEFAULT_BUCKETS),
}


class Counter:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.value = 0

    def inc(self, amount: int = 1) -> None:
        self.value += amount


class Histogram:
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        if tuple(buckets) != tuple(sorted(buckets)):
            raise ValueError(f"histogram {name}: buckets must be sorted")
        self.name = name
        self.help = help_text
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> list[int]:
        """Prometheus-style cumulative bucket counts (ending at +Inf)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class _StatsView(MutableMapping):
    """dict-compatible facade over a registry's counters."""

    __slots__ = ("_reg",)

    def __init__(self, registry: "MetricsRegistry"):
        self._reg = registry

    def __getitem__(self, name: str) -> int:
        return self._reg.counter(name).value

    def __setitem__(self, name: str, value: int) -> None:
        self._reg.counter(name).value = int(value)

    def __delitem__(self, name: str):
        raise TypeError("registry counters cannot be deleted")

    def __iter__(self):
        return iter(self._reg.counters)

    def __len__(self) -> int:
        return len(self._reg.counters)


class MetricsRegistry:
    """Holds one process-local set of typed counters and histograms."""

    def __init__(self, counters: dict[str, str] | None = None,
                 histograms: dict[str, tuple[str, tuple[float, ...]]]
                 | None = None):
        self.counters: dict[str, Counter] = {
            name: Counter(name, help_text)
            for name, help_text in (counters or {}).items()}
        self.histograms: dict[str, Histogram] = {
            name: Histogram(name, help_text, buckets)
            for name, (help_text, buckets) in (histograms or {}).items()}

    @classmethod
    def node_default(cls) -> "MetricsRegistry":
        return cls(NODE_COUNTERS, NODE_HISTOGRAMS)

    def counter(self, name: str) -> Counter:
        try:
            return self.counters[name]
        except KeyError:
            raise KeyError(
                f"counter {name!r} is not declared in the registry: add "
                "it to swim_tpu_torch.obs.registry.NODE_COUNTERS") from None

    def histogram(self, name: str) -> Histogram:
        return self.histograms[name]

    def observe(self, name: str, value: float) -> None:
        self.histograms[name].observe(value)

    def stats_view(self) -> _StatsView:
        return _StatsView(self)

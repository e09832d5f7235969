"""Bench trend engine: per-tier periods/sec trajectories + regression gate
(port of `swim_tpu/obs/trend.py`, whole: plain file parsing).

Two artifact sources:

* ``BENCH_r*.json`` at the repo root — one per bench round, written by
  the external driver; ``parsed`` carries every ``<tier>_periods_per_sec``
  / ``<tier>_nodes`` pair plus the resolved ``platform``.  The round
  number in the filename gives a total order, so these are the canonical
  trajectory and the ONLY samples the regression gate judges.
* ``bench_results/bench_all*.json`` — tpu_watch captures whose
  ``result`` is bench.py's final JSON.  Ordered by ``captured_at``;
  they enrich the rendered trajectory but are advisory (no round
  number, so their position relative to rounds is ambiguous).

A series is keyed ``(tier, nodes, platform)`` — a CPU proxy number and
a TPU capture never compare, and neither do different N (the honesty
rule all RESULTS tables follow).  The ``--check`` gate fails a series
when the latest round's value drops more than ``threshold`` (default
10%) below the immediately previous (last-good) round: periods/sec
must not silently decay while feature work lands.

CLI: ``python -m swim_tpu_torch.obs.trend [--repo DIR] [--json]
[--check]`` (also surfaced as ``swim-tpu-torch trend``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")
_PPS_SUFFIX = "_periods_per_sec"
# Second metric family: peak memory bytes (bench.py --tier memwall).
# Same auto-registration (`<tier>_peak_bytes` + `<tier>_nodes`), but the
# gate direction INVERTS — bytes regress by RISING, p/s by dropping.
_BYTES_SUFFIX = "_peak_bytes"
# Serving-hub families (bench.py --tier serve): concurrent sessions
# sustained (regresses by dropping, like p/s) and p99 round-trip
# latency in ms (regresses by RISING, inverted like peak_bytes).
_SESSIONS_SUFFIX = "_sessions"
_P99_SUFFIX = "_p99_ms"
# Serve-path tracing (bench.py --tier servetrace): mean echo-tail ms
# NOT explained by a named _period phase.  Inverted — unexplained tail
# time regressing upward means the attribution layer is losing its
# grip on the p99, which is exactly what the gate must catch.
_UNATTR_SUFFIX = "_unattributed_ms"

DEFAULT_THRESHOLD = 0.10


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _samples_from_parsed(parsed: dict, *, source: str, rnd: int | None,
                         captured_at: str | None) -> list[dict]:
    if not isinstance(parsed, dict):
        return []
    platform = parsed.get("platform") or parsed.get("accelerator") \
        or "unknown"
    out = []
    for key, val in parsed.items():
        if not isinstance(val, (int, float)):
            continue
        if key.endswith(_PPS_SUFFIX):
            tier, metric = key[:-len(_PPS_SUFFIX)], "pps"
        elif key.endswith(_BYTES_SUFFIX):
            tier, metric = key[:-len(_BYTES_SUFFIX)], "peak_bytes"
        elif key.endswith(_UNATTR_SUFFIX):
            tier, metric = key[:-len(_UNATTR_SUFFIX)], "unattributed_ms"
        elif key.endswith(_P99_SUFFIX):
            tier, metric = key[:-len(_P99_SUFFIX)], "p99_ms"
        elif key.endswith(_SESSIONS_SUFFIX):
            tier, metric = key[:-len(_SESSIONS_SUFFIX)], "sessions"
        else:
            continue
        nodes = parsed.get(f"{tier}_nodes")
        out.append({
            "tier": tier,
            "nodes": int(nodes) if isinstance(nodes, (int, float)) else None,
            "platform": str(platform),
            "metric": metric,
            "pps": float(val),
            "round": rnd,
            "captured_at": captured_at,
            "source": source,
        })
    return out


def collect(repo: str | None = None) -> list[dict]:
    """All trend samples from BENCH_r*.json + bench_results/bench_all*.

    Unreadable or shape-mismatched files are skipped (artifacts written
    by older rounds must never crash the gate)."""
    repo = repo or _repo_root()
    samples: list[dict] = []
    for path in sorted(glob.glob(os.path.join(repo, "BENCH_r*.json"))):
        m = _ROUND_RE.search(path)
        if not m:
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        samples.extend(_samples_from_parsed(
            doc.get("parsed", {}), source=os.path.basename(path),
            rnd=int(m.group(1)), captured_at=None))
    for path in sorted(glob.glob(
            os.path.join(repo, "bench_results", "bench_all*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        samples.extend(_samples_from_parsed(
            doc.get("result", {}), source=os.path.basename(path),
            rnd=None, captured_at=doc.get("captured_at")))
    return samples


def series(samples: list[dict]) -> dict[tuple, list[dict]]:
    """Group by (tier, nodes, platform, metric); each series ordered
    with rounds first (numeric) then round-less captures by
    captured_at."""
    out: dict[tuple, list[dict]] = {}
    for s in samples:
        out.setdefault((s["tier"], s["nodes"], s["platform"],
                        s.get("metric", "pps")), []).append(s)
    for key in out:
        out[key].sort(key=lambda s: (
            0 if s["round"] is not None else 1,
            s["round"] if s["round"] is not None else 0,
            s["captured_at"] or ""))
    return out


def check(ser: dict[tuple, list[dict]],
          threshold: float = DEFAULT_THRESHOLD) -> list[dict]:
    """Regression gate over the round-ordered samples of each series.

    Last-good semantics (bench.py's last_good_tpu vocabulary): the
    latest round is judged against the IMMEDIATELY PREVIOUS round, and
    fails (ok=False) when it regresses more than `threshold` past it —
    a DROP for pps series, a RISE for peak_bytes series (memory
    regresses upward).  CPU proxy numbers are noisy round to round, so
    judging against the all-time best would permanently fail a series
    after one lucky round; the full trajectory stays visible in
    render() either way.  Series with fewer than two round samples pass
    vacuously."""
    findings = []
    for (tier, nodes, platform, metric), samp in sorted(
            ser.items(), key=lambda kv: str(kv[0])):
        rounds = [s for s in samp if s["round"] is not None]
        if len(rounds) < 2:
            continue
        latest, last_good = rounds[-1], rounds[-2]
        drop = 1.0 - latest["pps"] / last_good["pps"] \
            if last_good["pps"] > 0 else 0.0
        regression = -drop if metric in ("peak_bytes", "p99_ms",
                                         "unattributed_ms") else drop
        findings.append({
            "tier": tier, "nodes": nodes, "platform": platform,
            "metric": metric,
            "latest_round": latest["round"], "latest_pps": latest["pps"],
            "last_good_round": last_good["round"],
            "last_good_pps": last_good["pps"],
            "drop_pct": round(drop * 100.0, 2),
            "threshold_pct": round(threshold * 100.0, 2),
            "ok": regression <= threshold,
        })
    return findings


def summarize(repo: str | None = None,
              threshold: float = DEFAULT_THRESHOLD) -> dict:
    ser = series(collect(repo))
    findings = check(ser, threshold)
    return {
        "series": {
            f"{tier}@{nodes}/{platform}"
            + ("" if metric == "pps" else f" [{metric}]"): [
                {"round": s["round"], "captured_at": s["captured_at"],
                 "pps": s["pps"], "source": s["source"]}
                for s in samp]
            for (tier, nodes, platform, metric), samp in sorted(
                ser.items(), key=lambda kv: str(kv[0]))
        },
        "checks": findings,
        "ok": all(f["ok"] for f in findings),
    }


def render(summary: dict) -> str:
    lines = ["bench trend (periods/sec by tier@nodes/platform)", ""]
    for name, samp in summary["series"].items():
        traj = " -> ".join(
            f"{s['pps']:g}" + (f" (r{s['round']})" if s["round"] is not None
                               else " (capture)")
            for s in samp)
        lines.append(f"  {name}: {traj}")
    lines.append("")
    if not summary["checks"]:
        lines.append("gate: no series with >= 2 rounds; nothing to check")
    for f in summary["checks"]:
        tag = "ok  " if f["ok"] else "FAIL"
        metric = f.get("metric", "pps")
        name = f"{f['tier']}@{f['nodes']}/{f['platform']}" \
            + ("" if metric == "pps" else f" [{metric}]")
        lines.append(
            f"  [{tag}] {name}: "
            f"r{f['latest_round']} {f['latest_pps']:g} vs last-good "
            f"r{f['last_good_round']} {f['last_good_pps']:g} "
            f"(drop {f['drop_pct']}%, limit {f['threshold_pct']}%)")
    lines.append("")
    lines.append("gate: " + ("PASS" if summary["ok"] else "FAIL"))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="swim-tpu-torch trend",
        description="per-tier bench trajectories + regression gate")
    ap.add_argument("--repo", default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                    help="max allowed fractional drop vs the last-good "
                         "round (default 0.10)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when any series regresses past the "
                         "threshold")
    args = ap.parse_args(argv)
    summary = summarize(args.repo, args.threshold)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(render(summary))
    if args.check and not summary["ok"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

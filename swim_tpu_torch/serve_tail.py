"""Where the serve path's echo-RTT tail sits against the traced periods.

    python3 -m swim_tpu_torch.serve_tail [--reps R] [--nodes N]
        [--sessions S] [--periods P] [--tag TAG] [--device cpu]

Runs the traced arm of `serve/load.run_trace` (its defaults: 1,000,000
nodes, 1,000 sessions, 3 periods, up to 2,000 echoes sampled while the
engine steps, the udppump frontend) R times on the CUDA card.  For each
run it prints one JSON line with `summarize_serve`'s coverage and, on
the clock of the first period's
start, the echoes before, inside and after the traced periods (count,
p50, p99, max ms), the tail echoes (send time, RTT, the share of it
that overlaps a phase), the largest RTT in each 100 ms after the last
period, and the Python garbage collector's passes (generation, ms)
while the arm ran.  Frames and echo windows go to
chiprun_out/serve_tail_<tag>.json.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.measure import card_line
from swim_tpu_torch.obs import analyze
from swim_tpu_torch.serve import load


def _stats(vals: list[float]) -> dict:
    if not vals:
        return {"n": 0}
    a = np.asarray(vals)
    return {"n": len(vals), "p50": round(float(np.percentile(a, 50)), 3),
            "p99": round(float(np.percentile(a, 99)), 3),
            "max": round(float(a.max()), 3)}


def one_run(cfg: SwimConfig, sessions: int, periods: int,
            device=None) -> dict:
    passes, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.monotonic()
        else:
            t = started.pop("t", None)
            if t is not None:
                passes.append((t, info["generation"],
                               (time.monotonic() - t) * 1e3))

    gc.callbacks.append(on_gc)
    try:
        on = load._run_arm(cfg, sessions, periods, 0, 16, 2000, "udppump",
                           0.0, 0.0, trace=True, device=device)
    finally:
        gc.callbacks.remove(on_gc)
    frames, windows = on["trace"]["frames"], on["trace"]["echo_windows"]
    att = analyze.summarize_serve(frames, windows)
    spans = [(b, e) for f in frames for _, b, e in f["phases"]]
    t0, t1 = frames[0]["t0"], frames[-1]["t1"]

    def covered(b, e):
        return sum(max(0.0, min(e, pe) - max(b, pb)) for pb, pe in spans)

    rtt = [(e - b) * 1e3 for b, e in windows]
    before = [r for (b, e), r in zip(windows, rtt) if e <= t0]
    after = [r for (b, e), r in zip(windows, rtt) if b >= t1]
    inside = [r for (b, e), r in zip(windows, rtt) if e > t0 and b < t1]
    p99 = float(np.percentile(rtt, 99))
    tail = sorted(((b - t0) * 1e3, r, covered(b, e) * 1e3 / r)
                  for (b, e), r in zip(windows, rtt) if r >= p99)
    bins: dict[int, float] = {}
    for (b, e), r in zip(windows, rtt):
        if b >= t1:
            k = int((b - t1) * 10)
            bins[k] = max(bins.get(k, 0.0), r)
    return {"coverage_pct": att.get("coverage_pct"),
            "p99_attribution_ms": att.get("p99_attribution_ms"),
            "periods_ms": round((t1 - t0) * 1e3, 3),
            "first_send_ms": round((windows[0][0] - t0) * 1e3, 3),
            "last_recv_ms": round((windows[-1][1] - t0) * 1e3, 3),
            "before": _stats(before), "inside": _stats(inside),
            "after": _stats(after),
            "tail": [[round(x, 3) for x in row] for row in tail],
            "after_max_per_100ms": [round(bins[k], 3) for k in sorted(bins)],
            "gc": [[round((t - t0) * 1e3, 3), g, round(ms, 3)]
                   for t, g, ms in passes],
            "phase_mean_ms": {k: v["mean_ms"] for k, v in
                              on["trace"]["summary"]["phases"].items()},
            "frames": frames, "windows": windows}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--sessions", type=int, default=1000)
    ap.add_argument("--periods", type=int, default=3)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    cfg = SwimConfig(n_nodes=args.nodes, **load.SERVE_ANCHOR)
    card = card_line() if args.device is None else args.device
    runs = []
    for rep in range(args.reps):
        r = one_run(cfg, args.sessions, args.periods, args.device)
        runs.append(r)
        print(json.dumps({"tag": args.tag, "rep": rep, "card": card,
                          **{k: v for k, v in r.items()
                             if k not in ("frames", "windows")}}),
              flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / f"serve_tail_{args.tag}.json").write_text(json.dumps(runs))


if __name__ == "__main__":
    main()

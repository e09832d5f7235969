"""Detection-latency arithmetic of the studies (port of the detection
part of `swim_tpu/obs/analyze.py`): numpy only.

`summarize_detection` is what `sim/runner.py` `detection_summary`
delegates to; `latency_cdf` and `detection_law` read the same
milestones (the law: with uniform probing, first detection is
geometric with mean e/(e-1) periods at large N).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np

NEVER = 2**31 - 1                     # sim/runner.py's not-yet sentinel
E_OVER_E_MINUS_1 = math.e / (math.e - 1)


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

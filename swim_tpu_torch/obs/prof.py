"""Phase-level step profiler (port of `swim_tpu/obs/prof.py`): where
does the protocol period's time go?

The engines' `step` functions take an optional `prof` PhaseProbe, which
marks the ends of the step's named phases, in the reference's order:

  select         window maintenance (Phase 0), the per-subject top-C
                 index and the first-B piggyback selection
  pack           staging the wave payloads (the buddy forced-bit rows)
  ppermute       the wave ok chain: per-wave delivery flags and their
                 node-vector rolls
  merge          the delivery ORs into the window (merge_waves on the
                 fused path; per-wave merges otherwise)
  commit         probe verdicts, the cold flush and view queries,
                 Phase C and D, the state assembled
  telemetry_tap  the EngineFrame tap reductions (beside a tap)

Two probe modes.  With `prof=None` a step runs exactly as without the
argument.

* **Marker mode** (`until=None`): each `cut` folds the first 256
  elements of one array the phase already made into an int32 signature
  (the reference's `_fold`, with its u32 branch taken where the
  reference's probe is u32, since the port carries u32 in int32) and
  the step returns normally.  `profiled_ring_run` stacks the per-period
  marker vectors into int32[T, 6] on the device, with no host sync per
  period.
* **Prefix mode** (`until=<phase>`): the step returns at the named
  boundary with the phase's live arrays (`PhaseProbe.capture`).
  `profile_ring` times one prefix per boundary and takes differences:
  phase time = t(prefix_i) - t(prefix_i-1).  Eager PyTorch eliminates
  no dead code, so a prefix runs all the step's code before its cut in
  program order, and a phase's time is the time of the code between its
  cut and the one before (the reference's is the marginal cost of the
  work XLA keeps live for the phase's outputs).  The differences still
  telescope to the full step.  Each difference is clamped at 0 and
  telemetry_tap takes the rest of the full step, so coverage is at
  least 100% by construction (the reference's >= 95% contract always
  holds); what it reads above 100% is the time the clamp dropped,
  where a prefix timed slower than a longer one.  Each timed dispatch
  gets a fresh copy of `cold` made outside the clock (the step flushes
  `cold` in place), and the clock is read after
  `torch.cuda.synchronize()`, best of `reps`.  The prefixes and the
  full step are timed in interleaved rounds, so a drift of the host's
  speed reaches each of them alike.

Per phase the report pairs the time with the modeled memory bytes
(utils/roofline.py's terms mapped to phases) and the modeled per-device
bytes of the sharded layout (obs/ici.py).  The reference's achieved
bytes come from XLA's cost analysis; eager PyTorch has no such source,
so `xla_bytes` is null and every verdict "n/a", as the reference gives
for a backend without a cost analysis.  The roofline rate is the H100
SXM's 3,350 GB/s; `ici_gbps` is null: no interconnect rate has been
measured for the port.

`swim-tpu-torch profile` is the CLI face; obs/expo.py `render_profile`
serves the latest report as `swim_prof_*` gauges on the bridge's
/metrics endpoint.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, NamedTuple

import torch

from swim_tpu_torch.ops import u32 as u32ops

# Canonical phase order (the attribution table renders in this order; a
# config whose step cannot separate the fine wave phases reports the
# coarse subset from phases_for()).
PHASES = ("select", "pack", "ppermute", "merge", "commit",
          "telemetry_tap")

# utils/roofline.py ring_traffic term -> phase (the memory byte model).
HBM_TERM_PHASE = {
    "phase0_shift_flush": "select",
    "topc_index": "select",
    "waves": "merge",
    "wave_vectors": "ppermute",
    "buddy_bits": "pack",
    "query_pass": "commit",
    "phase_cd": "commit",
}

# Prometheus gauge names emitted by obs/expo.py render_profile.
PROF_GAUGES = (
    "swim_prof_phase_ms",
    "swim_prof_phase_fraction",
    "swim_prof_phase_model_bytes",
    "swim_prof_phase_xla_bytes",
    "swim_prof_phase_ici_bytes",
    "swim_prof_step_ms",
    "swim_prof_coverage_pct",
)

# achieved-bytes-to-model threshold of the floor verdict, and the share
# of the memory rate a floor phase must stream at (the reference's)
FIXABLE_RATIO = 1.25
FLOOR_MIN_BW_FRAC = 0.5

_FOLD_ELEMS = 256       # marker fold width: tiny, deterministic, cheap
I32 = torch.int32


def _fold(a: torch.Tensor, u32: bool = False) -> torch.Tensor:
    """int32 signature of one array's leading slice: the reference's
    `_fold`.  `u32` says the reference's array is u32 (here its int32
    carrier): the low 15 bits of each element are summed.  The sum wraps
    modulo 2**32 as the reference's int32 sum does."""
    x = a.reshape(-1)[:_FOLD_ELEMS]
    if x.dtype == torch.bool:
        x = x.to(I32)
    elif u32:
        x = x & 0x7FFF
    elif x.dtype.is_floating_point:
        x = (x != 0).to(I32)
    return u32ops.from_u64(x.sum(dtype=torch.int64))


class PhaseProbe:
    """The phase-boundary seam threaded through the engines' step.

    `cut(name, probe, ...)` marks the end of phase `name` and returns
    True when the step should return there (prefix mode reached its
    boundary); the step then returns `capture(**parts)`, its live set.
    In marker mode it records one int32 signature per phase and returns
    False.  Prefix mode folds nothing: the reference's folds before its
    stop are dead code that XLA drops, and here they would add their
    launches to every prefix but not to the full step.  A fresh probe
    serves one step.
    """

    __slots__ = ("until", "markers", "captured", "_probe")

    def __init__(self, until: str | None = None):
        if until is not None and until not in PHASES:
            raise ValueError(f"unknown phase {until!r}; know {PHASES}")
        self.until = until
        self.markers: dict[str, torch.Tensor] = {}
        self.captured: Any = None
        self._probe = None

    def cut(self, name: str, probe: torch.Tensor, ops=None,
            u32: bool = False) -> bool:
        """Mark the end of phase `name`.  `probe` is the one array the
        marker folds, one the phase already made (`u32`: the
        reference's array is u32); `ops` is the step's GlobalOps, whose
        global sum the marker goes through."""
        if self.until is None:
            m = _fold(probe, u32)
            if ops is not None:
                m = ops.gsum(m)
            self.markers[name] = m
            return False
        if self.until == name:
            self._probe = probe
            return True
        return False

    def capture(self, **parts) -> dict:
        """The live set of the phase the step stops at, with the cut's
        probe under "_probe" (the reference's `captured`)."""
        self.captured = {**parts, "_probe": self._probe}
        return self.captured

    def marker_vector(self) -> torch.Tensor:
        """int32[len(PHASES)] in canonical order; 0 for phases not
        cut."""
        dev = next(iter(self.markers.values())).device
        zero = torch.zeros((), dtype=I32, device=dev)
        return torch.stack([self.markers.get(p, zero) for p in PHASES])


class ProfiledRun(NamedTuple):
    """Final state + stacked int32[T, len(PHASES)] phase markers.
    `.step` is the state's period counter."""

    state: Any
    markers: torch.Tensor

    @property
    def step(self):
        return self.state.step


def profiled_ring_run(cfg, state, plan, seed: int, periods: int, *,
                      plain: bool = False) -> ProfiledRun:
    """ring.run with the phase probe in marker mode: the same periods
    and randomness as `ring.run(cfg, state, plan, seed, periods)`, and
    each period's marker vector stacked on the device.  `plain` runs the
    plain versions of the kernels."""
    from swim_tpu_torch.models import ring
    from swim_tpu_torch.utils import threefry

    dev = state.win.device
    rows = []
    for rnd in ring.period_randomness(cfg, threefry.key(seed),
                                      int(state.step), periods, dev):
        pr = PhaseProbe()
        state = ring.step(cfg, state, plan, rnd, plain=plain, prof=pr)
        rows.append(pr.marker_vector())
    markers = (torch.stack(rows) if rows
               else torch.zeros((0, len(PHASES)), dtype=I32, device=dev))
    return ProfiledRun(state, markers)


def phases_for(cfg) -> tuple[str, ...]:
    """The phases a config's step can separate, in cut order.

    The fused period-scope rotor path exposes all six, and stages its
    wave payloads after deciding the ok chain, so its cut order is
    select -> ppermute -> pack -> merge.  Wave-scope rotor delivers
    per wave and pull mode by gathers: both report the coarse subset
    with the wave work under "merge"."""
    fused = (cfg.ring_probe == "rotor"
             and cfg.ring_sel_scope == "period"
             and (2 + 4 * cfg.k_indirect) <= 32)
    if fused:
        return ("select", "ppermute", "pack", "merge", "commit",
                "telemetry_tap")
    return ("select", "merge", "commit", "telemetry_tap")


def phase_hbm_model(cfg) -> dict[str, tuple[float, float]]:
    """(fused, unfused) modeled memory bytes per phase, from
    utils/roofline.py's per-term accounting."""
    from swim_tpu_torch.utils import roofline as rl

    active = phases_for(cfg)
    out: dict[str, list[float]] = {p: [0.0, 0.0] for p in active}
    for term, (f, u) in rl.ring_traffic(cfg)["terms"].items():
        p = HBM_TERM_PHASE[term]
        if p not in out:       # coarse phase set: wave terms fold into merge
            p = "merge" if p in ("pack", "ppermute") else p
        out[p][0] += f
        out[p][1] += u
    return {p: (f, u) for p, (f, u) in out.items()}


def phase_ici_model(cfg, d: int = 8) -> dict[str, int]:
    """Modeled per-device bytes per phase of a `d`-way sharded layout,
    from obs/ici.py's per-collective tally (named term -> phase, in the
    fused path's cut order)."""
    from swim_tpu_torch.obs.ici import trace_ici_bytes

    active = phases_for(cfg)
    out = {p: 0 for p in active}
    # buddy (col, val) ride the ok-chain bundle on the packed scalar
    # wire but roll during payload staging on the wide one
    buddy = ("ppermute" if cfg.ring_scalar_wire == "packed" else "pack")
    roll_phase = {
        "roll_probe_gate": "ppermute", "roll_ok_waves": "ppermute",
        "roll_pid_waves": "ppermute", "roll_buddy_slots": "ppermute",
        "roll_buddy_cols": buddy, "roll_buddy_vals": buddy,
        "roll_view_slots": "commit", "roll_view_known": "commit",
        "roll_view_verdict": "commit",
    }
    for key, nbytes in trace_ici_bytes(cfg, d)["breakdown"].items():
        if key == "sel_wire_boundary" or key.startswith("roll_sel_waves"):
            p = "merge"
        elif key in roll_phase:
            p = roll_phase[key]
        elif key.startswith("roll["):
            p = "ppermute"
        else:   # psum_scalar / gather_psum / knows_psum / candidates_*
            p = "commit"
        if p not in out:   # coarse phase set: wave terms fold into merge
            p = "merge"
        out[p] = out.get(p, 0) + int(nbytes)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_calls(fns: dict, state, rnds, reps: int) -> dict[str, float]:
    """Best per-call wall seconds of each of `fns` over `reps` rounds.
    A round dispatches every fn once, in turn, with the round's period
    randomness and its own copy of `state.cold` (made outside the
    clock: the step flushes cold in place), the clock read after the
    device is idle.  Interleaving the fns puts a drift of the host's
    speed on each of them alike, so the prefix differences still order."""
    dev = state.win.device
    best = {name: float("inf") for name in fns}
    for i in range(max(reps, 1)):
        rnd = rnds[i % len(rnds)]
        for name, fn in fns.items():
            st = state._replace(cold=state.cold.clone())
            _sync(dev)
            t0 = time.perf_counter()
            fn(st, rnd)
            _sync(dev)
            best[name] = min(best[name], time.perf_counter() - t0)
    return best


def _verdict(model_unfused: float, xla_bytes: float | None,
             dt_s: float, on_card: bool, hbm_gbps: float) -> str:
    if model_unfused <= 0 or xla_bytes is None or xla_bytes <= 0:
        return "n/a"
    if xla_bytes > FIXABLE_RATIO * model_unfused:
        return "fixable"
    if on_card and dt_s > 0:
        bw_frac = (xla_bytes / dt_s) / (hbm_gbps * 1e9)
        if bw_frac < FLOOR_MIN_BW_FRAC:
            return "fixable"
    return "floor"


def profile_ring(cfg, *, settle: int = 2, reps: int = 5, seed: int = 0,
                 crash_fraction: float = 0.001, ici_devices: int = 8,
                 trace_dir: str | None = None, top_k: int = 5,
                 device=None) -> dict:
    """Measure one ring period's phase attribution on `device` (the
    card unless the caller names another).  Returns the reference's
    report dict.  With `trace_dir`, the full step runs again under
    utils/profiling.py `trace` and the report gains the device top-op
    table (`top_ops`) with per-op phase guesses."""
    from swim_tpu_torch import device as devmod
    from swim_tpu_torch.models import ring
    from swim_tpu_torch.obs.engine import frame_from_tap
    from swim_tpu_torch.sim import faults
    from swim_tpu_torch.utils import roofline as rl
    from swim_tpu_torch.utils import threefry

    dev = devmod.resolve(device)
    n = cfg.n_nodes
    key = threefry.key(seed)
    plan = faults.with_random_crashes(
        faults.none(n, dev), threefry.key(1), crash_fraction, 0,
        max(settle, 1))
    state = ring.init_state(cfg, dev)
    if settle > 0:      # profile a steady-state window, not a cold start
        state = ring.run(cfg, state, plan, seed, settle)
    # distinct randomness per timed dispatch
    rnds = [ring.draw_period_ring(key, 1_000 + i, cfg, dev)
            for i in range(max(reps, 1))]

    active = phases_for(cfg)
    on_card = dev.type == "cuda"

    def _prefix_fn(phase):
        def fn(st, rnd):
            pr = PhaseProbe(until=phase)
            return ring.step(cfg, st, plan, rnd, tap={}, prof=pr)
        return fn

    def _full_fn(st, rnd):
        tap: dict = {}
        st = ring.step(cfg, st, plan, rnd, tap=tap)
        return st, frame_from_tap(tap, dev)

    # telemetry_tap's prefix is the full step
    fns = {phase: _prefix_fn(phase) for phase in active
           if phase != "telemetry_tap"}
    fns["full"] = _full_fn
    for fn in fns.values():     # warmup
        fn(state._replace(cold=state.cold.clone()), rnds[0])
    prefix_t = _time_calls(fns, state, rnds, reps)
    t_full = prefix_t.pop("full")

    hbm = phase_hbm_model(cfg)
    try:
        ici = phase_ici_model(cfg, ici_devices)
    except Exception:       # a config the byte tally does not trace
        ici = {}
    hbm_gbps, ici_gbps = rl.HBM_GBPS, None

    rows = []
    prev_t = 0.0
    covered = 0.0
    for phase in active:
        if phase == "telemetry_tap":
            dt = max(t_full - prev_t, 0.0)
        else:
            dt = max(prefix_t[phase] - prev_t, 0.0)
            prev_t = prefix_t[phase]
        covered += dt
        mf, mu = hbm.get(phase, (0.0, 0.0))
        rows.append({
            "phase": phase,
            "ms": round(dt * 1e3, 4),
            "fraction": round(dt / t_full, 4) if t_full else 0.0,
            "hbm_model_fused_bytes": int(mf),
            "hbm_model_unfused_bytes": int(mu),
            "xla_bytes": None,
            "ici_model_bytes": int(ici.get(phase, 0)),
            "verdict": _verdict(mu, None, dt, on_card, hbm_gbps),
        })

    top_ops = None
    if trace_dir:
        from swim_tpu_torch.utils import profiling

        with profiling.trace(trace_dir):
            for i in range(max(reps, 1)):
                st = state._replace(cold=state.cold.clone())
                _full_fn(st, rnds[i % len(rnds)])
        try:
            top_ops = top_ops_from_trace(trace_dir, top_k=top_k)
        except (FileNotFoundError, ValueError, KeyError) as e:
            top_ops = {"error": f"trace parse failed: {e}"}

    ceil = rl.ceiling_periods_per_sec(cfg, hbm_gbps)
    return {
        **({"top_ops": top_ops} if top_ops is not None else {}),
        "nodes": n,
        "platform_actual": dev.type,
        "phases_active": list(active),
        "step_ms": round(t_full * 1e3, 3),
        "pps": round(1.0 / t_full, 2) if t_full else 0.0,
        "coverage_pct": round(covered / t_full * 100.0, 2) if t_full
        else 0.0,
        "contract_coverage_pct": 95.0,
        "phases": rows,
        "xla_bytes_step": None,
        "roofline": {
            "hbm_gbps": hbm_gbps, "ici_gbps": ici_gbps,
            "ceiling_fused_pps": round(ceil["ceiling_fused"], 1),
            "ceiling_unfused_pps": round(ceil["ceiling_unfused"], 1),
            "bytes_fused": int(ceil["bytes_fused"]),
            "bytes_unfused": int(ceil["bytes_unfused"]),
        },
        "ici_model_devices": ici_devices,
        "reps": reps, "settle": settle,
        "anchor_cfg": {
            "ring_probe": cfg.ring_probe,
            "ring_sel_scope": cfg.ring_sel_scope,
            "k_indirect": cfg.k_indirect,
            "ring_window_periods": cfg.ring_window_periods,
            "ring_view_c": cfg.ring_view_c,
            "lifeguard": cfg.lifeguard,
            "telemetry_tap_included": True,
        },
    }


# ---------------------------------------------------------------------------
# Device-trace top-op attribution
# ---------------------------------------------------------------------------

# kernel-name pattern -> (phase guess, note).  First match wins.  The
# port's three kernels come first; the aten kernels after them are a
# heuristic: their names carry no phase.
OP_PHASE_PATTERNS = (
    ("selb_kernel", "select",
     "first-B selection (csrc/selb.cu); wave scope runs it per wave, "
     "after the select cut, so its time falls in merge"),
    ("wavemerge_kernel", "merge", "fused wave-OR merge (csrc/wavemerge.cu)"),
    ("coldsel_kernel", "commit",
     "cold flush + view queries (csrc/coldsel.cu)"),
    ("roll_cuda", "ppermute", "node-vector roll"),
    ("index_elementwise", "ppermute", "indexed gather (rolls, row gathers)"),
    ("gather", "commit", "gather by node id"),
    ("scatter", "commit", "origination/index scatter"),
    ("index_put", "commit", "indexed write"),
    ("scan", "commit", "cumsum compaction"),
    ("sort", "commit", "first-k compaction"),
    ("topk", "commit", "first-k compaction"),
    ("reduce", "select", "census/selection reduction"),
    ("copy", None, "layout copy, not in the byte model"),
)


def classify_op(name: str) -> tuple[str | None, str]:
    low = name.lower()
    for pat, phase, note in OP_PHASE_PATTERNS:
        if pat in low:
            return phase, note
    return None, "unattributed kernel"


def top_ops_from_trace(trace_dir: str, top_k: int = 25) -> dict:
    """Parse the newest Chrome trace (`*.trace.json`, as
    utils/profiling.py `trace` writes it) under `trace_dir`: the top GPU
    kernels (`cat == "kernel"` events) by device time.  Returns
    {"trace", "total_us", "ops"}."""
    import glob
    from collections import defaultdict

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json under {trace_dir}")
    with open(paths[-1]) as f:
        tr = json.load(f)

    by_op: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    total = 0.0
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        dur = float(ev.get("dur", 0.0))
        name = ev.get("name", "?")
        by_op[name] += dur
        count[name] += 1
        total += dur

    ops = []
    for name, us in sorted(by_op.items(), key=lambda kv: -kv[1])[:top_k]:
        phase, note = classify_op(name)
        ops.append({"op": name, "self_us": round(us, 1),
                    "calls": count[name], "phase_guess": phase,
                    "note": note})
    return {"trace": paths[-1], "total_us": round(total, 1), "ops": ops}


def render_report(report: dict) -> str:
    """Human-readable attribution table (the `profile` view)."""
    cov = report.get("coverage_pct", 0.0)
    lines = [
        f"phase attribution @ {report['nodes']} nodes "
        f"({report['platform_actual']}) — step "
        f"{report['step_ms']} ms, {report['pps']} periods/s, "
        f"coverage {cov}% (contract ≥ "
        f"{report.get('contract_coverage_pct', 95.0)}%)",
        "",
        f"{'phase':<14}{'ms':>9}{'frac':>8}"
        f"{'model HBM f/u':>22}{'XLA bytes':>12}{'ICI bytes':>11}"
        "  verdict",
    ]
    for row in report.get("phases", []):
        model = (f"{row['hbm_model_fused_bytes']:,}/"
                 f"{row['hbm_model_unfused_bytes']:,}")
        xla = (f"{row['xla_bytes']:,}" if row.get("xla_bytes") is not None
               else "-")
        lines.append(
            f"{row['phase']:<14}{row['ms']:>9.3f}{row['fraction']:>8.3f}"
            f"{model:>22}{xla:>12}{row['ici_model_bytes']:>11,}"
            f"  {row['verdict']}"
            + (f" ({row['achieved_gbps']} GB/s,"
               f" {row['hbm_ceiling_frac']:.0%} of HBM)"
               if "achieved_gbps" in row else ""))
    rl = report.get("roofline", {})
    lines.append("")
    lines.append(
        f"roofline: HBM {rl.get('hbm_gbps')} GB/s, ICI "
        f"{rl.get('ici_gbps')} GB/s; chip ceiling "
        f"{rl.get('ceiling_fused_pps')}/{rl.get('ceiling_unfused_pps')} "
        "p/s (fused/unfused)")
    top = report.get("top_ops")
    if isinstance(top, dict) and top.get("ops"):
        verdict_of = {r["phase"]: r["verdict"]
                      for r in report.get("phases", [])}
        lines.append("")
        lines.append(f"top device ops (trace {top.get('trace', '?')}, "
                     f"total {top.get('total_us')} µs):")
        lines.append(f"  {'self µs':>10} {'calls':>6}  "
                     f"{'phase?':<10} {'verdict':<10} op")
        for op in top["ops"]:
            ph = op.get("phase_guess")
            verdict = verdict_of.get(ph, "fixable" if ph is None else "n/a")
            lines.append(
                f"  {op['self_us']:>10.1f} {op['calls']:>6}  "
                f"{ph or '?':<10} {verdict:<10} {op['op']}"
                f"  [{op['note']}]")
    elif isinstance(top, dict) and top.get("error"):
        lines.append("")
        lines.append(f"top device ops: {top['error']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Artifact plumbing (the bridge's /metrics and the CLI's --out share it)
# ---------------------------------------------------------------------------

ARTIFACT_DIR = "prof_out"     # beside the package, gitignored


def default_artifact_path() -> str:
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, ARTIFACT_DIR, "profile_phases.json")


def load_artifact(path: str | None = None) -> dict | None:
    """The latest profile report, or None if absent or unreadable (the
    bridge's swim_prof_* gauges read this)."""
    path = path or default_artifact_path()
    try:
        with open(path) as f:
            report = json.load(f)
        return report if isinstance(report, dict) and "phases" in report \
            else None
    except (OSError, ValueError):
        return None


def save_artifact(report: dict, path: str | None = None) -> str:
    path = path or default_artifact_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
    return path

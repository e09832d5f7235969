"""Phase attribution of a ring period by device time, and the
profiler's clock, on the card.

    python3 -m swim_tpu_torch.attribution [--readings 6] [--sessions 4]

`device_attribution(cfg)` is chip_smoke.py phase 15's reading: the
prefixes of `ring.step` (obs/prof.py `PhaseProbe(until=...)`) and the
full step of profile_ring's settled 1M period (its plan, settle and
seed), called in ROUNDS rounds, every call on its own copy of `cold`
made before the round.  Each round runs under one torch.profiler
trace, its calls GAP_S of idle card apart, and its device events are
split into calls at those gaps (measure.busy_ms_by_gap); a round that
does not split into one run a call is run again.  A prefix's device ms
is its median call, so a call that a transient stretched drops out.  A
phase takes the device ms of its prefix less the prefix before
(clamped at 0), telemetry_tap the rest of the full step.  Device time
does not wait for the host, so the prefixes order as their kernels do
and the coverage is 100% plus what the clamp dropped.

Run as a script, it sets this reading beside `per_trace_attribution`,
the one it replaced (each prefix under a trace of its own, REPS calls a
trace started and stopped with no idle card around them, the mean of
their summed device times), `--readings` times each in period and in
wave scope, in turns; and it probes the profiler's clock `--sessions`
times: in a trace of host ranges that each launch a device spin and
wait for it, where the spin lands against its range (the profiler maps
the card's clock to the host's), and whether one op that a trace holds
with no idle card around it, and one held with EDGE_S of idle card on
each side, come out in the trace.  Prints one JSON line a reading or
session, then a summary with the card's name and power limit.  Needs
one card.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import numpy as np
import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.measure import busy_ms, busy_ms_by_gap, card_line

N = 1_000_000
CRASH_FRACTION = 0.001
SETTLE = 2
ROUNDS = 9
# host seconds the card idles before and after each call of a round
GAP_S = 0.025
# calls of each prefix under its trace in the reading this one replaced
REPS = 5
# idle card on each side of the one op of the probe's second trace
EDGE_S = 0.05
SPIN_CYCLES = 4_000_000
WINDOWS = 3


def _period(cfg, rounds: int):
    """(state, rnds, fns, active): profile_ring's settled period of
    `cfg` on the card, `rounds` period draws, and the prefixes and the
    full step as fn(state, rnd)."""
    from swim_tpu_torch.models import ring
    from swim_tpu_torch.obs import prof
    from swim_tpu_torch.obs.engine import frame_from_tap
    from swim_tpu_torch.sim import faults
    from swim_tpu_torch.utils import threefry

    plan = faults.with_random_crashes(faults.none(cfg.n_nodes, "cuda"),
                                      threefry.key(1), CRASH_FRACTION, 0,
                                      SETTLE)
    state = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, SETTLE)
    rnds = [ring.draw_period_ring(threefry.key(0), 1_000 + i, cfg, "cuda")
            for i in range(rounds)]
    active = prof.phases_for(cfg)

    def prefix(phase):
        return lambda st, rnd: ring.step(cfg, st, plan, rnd, tap={},
                                         prof=prof.PhaseProbe(until=phase))

    def full(st, rnd):
        tap: dict = {}
        st = ring.step(cfg, st, plan, rnd, tap=tap)
        return st, frame_from_tap(tap, st.win.device)

    fns = {p: prefix(p) for p in active if p != "telemetry_tap"}
    fns["full"] = full
    return state, rnds, fns, active


def _attribute(dev_ms: dict, active) -> dict:
    phases, prev = {}, 0.0
    for phase in active:
        if phase == "telemetry_tap":
            phases[phase] = max(dev_ms["full"] - prev, 0.0)
        else:
            phases[phase] = max(dev_ms[phase] - prev, 0.0)
            prev = dev_ms[phase]
    return {"step_device_ms": dev_ms["full"], "prefix_device_ms": dev_ms,
            "phases": phases, "coverage_pct":
            sum(phases.values()) / dev_ms["full"] * 100.0}


def device_attribution(cfg) -> dict:
    """The phase attribution of `cfg`'s settled period by device time
    (the module's docstring), with each prefix's range and device
    events a call, and the rounds run again."""
    from torch.profiler import ProfilerActivity, profile

    state, rnds, fns, active = _period(cfg, ROUNDS)

    def one_round(rnd) -> list:
        colds = [state.cold.clone() for _ in fns]
        torch.cuda.synchronize()
        time.sleep(GAP_S)
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            for cold, fn in zip(colds, fns.values()):
                time.sleep(GAP_S)
                fn(state._replace(cold=cold), rnd)
                torch.cuda.synchronize()
            time.sleep(GAP_S)
        return busy_ms_by_gap(pr, GAP_S / 2)

    for fn in fns.values():                                     # warm-up
        fn(state._replace(cold=state.cold.clone()), rnds[0])
    calls = {name: [] for name in fns}
    events = {name: set() for name in fns}
    redone = 0
    gc.disable()
    try:
        for rnd in rnds:
            got = one_round(rnd)
            while len(got) != len(fns):
                redone += 1
                if redone > ROUNDS:
                    raise AssertionError(
                        f"device_attribution: a round of {len(fns)} calls "
                        f"split into {len(got)} runs: {got}")
                got = one_round(rnd)
            for name, (ms, n) in zip(fns, got):
                calls[name].append(ms)
                events[name].add(n)
    finally:
        gc.enable()
    out = _attribute({k: float(np.median(v)) for k, v in calls.items()},
                     active)
    out.update(prefix_device_range={k: [min(v), max(v)]
                                    for k, v in calls.items()},
               prefix_events={k: sorted(v) for k, v in events.items()},
               rounds=ROUNDS, rounds_redone=redone)
    return out


def per_trace_attribution(cfg) -> dict:
    """The reading device_attribution replaced: each prefix and the full
    step, after one warm-up call, REPS calls under a torch.profiler
    trace of its own that starts and stops with the card busy or just
    idle; a prefix's device ms is the trace's summed device time over
    REPS."""
    from torch.profiler import ProfilerActivity, profile

    state, rnds, fns, active = _period(cfg, REPS)
    dev_ms = {}
    for name, fn in fns.items():
        fn(state._replace(cold=state.cold.clone()), rnds[0])
        colds = [state.cold.clone() for _ in range(REPS)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            for cold, rnd in zip(colds, rnds):
                fn(state._replace(cold=cold), rnd)
            torch.cuda.synchronize()
        dev_ms[name] = busy_ms(pr)[0] / REPS
        del colds
    return _attribute(dev_ms, active)


def clock_probe() -> dict:
    """One session of the profiler's clock probe (the module's
    docstring): each window's device spin start less its host range's
    start and the range's end less the spin's end, in microseconds; and
    the device events of a trace holding one op with no idle card
    around it and of one holding it with EDGE_S on each side (1 if the
    op came out)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            time.sleep(0.005)
            with record_function("attribution_probe"):
                torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
    ev = list(pr.profiler.kineto_results.events())
    rng = sorted((e.start_ns(), e.end_ns()) for e in ev
                 if e.name() == "attribution_probe"
                 and e.device_type() == cpu)
    spin = sorted((e.start_ns(), e.end_ns()) for e in ev
                  if "spin" in e.name() and e.device_type() == cuda)
    x = torch.ones(1 << 20, device="cuda")
    kept = {}
    for edge in (0.0, EDGE_S):
        torch.cuda._sleep(SPIN_CYCLES // 2)
        x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(edge)
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            time.sleep(edge)
            x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(edge)
        torch.cuda._sleep(SPIN_CYCLES // 2)
        torch.cuda.synchronize()
        kept[f"edge_{edge}"] = busy_ms(pr)[1]
    return {"windows": len(rng), "spins": len(spin),
            "start_us": [(s[0] - r[0]) / 1e3 for r, s in zip(rng, spin)],
            "end_us": [(r[1] - s[1]) / 1e3 for r, s in zip(rng, spin)],
            "events": kept}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readings", type=int, default=6)
    ap.add_argument("--sessions", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attribution: PyTorch sees no CUDA device")
    from swim_tpu_torch import _kernels
    _kernels.build()
    card = card_line()
    scopes = {"period": SwimConfig(n_nodes=N, ring_sel_scope="period"),
              "wave": SwimConfig(n_nodes=N)}
    methods = {"by_gap": device_attribution,
               "per_trace": per_trace_attribution}
    cov = {(m, s): [] for m in methods for s in scopes}
    probes = []
    for i in range(max(args.readings, args.sessions)):
        if i < args.sessions:
            probes.append(clock_probe())
            print(json.dumps(dict(part="clock", session=i, **probes[-1])),
                  flush=True)
        if i >= args.readings:
            continue
        for scope, cfg in scopes.items():
            for method, fn in methods.items():
                t0 = time.perf_counter()
                got = fn(cfg)
                cov[method, scope].append(got["coverage_pct"])
                print(json.dumps(dict(
                    part="reading", reading=i, scope=scope, method=method,
                    seconds=time.perf_counter() - t0, **got)), flush=True)
    starts = [u for p in probes for u in p["start_us"]]
    print(json.dumps(dict(
        part="summary", card=card, readings=args.readings,
        coverage={f"{m}/{s}": dict(
            min=min(v), median=statistics.median(v), max=max(v),
            outside_95_105=sum(not 95.0 <= c <= 105.0 for c in v))
            for (m, s), v in cov.items()},
        spin_start_us=dict(min=min(starts), max=max(starts)),
        sessions=len(probes),
        op_kept={e: sum(p["events"][e] > 0 for p in probes)
                 for e in probes[0]["events"]})), flush=True)


if __name__ == "__main__":
    main()

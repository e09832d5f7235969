"""Where one engine period's time goes on the card.

    python3 -m swim_tpu_torch.period_profile [--engine ring|dense|rumor]
        [--nodes N] [--periods P] [--scope period|wave] [--lifeguard]
        [--probe rotor|pull] [--study] [--target uniform|round_robin]
        [--scenario NAME]

Runs the ring engine (0.1% of nodes crashing over the run) with the
given probe, in the given selection scope, vanilla or with Lifeguard,
on the CUDA card; with `--study`, periods of the streaming detection
study (`sim/runner.py`: the step plus the census and milestones)
instead of bare engine periods.  `--engine dense` (default 8,192 nodes,
DENSE_MAX) and `--engine rumor` (default 1,000,000 nodes) run those
engines' periods instead (1% of nodes crashing, loss 0.1; `--lifeguard`
and `--target`, the probe-target selection, apply).  `--scenario NAME`
runs the full-track study periods of a library scenario's first arm
(sim/scenario.py: its nodes, SwimConfig with telemetry, and compiled
FaultProgram; `gray_10pct` is the search's geometry) instead.  Prints
one JSON line with

  * wall ms per period of `RingEngine.run` (host clock around a
    synchronised run), and the split between drawing the period's
    randomness (`draw_period_ring`) and `step` (CUDA events);
  * from torch.profiler over the same run: device-busy ms per period
    (the sum of the kernels' device time; one stream, so they do not
    overlap), the idle share 1 - busy / wall, kernel launches per
    period, the aten ops that take the most device time, and the
    device ms per period of the port's own CUDA kernels with their share
    of the busy time;
  * the device ms per period of named parts, from CUDA events around
    each call inside the profiled run: `draw` (the period's threefry
    draws), `gather_rows` (pull's three selection-row gathers) and,
    with `--study`, `census` (`live_knower_counts`); dense: `piggyback`
    (the per-wave top-B); rumor: `live_knowers`, `heard_max` (views,
    self view and buddy witnesses) and `believes_dead` (target
    resampling);
  * the peak of PyTorch's allocated device memory;
  * dense and rumor: the host syncs of one period (`step`), counted
    with PyTorch's sync check set to warn.

The full profiler table goes to
chiprun_out/period_profile_<probe>_<scope>[_lifeguard][_study].txt, or
period_profile_<engine>[_lifeguard][_round_robin].txt, or
period_profile_scenario_<name>.txt.
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from swim_tpu_torch import SwimConfig
from swim_tpu_torch.measure import PartTimer, card_line
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.sim import faults, runner, scenario
from swim_tpu_torch.utils import prng, threefry

# engine -> (module, default nodes, its draw, the parts timed in a period)
ENGINES = {
    "dense": (dense, 8192, prng.draw_period,
              {"draw": (dense, "draw_period"),
               "piggyback": (dense, "_piggyback")}),
    "rumor": (rumor, 1_000_000, rumor.draw_period_rumor,
              {"draw": (rumor, "draw_period_rumor"),
               "live_knowers": (rumor, "live_knowers"),
               "heard_max": (rumor, "_heard_max"),
               "believes_dead": (rumor, "_believes_dead")}),
}


def _events_ms(fn, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _profile(advance, p: int):
    """(torch.profiler key averages, the CUDA kernels among them) of
    `advance(p)`."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        advance(p)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [e for e in ka if e.device_type == cuda_type]
    return ka, kernels


def _summary(ka, kernels, p: int) -> dict:
    busy_us = sum(e.self_device_time_total for e in kernels)
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    top_kernels = sorted(kernels, key=lambda e: e.self_device_time_total,
                         reverse=True)[:12]
    return dict(
        device_busy_ms_per_period=busy_us / 1e3 / p,
        kernel_launches_per_period=sum(e.count for e in kernels) / p,
        top_aten_ops_by_self_device_time=[
            dict(op=e.key, device_ms=e.self_device_time_total / 1e3 / p,
                 calls=e.count / p) for e in ops[:12]],
        top_kernels=[dict(kernel=e.key[:80],
                          device_ms=e.self_device_time_total / 1e3 / p,
                          calls=e.count / p) for e in top_kernels])


def _host_syncs(fn) -> int:
    """Host syncs made by one call of `fn`, counted with PyTorch's sync
    check set to warn, on the second of two calls: the first call under
    the check in a process counts one more (on the H100: 1, then 0, for
    a step that the check set to raise lets pass)."""
    counts = []
    for _ in range(2):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts.append(sum("synchronizing" in str(w.message) for w in seen))
    return counts[-1]


def engine_main(args, card: str) -> None:
    """--engine dense|rumor: bare periods of that engine."""
    mod, default_n, draw, part_names = ENGINES[args.engine]
    n, p = args.nodes or default_n, args.periods
    cfg = SwimConfig(n_nodes=n, lifeguard=args.lifeguard,
                     target_selection=args.target)
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n), threefry.key(1), 0.01, 0, 3 + 3 * p), 0.1)
    eng = (mod.DenseEngine if args.engine == "dense" else
           mod.RumorEngine)(cfg, plan, seed=0)
    eng.run(3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run(p)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / p
    peak = torch.cuda.max_memory_allocated()

    key = threefry.key(0)
    t_now = int(eng.state.step)
    draw_ms = _events_ms(lambda: draw(key, t_now, cfg, "cuda"), p)
    rnd = draw(key, t_now, cfg, "cuda")
    base = eng.state
    step_ms = _events_ms(lambda: mod.step(cfg, base, plan, rnd), p)
    syncs = _host_syncs(lambda: mod.step(cfg, base, plan, rnd))

    parts = PartTimer(part_names)
    with parts:
        ka, kernels = _profile(eng.run, p)
    summary = _summary(ka, kernels, p)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = (args.engine + ("_lifeguard" if args.lifeguard else "")
           + ("_round_robin" if args.target == "round_robin" else ""))
    (out / f"period_profile_{tag}.txt").write_text(
        ka.table(sort_by="self_device_time_total", row_limit=60))
    busy = summary["device_busy_ms_per_period"]
    print(json.dumps(dict(
        card=card, engine=args.engine, n_nodes=n, periods=p,
        lifeguard=args.lifeguard, target_selection=args.target,
        wall_ms_per_period=wall_ms, draw_ms=draw_ms, step_ms=step_ms,
        host_syncs_per_step=syncs, idle_share=1.0 - busy / wall_ms,
        max_memory_allocated=peak, parts=parts.ms(p), **summary)),
        flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("ring", "dense", "rumor"),
                    default="ring")
    ap.add_argument("--nodes", type=int, default=0,
                    help="0: 1,000,000 (ring, rumor) or 8,192 (dense)")
    ap.add_argument("--periods", type=int, default=20)
    ap.add_argument("--scope", choices=("period", "wave"), default="period")
    ap.add_argument("--lifeguard", action="store_true")
    ap.add_argument("--probe", choices=("rotor", "pull"), default="rotor")
    ap.add_argument("--study", action="store_true")
    ap.add_argument("--target", choices=("uniform", "round_robin"),
                    default="uniform", help="dense and rumor only")
    ap.add_argument("--scenario", default="",
                    help="a library scenario: its first arm's study")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("period_profile: PyTorch sees no CUDA device")
    card = card_line()
    if args.engine != "ring":
        engine_main(args, card)
        return
    n, p = args.nodes or 1_000_000, args.periods
    cfg = SwimConfig(n_nodes=n, ring_sel_scope=args.scope,
                     lifeguard=args.lifeguard, ring_probe=args.probe)
    plan = faults.with_random_crashes(faults.none(n), threefry.key(1),
                                      0.001, 0, 3 + 3 * p)
    if args.scenario:
        sc = scenario.get(args.scenario)
        arm = scenario._arm_defs(sc)[0][1]
        _, cfg, plan = scenario._arm_prepare(sc, arm, "cuda")
        n = sc.n
    eng = ring.RingEngine(cfg, plan, seed=0)
    key = threefry.key(0)

    def advance(periods):
        """`periods` periods of the engine, or of the streaming study
        (which continues from the engine's state and step), or of the
        scenario arm's full-track study."""
        if args.scenario:
            eng.state = runner.run_study_ring(cfg, eng.state, plan, key,
                                              periods).state
            return eng.state
        if args.study:
            eng.state = runner.run_study_ring_stream(
                cfg, eng.state, plan, key, periods).state
            return eng.state
        return eng.run(periods)

    advance(3)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    advance(p)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / p

    t_now = int(eng.state.step)
    offs = torch.tensor(ring.rotor_offsets(cfg, t_now), dtype=torch.int32,
                        device="cuda")
    draw_ms = _events_ms(
        lambda: ring.draw_period_ring(key, t_now, cfg, offsets=offs), p)
    rnd = ring.draw_period_ring(key, t_now, cfg, offsets=offs)
    base = eng.state

    def one_step():
        st = base._replace(cold=base.cold.clone())
        ring.step(cfg, st, plan, rnd)

    clone_ms = _events_ms(lambda: base.cold.clone(), p)
    step_ms = _events_ms(one_step, p) - clone_ms

    parts = PartTimer({"draw": (ring, "draw_period_ring"),
                       "gather_rows": (ring.GlobalOps, "gather_rows"),
                       "census": (ring, "live_knower_counts")})
    with parts:
        ka, kernels = _profile(advance, p)
    summary = _summary(ka, kernels, p)
    busy = summary["device_busy_ms_per_period"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    own = {name: sum(e.self_device_time_total for e in kernels
                     if f"{name}_kernel" in e.key) / 1e3 / p
           for name in ("selb", "coldsel", "wavemerge")}
    own_launches = {name: sum(e.count for e in kernels
                              if f"{name}_kernel" in e.key) / p
                    for name in own}
    tag = (f"{args.probe}_{args.scope}" + ("_lifeguard" if args.lifeguard
                                            else "")
           + ("_study" if args.study else ""))
    if args.scenario:
        tag = f"scenario_{args.scenario}"
    (out / f"period_profile_{tag}.txt").write_text(
        ka.table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(dict(
        card=card, n_nodes=n, periods=p, scope=cfg.ring_sel_scope,
        probe=cfg.ring_probe, study=args.study or bool(args.scenario),
        lifeguard=cfg.lifeguard, scenario=args.scenario or None,
        scalar_wire=cfg.ring_scalar_wire, wall_ms_per_period=wall_ms,
        draw_ms=draw_ms, step_ms=step_ms, idle_share=1.0 - busy / wall_ms,
        port_kernels_device_ms=own,
        port_kernels_launches_per_period=own_launches,
        port_kernels_busy_share=sum(own.values()) / busy,
        parts=parts.ms(p), **summary)), flush=True)


if __name__ == "__main__":
    main()

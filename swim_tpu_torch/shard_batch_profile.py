"""Where a batched sharded study period goes on the card, beside one
lane's sharded study period: the 1M ring batch of chip_smoke.py's phase
16 (D = 8 slots of the card, the default SwimConfig with telemetry).

    python3 -m swim_tpu_torch.shard_batch_profile [--nodes N]
        [--lanes 1 3] [--periods 3] [--device cpu]

For one serial lane (`runner.ring_study_period` with the sharded step)
and for a batch of each lane count (`runner.batch_period` with the same
step on placed lane-stacked states, as `experiments._run_study_batch`
runs it), after two warm-up periods:

  * `wall_ms`: the wall a period, bare;
  * `step_ms` / `census_ms`: the wall a period of the sharded step and
    of the rest of the study period, from a run with the card
    synchronized around each step call (which adds the waits it
    removes);
  * `busy_ms`, `kernels`: device ms and device activities a period
    under torch.profiler (CUDA), and `idle_share`;
  * `top_kernels`: the device activities with the most device time a
    period, with their count a period.

Prints one JSON line an arm and the card's name and power limit.  Needs
one card (`--device cpu --nodes 64` runs it on the CPU, with no device
times).
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from swim_tpu_torch import SwimConfig
from swim_tpu_torch.measure import card_line
from swim_tpu_torch.models import ring
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import ring_shard
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.utils import threefry

WARM = 2


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _program(n: int, lane: int, dev):
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n, dev), threefry.key(1), 0.001, 0, 8), 0.01)
    prog = faults.as_program(plan, np.arange(n) % 4, capacity=1)
    return faults.with_segment(prog, 0, kind="gray", start=1, end=8,
                               level=0.2 + 0.2 * lane, domain=1)


def _arm(cfg, lanes: int | None, dev):
    """(period(t) -> None, the sharded step on 8 slots of `dev`): one
    serial lane's study period (`lanes` None) or a batch's."""
    n = cfg.n_nodes
    p = lanes or 1
    progs = [_program(n, i, dev) for i in range(p)]
    keys = [threefry.key(20 + i) for i in range(p)]
    plan = progs[0] if lanes is None else \
        faults.stack_programs(progs).program
    _, state, plans, step = ring_shard.start(cfg, plan, dev)
    shape = (n,) if lanes is None else (p, n)
    track = runner.StudyTrack(*(torch.full(shape, runner.NEVER,
                                           dtype=torch.int32, device=dev)
                                for _ in range(3)))
    held = {"state": state, "track": track}
    if lanes is None:
        stepper = runner.make_stepper(cfg, plans, ring.step, step)
        base = pmesh.assemble(faults.base_of(plans))

        def period(t):
            rnd, shifts = next(ring.period_draws(cfg, keys[0], t, 1,
                                                 dev))
            held["state"], held["track"], _, _ = runner.ring_study_period(
                cfg, held["state"], held["track"], base, rnd, stepper,
                shifts)
        return period, step
    vperiod = {}

    def period(t):
        rnd, shifts = next(ring.period_draws(cfg, keys, t, 1, dev))
        if not vperiod:
            vperiod["fn"] = runner.batch_period(cfg, "ring", rnd, step)
        held["state"], held["track"], _, _ = vperiod["fn"](
            held["state"], held["track"], plans, rnd, shifts)
    return period, step


def _top_kernels(events, periods: int, k: int = 12) -> list:
    """The device activities with the most device time a period, by
    name (cut to 60 characters), with their count a period."""
    ms, count = collections.Counter(), collections.Counter()
    for e in events:
        ms[e.name()[:60]] += e.duration_ns() / 1e6 / periods
        count[e.name()[:60]] += 1 / periods
    return [{"kernel": name, "ms": t, "count": count[name]}
            for name, t in ms.most_common(k)]


def profile_arm(cfg, lanes: int | None, periods: int, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    period, step = _arm(cfg, lanes, dev)
    clock = iter(range(10 ** 9))

    def run(n: int) -> float:
        """ms a period of n periods, the card synchronized after."""
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            period(next(clock))
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3 / n

    run(WARM)
    wall = run(periods)
    spent = {"step": 0.0}
    real = step._run

    def timed(*a, **kw):
        _sync(dev)
        s0 = time.perf_counter()
        out = real(*a, **kw)
        _sync(dev)
        spent["step"] += time.perf_counter() - s0
        return out

    step._run = timed
    synced = run(periods)
    step._run = real
    step_ms = spent["step"] * 1e3 / periods
    busy = kernels = 0.0
    top = []
    if torch.device(dev).type == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            run(periods)
        evs = [e for e in pr.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy = sum(e.duration_ns() for e in evs) / 1e6 / periods
        kernels, top = len(evs) / periods, _top_kernels(evs, periods)
    return {"arm": "serial lane" if lanes is None else f"batch P={lanes}",
            "n_nodes": cfg.n_nodes, "periods": periods, "wall_ms": wall,
            "step_ms": step_ms, "census_ms": synced - step_ms,
            "busy_ms": busy, "kernels": kernels,
            "idle_share": 1.0 - busy / wall, "top_kernels": top}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--lanes", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--periods", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = SwimConfig(n_nodes=args.nodes, telemetry=True)
    for lanes in [None, *args.lanes]:
        print(json.dumps(profile_arm(cfg, lanes, args.periods,
                                     args.device)), flush=True)
    if args.device != "cpu":
        print(card_line(), flush=True)


if __name__ == "__main__":
    main()

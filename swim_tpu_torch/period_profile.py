"""Where one ring period's time goes on the card.

    python3 -m swim_tpu_torch.period_profile [--nodes N] [--periods P]

Runs the period-scope rotor slice (0.1% of nodes crashing over the run)
on the CUDA card and prints one JSON line with

  * wall ms per period of `RingEngine.run` (host clock around a
    synchronised run), and the split between drawing the period's
    randomness (`draw_period_ring`) and `step` (CUDA events);
  * from torch.profiler over the same run: device-busy ms per period
    (the sum of the kernels' device time; one stream, so they do not
    overlap), the idle share 1 - busy / wall, kernel launches per
    period, and the aten ops that take the most device time.

The full profiler table goes to chiprun_out/period_profile.txt.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from swim_tpu_torch import SwimConfig
from swim_tpu_torch.models import ring
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import threefry


def _events_ms(fn, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--periods", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("period_profile: PyTorch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    n, p = args.nodes, args.periods
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    plan = faults.with_random_crashes(faults.none(n), gen, 0.001, 0,
                                      3 + 3 * p)
    eng = ring.RingEngine(cfg, plan, seed=0)
    eng.run(3)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    eng.run(p)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / p

    key = threefry.key(0)
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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(p)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels = [e for e in ka if e.device_type == cuda_type]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    ops = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    top_ops = [dict(op=e.key, device_ms=e.self_device_time_total / 1e3 / p,
                    calls=e.count / p) for e in ops[:12]]
    top_kernels = sorted(kernels, key=lambda e: e.self_device_time_total,
                         reverse=True)[:12]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "period_profile.txt").write_text(
        ka.table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(dict(
        card=card, n_nodes=n, periods=p, wall_ms_per_period=wall_ms,
        draw_ms=draw_ms, step_ms=step_ms,
        device_busy_ms_per_period=busy_us / 1e3 / p,
        idle_share=1.0 - (busy_us / 1e3 / p) / wall_ms,
        kernel_launches_per_period=launches / p,
        top_aten_ops_by_self_device_time=top_ops,
        top_kernels=[dict(kernel=e.key[:80],
                          device_ms=e.self_device_time_total / 1e3 / p,
                          calls=e.count / p) for e in top_kernels])),
        flush=True)


if __name__ == "__main__":
    main()

"""Batched studies from several checkouts of the repo, in turns: the
1M ring batch of chip_smoke.py's phase 11, the same batch on the
sharded ring (phase 16's) and one search generation.

    python3 -m swim_tpu_torch.batch_ab --trees _parent . [--rounds 1]

Each round runs one fresh process per tree in the order given and then
in reverse (for two trees: A B B A), each from that tree's root, so it
imports that tree's `swim_tpu_torch`; a checkout of another commit is
made with `git archive` into a git-ignored directory such as
`_parent/`.  A process runs on the card, each arm once to warm up and
once measured:

  * `batch`: `experiments._run_study_batch` with telemetry on at
    1,000,000 nodes (the default SwimConfig: rotor, wave scope), P = 3
    FaultPrograms (chip_smoke.py's program plan, the same with a gray
    segment at 0.6, and none), PERIODS periods;
  * `serial`: lane 0's study alone (`experiments._run_study`), the
    control for the host's speed and the batch's one-lane yardstick;
  * `search`: `search.explore(generations=1)` at its defaults (16
    candidates, 256 nodes, 48 periods as one batch);
  * `ringshard_batch`: the `batch` arm's programs and keys on the
    sharded ring (`_run_study_batch(..., "ringshard")`, D = 8 slots of
    the card), SHARD_PERIODS periods;
  * `ringshard_serial`: its three lanes' serial sharded studies, one
    after another.

For each: the wall seconds, the three kernels' launches, and the peak
(`torch.cuda.max_memory_allocated()` over the call less what was
allocated before); then `batch`, `serial` and the two ringshard arms
once more under torch.profiler for the kernels a period on the card
(the study's own set-up included; the serial sharded arm's are its
three lanes' together) and the kernels, by name (cut to 100
characters), the batch launches a period beyond one serial lane.  It
uses only calls that every checkout since the batched studies has.
Prints one JSON line a process and last a summary, with the card's name
and power limit.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from swim_tpu_torch.shard_period_ab import card_line, run_tree

N = 1_000_000
LANES = 3
PERIODS = 20
SHARD_PERIODS = 5

WORKER = f"""
import collections, json, time, torch
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.ops import coldsel, selb, wavemerge
from swim_tpu_torch.sim import experiments, faults, search
from swim_tpu_torch.utils import threefry
import numpy as np

N, P, T, TS = {N}, {LANES}, {PERIODS}, {SHARD_PERIODS}
cfg = SwimConfig(n_nodes=N, telemetry=True)
plan = faults.with_loss(faults.with_random_crashes(
    faults.none(N, "cuda"), threefry.key(1), 0.001, 0, T), 0.01)
prog = faults.as_program(plan, np.arange(N) % 4, capacity=2)
prog = faults.with_segment(prog, 0, kind="gray", start=2, end=T, level=0.3,
                           domain=1)
prog = faults.with_segment(prog, 1, kind="link_loss", start=4, end=T - 2,
                           level=0.5, domain=2)
gray = faults.with_segment(prog, 0, kind="gray", start=2, end=T, level=0.6,
                           domain=1)
progs = [prog, gray, faults.as_program(plan)][:P]
keys = [threefry.key(20 + p) for p in range(P)]
mods = (selb, coldsel, wavemerge)
arms = {{
    "batch": lambda: experiments._run_study_batch(cfg, progs, keys, T,
                                                  "ring"),
    "serial": lambda: experiments._run_study(cfg, progs[0], keys[0], T,
                                             "ring", "cuda"),
    "search": lambda: search.explore(generations=1),
    "ringshard_batch": lambda: experiments._run_study_batch(
        cfg, progs, keys, TS, "ringshard", device="cuda"),
    "ringshard_serial": lambda: [experiments._run_study(
        cfg, progs[p], keys[p], TS, "ringshard", "cuda") for p in range(P)],
}}
periods = {{"batch": T, "serial": T, "ringshard_batch": TS,
            "ringshard_serial": TS}}
out = {{}}
for name, fn in arms.items():
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        for m in mods:
            m.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        del res
    out[name] = {{"seconds": seconds, "peak_bytes": peak,
                  "launches": {{m.__name__.rsplit(".", 1)[1]: m.launches
                               for m in mods}}}}
counts = {{}}
for name in periods:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        arms[name]()
        torch.cuda.synchronize()
    counts[name] = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            counts[name][e.key[:100]] += e.count
    out[name]["kernels_per_period"] = (sum(counts[name].values())
                                       / periods[name])
more = {{k: (counts["batch"][k] - counts["serial"][k]) / T
        for k in counts["batch"].keys() | counts["serial"].keys()}}
out["batch"]["kernels_beyond_serial"] = dict(sorted(
    more.items(), key=lambda kv: -abs(kv[1]))[:12])
print(json.dumps(out))
"""


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="repo checkouts, each run from its root")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    trees = [Path(t).resolve() for t in args.trees]
    order = [t for _ in range(args.rounds) for t in trees + trees[::-1]]
    rows: dict = {str(t): {} for t in trees}
    for i, tree in enumerate(order):
        got = run_tree(tree, WORKER)
        print(json.dumps({"turn": i, "tree": str(tree), "n_nodes": N,
                          "lanes": LANES, "periods": PERIODS,
                          "shard_periods": SHARD_PERIODS, "arms": got}),
              flush=True)
        for arm, row in got.items():
            rows[str(tree)].setdefault(arm, []).append(row)
    print(json.dumps({"summary": rows, "card": card_line()}), flush=True)


if __name__ == "__main__":
    main()

"""Peak device memory of 1M studies started by
`experiments._run_study`, from several checkouts of the repo, in turns.

    python3 -m swim_tpu_torch.study_peak_ab --trees _parent . [--rounds 1]

Each round runs one fresh process per tree in the order given and then
in reverse (for two trees: A B B A), each from that tree's root, so it
imports that tree's `swim_tpu_torch`; a checkout of another commit is
made with `git archive` into a git-ignored directory such as
`_parent/`.  A process runs, one after the other on the card, each arm
once to warm up and once measured: the pull detection study (the study
default, 0.1% crashing) at 1,000,000 nodes for RING_PERIODS periods on
`ringshard` (pmesh.DEFAULT_SHARDS slots of the card) and on `ring`, and
the default SwimConfig's study under loss 0.1 (R = 4,096) for
RUMOR_PERIODS periods on `shard` and on `rumor`.  An arm's peak is
`torch.cuda.max_memory_allocated()` over the call less what was
allocated before it (nothing of the study is allocated before).  It
uses only calls that every checkout since the partitioned studies has.

Prints one JSON line a process (each arm's peak bytes and seconds) and
last a summary: for each tree and arm the peaks seen, with the card's
name and power limit.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from swim_tpu_torch.shard_period_ab import card_line, run_tree

N = 1_000_000
RING_PERIODS = 12
RUMOR_PERIODS = 4

WORKER = f"""
import json, time, torch
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.sim import experiments, faults
from swim_tpu_torch.utils import threefry

N, RP, UP = {N}, {RING_PERIODS}, {RUMOR_PERIODS}
key = threefry.key(0)
pull = SwimConfig(n_nodes=N, ring_probe="pull")
loss = SwimConfig(n_nodes=N)
ring_plan = experiments._crash_plan(N, 0, 0.001, RP, "cuda")
rumor_plan = faults.with_loss(experiments._crash_plan(N, 0, 0.001, UP,
                                                      "cuda"), 0.1)
arms = {{
    "ringshard": (pull, ring_plan, RP),
    "ring": (pull, ring_plan, RP),
    "shard": (loss, rumor_plan, UP),
    "rumor": (loss, rumor_plan, UP),
}}
out = {{}}
for name, (cfg, plan, periods) in arms.items():
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = experiments._run_study(cfg, plan, key, periods, name, "cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        del res
    out[name] = {{"peak_bytes": peak, "seconds": seconds}}
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
    peaks: dict = {str(t): {} for t in trees}
    for i, tree in enumerate(order):
        got = run_tree(tree, WORKER)
        print(json.dumps({"turn": i, "tree": str(tree), "n_nodes": N,
                          "arms": got}), flush=True)
        for arm, row in got.items():
            peaks[str(tree)].setdefault(arm, []).append(row["peak_bytes"])
    print(json.dumps({"summary": peaks, "card": card_line()}), flush=True)


if __name__ == "__main__":
    main()

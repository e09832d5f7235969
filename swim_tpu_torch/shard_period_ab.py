"""Wall a period of the sharded ring engine at 1M, from several
checkouts of the repo, in turns.

    python3 -m swim_tpu_torch.shard_period_ab --trees _parent . [--rounds 2]

Each round runs one fresh process per tree in the order given and then
in reverse (for two trees: A B B A), each from that tree's root, so it
imports that tree's `swim_tpu_torch`; a checkout of another commit is
made with `git archive` into a git-ignored directory such as
`_parent/`.  A process times the period of chip_smoke.py's phase 16
timing: the default SwimConfig (wave scope) at 1,000,000 nodes, 0.1%
crashing, `ring_shard.build_run` over PERIODS periods on
pmesh.DEFAULT_SHARDS slots of the card, after one warm-up run, REPS
times from the same placed state (its `cold` cloned each time); then
the one-device `ring.run` the same way, a control for the host's speed.
It uses only calls that every checkout since the sharded engine has.

Prints one JSON line a process (its wall ms a period, each rep) and
last a summary: for each tree and arm the median, min and max over all
its reps, with the card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

PERIODS = 5
REPS = 5

WORKER = f"""
import json, time, torch
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.models import ring
from swim_tpu_torch.parallel import mesh as pmesh, ring_shard
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import threefry

P, REPS = {PERIODS}, {REPS}
cfg = SwimConfig(n_nodes=1_000_000)
plan = faults.with_random_crashes(faults.none(cfg.n_nodes, "cuda"),
                                  threefry.key(1), 0.001, 0, 2 * P)
mesh = pmesh.make_mesh(devices=["cuda"] * pmesh.DEFAULT_SHARDS)
placed, placed_plan = ring_shard.place(cfg, mesh,
                                       ring.init_state(cfg, "cuda"), plan)
run = ring_shard.build_run(cfg, mesh, P)
single = ring.init_state(cfg, "cuda")
arms = {{
    "ringshard": lambda: run(placed._replace(cold=pmesh.Sharded(
        [b.clone() for b in placed.cold.blocks], placed.cold.axis)),
        placed_plan, threefry.key(0)),
    "one_device": lambda: ring.run(cfg, single._replace(
        cold=single.cold.clone()), plan, 0, P),
}}
out = {{}}
for name, fn in arms.items():
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / P)
    out[name] = walls
print(json.dumps(out))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def run_tree(tree: Path, worker: str = WORKER) -> dict:
    """The JSON last line of `worker` run in a fresh process from
    `tree`'s root."""
    proc = subprocess.run([sys.executable, "-c", worker], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="repo checkouts, each run from its root")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    trees = [Path(t).resolve() for t in args.trees]
    order = [t for _ in range(args.rounds) for t in trees + trees[::-1]]
    walls: dict = {str(t): {} for t in trees}
    for i, tree in enumerate(order):
        got = run_tree(tree)
        print(json.dumps({"turn": i, "tree": str(tree), "periods": PERIODS,
                          "wall_ms_per_period": got}), flush=True)
        for arm, ws in got.items():
            walls[str(tree)].setdefault(arm, []).extend(ws)
    summary = {tree: {arm: {"median": statistics.median(ws), "min": min(ws),
                            "max": max(ws), "reps": len(ws)}
                      for arm, ws in arms.items()}
               for tree, arms in walls.items()}
    print(json.dumps({"summary": summary, "card": card_line()}), flush=True)


if __name__ == "__main__":
    main()

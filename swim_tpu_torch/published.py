"""The JAX package's published studies, run by the port at their own
sizes and horizons and held field by field to what that package
published under `bench_results/`.

    python3 -m swim_tpu_torch.published [--only ROW ...]

runs every row (or the named ones) on the card, after two untimed
periods of the witness's study, and prints one JSON line a row, then
the card's name and power limit.  Each row's line holds
whether the port's result equals the published one, the fields that
differ (with both values), and what the run cost: its wall, the device
busy ms a period from a second run under torch.profiler (which must
give the same result), the idle share, the
peak memory over what was held before, the device activities a period,
and the three kernels' launches a period beside the launches the
configurations call for (zeroed just before the bare run, read just
after it); a row that is not asserted prints its whole result beside
the artifact's.  A row whose result differs where it is asserted, or
whose launches are not the expected ones, makes the command exit 1.

Rows, each the command the artifact names, through the port's own
entry point:

  witness             `study suspicion_sweep --nodes 1000000 --engine
                      ring --periods 100 --mults 2.0 --losses 0.02`
                      (cli.main), held to determinism_witness_1m.json's
                      `tpu_result`;
  witness_ringshard   the same on `--engine ringshard` (D = 8 slots of
                      the card), held to its `cpu_result`, the ring
                      result but for the engine's name;
  suspicion_1m        study_suspicion_1m.json's `cmd`: 5 mults x 2
                      losses, 100 periods, every field of the 10 points;
  lifeguard_1m        study_lifeguard_1m.json's `cmd`: Lifeguard off and
                      on at ring_orig_words 2 and 8 (`--budget-arms`);
  suspicion_4m_sized  `experiments.suspicion_sweep(n=4_000_000,
                      mults=(2.0,), losses=(0.02,), crash_fraction=
                      0.0002, periods=60, engine="ring",
                      ring_orig_words=4)` beside
                      study_suspicion_4m_sized.json;
  suspicion_4m        the same at ring_orig_words 2, beside
                      study_suspicion_4m.json;
  sized_4m_ringshard  the sized call on `ringshard` (the reference's
                      scripts/sized_4m_arm.py), held to the port's own
                      `suspicion_4m_sized` result;
  geometry            the three arms of geometry_ablation.json (1M
                      nodes, 50 periods of `ring.run` under 0.1% crashes
                      with the key folded with 99): each arm's
                      `overflow` and `geometry`;
  pull_law            pull_law_131k.json: 131,072 nodes, 48 crashes at
                      period 2, 5 seeds, 30 periods of the pull-probe
                      study, the first-suspicion latencies KS-tested
                      against Geometric(p) at alpha = 0.01; every field
                      but `wall_seconds` and `platform`.

The 4M rows are printed beside their artifacts and not asserted: no
JAX run at 4M can arbitrate here (a 4M study needs about 77.5 GB of
XLA:CPU temporaries).  Were an artifact older than the JAX package's
code, its row would be held to what that package computes instead.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.measure import (busy_ms, launches_a_period,
                                    read_launches, reset_launches)
from swim_tpu_torch.models import ring
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.utils import threefry

RESULTS = Path(__file__).resolve().parent.parent / "bench_results"
KERNELS = ("selb", "coldsel", "wavemerge")

# the sized 4M call (scripts/sized_4m_arm.py, minus its engine)
SIZED_4M = dict(n=4_000_000, mults=(2.0,), losses=(0.02,),
                crash_fraction=0.0002, periods=60, seed=0)

# scripts/geometry_ablation.py's arms: SwimConfig keywords
GEOMETRY_ARMS = {
    "default": {},
    "period": dict(ring_sel_scope="period"),
    "lean": dict(ring_sel_scope="period", suspicion_mult=2.0,
                 retransmit_mult=2.0, k_indirect=1, ring_window_periods=3,
                 ring_view_c=2),
}
GEOMETRY_N, GEOMETRY_PERIODS = 1_000_000, 50

# scripts/pull_law_131k.py's defaults
PULL_LAW = dict(n=131_072, crashes=48, seeds=5, periods=30)
PULL_CRASH_AT = 2


# ------------------------------------------------ the ported computations

def study_cli(argv: list, device=None) -> dict:
    """`swim-tpu-torch <argv>` through cli.main on `device` (None: the
    card), its printed result."""
    from swim_tpu_torch import cli

    pre = [] if device is None else ["--device", str(device)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(pre + list(argv))
    if rc != 0:
        raise RuntimeError(f"swim-tpu-torch {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def geometry_arm(name: str, n: int = GEOMETRY_N,
                 periods: int = GEOMETRY_PERIODS, device=None):
    """One arm of the geometry ablation: `periods` of `ring.run` from a
    fresh state under 0.1% crashes in [0, periods), the root key
    `fold_in(key(0), 99)` (the ablation's first dispatch).  (arm's
    fields, final state)."""
    dev = devmod.resolve(device)
    cfg = SwimConfig(n_nodes=n, **GEOMETRY_ARMS[name])
    g = ring.geometry(cfg)
    plan = faults.with_random_crashes(faults.none(n, dev), threefry.key(1),
                                      0.001, 0, periods)
    state = ring.init_state(cfg, dev)
    key = threefry.fold_in(threefry.key(0), 99)
    for rnd in ring.period_randomness(cfg, key, 0, periods, dev):
        state = ring.step(cfg, state, plan, rnd)
    arm = {"arm": name, "n": n, "periods": periods,
           "overflow": int(state.overflow),
           "geometry": {"ww": g.ww, "rw": g.rw, "c": g.c,
                        "k": cfg.k_indirect,
                        "sel_scope": cfg.ring_sel_scope,
                        "suspicion_mult": cfg.suspicion_mult}}
    return arm, state


def geometry_ablation(n: int = GEOMETRY_N, periods: int = GEOMETRY_PERIODS,
                      device=None) -> dict:
    return {"n": n, "periods": periods,
            "arms": [geometry_arm(name, n, periods, device)[0]
                     for name in GEOMETRY_ARMS]}


def pull_law(n: int = PULL_LAW["n"], crashes: int = PULL_LAW["crashes"],
             seeds: int = PULL_LAW["seeds"],
             periods: int = PULL_LAW["periods"], device=None) -> dict:
    """The SWIM e/(e-1) first-detection law on the pull-probe ring
    study: `crashes` nodes spread evenly over the ids crash at period 2,
    one study a seed; the first-suspicion latencies of all seeds
    KS-tested against Geometric(p), p = 1 - (1 - 1/(N-1))^live, at
    alpha = 0.01."""
    dev = devmod.resolve(device)
    cfg = SwimConfig(n_nodes=n, ring_probe="pull")
    budget = 32 * cfg.ring_orig_words
    if crashes > budget - 8:
        raise ValueError(f"{crashes} crashes at once would saturate the "
                         f"origination budget ({budget} a period)")
    victims = np.linspace(0, n - 1, crashes).astype(np.int32)
    lats = []
    t0 = time.perf_counter()
    for seed in range(seeds):
        plan = faults.with_crashes(faults.none(n, dev), victims,
                                   PULL_CRASH_AT)
        res = runner.run_study_ring(cfg, ring.init_state(cfg, dev), plan,
                                    threefry.key(seed), periods)
        first = res.track.first_suspect.cpu().numpy()[victims]
        detected = first != int(runner.NEVER)
        lats.append(first[detected].astype(np.int64) - PULL_CRASH_AT + 1)
        del res
    lats = np.concatenate(lats)
    elapsed = time.perf_counter() - t0
    live = n - crashes
    p = 1.0 - (1.0 - 1.0 / (n - 1)) ** live
    ks_k = np.arange(0, int(lats.max()) + 1)
    emp = np.searchsorted(np.sort(lats), ks_k, side="right") / len(lats)
    d = float(np.abs(emp - (1.0 - (1.0 - p) ** ks_k)).max())
    crit = 1.628 / math.sqrt(len(lats))
    return {"study": "pull_detection_law", "n": n,
            "crashes_per_seed": crashes, "seeds": seeds,
            "periods": periods, "engine": "ring", "ring_probe": "pull",
            "platform": dev.type, "samples": int(len(lats)),
            "latency_mean": float(lats.mean()), "expected_mean": 1.0 / p,
            "e_over_e_minus_1": math.e / (math.e - 1.0),
            "ks_distance": d, "ks_critical_alpha01": crit,
            "ks_pass": d < crit, "wall_seconds": round(elapsed, 1)}


def sized_sweep(engine: str, ring_orig_words: int, device=None,
                **kw) -> dict:
    """The sized 4M suspicion call on `engine` (kw overrides SIZED_4M)."""
    from swim_tpu_torch.sim import experiments

    return experiments.suspicion_sweep(
        **{**SIZED_4M, **kw}, engine=engine, device=device,
        ring_orig_words=ring_orig_words)


# ------------------------------------------------------------ the rows

@dataclass(frozen=True)
class Row:
    artifact: str
    run: Callable[[], dict]          # the port's result, on the card
    want: Callable[[dict, dict], dict]   # (artifact, done rows) -> value
    # (SwimConfig, engine, periods) of each study the row runs
    studies: Callable[[], list]
    asserted: bool = True
    # fields left out of the comparison
    skip: tuple = ()
    what: str = ""


def _argv(cmd) -> list:
    """An artifact's command as the port's CLI arguments."""
    words = cmd.split() if isinstance(cmd, str) else list(cmd)
    return words[words.index("study"):]


def _artifact(name: str) -> dict:
    return json.loads((RESULTS / name).read_text())


def _swapped_engine(argv: list, engine: str) -> list:
    out = list(argv)
    out[out.index("--engine") + 1] = engine
    return out


def _sweep_studies(n, mults, losses, periods, engine="ring", **kw):
    return [(SwimConfig(n_nodes=n, suspicion_mult=m, **kw), engine, periods)
            for _ in losses for m in mults]


def _lifeguard_studies(n, periods, engine="ring"):
    return [(SwimConfig(n_nodes=n, lifeguard=lg, ring_orig_words=ow),
             engine, periods) for ow in (2, 8) for lg in (False, True)]


WITNESS = "determinism_witness_1m.json"


def _witness_argv() -> list:
    return _argv(_artifact(WITNESS)["tpu_cmd"])


def _published(key: str | None = "result"):
    """`want` of a row held to an artifact's field (None: the whole
    artifact)."""
    return lambda art, done: art if key is None else art[key]


ROWS: dict[str, Row] = {
    "witness": Row(
        WITNESS, lambda: study_cli(_witness_argv()),
        _published("tpu_result"),
        lambda: _sweep_studies(1_000_000, (2.0,), (0.02,), 100),
        what="1M suspicion point (lambda 2, loss 0.02), 100 periods"),
    "witness_ringshard": Row(
        WITNESS,
        lambda: study_cli(_swapped_engine(_witness_argv(), "ringshard")),
        _published("cpu_result"),
        lambda: _sweep_studies(1_000_000, (2.0,), (0.02,), 100,
                               engine="ringshard"),
        what="the witness point on ringshard, D = 8"),
    "suspicion_1m": Row(
        "study_suspicion_1m.json",
        lambda: study_cli(_argv(_artifact("study_suspicion_1m.json")["cmd"])),
        _published(),
        lambda: _sweep_studies(1_000_000, (1.0, 2.0, 3.0, 4.0, 6.0),
                               (0.02, 0.05), 100),
        what="1M suspicion grid, 5 mults x 2 losses, 100 periods"),
    "lifeguard_1m": Row(
        "study_lifeguard_1m.json",
        lambda: study_cli(_argv(_artifact("study_lifeguard_1m.json")["cmd"])),
        _published(),
        lambda: _lifeguard_studies(1_000_000, 100),
        what="1M Lifeguard off / on at ring_orig_words 2 and 8"),
    "suspicion_4m_sized": Row(
        "study_suspicion_4m_sized.json", lambda: sized_sweep("ring", 4),
        _published(),
        lambda: _sweep_studies(4_000_000, (2.0,), (0.02,), 60,
                               ring_orig_words=4),
        asserted=False, what="4M suspicion point at ring_orig_words 4"),
    "suspicion_4m": Row(
        "study_suspicion_4m.json", lambda: sized_sweep("ring", 2),
        _published(),
        lambda: _sweep_studies(4_000_000, (2.0,), (0.02,), 60),
        asserted=False, what="4M suspicion point at ring_orig_words 2"),
    "sized_4m_ringshard": Row(
        "study_suspicion_4m_sized.json",
        lambda: sized_sweep("ringshard", 4),
        lambda art, done: {**done["suspicion_4m_sized"],
                           "engine": "ringshard"},
        lambda: _sweep_studies(4_000_000, (2.0,), (0.02,), 60,
                               engine="ringshard", ring_orig_words=4),
        what="the sized 4M call on ringshard, D = 8, against ring"),
    "geometry": Row(
        "geometry_ablation.json", geometry_ablation,
        lambda art, done: {"n": art["n"], "periods": art["periods"],
                           "arms": [{k: a[k] for k in
                                     ("arm", "n", "periods", "overflow",
                                      "geometry")} for a in art["arms"]]},
        lambda: [(SwimConfig(n_nodes=GEOMETRY_N, **kw), "ring",
                  GEOMETRY_PERIODS) for kw in GEOMETRY_ARMS.values()],
        what="1M geometry arms, 50 periods of ring.run"),
    "pull_law": Row(
        "pull_law_131k.json", pull_law, _published(None),
        lambda: [(SwimConfig(n_nodes=PULL_LAW["n"], ring_probe="pull"),
                  "ring", PULL_LAW["periods"])] * PULL_LAW["seeds"],
        skip=("wall_seconds", "platform"),
        what="131,072-node pull law, 5 seeds x 30 periods"),
}


def differing(got, want, path: str = "") -> list:
    """The paths at which two JSON values differ."""
    if isinstance(want, dict) and isinstance(got, dict):
        out = []
        for k in sorted(set(want) | set(got), key=str):
            sub = f"{path}.{k}" if path else str(k)
            if k not in got or k not in want:
                out.append(sub)
            else:
                out += differing(got[k], want[k], sub)
        return out
    if isinstance(want, list) and isinstance(got, list) \
            and len(want) == len(got):
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += differing(g, w, f"{path}[{i}]")
        return out
    return [] if got == want else [path]


def _at(value, path: str):
    for part in path.replace("[", ".[").split("."):
        if not part:
            continue
        if part.startswith("["):
            value = value[int(part[1:-1])]
        else:
            value = value.get(part) if isinstance(value, dict) else None
    return value


def _plain(x):
    return json.loads(json.dumps(x))


def _without(d: dict, keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def run_row(name: str, done: dict, card: str, profile: bool = True
            ) -> dict:
    """Run row `name` on the card, bare and (with `profile`) again under
    torch.profiler; its line.  `done` maps the names of rows already run
    to their port results and gains this one's."""
    row = ROWS[name]
    studies = row.studies()
    periods = sum(p for _, _, p in studies)
    expected = {k: 0 for k in KERNELS}
    for cfg, engine, p in studies:
        for k, v in launches_a_period(cfg, engine).items():
            expected[k] += v * p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    got = _plain(row.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - before
    line = {"published": name, "what": row.what, "artifact":
            f"bench_results/{row.artifact}", "asserted": row.asserted}
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = _plain(row.run())
            torch.cuda.synchronize()
        if differing(_without(again, row.skip), _without(got, row.skip)):
            raise AssertionError(f"{name}: the profiled run gave another "
                                 "result")
        busy, acts = busy_ms(prof)
        line.update(busy_ms_per_period=busy / periods,
                    idle_share=1.0 - busy / (wall * 1e3),
                    device_activities_per_period=acts / periods)
    cmp_want = _without(_plain(row.want(_artifact(row.artifact), done)),
                        row.skip)
    cmp_got = _without(got, row.skip)
    diff = differing(cmp_got, cmp_want)
    done[name] = got
    line.update(
        equal=not diff, differ=diff,
        port={p: _at(cmp_got, p) for p in diff},
        reference={p: _at(cmp_want, p) for p in diff},
        periods=periods, wall_s=wall, wall_ms_per_period=wall * 1e3 / periods,
        peak_bytes=peak, allocated_before=before,
        launches=launches,
        launches_per_period={k: v / periods for k, v in launches.items()},
        launches_expected=expected, launches_ok=launches == expected,
        card=card)
    if not row.asserted:
        # printed whole beside the artifact's, not held to it
        line.update(port_result=cmp_got, artifact_result=cmp_want)
    if name == "pull_law":
        line["ks_pass"] = got["ks_pass"]
    return line


def warm_up(device=None) -> float:
    """Two periods of the witness's 1M study, untimed, so that the first
    timed row does not pay for what a process pays once (the kernels'
    loading, the allocator's first blocks); its seconds."""
    from swim_tpu_torch.sim import experiments

    t0 = time.perf_counter()
    experiments.suspicion_sweep(n=1_000_000, mults=(2.0,), losses=(0.02,),
                                periods=2, engine="ring", device=device)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python3 -m swim_tpu_torch.published",
        description="the JAX package's published studies on the card, "
                    "each held field by field to its artifact")
    p.add_argument("--only", nargs="+", choices=list(ROWS), default=None)
    args = p.parse_args(argv)
    names = [n for n in ROWS if args.only is None or n in args.only]
    if "sized_4m_ringshard" in names and "suspicion_4m_sized" not in names:
        p.error("sized_4m_ringshard is held to suspicion_4m_sized's "
                "result: run both")
    if not torch.cuda.is_available():
        print("published: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    from swim_tpu_torch import _kernels
    from swim_tpu_torch.measure import card_line

    card = card_line()
    print(json.dumps({"card": card, "build_s": _kernels.build(),
                      "warm_up_s": warm_up()}), flush=True)
    done: dict = {}
    bad = []
    t0 = time.perf_counter()
    for name in names:
        line = run_row(name, done, card)
        print(json.dumps(line), flush=True)
        if (line["asserted"] and not line["equal"]) \
                or not line["launches_ok"] \
                or (name == "pull_law" and not line["ks_pass"]):
            bad.append(name)
    print(json.dumps({"published": "done", "rows": list(done), "failed": bad,
                      "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    print(card, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

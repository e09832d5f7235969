"""Coverage-guided adversarial search over fault-program parameters
(port of `swim_tpu/sim/search.py`).

It maps where the detector breaks, as the scenario library's hand
calibration did: every generation compiles P mutated candidates at one
segment capacity and runs them as one batch
(`experiments._run_study_batch`: one step a period over the P lanes,
on one device or partitioned over several, each kernel launched once a
period for all of them).

  * `explore`: novelty-guided mutation over (kind, level, window, duty
    cycle, domain, crash co-injection).  Each lane reduces to a coarse
    behaviour signature (log-bucketed false-dead peak and final,
    suspect volume, incarnation ceiling, undetected crashes); the archive
    keeps the first candidate of each signature, and parents are drawn
    from the candidates that opened new signatures.  Violations: a
    sticky false death under the full Lifeguard stack, a false-dead
    storm, an undetected crash.
  * `refine_boundary`: batched bisection of `level` for one candidate
    shape; each generation evaluates a P-point grid over the bracket and
    tightens it to [max clean, min violating].

Deterministic given `seed` (numpy's default_rng for mutation, fixed
engine keys); the report is a byte-stable JSON artifact (sorted keys,
no timestamps), the reference's for the same arguments.  Entry points
run on the CUDA card unless `device` names another.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.sim import faults, scenario
from swim_tpu_torch.utils import threefry

NEVER = 2**31 - 1

# The searched geometry: the library's flap/gray anchor (n=256, 8 racks,
# full Lifeguard stack on the packed rotor wire), identical to the
# library scenarios so a found boundary transplants into the library.
SEARCH_N = 256
SEARCH_PERIODS = 48
SEARCH_DOMAINS = "blocks:8"
SEARCH_CONFIG: Mapping[str, Any] = {
    "ring_probe": "rotor", "ring_scalar_wire": "packed",
    "ring_sel_scope": "period", "lifeguard": True, "buddy": True,
}
# one lane-event slot (crash co-injections fold into the base plan), so
# every candidate's program has one shape
SEARCH_CAPACITY = 1


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in the fault-parameter space (JSON-able)."""

    kind: str = "link_loss"     # link_loss | gray | send_loss | recv_loss
    level: float = 0.2          # loss probability of the lane event
    start: int = 8              # window first period (inclusive)
    end: int = 40               # window last period (exclusive)
    period: int = 0             # flap cycle (0 = always on in window)
    on: int = 0                 # on-duty periods per cycle
    domain: int = 3             # target rack
    crash_domain: int = -1      # -1 = none; else that rack crash-stops
    crash_start: int = 12

    def events(self) -> tuple:
        ev: list[dict] = [{
            "kind": self.kind, "start": self.start, "end": self.end,
            "level": round(float(self.level), 6),
            "domain": self.domain,
            "period": self.period, "on": self.on,
        }]
        if self.crash_domain >= 0:
            ev.append({"kind": "crash", "domain": self.crash_domain,
                       "start": self.crash_start})
        return tuple(ev)

    def to_scenario(self, name: str, seed: int = 0,
                    **overrides) -> scenario.Scenario:
        return scenario.Scenario(
            name=name, n=SEARCH_N, periods=SEARCH_PERIODS, engine="ring",
            seed=seed, config=dict(SEARCH_CONFIG),
            domains=SEARCH_DOMAINS, capacity=SEARCH_CAPACITY,
            events=self.events(), **overrides)

    def spec_dict(self) -> dict:
        return dataclasses.asdict(self)


def _compile(cand: Candidate, seed: int, device) -> faults.FaultProgram:
    return scenario.compile_program(cand.to_scenario("search", seed=seed),
                                    device)


def run_generation(cands: list[Candidate], seed: int = 0, device=None):
    """One batch over a candidate population (all share the search
    geometry and config: one batch group).  Returns the batched study
    result."""
    from swim_tpu_torch.sim import experiments

    dev = devmod.resolve(device)
    cfg = SwimConfig(n_nodes=SEARCH_N, telemetry=True, **SEARCH_CONFIG)
    progs = [_compile(c, seed, dev) for c in cands]
    keys = [threefry.key(seed) for _ in cands]
    return experiments._run_study_batch(
        cfg, progs, keys, SEARCH_PERIODS, "ring",
        capacity=SEARCH_CAPACITY, device=dev)


def lane_signature(res, cand: Candidate) -> dict:
    """Coarse behaviour signature + raw observables for one lane."""
    from swim_tpu_torch.sim import runner

    series = runner.host_series(res.series)
    fd = series.false_dead_views
    susp = series.suspect_views
    inc = series.max_incarnation
    first_dead = res.track.first_dead_view.cpu().numpy()
    # undetected crashes: crashed early enough that detection is due
    # (>= 8 periods of margin), yet no DEAD view ever formed
    undetected = 0
    crashed_due = 0
    if cand.crash_domain >= 0:
        dom = scenario.domain_labels(SEARCH_N, SEARCH_DOMAINS)
        members = np.nonzero(dom == cand.crash_domain)[0]
        if cand.crash_start <= SEARCH_PERIODS - 8:
            crashed_due = int(members.size)
            undetected = int((first_dead[members] == NEVER).sum())

    def bucket(v: int) -> int:
        return 0 if v <= 0 else int(math.log10(v)) + 1

    obs = {
        "false_dead_peak": int(fd.max()),
        "false_dead_final": int(fd[-1]),
        "suspect_peak": int(susp.max()),
        "max_incarnation": int(inc.max()),
        "crashed_due": crashed_due,
        "undetected_crashes": undetected,
    }
    sig = (bucket(obs["false_dead_peak"]), bucket(obs["false_dead_final"]),
           bucket(obs["suspect_peak"]), bucket(obs["max_incarnation"]),
           1 if undetected else 0)
    return {"signature": sig, **obs}


def violations_of(sig: dict, cand: Candidate) -> list[str]:
    """Which detector-breaking behaviours this lane shows.  Every
    candidate runs the full Lifeguard stack, so a false death here is
    the detector failing."""
    out = []
    if sig["false_dead_final"] > 0:
        out.append("sticky_false_dead")
    if sig["false_dead_peak"] >= 100:
        out.append("false_dead_storm")
    if sig["undetected_crashes"] > 0:
        out.append("undetected_crash")
    return out


def _mutate(cand: Candidate, rng: np.random.Generator) -> Candidate:
    """Perturb one or two parameters (bounded to the valid spec box)."""
    d = dataclasses.asdict(cand)
    for _ in range(int(rng.integers(1, 3))):
        which = rng.choice(["level", "window", "duty", "domain", "kind",
                            "crash"])
        if which == "level":
            d["level"] = float(np.clip(
                d["level"] + rng.normal(0, 0.12), 0.02, 0.98))
        elif which == "window":
            d["start"] = int(rng.integers(2, 20))
            d["end"] = int(d["start"]
                           + rng.integers(6, SEARCH_PERIODS - d["start"]))
        elif which == "duty":
            if rng.random() < 0.3:
                d["period"], d["on"] = 0, 0
            else:
                d["period"] = int(rng.integers(2, 9))
                d["on"] = int(rng.integers(1, d["period"] + 1))
        elif which == "domain":
            d["domain"] = int(rng.integers(0, 8))
        elif which == "kind":
            d["kind"] = str(rng.choice(
                ["link_loss", "gray", "send_loss", "recv_loss"]))
        elif which == "crash":
            if rng.random() < 0.5:
                d["crash_domain"] = -1
            else:
                d["crash_domain"] = int(rng.integers(0, 8))
                d["crash_start"] = int(rng.integers(4, 30))
        if d["crash_domain"] == d["domain"]:
            d["crash_domain"] = -1   # crashing the faulted rack masks it
    d["end"] = int(min(d["end"], SEARCH_PERIODS))
    return Candidate(**d)


def explore(generations: int = 4, pop: int = 16, seed: int = 0,
            device=None) -> dict:
    """Novelty-guided exploration: returns the archive + violations."""
    from swim_tpu_torch.sim import runner

    rng = np.random.default_rng(seed)
    seedling = Candidate()
    archive: dict[tuple, dict] = {}
    violations: list[dict] = []
    parents = [seedling]
    evaluated = 0
    for gen in range(generations):
        cands = []
        for i in range(pop):
            if i < 2 or not parents:
                base = seedling
            else:
                base = parents[int(rng.integers(0, len(parents)))]
            cands.append(_mutate(base, rng))
        res_b = run_generation(cands, seed=seed, device=device)
        fresh = []
        for lane, cand in enumerate(cands):
            sig = lane_signature(runner.lane_result(res_b, lane), cand)
            evaluated += 1
            key = sig["signature"]
            if key not in archive:
                archive[key] = {"candidate": cand.spec_dict(),
                                "generation": gen, **sig,
                                "signature": list(key)}
                fresh.append(cand)
            for v in violations_of(sig, cand):
                violations.append({"violation": v, "generation": gen,
                                   "candidate": cand.spec_dict(), **sig,
                                   "signature": list(key)})
        # novelty guidance: parents are the candidates that just opened
        # new signature cells (the whole archive when a generation goes
        # dry)
        parents = fresh or [Candidate(**a["candidate"])
                            for a in archive.values()]
    return {
        "generations": generations, "pop": pop, "seed": seed,
        "evaluated": evaluated,
        "archive": sorted(archive.values(),
                          key=lambda a: a["signature"]),
        "violations": violations,
    }


def refine_boundary(template: Candidate,
                    predicate: Callable[[dict], bool] | None = None,
                    lo: float = 0.02, hi: float = 0.98,
                    pop: int = 16, tol: float = 0.005,
                    max_generations: int = 6, seed: int = 0,
                    device=None) -> dict:
    """Batched bisection of the `level` frontier for one candidate
    shape: per generation, evaluate a `pop`-point grid spanning the
    bracket and tighten it to [max clean level, min violating level]."""
    from swim_tpu_torch.sim import runner

    if predicate is None:
        predicate = lambda sig: sig["false_dead_final"] > 0  # noqa: E731
    history = []
    for gen in range(max_generations):
        levels = list(np.linspace(lo, hi, pop))
        cands = [dataclasses.replace(template, level=float(lv))
                 for lv in levels]
        res_b = run_generation(cands, seed=seed, device=device)
        sigs = [lane_signature(runner.lane_result(res_b, lane), c)
                for lane, c in enumerate(cands)]
        viol = [bool(predicate(s)) for s in sigs]
        new_lo, new_hi = lo, hi
        for lv, v in zip(levels, viol):
            if not v and lv > new_lo:
                # highest clean level below the first violation only: a
                # non-monotone pocket must not fold the bracket past a
                # violating level
                if not any(vv and lx < lv for lx, vv in zip(levels, viol)):
                    new_lo = lv
        for lv, v in zip(levels, viol):
            if v:
                new_hi = min(new_hi, lv)
                break
        history.append({"generation": gen, "lo": lo, "hi": hi,
                        "grid": [round(float(lv), 6) for lv in levels],
                        "violating": viol})
        if not any(viol):
            return {"found": False, "lo": lo, "hi": hi,
                    "history": history,
                    "note": "no violation in bracket"}
        lo, hi = new_lo, new_hi
        if hi - lo <= tol:
            break
    return {
        "found": True,
        "clean_level": round(float(lo), 6),
        "violation_level": round(float(hi), 6),
        "width": round(float(hi - lo), 6),
        "template": template.spec_dict(),
        "history": history,
    }


def search(generations: int = 4, pop: int = 16, seed: int = 0,
           out: str | None = None, device=None) -> dict:
    """The full search: explore, then refine the flap false-dead
    frontier (the library's `flap_boundary` scenario is this report's
    committed form).  Deterministic given `seed`; the report is a
    byte-stable JSON artifact when `out` is given."""
    dev = devmod.resolve(device)
    report: dict[str, Any] = {"kind": "scenario_search", "version": 1,
                              "n": SEARCH_N, "periods": SEARCH_PERIODS,
                              "config": dict(SEARCH_CONFIG),
                              "domains": SEARCH_DOMAINS}
    report["explore"] = explore(generations=generations, pop=pop,
                                seed=seed, device=dev)
    flap = Candidate(kind="link_loss", start=8, end=40, period=6, on=3,
                     domain=3)
    report["boundary"] = refine_boundary(flap, pop=pop, seed=seed,
                                         device=dev)
    if out:
        scenario.write_verdict(report, out)
        report["artifact"] = out
    return report

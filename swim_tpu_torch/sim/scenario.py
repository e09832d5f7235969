"""Scenario compiler and library (port of `swim_tpu/sim/scenario.py`).

A `Scenario` is a small declarative fault spec that compiles to a
`sim/faults.py` FaultProgram: correlated domain (rack) failures,
asymmetric and flapping links, gray failures (a node alive and
gossiping whose acks get lost).  The reference's module docstring holds
the spec grammar and its rationale; docs/SCENARIOS.md the library table
and the artifact format.

Every arm of a scenario runs the study runner with telemetry on, and its
frames, plus the fault-schedule gauges `gray_nodes` and `flap_active`,
feed the health monitor and the flight recorder; the dump is replayed
through the offline analyzer.  A packed rotor arm with a program embeds
the byte bill of its lanes on the sharded layout (obs/ici.py).  `run`
writes a diffable verdict artifact: sorted keys, no timestamps, and
the same bytes as the reference's for the same spec (the paths under
`out_dir` aside).  `run(batch=True)` runs the arms sharing a SwimConfig
as one batch (`experiments._run_study_batch`, lane by lane) with the
same verdict.

Entry points run on the CUDA card unless `device` names another.
`engine="real"` (`replay_storm`) runs a core/cluster.py SimCluster of
real nodes on the host; `ringshard` arms run the sharded ring engine
(parallel/ring_shard.py), whose verdicts are the `ring` arms' but for
the engine's name.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Any, Mapping, Sequence

import numpy as np

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import threefry

VERDICT_KIND = "scenario_verdict"
VERDICT_VERSION = 1

ENGINES = ("auto", "dense", "rumor", "ring", "ringshard", "real")

# event keys: required / optional-with-default (validation table)
_EVENT_KEYS = {"kind", "start", "end", "level", "domain", "nodes",
               "period", "on"}

# arm-spec keys: "config" overrides SwimConfig knobs; "gate" opts the
# arm out of the observatory error gate (ablation contrast arms); the
# rest override the scenario's own fault fields for that arm
_ARM_KEYS = {"config", "gate", "loss", "events", "partition", "crashes",
             "seed"}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative fault-scenario spec (compile_program -> FaultProgram).

    `events` entries are mappings with keys:
      kind    - "crash" | "send_loss" | "recv_loss" | "link_loss" | "gray"
      start   - first period (inclusive); crash events need only this
      end     - last period (exclusive); required for non-crash kinds
      level   - probability in [0, 1] (non-crash kinds)
      domain  - failure-domain id to target (-1 / absent = every node)
      nodes   - explicit node-id list (crash events, instead of domain)
      period, on - flap duty cycle: active when (t - start) mod period
                < on; period 0 (default) = always on in the window

    `arms` maps arm name -> {"config": {SwimConfig overrides}, "gate":
    bool, plus optional overrides of loss, events, partition, crashes,
    seed}; arms=None runs one gated "main" arm.  `study` delegates to
    sim/experiments.STUDIES[study](**study_kw) under the same verdict
    wrapper.  engine="real" runs a SimCluster with the `real` knobs.
    """

    name: str
    n: int = 256
    periods: int = 48
    engine: str = "ring"
    seed: int = 0
    config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    loss: float = 0.0
    domains: Any = None          # None | "blocks:K" | "stripe:K" | seq
    crashes: Mapping[str, Any] | None = None
    partition: Mapping[str, Any] | None = None
    events: Sequence[Mapping[str, Any]] = ()
    capacity: int | None = None
    arms: Mapping[str, Mapping[str, Any]] | None = None
    study: str | None = None
    study_kw: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    real: Mapping[str, Any] | None = None
    expect: Sequence[Mapping[str, Any]] = ()
    allow_rules: Sequence[str] = ()
    artifact: str | None = None
    description: str = ""

    def spec_dict(self) -> dict:
        """JSON-able echo of the spec (embedded in verdict artifacts)."""
        d = dataclasses.asdict(self)
        if d["domains"] is not None and not isinstance(d["domains"], str):
            d["domains"] = np.asarray(d["domains"]).tolist()
        return d


def validate(sc: Scenario) -> None:
    """Reject malformed specs with actionable errors (compile_program
    and run call this)."""
    if sc.engine not in ENGINES:
        raise ValueError(f"unknown engine {sc.engine!r}; one of {ENGINES}")
    if sc.n < 2:
        raise ValueError("scenario needs n >= 2")
    if sc.periods < 1:
        raise ValueError("scenario needs periods >= 1")
    if sc.study is not None and sc.study not in _study_names():
        raise ValueError(
            f"unknown study {sc.study!r}; one of {sorted(_study_names())}")
    dom = domain_labels(sc.n, sc.domains)
    n_domains = int(dom.max()) + 1
    for i, ev in enumerate(sc.events):
        unknown = set(ev) - _EVENT_KEYS
        if unknown:
            raise ValueError(
                f"events[{i}]: unknown key(s) {sorted(unknown)}")
        kind = ev.get("kind")
        if kind != "crash" and kind not in faults.SEG_KINDS:
            raise ValueError(
                f"events[{i}]: unknown kind {kind!r}; one of "
                f"{['crash'] + sorted(faults.SEG_KINDS)}")
        if "start" not in ev:
            raise ValueError(f"events[{i}]: missing 'start'")
        if kind != "crash":
            if "end" not in ev or ev["end"] <= ev["start"]:
                raise ValueError(
                    f"events[{i}]: needs end > start (half-open window)")
            level = ev.get("level")
            if level is None or not 0.0 <= level <= 1.0:
                raise ValueError(
                    f"events[{i}]: needs level in [0, 1], got {level!r}")
            period = ev.get("period", 0)
            on = ev.get("on", 0)
            if period > 0 and not 0 < on <= period:
                raise ValueError(
                    f"events[{i}]: flap duty needs 0 < on <= period "
                    f"({on}/{period})")
        d = ev.get("domain", -1)
        if d >= 0 and d >= n_domains:
            raise ValueError(
                f"events[{i}]: domain {d} out of range (the spec labels "
                f"{n_domains} domain(s))")
        if kind == "crash" and "nodes" in ev and "domain" in ev:
            raise ValueError(
                f"events[{i}]: crash targets either 'domain' or 'nodes'")
    if sc.arms is not None and sc.study is None and sc.engine != "real":
        for arm, spec in sc.arms.items():
            unknown = set(spec) - _ARM_KEYS
            if unknown:
                raise ValueError(
                    f"arm {arm!r}: unknown key(s) {sorted(unknown)}; "
                    f"one of {sorted(_ARM_KEYS)}")


def _study_names() -> set:
    from swim_tpu_torch.sim import experiments

    return set(experiments.STUDIES)


def domain_labels(n: int, spec) -> np.ndarray:
    """u8[n] failure-domain labels from the spec's `domains` field:
    "blocks:K" (node i in rack i // ceil(n/K)), "stripe:K" (rack i % K),
    or explicit labels in [0, 255]."""
    if spec is None:
        return np.zeros((n,), np.uint8)
    if isinstance(spec, str):
        form, _, arg = spec.partition(":")
        try:
            k = int(arg)
        except ValueError:
            raise ValueError(f"bad domain spec {spec!r}") from None
        if not 1 <= k <= 256:
            raise ValueError(
                f"domain count must be in [1, 256] (u8 labels): {k}")
        ids = np.arange(n)
        if form == "blocks":
            labels = ids // -(-n // k)          # ceil-div block size
        elif form == "stripe":
            labels = ids % k
        else:
            raise ValueError(
                f"unknown domain form {form!r}; 'blocks:K' or 'stripe:K'")
        return labels.astype(np.uint8)
    arr = np.asarray(spec)
    if arr.shape != (n,):
        raise ValueError(
            f"explicit domain labels must have shape ({n},): {arr.shape}")
    if arr.size and (arr.min() < 0 or arr.max() > 255):
        raise ValueError("domain labels must fit u8 ([0, 255])")
    return arr.astype(np.uint8)


def compile_program(sc: Scenario, device=None) -> faults.FaultProgram:
    """Spec -> validated FaultProgram on `device`.  Crash events (whole
    domains included) fold into base.crash_step; the other events fill
    segment slots, padded to `capacity` so specs with different event
    counts share one program shape.  The random crashes draw from
    `threefry.key(seed + 1)`, the reference's `jax.random.key(seed + 1)`."""
    validate(sc)
    dev = devmod.resolve(device)
    n = sc.n
    dom = domain_labels(n, sc.domains)
    plan = faults.none(n, dev)
    if sc.loss:
        plan = faults.with_loss(plan, float(sc.loss))
    if sc.crashes:
        c = dict(sc.crashes)
        plan = faults.with_random_crashes(
            plan, threefry.key(sc.seed + 1), float(c["fraction"]),
            int(c.get("start", 2)),
            int(c.get("end", max(3, sc.periods // 2))))
    if sc.partition:
        p = dict(sc.partition)
        groups = p.get("groups")
        groups = faults.halves(n) if groups is None else groups
        plan = faults.with_partition(plan, groups, int(p["start"]),
                                     int(p["end"]))
    lane_events = []
    for ev in sc.events:
        if ev["kind"] == "crash":
            if "nodes" in ev:
                ids = np.asarray(ev["nodes"], np.int32)
            elif ev.get("domain", -1) >= 0:
                ids = np.nonzero(dom == ev["domain"])[0].astype(np.int32)
            else:
                ids = np.arange(n, dtype=np.int32)
            plan = faults.with_crashes(plan, ids, int(ev["start"]))
        else:
            lane_events.append(ev)
    cap = len(lane_events) if sc.capacity is None else int(sc.capacity)
    if len(lane_events) > cap:
        raise ValueError(
            f"{len(lane_events)} lane events exceed capacity {cap}")
    prog = faults.as_program(plan, domain_id=dom, capacity=cap)
    for i, ev in enumerate(lane_events):
        prog = faults.with_segment(
            prog, i, start=int(ev["start"]), end=int(ev["end"]),
            kind=ev["kind"], level=float(ev["level"]),
            domain=int(ev.get("domain", -1)),
            period=int(ev.get("period", 0)), on=int(ev.get("on", 0)))
    return prog


def fault_gauges(sc: Scenario) -> dict[str, np.ndarray]:
    """Host-side per-period fault-schedule gauges recomputed from the
    spec: `gray_nodes` (nodes with an active gray lane) and
    `flap_active` (nodes covered by a flapping segment's window), the
    aux rows of obs/health.py's `gray_undetected` / `flap_false_dead`
    rules."""
    n, t_max = sc.n, sc.periods
    dom = domain_labels(n, sc.domains).astype(np.int32)
    gray = np.zeros((t_max,), np.int64)
    flap = np.zeros((t_max,), np.int64)
    for ev in sc.events:
        kind = ev.get("kind")
        if kind not in faults.SEG_KINDS:
            continue
        d = ev.get("domain", -1)
        cnt = int(n if d < 0 else (dom == d).sum())
        period = int(ev.get("period", 0))
        on = int(ev.get("on", 0))
        for t in range(max(0, int(ev["start"])),
                       min(t_max, int(ev["end"]))):
            duty = (period == 0
                    or ((t - int(ev["start"])) % period) < on)
            if kind == "gray" and duty:
                gray[t] += cnt
            if period > 0:
                flap[t] += cnt
    return {"gray_nodes": gray, "flap_active": flap}


# --------------------------------------------------------------- execution


def _arm_defs(sc: Scenario) -> list[tuple[str, dict, bool]]:
    if sc.arms is None:
        return [("main", {}, True)]
    return [(name, dict(spec), bool(spec.get("gate", True)))
            for name, spec in sc.arms.items()]


def _arm_scenario(sc: Scenario, spec: dict) -> Scenario:
    """Apply an arm's scenario-field overrides (loss / events /
    partition / crashes / seed)."""
    repl = {k: spec[k] for k in
            ("loss", "events", "partition", "crashes", "seed")
            if k in spec}
    return dataclasses.replace(sc, **repl) if repl else sc


def _arm_prepare(sc: Scenario, spec: dict, dev) -> tuple:
    """Arm spec -> (arm-overridden scenario, SwimConfig, compiled
    program): the static half of an arm run, shared by the serial and
    batched paths."""
    sc = _arm_scenario(sc, spec)
    cfg_kw = {**dict(sc.config), **dict(spec.get("config", {}))}
    cfg_kw.setdefault("telemetry", True)
    cfg = SwimConfig(n_nodes=sc.n, **cfg_kw)
    return sc, cfg, compile_program(sc, dev)


def _arm_engine(sc: Scenario) -> str:
    from swim_tpu_torch.sim import experiments

    engine = experiments.pick_engine(sc.n, sc.engine)
    experiments._require_ported(engine)
    return engine


def _run_engine_arm(sc: Scenario, arm: str, spec: dict, out_dir: str,
                    dev) -> dict:
    """One engine arm: compile, run the study with telemetry, feed the
    health monitor and flight recorder (with the fault-schedule gauges),
    dump, and replay the dump through the offline analyzer."""
    from swim_tpu_torch.sim import experiments

    engine = _arm_engine(sc)
    sc, cfg, prog = _arm_prepare(sc, spec, dev)
    res = experiments._run_study(cfg, prog, threefry.key(sc.seed),
                                 sc.periods, engine, dev)
    return _arm_digest(sc, arm, engine, cfg, prog, res, out_dir)


def _run_engine_arms_batched(sc: Scenario, out_dir: str, dev) -> dict:
    """All engine arms of one scenario as batches: arms sharing a
    SwimConfig run as one `experiments._run_study_batch` (each arm's
    program padded to the group's capacity), and each lane goes through
    the same `_arm_digest` as a serial arm, so the per-arm dicts, dumps
    and verdict are the serial run's.  The byte bill is priced from the
    arm's own program, never the padded copy."""
    from swim_tpu_torch.sim import experiments, runner

    engine = _arm_engine(sc)
    prepared = [(arm, *_arm_prepare(sc, spec, dev))
                for arm, spec, _gate in _arm_defs(sc)]
    groups: dict[Any, list[int]] = {}
    for i, (_arm, _sc_a, cfg, _prog) in enumerate(prepared):
        groups.setdefault(cfg, []).append(i)
    arms_out: dict[str, dict] = {}
    for cfg, idxs in groups.items():
        progs = [prepared[i][3] for i in idxs]
        keys = [threefry.key(prepared[i][1].seed) for i in idxs]
        res_b = experiments._run_study_batch(cfg, progs, keys, sc.periods,
                                             engine, device=dev)
        for lane, i in enumerate(idxs):
            arm, sc_a, cfg_i, prog = prepared[i]
            res = runner.lane_result(res_b, lane)
            arms_out[arm] = _arm_digest(sc_a, arm, engine, cfg_i, prog,
                                        res, out_dir)
    return {arm: arms_out[arm] for arm, _, _ in _arm_defs(sc)}


def _arm_digest(sc: Scenario, arm: str, engine: str, cfg: SwimConfig,
                prog: faults.FaultProgram, res, out_dir: str) -> dict:
    """Post-run half of an arm: metric digests, the byte bill, health
    monitor + flight-record dump, offline-analyzer replay.  `res` is a
    serial study result or one lane of a batch: equal inputs give equal
    bytes.  Every value is a Python or numpy scalar."""
    from swim_tpu_torch.obs import analyze
    from swim_tpu_torch.obs.health import HealthMonitor
    from swim_tpu_torch.obs.recorder import FlightRecorder
    from swim_tpu_torch.sim import runner
    from swim_tpu_torch.utils import metrics

    series = runner.host_series(res.series)
    out: dict[str, Any] = {"engine": engine}
    out.update(runner.detection_summary(res, prog, sc.periods))
    out.update(metrics.series_digest(series))
    out["false_dead_views_final"] = int(series.false_dead_views[-1])
    out["false_dead_views_peak"] = int(series.false_dead_views.max())
    out["max_incarnation"] = int(series.max_incarnation.max())
    if engine in ("rumor", "shard", "ring", "ringshard"):
        out["overflow"] = int(res.state.overflow)

    if (cfg.ring_scalar_wire == "packed"
            and int(prog.seg_kind.shape[0]) > 0):
        # the lane's bytes on the packed scalar wire of the 8-way
        # sharded layout: the roll_link_thr term (a meta-device pass)
        from swim_tpu_torch.obs import ici

        bill = ici.trace_ici_bytes(cfg, d=8, plan=prog)
        out["ici"] = {
            "per_chip_bytes_per_period":
                bill["per_chip_bytes_per_period"],
            "roll_link_thr_bytes":
                bill["breakdown"].get("roll_link_thr", 0),
        }

    monitor = HealthMonitor(window=min(16, max(2, sc.periods)),
                            n_nodes=sc.n)
    rec = FlightRecorder(cfg=cfg, capacity=sc.periods, monitor=monitor)
    aux = {"false_dead_views": np.asarray(series.false_dead_views)}
    aux.update(fault_gauges(sc))
    rec.record_stacked(res.telemetry, aux=aux)
    dump = os.path.join(out_dir, f"scenario_{sc.name}_{arm}.jsonl")
    rec.dump(dump, reason="scenario",
             extra={"scenario": sc.name, "arm": arm})
    report = analyze.analyze(dump)
    errors = analyze.error_findings(report)
    out["observatory"] = {
        "dump": dump,
        "health": monitor.summary(),
        "error_findings": errors,
        "waived_rules": sorted(set(sc.allow_rules)),
    }
    return out


def _run_real_arm(sc: Scenario, out_dir: str) -> dict:
    """Real-node arm: a core/cluster.py SimCluster under the scenario's
    adversarial delivery (loss / duplication / stale replay), gated on
    the real-node registry health rules.  Host Python only: no tensor
    is made, whatever the device."""
    from swim_tpu_torch.core.cluster import SimCluster
    from swim_tpu_torch.obs.health import HealthMonitor
    from swim_tpu_torch.types import Status

    rk = dict(sc.real or {})
    cfg = SwimConfig(n_nodes=sc.n, **dict(sc.config))
    cluster = SimCluster(
        cfg, seed=sc.seed, loss=float(rk.get("loss", 0.0)),
        duplicate=float(rk.get("duplicate", 0.0)),
        replay=float(rk.get("replay", 0.0)))
    cluster.start()
    cluster.run(float(rk.get("seconds", 12.0)))
    net = cluster.network
    totals: dict[str, int] = {}
    for node in cluster.nodes:
        for name, counter in node.registry.counters.items():
            totals[name] = totals.get(name, 0) + int(counter.value)
    # every node is alive for the whole run: any DEAD view of a peer at
    # the end is a false-dead view
    false_dead = sum(
        1 for i, node in enumerate(cluster.nodes)
        for peer in range(sc.n)
        if peer != i
        and (op := node.members.opinion(peer)) is not None
        and op.status is Status.DEAD)
    monitor = HealthMonitor(n_nodes=sc.n)
    findings = monitor.check_registries(
        [node.registry for node in cluster.nodes])
    errors = [f.to_dict() for f in findings if f.severity == "error"]
    return {
        "engine": "real",
        "seconds": float(rk.get("seconds", 12.0)),
        "network": {"sent": net.sent, "delivered": net.delivered,
                    "duplicated": net.duplicated,
                    "replayed": net.replayed},
        "counters": totals,
        "false_dead_views_final": false_dead,
        "observatory": {
            "health": monitor.summary(),
            "error_findings": errors,
            "waived_rules": sorted(set(sc.allow_rules)),
        },
    }


def _run_study_mode(sc: Scenario, out_dir: str, dev) -> dict:
    """Delegate to sim/experiments.STUDIES under the verdict wrapper;
    a flight_record path in the study kwargs is replayed through the
    offline analyzer for the observatory gate."""
    from swim_tpu_torch.obs import analyze
    from swim_tpu_torch.sim import experiments

    kw = dict(sc.study_kw)
    if "flight_record" in kw and kw["flight_record"] is not None:
        kw["flight_record"] = os.path.join(out_dir, kw["flight_record"])
    result = experiments.STUDIES[sc.study](**kw, device=dev)
    out: dict[str, Any] = {"engine": result.get("engine", "study"),
                           "result": result}
    dump = result.get("flight_record")
    if dump and os.path.exists(dump):
        report = analyze.analyze(dump)
        out["observatory"] = {
            "dump": dump,
            "error_findings": analyze.error_findings(report),
            "waived_rules": sorted(set(sc.allow_rules)),
        }
    else:
        out["observatory"] = None
    return out


# ------------------------------------------------------------------ checks


def _geometric_law(result: dict, dump: str | None) -> dict | None:
    """First-detection-law statistics from a detection study's dump
    header (the full per-crash milestone lists live there)."""
    if not dump or not os.path.exists(dump):
        return None
    from swim_tpu_torch.obs import analyze as _a

    header = _a.read_jsonl(dump)[0]
    study = header.get("study") or {}
    crash = np.asarray(study.get("crash_step", []), np.int64)
    first = np.asarray(study.get("first_suspect", []), np.int64)
    nn = study.get("n") or result.get("n")
    if crash.size == 0 or first.size == 0 or not nn:
        return None
    ok = first != np.int64(2**31 - 1)
    lat = (first[ok] + 1 - crash[ok]).astype(np.float64)
    m = int(lat.size)
    if m == 0:
        return None
    p = 1.0 - (1.0 - 1.0 / (nn - 1)) ** (nn - 1)
    mean_exp = 1.0 / p
    var = (1.0 - p) / (p * p)
    mean_obs = float(lat.mean())
    z_obs = (mean_obs - mean_exp) / math.sqrt(var / m)
    # KS against Geometric(p) on {1, 2, ...}: both CDFs step at the same
    # integers, so the sup is over post-jump values at support points
    lat_sorted = np.sort(lat)
    ks = 0.0
    for l in np.unique(lat_sorted):
        f_emp = float((lat_sorted <= l).mean())
        f_geo = 1.0 - (1.0 - p) ** l
        ks = max(ks, abs(f_emp - f_geo))
    return {"samples": m, "p": p, "expected_mean": mean_exp,
            "observed_mean": mean_obs, "z": z_obs,
            "ks_stat": ks, "ks_scaled": ks * math.sqrt(m)}


def _eval_checks(sc: Scenario, arms: dict[str, dict]) -> list[dict]:
    checks: list[dict] = []

    def add(name, ok, **detail):
        checks.append({"check": name,
                       "ok": bool(ok), **detail})

    # mandatory observatory gate: gated arms must be free of
    # error-severity findings outside the spec's waived rules
    waived = set(sc.allow_rules)
    gate_arms = [a for a, _, g in _arm_defs(sc) if g] \
        if (sc.study is None and sc.engine != "real") else list(arms)
    for arm in gate_arms:
        obs = (arms.get(arm) or {}).get("observatory")
        if obs is None:
            add("observe_clean", True, arm=arm, note="no dump to replay")
            continue
        hard = [f for f in obs["error_findings"]
                if f.get("rule") not in waived]
        soft = [f["rule"] for f in obs["error_findings"]
                if f.get("rule") in waived]
        add("observe_clean", not hard, arm=arm,
            errors=[f.get("rule") for f in hard], waived=sorted(set(soft)))

    for spec in sc.expect:
        spec = dict(spec)
        kind = spec.pop("check")
        if kind == "metric_zero":
            arm = spec.get("arm", "main")
            metric = spec.get("metric", "false_dead_views_final")
            v = arms[arm].get(metric)
            add(kind, v == 0, arm=arm, metric=metric, value=v)
        elif kind == "metric_max":
            arm = spec.get("arm", "main")
            metric = spec["metric"]
            v = arms[arm].get(metric)
            add(kind, v is not None and v <= spec["limit"], arm=arm,
                metric=metric, value=v, limit=spec["limit"])
        elif kind == "metric_nonzero":
            arm = spec.get("arm", "main")
            metric = spec["metric"]
            v = arms[arm].get(metric)
            add(kind, bool(v), arm=arm, metric=metric, value=v)
        elif kind == "fewer":
            metric = spec.get("metric", "false_dead_views_peak")
            lo = arms[spec["less"]].get(metric)
            hi = arms[spec["than"]].get(metric)
            add(kind, lo is not None and hi is not None and lo < hi,
                metric=metric, less=spec["less"], than=spec["than"],
                less_value=lo, than_value=hi)
        elif kind == "require_points":
            result = arms.get("study", {}).get("result", {})
            pts = result.get("points", [])
            add(kind, len(pts) >= spec.get("min", 1),
                points=len(pts), min=spec.get("min", 1))
        elif kind == "rule_fired":
            arm = spec.get("arm", "main")
            rule = spec["rule"]
            obs = (arms.get(arm) or {}).get("observatory") or {}
            fired = [f["rule"] for f in
                     obs.get("health", {}).get("findings", [])]
            add(kind, rule in fired, arm=arm, rule=rule, fired=fired)
        elif kind == "lane_charged":
            arm = spec.get("arm", "main")
            bill = arms[arm].get("ici") or {}
            v = bill.get("roll_link_thr_bytes", 0)
            add(kind, v > 0, arm=arm, roll_link_thr_bytes=v)
        elif kind == "detection_law":
            st = arms.get("study", {})
            law = _geometric_law(st.get("result", {}),
                                 (st.get("observatory") or {}).get("dump"))
            if law is None:
                add(kind, False, note="no law samples in dump header")
            else:
                z_lim = float(spec.get("z", 3.0))
                ks_lim = float(spec.get("ks", 1.358))
                band_ok = abs(law["z"]) <= z_lim
                ks_ok = law["ks_scaled"] <= ks_lim
                strict = bool(spec.get("strict", True))
                add(kind, (band_ok and ks_ok) or not strict,
                    band_ok=band_ok, ks_ok=ks_ok, z_limit=z_lim,
                    ks_limit=ks_lim, **law)
        elif kind == "counter_zero":
            arm = spec.get("arm", "real")
            name = spec["counter"]
            v = arms[arm].get("counters", {}).get(name, 0)
            add(kind, v == 0, arm=arm, counter=name, value=v)
        elif kind == "counter_nonzero":
            arm = spec.get("arm", "real")
            name = spec["counter"]
            v = arms[arm].get("counters", {}).get(name, 0)
            add(kind, v > 0, arm=arm, counter=name, value=v)
        elif kind == "network_nonzero":
            arm = spec.get("arm", "real")
            name = spec["field"]
            v = arms[arm].get("network", {}).get(name, 0)
            add(kind, v > 0, arm=arm, field=name, value=v)
        else:
            add(kind, False, note=f"unknown check kind {kind!r}")
    return checks


# --------------------------------------------------------------- verdicts


def write_verdict(verdict: dict, path: str) -> str:
    """Atomic, diffable JSON: sorted keys, indent 1, trailing newline,
    no timestamps, so reruns of an unchanged scenario give the same
    bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".verdict_")
    try:
        with os.fdopen(fd, "w") as fh:
            # numpy scalars and arrays ride in from study results
            json.dump(verdict, fh, sort_keys=True, indent=1,
                      default=lambda o: (o.item() if np.isscalar(o)
                                         or getattr(o, "ndim", 1) == 0
                                         else np.asarray(o).tolist()))
            fh.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def run(sc: Scenario, out_dir: str = "scenario_out", batch: bool = False,
        device=None) -> tuple[dict, str]:
    """Run a scenario end to end on `device` (None: the CUDA card) and
    write its verdict artifact under `out_dir`; returns (verdict, path).
    verdict["verdict"] is "pass" iff every check holds (the observatory
    gate plus the spec's `expect` list).  `batch=True` runs the engine
    arms as batches per shared SwimConfig with the same verdict bytes
    (study mode ignores it)."""
    validate(sc)
    dev = devmod.resolve(device)
    os.makedirs(out_dir, exist_ok=True)
    arms: dict[str, dict] = {}
    if sc.study is not None:
        arms["study"] = _run_study_mode(sc, out_dir, dev)
    elif sc.engine == "real":
        arms["real"] = _run_real_arm(sc, out_dir)
    elif batch:
        arms = _run_engine_arms_batched(sc, out_dir, dev)
    else:
        for arm, spec, _gate in _arm_defs(sc):
            arms[arm] = _run_engine_arm(sc, arm, spec, out_dir, dev)
    checks = _eval_checks(sc, arms)
    verdict = {
        "kind": VERDICT_KIND,
        "version": VERDICT_VERSION,
        "scenario": sc.spec_dict(),
        "arms": arms,
        "checks": checks,
        "verdict": "pass" if all(c["ok"] for c in checks) else "fail",
    }
    path = os.path.join(out_dir,
                        sc.artifact or f"scenario_{sc.name}.json")
    write_verdict(verdict, path)
    return verdict, path


# ---------------------------------------------------------------- library


def _lib() -> dict[str, Scenario]:
    ring_cfg = {"ring_probe": "rotor", "ring_scalar_wire": "packed",
                "ring_sel_scope": "period", "lifeguard": True,
                "buddy": True}
    lean_cfg = {"ring_sel_scope": "period", "suspicion_mult": 2.0,
                "retransmit_mult": 2.0, "k_indirect": 1,
                "ring_window_periods": 3, "ring_view_c": 2}
    return {
        "rack_outage": Scenario(
            name="rack_outage", n=256, periods=40, engine="ring",
            config=ring_cfg, domains="blocks:8",
            events=(
                {"kind": "crash", "domain": 2, "start": 12},
                {"kind": "link_loss", "domain": 5, "start": 8,
                 "end": 24, "level": 0.15},
            ),
            expect=(
                {"check": "metric_zero", "arm": "main",
                 "metric": "false_dead_views_final"},
                {"check": "metric_nonzero", "arm": "main",
                 "metric": "crashed"},
                {"check": "lane_charged", "arm": "main"},
            ),
            description="One rack (32/256 nodes) crash-stops at once "
                        "while another rack degrades to 15% link loss "
                        "— correlated domain failure.  (At 30% "
                        "sustained rack loss Lifeguard starts losing "
                        "nodes: measured, not assumed.)"),
        "flap": Scenario(
            name="flap", n=256, periods=48, engine="ring",
            config=ring_cfg, domains="blocks:8",
            events=(
                {"kind": "link_loss", "domain": 3, "start": 8,
                 "end": 40, "level": 0.2, "period": 6, "on": 3},
            ),
            arms={
                "mild": {},
                "storm": {"gate": False, "events": (
                    {"kind": "link_loss", "domain": 3, "start": 8,
                     "end": 40, "level": 0.5, "period": 6, "on": 3},
                )},
            },
            expect=(
                {"check": "metric_zero", "arm": "mild",
                 "metric": "false_dead_views_final"},
                {"check": "lane_charged", "arm": "mild"},
                {"check": "metric_nonzero", "arm": "storm",
                 "metric": "false_dead_views_peak"},
                {"check": "rule_fired", "arm": "storm",
                 "rule": "flap_false_dead"},
            ),
            description="One rack's links flap on a 3-on/3-off duty "
                        "cycle.  At 20% burst loss Lifeguard rides it "
                        "out clean (gated arm); at 50% the suspicion "
                        "volume saturates the piggyback budget, "
                        "refutations drop, and sticky DEAD cascades — "
                        "the ungated storm arm pins that regime and "
                        "proves the flap_false_dead health rule "
                        "fires."),
        "flap_boundary": Scenario(
            name="flap_boundary", n=256, periods=48, engine="ring",
            config=ring_cfg, domains="blocks:8",
            events=(
                {"kind": "link_loss", "domain": 3, "start": 8,
                 "end": 40, "level": 0.261209, "period": 6, "on": 3},
            ),
            arms={
                "edge_clean": {},
                "edge_storm": {"gate": False, "events": (
                    {"kind": "link_loss", "domain": 3, "start": 8,
                     "end": 40, "level": 0.261493, "period": 6,
                     "on": 3},
                )},
            },
            expect=(
                {"check": "metric_zero", "arm": "edge_clean",
                 "metric": "false_dead_views_final"},
                {"check": "lane_charged", "arm": "edge_clean"},
                {"check": "metric_nonzero", "arm": "edge_storm",
                 "metric": "false_dead_views_final"},
            ),
            description="Machine-found sticky-false-dead frontier of "
                        "the flap duty cycle (coverage-guided search, "
                        "seed 0: sim/search.py refine_boundary over "
                        "the 3-on/3-off link-loss template).  At burst "
                        "loss 0.261209 Lifeguard still converges to "
                        "zero false-dead views; 0.000284 higher, at "
                        "0.261493, refutations stop landing inside "
                        "the flap window and DEAD views stick past "
                        "recovery.  Pins the measured cliff between "
                        "the hand-picked flap anchors (0.2 clean / "
                        "0.5 storm)."),
        "gray_10pct": Scenario(
            name="gray_10pct", n=256, periods=48, engine="ring",
            config=ring_cfg, domains="blocks:10",
            events=(
                {"kind": "gray", "domain": 1, "start": 6, "end": 42,
                 "level": 0.43},
            ),
            arms={
                "lha": {"config": {}, "gate": True},
                "vanilla": {"config": {"lifeguard": False,
                                       "buddy": False},
                            "gate": False},
            },
            expect=(
                {"check": "fewer", "less": "lha", "than": "vanilla",
                 "metric": "false_dead_views_peak"},
                {"check": "metric_nonzero", "arm": "vanilla",
                 "metric": "false_dead_views_peak"},
                {"check": "metric_zero", "arm": "lha",
                 "metric": "false_dead_views_final"},
            ),
            description="~10% of nodes go gray (alive, gossiping, 43% "
                        "of their acks lost).  The LHA/buddy arm must "
                        "show strictly fewer false-dead views than "
                        "vanilla SWIM — Lifeguard's headline claim.  "
                        "(Calibrated across both threefry streams: at "
                        "this severity LHA holds zero false deaths "
                        "while vanilla false-kills 500-1000 views; by "
                        "~0.5 both degrade, at <=0.4 vanilla largely "
                        "survives too and the contrast shrinks.)"),
        "replay_storm": Scenario(
            name="replay_storm", n=16, engine="real",
            config={"k_indirect": 2},
            real={"seconds": 12.0, "loss": 0.05, "duplicate": 0.3,
                  "replay": 0.3},
            expect=(
                {"check": "counter_zero", "arm": "real",
                 "counter": "decode_errors"},
                {"check": "metric_zero", "arm": "real",
                 "metric": "false_dead_views_final"},
                {"check": "network_nonzero", "arm": "real",
                 "field": "duplicated"},
                {"check": "network_nonzero", "arm": "real",
                 "field": "replayed"},
            ),
            description="Real-node cluster under 30% duplication and "
                        "30% stale-datagram replay: the decode path "
                        "must be idempotent (no decode errors, no "
                        "false deaths)."),
        "baseline_config3": Scenario(
            name="baseline_config3", n=100_000, periods=100,
            engine="rumor",
            partition={"start": 33, "end": 66},
            arms={
                "loss_000": {"loss": 0.0},
                "loss_010": {"loss": 0.1},
                "loss_020": {"loss": 0.2},
                "loss_030": {"loss": 0.3},
            },
            allow_rules=("false_dead_views", "probe_failure_burst",
                         "stalled_dissemination", "overflow_growth",
                         "saturation_spike"),
            expect=(
                {"check": "metric_nonzero", "arm": "loss_030",
                 "metric": "suspect_views_peak"},
                {"check": "metric_nonzero", "arm": "loss_000",
                 "metric": "false_dead_views_peak"},
            ),
            artifact="study_fp_100k_scenario.json",
            description="BASELINE config 3 at spec (VERDICT r6 #3): "
                        "n=100,000, losses through 0.30, mid-run 2-way "
                        "partition — fp_sweep as four scenario arms "
                        "under full telemetry + health gating.  The "
                        "partition makes false-dead views and probe "
                        "bursts EXPECTED (DEAD is sticky; re-join is "
                        "the recovery path), so those rules are "
                        "explicitly waived, not silently ignored."),
        "lean_fidelity": Scenario(
            name="lean_fidelity", n=4096, periods=24, engine="ring",
            study="detection",
            study_kw={"n": 4096, "crash_fraction": 0.02,
                      "periods": 24, "engine": "ring",
                      "telemetry": True,
                      "flight_record": "scenario_lean_fidelity.jsonl",
                      **lean_cfg},
            expect=(
                {"check": "detection_law", "z": 3.0, "ks": 1.358,
                 "strict": True},
            ),
            allow_rules=("overflow_growth",),
            artifact="scenario_lean_fidelity.json",
            description="Lean-geometry fidelity certificate (VERDICT "
                        "r6 #4): the WW=6/RW=56/C=2/k=1/lambda=2 "
                        "anchor must satisfy the first-detection "
                        "geometric law (CLT band + KS) on the "
                        "law-preserving pull probe.  Calibrated "
                        "SUBCRITICAL (crash density 2% over 24 "
                        "periods): at 4% over 100 periods the piggyback "
                        "queue saturates and BOTH lean and default "
                        "geometry deviate from the law (measured mean "
                        "3.6 resp. 2.4 vs 1.58) — the law's "
                        "precondition, not the lean geometry, is what "
                        "breaks.  Residual overflow (~2 updates) is "
                        "waived, measured, and embedded in the "
                        "artifact."),
    }


LIBRARY: dict[str, Scenario] = _lib()


def get(name: str) -> Scenario:
    """Library lookup; accepts hyphenated aliases (rack-outage)."""
    key = name.replace("-", "_")
    if key not in LIBRARY:
        raise KeyError(
            f"unknown scenario {name!r}; one of {sorted(LIBRARY)}")
    return LIBRARY[key]

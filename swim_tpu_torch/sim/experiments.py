"""The BASELINE studies (port of `swim_tpu/sim/experiments.py`).

Each function returns a JSON-able dict, the reference's for the same
arguments:

  * `detection_study`    - random crash-stop injection -> first-detection
    time distribution (pull-uniform probing by default: the SWIM paper's
    e/(e-1)-periods law);
  * `fp_sweep`           - packet loss (+ optional 2-way partition)
    -> false-positive rates;
  * `suspicion_sweep`    - suspicion-multiplier sweep -> detection
    latency against false positives;
  * `lifeguard_ablation` - Lifeguard on/off under loss and crashes.

Engine selection as in the reference: "auto" picks the exact dense
engine up to `DENSE_MAX` nodes and the O(R*N) rumor engine above;
"ring" is the ring engine, "ringshard" the same engine sharded over
the node axis (parallel/ring_shard.py, stepped through its mapped
step; the census counts each shard's rows on its device and sums the
counts); "shard" the exchange-sharded rumor engine
(parallel/shard_engine.py, lossless: the rumor engine's result; the
census sums each shard's knower counts).  Both shard over
`mesh.make_mesh()` (one shard per card, or `pmesh.DEFAULT_SHARDS` slots
of one card) unless `device` names a device, whose 8 slots they then
take.  "dense", "ring" and "rumor" run on the CUDA card unless `device`
names another device; with no device named and two or more distinct
devices in `make_mesh()` (several cards) they are partitioned over them
as the reference's GSPMD partitions them (parallel/partition.py: the
ring through ring_shard's step, dense and rumor by row blocks), bitwise
the one-device study.  The result's state is assembled from the
shards.
`SwimConfig(telemetry=True)` with "shard" raises ValueError: the
engine has no tap (the reference fails there unpacking the frame).

`detection_study(telemetry=True)` adds the per-period EngineFrame
digest and a health summary, and dumps the flight recorder on an
error-severity finding or when `flight_record` names a path.
`_run_study_batch` runs one study per fault program of a library and
stacks the results along a leading P axis, each lane partitioned
where a serial study would be.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.obs.health import HealthMonitor
from swim_tpu_torch.obs.recorder import FlightRecorder
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.utils import metrics, threefry

DENSE_MAX = 8192

# detection_study(stream="auto") switches to the streaming O(crashes)
# runner at and above this N (milestones and series are bitwise equal
# either way)
STREAM_AUTO_NODES = 2_000_000


def pick_engine(n: int, engine: str = "auto") -> str:
    if engine != "auto":
        return engine
    return "dense" if n <= DENSE_MAX else "rumor"


ENGINES = ("dense", "rumor", "shard", "ring", "ringshard")
RING_ENGINES = ("ring", "ringshard")
# the engines a study partitions over every device (parallel/partition.py)
PARTITIONED = ("dense", "ring", "rumor")


def _require_ported(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown study engine '{engine}'")


def _run_study(cfg: SwimConfig, plan, key: tuple[int, int], periods: int,
               engine: str, device=None, stream: bool = False, ckpt=None,
               chunk: int = 0):
    """One study of `engine` on `device`.  None: for dense, ring and
    rumor the card, or partitioned over `mesh.make_mesh()` where it has
    two or more distinct devices (parallel/partition.py), as the
    reference's GSPMD partitions them; for the sharded engines the
    default mesh.  A partitioned or sharded study's state is
    assembled."""
    if stream and engine not in RING_ENGINES:
        raise ValueError(
            f"streaming studies cover the ring engines only, not "
            f"'{engine}'")
    placed = None                       # [mesh, state, plan, step_fn]
    if engine == "shard":
        from swim_tpu_torch.parallel import shard_engine

        if cfg.telemetry:
            raise ValueError("the exchange-sharded rumor engine ('shard') "
                             "has no telemetry tap; use 'rumor' or "
                             "'ringshard' for telemetry studies")
        placed = list(shard_engine.start(cfg, plan, device))
    elif engine == "ringshard":
        from swim_tpu_torch.parallel import ring_shard

        placed = list(ring_shard.start(cfg, plan, device))
    elif device is None and engine in PARTITIONED:
        from swim_tpu_torch.parallel import partition

        mesh = pmesh.make_mesh()
        if partition.partitions(mesh):
            placed = list(partition.start(cfg, engine, plan, mesh))
    if placed is None:
        init = {"dense": dense, "rumor": rumor,
                "ring": ring}[engine].init_state
        placed = [None, init(cfg, devmod.resolve(device)), plan, None]
    plan, step_fn = placed[2], placed[3]
    # the runner is called directly and takes the initial state out of
    # `placed`: no frame here holds it, and the runner drops it after
    # its first period
    if stream:
        res = runner.run_study_ring_stream(cfg, placed.pop(1), plan, key,
                                           periods, step_fn, chunk=chunk,
                                           ckpt=ckpt)
    else:
        res = _study_runner(engine)(cfg, placed.pop(1), plan, key, periods,
                                    step_fn)
    if step_fn is None:
        return res
    return res._replace(state=pmesh.assemble(res.state))


def _study_runner(engine: str):
    """The full-track study runner of `engine`'s family, as run(cfg,
    state, plan, key, periods, step_fn); step_fn None: the one-device
    step."""
    if engine == "dense":
        return runner.run_study
    if engine in ("rumor", "shard"):
        return runner.run_study_rumor
    return runner.run_study_ring


def _run_study_batch(cfg: SwimConfig, progs, keys, periods: int,
                     engine: str, capacity: int | None = None,
                     device=None):
    """`len(progs)` studies of one configuration, one per FaultProgram
    (all of one N), stacked along a leading P axis.  The programs are
    padded to one segment capacity (the library's largest, or
    `capacity` if larger) and stacked (`faults.stack_programs`); lane p
    runs the serial study on `faults.lane_program(batch, p)` and its own
    threefry key `keys[p]`, from a fresh state.  De-interleave with
    `runner.lane_result`: each lane is its serial run bit for bit
    (inert padding slots add 0 to every lane threshold).  The lanes run
    one after another."""
    if engine == "shard":
        raise ValueError("batched studies: the exchange-sharded engine "
                         "has no fault-program path; use rumor, ring, "
                         "or ringshard")
    _require_ported(engine)
    progs = list(progs)
    keys = list(keys)
    if len(keys) != len(progs):
        raise ValueError(
            f"batched studies: {len(progs)} lanes need {len(progs)} root "
            f"keys, got {len(keys)}")
    cap = max(int(p.seg_kind.shape[0]) for p in progs)
    if capacity is not None:
        cap = max(cap, int(capacity))
    batch = faults.stack_programs(progs, cap)
    return runner.batch_states(
        [_run_study(cfg, faults.lane_program(batch, p), key, periods,
                    engine, device) for p, key in enumerate(keys)])


def _crash_plan(n: int, seed: int, crash_fraction: float, periods: int,
                dev):
    return faults.with_random_crashes(
        faults.none(n, dev), threefry.key(seed + 1), crash_fraction,
        2, max(3, periods // 2))


def detection_study(n: int = 1000, crash_fraction: float = 0.01,
                    periods: int = 100, seed: int = 0,
                    engine: str = "auto",
                    flight_record: str | None = None,
                    stream: bool | str = "auto",
                    checkpoint_dir: str | None = None,
                    checkpoint_every: int = 0,
                    chunk: int = 0, device=None,
                    **cfg_kw) -> dict[str, Any]:
    """Crash-stop injection -> detection-time distribution.  The ring
    engine probes pull-uniform here unless `ring_probe` is given: the
    study measures the e/(e-1) first-detection law, which the rotor
    probe's bounded detection does not follow (deviation R1).

    With `telemetry=True` (a SwimConfig option in cfg_kw) the result
    gains a `telemetry` digest of the per-period EngineFrame series and
    a `health` summary of the sliding-window rules (obs/health.py), and
    the flight recorder dumps its last periods as JSONL when an
    error-severity finding fires (reason "health:<rule>"; the file
    "flight_record.jsonl" in the working directory unless
    `flight_record` names one) or whenever `flight_record` names a
    path.  The dump header embeds the crashed subjects' milestones, so
    `obs/analyze.py` reproduces the detection summary from the dump
    alone."""
    engine = pick_engine(n, engine)
    _require_ported(engine)
    dev = devmod.resolve(device)
    if engine in RING_ENGINES:
        cfg_kw.setdefault("ring_probe", "pull")
    cfg = SwimConfig(n_nodes=n, **cfg_kw)
    # stream="auto": the ring engine's O(crashes) runner from
    # STREAM_AUTO_NODES on, or whenever checkpointing is asked for (only
    # it checkpoints); the dense and rumor runners do not stream
    if isinstance(stream, bool):
        do_stream = stream
    else:
        do_stream = engine in RING_ENGINES and (
            n >= STREAM_AUTO_NODES or checkpoint_dir is not None)
    ckpt = None
    if checkpoint_dir is not None:
        if not do_stream:
            raise ValueError("checkpointing needs the streaming study "
                             "runner; pass stream='auto' or stream=True")
        ckpt = runner.StudyCheckpointer(checkpoint_dir,
                                        every=checkpoint_every)
    plan = _crash_plan(n, seed, crash_fraction, periods, dev)
    res = _run_study(cfg, plan, threefry.key(seed), periods, engine, device,
                     stream=do_stream, ckpt=ckpt, chunk=chunk)
    out = {"study": "detection", "n": n, "periods": periods,
           "engine": engine, "crash_fraction": crash_fraction,
           "suspicion_periods": cfg.suspicion_periods}
    if engine in RING_ENGINES:
        out["ring_probe"] = cfg.ring_probe
        out["stream"] = bool(do_stream)
    out.update(runner.detection_summary(res, plan, periods))
    out.update(metrics.series_digest(res.series))
    if engine != "dense":
        out["overflow"] = int(res.state.overflow)
    if res.telemetry is not None:
        out["telemetry"] = metrics.series_digest(res.telemetry)
        monitor = HealthMonitor(window=min(16, max(2, periods)), n_nodes=n)
        rec = FlightRecorder(cfg=cfg, capacity=min(64, periods),
                             monitor=monitor)
        false_dead = runner.host_series(res.series).false_dead_views
        rec.record_stacked(res.telemetry,
                           aux={"false_dead_views": false_dead})
        out["health"] = {"worst": monitor.worst() or "ok",
                         "findings": len(monitor.findings())}
        reason = rec.auto_dump_reason()
        if flight_record or reason:
            crash, milestones = runner.study_milestones(res, plan, periods)
            # the probe regime of the law check: only the ring engine
            # can deviate (rotor, R1); dense and rumor probe uniformly
            study = {"n": n, "periods": periods, "engine": engine,
                     "probe": (cfg.ring_probe if engine in RING_ENGINES
                               else "pull"),
                     "crash_step": crash.tolist(),
                     "false_dead_views_final": int(np.asarray(
                         false_dead)[-1])}
            for name, arr in milestones.items():
                study[f"first_{name}" if name != "disseminated"
                      else name] = arr.tolist()
            path = flight_record or "flight_record.jsonl"
            rec.dump(path, reason=reason or "on_demand",
                     extra={"study": study})
            out["flight_record"] = path
    return out


def fp_sweep(n: int = 100_000, losses: tuple = (0.0, 0.1, 0.2, 0.3),
             partition: bool = True, periods: int = 100, seed: int = 0,
             engine: str = "auto", device=None,
             **cfg_kw) -> dict[str, Any]:
    """Loss (+ optional mid-run 2-way partition) -> false-positive
    rates: live nodes holding a DEAD view of a live node, at the end of
    the run and at the peak."""
    engine = pick_engine(n, engine)
    _require_ported(engine)
    dev = devmod.resolve(device)
    points = []
    for loss in losses:
        cfg = SwimConfig(n_nodes=n, **cfg_kw)
        plan = faults.with_loss(faults.none(n, dev), loss)
        if partition:
            plan = faults.with_partition(plan, faults.halves(n),
                                         periods // 3, 2 * periods // 3)
        res = _run_study(cfg, plan, threefry.key(seed), periods, engine,
                         device)
        series = runner.host_series(res.series)
        pt = {
            "loss": loss,
            "suspect_views_peak": int(series.suspect_views.max()),
            "false_dead_views_final": int(series.false_dead_views[-1]),
            "false_dead_views_peak": int(series.false_dead_views.max()),
            "max_incarnation": int(series.max_incarnation.max()),
        }
        if engine != "dense":
            pt["overflow"] = int(res.state.overflow)
        points.append(pt)
    return {"study": "fp_sweep", "n": n, "periods": periods,
            "engine": engine, "partition": partition, "points": points}


def suspicion_sweep(n: int = 1_000_000,
                    mults: tuple = (2.0, 3.0, 5.0, 8.0),
                    crash_fraction: float = 0.001, loss: float = 0.05,
                    losses: tuple | None = None,
                    periods: int = 100, seed: int = 0,
                    engine: str = "auto", device=None,
                    **cfg_kw) -> dict[str, Any]:
    """Suspicion-timeout multiplier sweep: latency against false
    positives, at `loss` or over the grid `mults x losses`."""
    engine = pick_engine(n, engine)
    _require_ported(engine)
    dev = devmod.resolve(device)
    grid = tuple(losses) if losses else (loss,)
    points = []
    for lv in grid:
        for mult in mults:
            cfg = SwimConfig(n_nodes=n, suspicion_mult=mult, **cfg_kw)
            plan = faults.with_loss(
                _crash_plan(n, seed, crash_fraction, periods, dev), lv)
            res = _run_study(cfg, plan, threefry.key(seed), periods,
                             engine, device)
            pt = {"suspicion_mult": mult, "loss": lv,
                  "suspicion_periods": cfg.suspicion_periods}
            pt.update(runner.detection_summary(res, plan, periods))
            pt["false_dead_views_peak"] = int(
                runner.host_series(res.series).false_dead_views.max())
            points.append(pt)
    return {"study": "suspicion_sweep", "n": n, "periods": periods,
            "engine": engine, "losses": list(grid), "points": points}


def lifeguard_ablation(n: int = 1_000_000, crash_fraction: float = 0.001,
                       loss: float = 0.2, periods: int = 100, seed: int = 0,
                       engine: str = "auto", budget_arms: bool = False,
                       device=None, **cfg_kw) -> dict[str, Any]:
    """Lifeguard against vanilla SWIM under lossy churn.
    `budget_arms=True` adds twins of both arms with a four times larger
    origination budget (ring_orig_words 2 -> 8)."""
    engine = pick_engine(n, engine)
    _require_ported(engine)
    dev = devmod.resolve(device)
    arm_defs = [("vanilla", False, {}), ("lifeguard", True, {})]
    if budget_arms:
        if engine not in RING_ENGINES:
            raise ValueError("budget_arms sweeps ring_orig_words — ring "
                             "engines only")
        arm_defs += [("vanilla_ob8", False, {"ring_orig_words": 8}),
                     ("lifeguard_ob8", True, {"ring_orig_words": 8})]
    arms = {}
    for name, lg, extra in arm_defs:
        cfg = SwimConfig(n_nodes=n, lifeguard=lg, **{**cfg_kw, **extra})
        plan = faults.with_loss(
            _crash_plan(n, seed, crash_fraction, periods, dev), loss)
        res = _run_study(cfg, plan, threefry.key(seed), periods, engine,
                         device)
        arm = runner.detection_summary(res, plan, periods)
        arm["false_dead_views_peak"] = int(
            runner.host_series(res.series).false_dead_views.max())
        arm["ring_orig_words"] = cfg.ring_orig_words
        arms[name] = arm
    return {"study": "lifeguard_ablation", "n": n, "periods": periods,
            "engine": engine, "loss": loss, "arms": arms}


STUDIES: dict[str, Callable[..., dict]] = {
    "detection": detection_study,
    "fp_sweep": fp_sweep,
    "suspicion_sweep": suspicion_sweep,
    "lifeguard": lifeguard_ablation,
}

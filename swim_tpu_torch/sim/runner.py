"""Study runners (port of `swim_tpu/sim/runner.py`).

Each period, after the engine's step, the runner folds the state into

  * per-crashed-node milestones: first suspicion seen by a live node,
    first DEAD view, DEAD known by all live nodes (`StudyTrack` over all
    N nodes, or `CompactTrack` over the subjects that crash within the
    study);
  * per-period global counters (`PeriodSeries`): knower-weighted
    suspect and dead views, false dead views, the largest incarnation.

One runner per engine: `run_study` (dense: the [N, N] views read
directly), `run_study_rumor` (rumor: per-rumor counts of live knowers,
`rumor.live_knowers`, once a period) and `run_study_ring` /
`run_study_ring_stream` (ring: the census `ring.live_knower_counts`).
The streaming ring runner keeps the compact track, runs in chunks of
periods and can checkpoint between chunks (`StudyCheckpointer`) and
resume bitwise.  The ring runners also step a placed state (the sharded
engine, parallel/ring_shard.py) through its `mapped_step` as `step_fn`,
and the result holds the placed state; `run_study` steps the
partitioned dense engine (parallel/partition.py) the same way, its
census reading each shard's rows of `key` on the shard's device and
joining the parts on shard 0's.  The ring census counts each
shard's blocks of `win` and `cold` against its rows of `up` on the
shard's device, and sums the partial counts in int64 on shard 0's
device, cut to int32, as the reference's partitioned census does
(`_placed_knowers`); only the per-node and replicated fields are
assembled there, never the window or the cold ring.  `run_study_rumor`
steps the exchange-sharded rumor engine (parallel/shard_engine.py) the
same way; its census counts each shard's block of `knows` and sums the
counts in int32 (`_live_knowers`), never assembling the [N, R] matrix,
and reads the other fields assembled.  The per-period values stay on
the device and are stacked at the end (a chunk's end for the stream):
no host sync inside a period.  Counts are int32 with int32 wrap, as
the reference's (the sums are taken in int64 and cut to 32 bits).

With `cfg.telemetry` every runner steps the engine with its tap and
returns the period-stacked `EngineFrame` (obs/engine.py) as the
result's `telemetry`; else that field is None.

`run_study_batch` runs P studies of one configuration as one step a
period over a leading lane axis (`torch.func.vmap` of the study bodies,
as the reference's vmap), on one device or, with the sharded or
partitioned step as `step_fn`, on placed lane-stacked states (one
sharded step a period for all lanes); `batch_states` stacks per-lane
states or results along that axis and `lane_result` takes one lane
back out.
"""
from __future__ import annotations

import functools
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.obs import analyze
from swim_tpu_torch.obs.engine import (concat_frames, frame_from_tap,
                                       stack_frames)
from swim_tpu_torch.ops import lattice, u32
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.sim import faults
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.utils import checkpoint, prng
from swim_tpu_torch.utils.tree import tree_map

NEVER = analyze.NEVER
I32 = torch.int32
I64 = torch.int64


class StudyTrack(NamedTuple):
    """Per-crashed-node detection milestones (i32[N], NEVER = not yet)."""

    first_suspect: torch.Tensor    # some live node stops believing ALIVE
    first_dead_view: torch.Tensor  # some live node holds DEAD
    disseminated: torch.Tensor     # all live nodes hold DEAD


class PeriodSeries(NamedTuple):
    """Per-period global counters (i32[periods])."""

    suspect_views: torch.Tensor
    dead_views: torch.Tensor
    false_dead_views: torch.Tensor
    max_incarnation: torch.Tensor


class StudyResult(NamedTuple):
    state: dense.DenseState
    track: StudyTrack
    series: PeriodSeries
    # [periods]-stacked obs.engine.EngineFrame when cfg.telemetry, else None
    telemetry: Any = None


class RumorStudyResult(NamedTuple):
    state: rumor.RumorState
    track: StudyTrack
    series: PeriodSeries
    telemetry: Any = None      # as StudyResult.telemetry


class RingStudyResult(NamedTuple):
    state: ring.RingState
    track: Any                 # StudyTrack or CompactTrack
    series: PeriodSeries
    telemetry: Any = None      # as StudyResult.telemetry


class CompactTrack(NamedTuple):
    """Detection milestones restricted to crashed subjects (i32[C])."""

    subjects: torch.Tensor     # node ids with crash_step < periods, asc.
    crash_step: torch.Tensor   # their crash periods
    first_suspect: torch.Tensor
    first_dead_view: torch.Tensor
    disseminated: torch.Tensor


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 count as the int32 the reference's int32 sum gives."""
    return u32.from_u64(x)


def _view_counts(subject, rkey, knowers, up, gone_dead):
    """Knower-weighted (suspect, dead) view counts over the rumor table
    plus the dissemination floor."""
    used = subject >= 0
    live_total = up.sum(dtype=I64)
    sus = torch.where(used & lattice.is_suspect(rkey), knowers, 0)
    dead = torch.where(used & lattice.is_dead(rkey), knowers, 0)
    return (_wrap32(sus.sum(dtype=I64)),
            _wrap32(dead.sum(dtype=I64)
                    + gone_dead.sum(dtype=I64) * live_total))


def _subject_flags(n: int, subject, rkey, knowers, up, gone_not_alive,
                   gone_dead):
    """Per-subject (not-alive-seen, dead-seen, dead-disseminated) bool[N]
    plus the view counts.  The three flags ride one verdict code per
    subject (bit0 not-alive seen, bit1 dead seen, bit2 disseminated),
    written by one scatter-max over a spare row: within a period the
    slot codes form a chain ({0, 1, 3, 7}, or {0, 4} with no live
    observer), so the max is the per-bit OR."""
    used = subject >= 0
    live_total = up.sum(dtype=I64)
    is_s = lattice.is_suspect(rkey)
    is_d = lattice.is_dead(rkey)
    known = used & (knowers > 0)
    code = ((known & (is_s | is_d)).to(I32)
            | (known & is_d).to(I32) << 1
            | (used & is_d & (knowers >= live_total)).to(I32) << 2)
    sub = torch.where(used, subject, n).to(I64)
    verdict = torch.zeros((n + 1,), dtype=I32, device=subject.device)
    verdict = verdict.scatter_reduce(0, sub, code, "amax")[:n]
    verdict = (verdict | torch.where(gone_not_alive, 1, 0)
               | torch.where(gone_dead, 6, 0))
    return ((verdict & 1) > 0, (verdict & 2) > 0, (verdict & 4) > 0,
            _view_counts(subject, rkey, knowers, up, gone_dead))


def _false_dead_views(subject, rkey, knowers, up, gone_dead):
    """Knower-weighted DEAD views whose subject is actually alive."""
    used = subject >= 0
    live_total = up.sum(dtype=I64)
    live_subj = up[subject.clamp(min=0).to(I64)]
    wrong = torch.where(used & lattice.is_dead(rkey) & live_subj, knowers, 0)
    return _wrap32(wrong.sum(dtype=I64)
                   + (gone_dead & up).sum(dtype=I64) * live_total)


def _max_incarnation(st) -> torch.Tensor:
    """The largest incarnation in the rumor table and the own
    incarnations (ring and rumor states)."""
    inc = torch.cat([lattice.incarnation_of(st.rkey), st.inc_self])
    return u32.flip(u32.flip(inc).max())


def _placed_knowers(cfg: SwimConfig, state, up: torch.Tensor
                    ) -> torch.Tensor:
    """ring.live_knower_counts of a placed state: each shard's count of
    its own rows on its device, the partial counts summed in int64 on
    `up`'s device and cut to int32."""
    s = cfg.n_nodes // len(state.win.blocks)
    parts = []
    for i, blk in enumerate(state.win.blocks):
        mine = up[i * s:(i + 1) * s].to(blk.device)
        parts.append(ring.live_knower_counts(cfg, pmesh.block(state, i),
                                             mine).to(up.device, I64))
    return _wrap32(torch.stack(parts).sum(0))


def _census(cfg: SwimConfig, state, base: FaultPlan):
    """What every study body reads after a step: (the state's per-node
    and replicated fields, whole; t, crashed, up, knowers,
    gone_not_alive, gone_dead) of the period just run.  `state` is
    whole or placed (the census then counts per shard), `base` whole."""
    placed = isinstance(state.win, pmesh.Sharded)
    st = (pmesh.assemble(state._replace(win=None, cold=None)) if placed
          else state)
    t, crashed, up = _observers(st, base)
    knowers = (_placed_knowers(cfg, state, up) if placed
               else ring.live_knower_counts(cfg, st, up))
    gone = st.gone_key
    gone_dead = lattice.is_dead(gone)
    return (st, t, crashed, up, knowers,
            lattice.is_suspect(gone) | gone_dead, gone_dead)


def _first(cur, cond, crashed, t):
    return torch.where(cond & crashed & (cur == NEVER), t, cur)


def make_stepper(cfg: SwimConfig, plan, engine_step, step_fn=None):
    """(state, rnd, shifts=None) -> (state, EngineFrame or None):
    `engine_step(cfg, state, plan, rnd)`, with its tap when
    cfg.telemetry.  `step_fn(state, plan, rnd)` overrides it; under
    telemetry it returns (state, frame) itself, as in the reference.
    A step_fn whose `takes_shifts` is true (the sharded ring's) is
    called with the period's host shifts too, as the ring runners pass
    them (`ring.period_draws`)."""
    if step_fn is not None:
        takes = getattr(step_fn, "takes_shifts", False)

        def call(st, rnd, shifts=None):
            out = (step_fn(st, plan, rnd, shifts) if takes
                   else step_fn(st, plan, rnd))
            return out if cfg.telemetry else (out, None)
        return call
    if not cfg.telemetry:
        return lambda st, rnd, shifts=None: (engine_step(cfg, st, plan,
                                                         rnd), None)

    def tapped(st, rnd, shifts=None):
        tap: dict = {}
        st = engine_step(cfg, st, plan, rnd, tap=tap)
        return st, frame_from_tap(tap, st.step.device)
    return tapped


def _stack(rows: list) -> PeriodSeries:
    return PeriodSeries(*(torch.stack(col) for col in zip(*rows)))


def _frames(frames: list):
    """The stacked telemetry of a run, None when the tap was off."""
    return stack_frames(frames) if frames and frames[0] is not None \
        else None


def run_study_ring(cfg: SwimConfig, state: ring.RingState, plan,
                   root_key: tuple[int, int], periods: int,
                   step_fn=None) -> RingStudyResult:
    """Ring-engine study with the full StudyTrack over all N nodes.
    `root_key` is a threefry key (`threefry.key(seed)`); `step_fn(state,
    plan, rnd)` overrides the stepper (e.g. the plain versions of the
    kernels).  The `disseminated` milestone reads the dissemination floor
    (gone_key), so it can lag true dissemination by up to the window
    length (deviation R2); the other two are exact."""
    stepper = make_stepper(cfg, plan, ring.step, step_fn)
    dev = state.win.device
    base = pmesh.assemble(faults.base_of(plan))
    track = _new_track(cfg.n_nodes, dev)
    rows, frames = [], []
    for rnd, shifts in ring.period_draws(cfg, root_key, _step_of(state),
                                         periods, dev):
        state, track, row, frame = ring_study_period(
            cfg, state, track, base, rnd, stepper, shifts)
        rows.append(row)
        frames.append(frame)
    return RingStudyResult(state, track, _stack(rows), _frames(frames))


def ring_study_period(cfg: SwimConfig, state, track: StudyTrack,
                      base: FaultPlan, rnd, stepper, shifts=None):
    """One period of the full-track ring study, all on the device:
    (state, track, the period's series row, its EngineFrame or None);
    `base` is the plan's whole FaultPlan, `shifts` the period's host
    shifts (the sharded step's)."""
    state, frame = stepper(state, rnd, shifts)
    whole, t, crashed, up, knowers, gone_na, gone_dead = _census(
        cfg, state, base)
    not_alive, dead_seen, dead_all, counts = _subject_flags(
        cfg.n_nodes, whole.subject, whole.rkey, knowers, up, gone_na,
        gone_dead)
    track = StudyTrack(
        first_suspect=_first(track.first_suspect, not_alive, crashed, t),
        first_dead_view=_first(track.first_dead_view, dead_seen, crashed,
                               t),
        disseminated=_first(track.disseminated, dead_all, crashed, t))
    return state, track, (counts[0], counts[1],
                          _false_dead_views(whole.subject, whole.rkey,
                                            knowers, up, gone_dead),
                          _max_incarnation(whole)), frame


def _step_of(state) -> int:
    """The period counter of a whole or placed state, on the host."""
    return int(pmesh.assemble(state.step))


def _new_track(n: int, dev) -> StudyTrack:
    return StudyTrack(*(torch.full((n,), NEVER, dtype=I32, device=dev)
                        for _ in range(3)))


def _observers(state, base: FaultPlan):
    """(t, crashed, live) of the period just run."""
    t = state.step - 1
    crashed = t >= base.crash_step
    return t, crashed, ~crashed & (t >= base.join_step)


def _dense_rows(key: torch.Tensor, live_rows: torch.Tensor,
                live: torch.Tensor) -> tuple:
    """What the dense census reads of a block of observer rows `key`
    [m, N] (`live_rows` their liveness, `live` every node's): per
    subject, some live row holds it SUSPECT or DEAD, some live row
    holds it DEAD, every live row holds it DEAD; the int64 counts of
    live suspect, dead and false-dead views; the largest incarnation."""
    live_col = live_rows[:, None]
    dead = lattice.is_dead(key)
    susp = lattice.is_suspect(key)
    dead_live = dead & live_col
    return (((susp | dead) & live_col).any(dim=0), dead_live.any(dim=0),
            (dead | ~live_col).all(dim=0), (susp & live_col).sum(dtype=I64),
            dead_live.sum(dtype=I64),
            (dead_live & live[None, :]).sum(dtype=I64),
            lattice.incarnation_of(key).max())


def dense_study_period(cfg: SwimConfig, state: dense.DenseState,
                       track: StudyTrack, base: FaultPlan, rnd, stepper):
    """One period of the dense study, all on the device: (state, track,
    the period's series row, its EngineFrame or None); `stepper` as
    `make_stepper` makes it.  The views are read off the [N, N] keys;
    `live` (crash- and join-aware) selects the observers.  A placed
    state's row blocks are read each on its device and the parts joined
    on `live`'s (ORs, ANDs, int64 sums, a max)."""
    state, frame = stepper(state, rnd)
    placed = isinstance(state.key, pmesh.Sharded)
    st = (pmesh.assemble(state._replace(key=None, retransmit=None,
                                        deadline=None)) if placed
          else state)
    t, crashed, live = _observers(st, base)
    parts, off = [], 0
    for blk in (state.key.blocks if placed else [state.key]):
        m = blk.shape[0]
        lv = live.to(blk.device)
        parts.append([x.to(live.device) for x in
                      _dense_rows(blk, lv[off:off + m], lv)])
        off += m
    ops = (torch.logical_or, torch.logical_or, torch.logical_and,
           torch.add, torch.add, torch.add, torch.maximum)
    sus_seen, dead_seen, dead_all, sus, dead_n, false_dead, inc = (
        functools.reduce(op, col) for op, col in zip(ops, zip(*parts)))
    track = StudyTrack(
        first_suspect=_first(track.first_suspect, sus_seen, crashed, t),
        first_dead_view=_first(track.first_dead_view, dead_seen, crashed, t),
        disseminated=_first(track.disseminated, dead_all, crashed, t))
    row = (_wrap32(sus), _wrap32(dead_n), _wrap32(false_dead), inc)
    return state, track, row, frame


def run_study(cfg: SwimConfig, state: dense.DenseState, plan,
              root_key: tuple[int, int], periods: int,
              step_fn=None) -> StudyResult:
    """Dense-engine study with the full StudyTrack over all N nodes.
    `root_key` is a threefry key (`threefry.key(seed)`); `step_fn(state,
    plan, rnd)` overrides the step: the partitioned engine
    (parallel/partition.py `build_step`) on a placed state and plan.
    Reads state.step once."""
    dev = state.key.device
    base = pmesh.assemble(faults.base_of(plan))
    track = _new_track(cfg.n_nodes, dev)
    rows, frames = [], []
    t0 = _step_of(state)
    stepper = make_stepper(cfg, plan, dense.step, step_fn)
    for t in range(t0, t0 + periods):
        state, track, row, frame = dense_study_period(
            cfg, state, track, base, prng.draw_period(root_key, t, cfg, dev),
            stepper)
        rows.append(row)
        frames.append(frame)
    return StudyResult(state, track, _stack(rows), _frames(frames))


def _live_knowers(knows, up: torch.Tensor) -> torch.Tensor:
    """rumor.live_knowers of a whole or a placed heard-bit matrix: a
    placed one counts each shard's block against its rows of `up` on
    the shard's device and sums the counts in int32 on `up`'s device
    (the whole matrix's bits)."""
    if not isinstance(knows, pmesh.Sharded):
        return rumor.live_knowers(knows, up)
    s = knows.blocks[0].shape[0]
    return torch.stack([
        rumor.live_knowers(b, up[i * s:(i + 1) * s].to(b.device))
        .to(up.device) for i, b in enumerate(knows.blocks)]).sum(
            0, dtype=I32)


def rumor_study_period(cfg: SwimConfig, state: rumor.RumorState,
                       track: StudyTrack, base: FaultPlan, rnd, stepper):
    """One period of the rumor study, all on the device: (state, track,
    the period's series row, its EngineFrame or None).  The live-knower
    counts of the rumors are taken once; the tombstone floor holds only
    DEAD keys.  A placed state's fields but `knows` are read assembled."""
    state, frame = stepper(state, rnd)
    st = pmesh.assemble(state._replace(knows=None))
    t, crashed, up = _observers(st, base)
    knowers = _live_knowers(state.knows, up)
    gone_dead = lattice.is_dead(st.gone_key)
    not_alive, dead_seen, dead_all, counts = _subject_flags(
        cfg.n_nodes, st.subject, st.rkey, knowers, up, gone_dead,
        gone_dead)
    track = StudyTrack(
        first_suspect=_first(track.first_suspect, not_alive, crashed, t),
        first_dead_view=_first(track.first_dead_view, dead_seen, crashed, t),
        disseminated=_first(track.disseminated, dead_all, crashed, t))
    return state, track, (counts[0], counts[1],
                          _false_dead_views(st.subject, st.rkey,
                                            knowers, up, gone_dead),
                          _max_incarnation(st)), frame


def run_study_rumor(cfg: SwimConfig, state: rumor.RumorState, plan,
                    root_key: tuple[int, int], periods: int,
                    step_fn=None) -> RumorStudyResult:
    """Rumor-engine study with the full StudyTrack.  `root_key` is a
    threefry key (`threefry.key(seed)`).  `step_fn(state, plan, rnd)`
    overrides the step: the exchange-sharded engine
    (parallel/shard_engine.py `build_step`) on a placed state and plan.
    Reads state.step once."""
    dev = state.knows.device
    base = pmesh.assemble(faults.base_of(plan))
    track = _new_track(cfg.n_nodes, dev)
    rows, frames = [], []
    t0 = _step_of(state)
    stepper = make_stepper(cfg, plan, rumor.step, step_fn)
    for t in range(t0, t0 + periods):
        state, track, row, frame = rumor_study_period(
            cfg, state, track, base,
            rumor.draw_period_rumor(root_key, t, cfg, dev), stepper)
        rows.append(row)
        frames.append(frame)
    return RumorStudyResult(state, track, _stack(rows), _frames(frames))


def compact_track_init(plan, periods: int) -> CompactTrack:
    """The subjects that can crash within the study window, ascending
    (the order of study_milestones' restriction of the full track).
    Reads the crash schedule to the host once."""
    base = pmesh.assemble(faults.base_of(plan))
    dev = base.crash_step.device
    crash = base.crash_step.cpu().numpy()
    subjects = np.flatnonzero(crash < periods).astype(np.int32)
    c = subjects.size
    return CompactTrack(
        subjects=torch.from_numpy(subjects).to(dev),
        crash_step=torch.from_numpy(crash[subjects].astype(np.int32)).to(dev),
        first_suspect=torch.full((c,), NEVER, dtype=I32, device=dev),
        first_dead_view=torch.full((c,), NEVER, dtype=I32, device=dev),
        disseminated=torch.full((c,), NEVER, dtype=I32, device=dev))


def _compact_subject_flags(subjects, subject, rkey, knowers, up,
                           gone_not_alive, gone_dead):
    """_subject_flags restricted to the crashed-subject list: a [C, R]
    compare against the rumor table plus [C] floor gathers."""
    used = subject >= 0
    live_total = up.sum(dtype=I64)
    is_s = lattice.is_suspect(rkey)
    is_d = lattice.is_dead(rkey)
    known = used & (knowers > 0)
    eq = subject[None, :] == subjects[:, None]                   # [C, R]
    sub64 = subjects.to(I64)

    def hit(pred):
        return (eq & pred[None, :]).any(dim=1)

    not_alive = hit(known & (is_s | is_d)) | gone_not_alive[sub64]
    dead_seen = hit(known & is_d) | gone_dead[sub64]
    dead_all = (hit(used & is_d & (knowers >= live_total))
                | gone_dead[sub64])
    return not_alive, dead_seen, dead_all


def study_period(cfg: SwimConfig, state, track: CompactTrack, base, rnd,
                 stepper, shifts=None):
    """One period of a streaming study, all on the device (no host
    read): (state, track, the period's series row, its EngineFrame or
    None).  `base` is the plan's whole FaultPlan, `shifts` the period's
    host shifts (the sharded step's)."""
    state, frame = stepper(state, rnd, shifts)
    whole, t, _, up, knowers, gone_na, gone_dead = _census(cfg, state,
                                                           base)
    not_alive, dead_seen, dead_all = _compact_subject_flags(
        track.subjects, whole.subject, whole.rkey, knowers, up,
        gone_na, gone_dead)
    crashed = t >= track.crash_step
    track = track._replace(
        first_suspect=_first(track.first_suspect, not_alive, crashed, t),
        first_dead_view=_first(track.first_dead_view, dead_seen,
                               crashed, t),
        disseminated=_first(track.disseminated, dead_all, crashed, t))
    counts = _view_counts(whole.subject, whole.rkey, knowers, up,
                          gone_dead)
    return state, track, (counts[0], counts[1],
                          _false_dead_views(whole.subject, whole.rkey,
                                            knowers, up, gone_dead),
                          _max_incarnation(whole)), frame


def _run_study_ring_chunk(cfg: SwimConfig, state, track: CompactTrack,
                          plan, root_key, periods: int, stepper):
    """`periods` periods of a streaming study: (state, track, series and
    stacked frames (or None) of the chunk on the device).  The period
    clock is state.step, so chained chunks reproduce one long run
    bitwise."""
    dev = state.win.device
    base = pmesh.assemble(faults.base_of(plan))
    rows, frames = [], []
    for rnd, shifts in ring.period_draws(cfg, root_key, _step_of(state),
                                         periods, dev):
        state, track, row, frame = study_period(cfg, state, track, base,
                                                rnd, stepper, shifts)
        rows.append(row)
        frames.append(frame)
    return state, track, _stack(rows), _frames(frames)


class StudyCheckpointer:
    """Mid-study checkpoint/resume for the streaming runner: {engine
    state, CompactTrack, series prefix, root key, step} in one `.npz`
    per snapshot (utils/checkpoint.py), the newest `keep` kept.
    `restore` puts the engine state on `state_like`'s device; the track
    and series prefix come back as host arrays."""

    def __init__(self, directory: str, every: int = 0, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _snaps(self) -> list[str]:
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("study_") and f.endswith(".npz"))

    def save(self, state, track: CompactTrack, series: PeriodSeries,
             root_key: tuple[int, int], step: int) -> str:
        path = os.path.join(self.directory, f"study_{step:012d}.npz")
        checkpoint.save_placed(path, (state, track, series), root_key, step)
        for f in self._snaps()[:-self.keep]:
            os.remove(os.path.join(self.directory, f))
        return path

    def latest(self) -> str | None:
        snaps = self._snaps()
        return os.path.join(self.directory, snaps[-1]) if snaps else None

    def restore(self, state_like):
        """None when no snapshot exists; else (state, track, series
        prefix, root_key, step)."""
        path = self.latest()
        if path is None:
            return None
        track_like = CompactTrack(None, None, None, None, None)
        series_like = PeriodSeries(None, None, None, None)
        (state, track, series), root_key, step = checkpoint.restore_placed(
            path, (state_like, track_like, series_like))
        return (state, CompactTrack(*track), PeriodSeries(*series),
                root_key, step)


def host_series(series: PeriodSeries) -> PeriodSeries:
    """The series as numpy arrays."""
    return PeriodSeries(*(x.cpu().numpy() for x in series))


def run_study_ring_stream(cfg: SwimConfig, state, plan,
                          root_key: tuple[int, int], periods: int,
                          step_fn=None, chunk: int = 0,
                          ckpt: StudyCheckpointer | None = None
                          ) -> RingStudyResult:
    """Streaming ring study: the CompactTrack, `chunk` periods per chunk
    (0 = one chunk, or ckpt.every when checkpointing), a snapshot after
    every chunk but the last.  When `ckpt` holds a snapshot the study
    resumes from it: callers pass the same (cfg, plan, root_key,
    periods), and the result is bitwise that of an uninterrupted run;
    milestones and series equal run_study_ring's (restricted to the
    crashed subjects)."""
    if ckpt is not None and cfg.telemetry:
        raise ValueError("streaming study checkpointing does not cover "
                         "telemetry frames; disable one of them")
    stepper = make_stepper(cfg, plan, ring.step, step_fn)
    dev = state.win.device
    # each chunk takes the state out of `held` and puts its end state
    # back, so no frame here keeps the state a chunk started from
    held = {"state": state}
    del state
    track = None
    done = 0
    series_parts: list = []
    frame_parts: list = []
    if ckpt is not None:
        restored = ckpt.restore(held["state"])
        if restored is not None:
            held["state"], track, series_prefix, root_key, done = restored
            if done > periods:
                raise ValueError(
                    f"checkpoint at step {done} is beyond the requested "
                    f"{periods}-period study")
            series_parts.append(series_prefix)
    if track is None:
        track = compact_track_init(plan, periods)
    else:
        # a snapshot's subject list is a function of (plan, periods):
        # resuming under another pair would drop or invent subjects
        want = compact_track_init(plan, periods)
        if not np.array_equal(want.subjects.cpu().numpy(),
                              np.asarray(track.subjects)):
            raise ValueError(
                "checkpointed subject list does not match this "
                "(plan, periods); resume a study with its original "
                "arguments")
        track = CompactTrack(*(torch.from_numpy(np.asarray(a)).to(dev)
                               for a in track))
    if chunk <= 0:
        chunk = (ckpt.every if ckpt is not None and ckpt.every > 0
                 else periods)
    while done < periods:
        csize = min(chunk, periods - done)
        held["state"], track, series_c, frames_c = _run_study_ring_chunk(
            cfg, held.pop("state"), track, plan, root_key, csize, stepper)
        done += csize
        series_parts.append(host_series(series_c))
        if frames_c is not None:
            frame_parts.append(frames_c)
        if ckpt is not None and done < periods:
            series_so_far = PeriodSeries(*(np.concatenate(xs) for xs in
                                           zip(*series_parts)))
            ckpt.save(held["state"], track, series_so_far, root_key, done)
    series = PeriodSeries(*(torch.from_numpy(np.concatenate(xs)).to(dev)
                            for xs in zip(*series_parts)))
    frames = concat_frames(frame_parts) if frame_parts else None
    return RingStudyResult(held["state"], track, series, frames)


# ---------------------------------------------------------------------
# Batched studies: P studies of one configuration along a leading P axis
# ---------------------------------------------------------------------


_BODIES = {
    "dense": (dense.step, dense_study_period, StudyResult),
    "rumor": (rumor.step, rumor_study_period, RumorStudyResult),
    "ring": (ring.step, ring_study_period, RingStudyResult),
}


def lane_draws(cfg: SwimConfig, kind: str, keys: list, t0: int,
               periods: int, dev):
    """Every lane's draws of periods t0 .. t0+periods-1, stacked along a
    leading P axis (one set of launches a period): the ring's rotor
    offsets, a function of the step alone, stay one shared copy."""
    for rnd, _ in _lane_periods(cfg, kind, keys, t0, periods, dev):
        yield rnd


def _lane_periods(cfg: SwimConfig, kind: str, keys: list, t0: int,
                  periods: int, dev):
    """(lane_draws' draw, the ring's host shifts or None) of each
    period."""
    if kind == "ring":
        yield from ring.period_draws(cfg, keys, t0, periods, dev)
        return
    draw = prng.draw_period if kind == "dense" else rumor.draw_period_rumor
    for t in range(t0, t0 + periods):
        yield draw(keys, t, cfg, dev), None


def _lane_dims(rnd):
    """vmap in-dims of a lane-stacked draw: 0 on every leaf, None on the
    ring's shared rotor offsets."""
    dims = tree_map(lambda x: 0, rnd)
    if isinstance(rnd, ring.RingRandomness):
        dims = dims._replace(s_off=None, q_off=None)
    return dims


def batch_period(cfg: SwimConfig, kind: str, rnd, step_fn=None):
    """`kind`'s study period vmapped over the lane axis: (state, track,
    plan, rnd, shifts=None), each lane-stacked as `rnd` (a `lane_draws`
    draw), -> (state, track, the period's series row, its EngineFrame;
    the state's step in the frame's place when cfg.telemetry is off).
    `step_fn` is the serial runners' (make_stepper): the sharded or
    partitioned step on placed lane-stacked trees, which crosses the
    vmap itself; `shifts` the ring's host shifts of the period, which
    the sharded ring step reads."""
    engine_step, body, _ = _BODIES[kind]

    def period(state, track, plan, rnd, shifts=None):
        stepper = make_stepper(cfg, plan, engine_step, step_fn)
        extra = () if shifts is None else (shifts,)
        out = body(cfg, state, track, pmesh.assemble(faults.base_of(plan)),
                   rnd, stepper, *extra)
        return out if cfg.telemetry else out[:3] + (state.step,)

    vperiod = torch.func.vmap(period,
                              in_dims=(0, 0, 0, _lane_dims(rnd), None))
    return lambda state, track, plan, rnd, shifts=None: vperiod(
        state, track, plan, rnd, shifts)


def run_study_batch(cfg: SwimConfig, states, plans, root_keys,
                    periods: int, kind: str, step_fn=None):
    """P studies of one configuration as one step a period over a
    leading lane axis: the reference's `run_study_batch`, a vmap of the
    unchanged study bodies.  `states` and `plans` carry a leading P axis
    (`batch_states`, `faults.stack_programs`), `root_keys` is one
    threefry key per lane and `kind` the engine ("dense", "rumor" or
    "ring").  Each period draws every lane's randomness in one set of
    launches, outside the vmap, and calls `torch.func.vmap` of the
    engine's study period once on the lane-stacked (state, track, plan,
    draws): every op, the three kernels included (their vmap rules),
    runs once for all lanes.  `step_fn` overrides the engine's step as
    in the serial runners: the sharded ring's or a partitioned step, on
    placed lane-stacked states and plans (`place(..., lanes=1)`), which
    runs one sharded step a period for all lanes, each shard's kernels
    launched once for all of them.  The lanes share one period clock,
    read once.  Returns the engine's result with every leaf [P, ...]
    (series and frames [P, periods]; a placed state stays placed);
    lane p is bitwise the serial study of lane p's state, plan and
    key."""
    result = _BODIES[kind][2]
    keys = list(root_keys)
    steps = pmesh.assemble(states.step).cpu()
    if steps.shape != (len(keys),):
        raise ValueError(f"batched studies: {len(keys)} root keys for "
                         f"states of lanes {tuple(steps.shape)}")
    if not bool((steps == steps[0]).all()):
        raise ValueError("batched studies: the lanes start at different "
                         f"steps {steps.tolist()}")
    dev = states.step.device
    track = StudyTrack(*(torch.full((len(keys), cfg.n_nodes), NEVER,
                                    dtype=I32, device=dev)
                         for _ in range(3)))
    takes = getattr(step_fn, "takes_shifts", False)
    state, rows, frames, vperiod = states, [], [], None
    del states
    for rnd, shifts in _lane_periods(cfg, kind, keys, int(steps[0]),
                                     periods, dev):
        vperiod = vperiod or batch_period(cfg, kind, rnd, step_fn)
        state, track, row, frame = vperiod(state, track, plans, rnd,
                                           shifts if takes else None)
        rows.append(row)
        frames.append(frame)
    frames = (type(frames[0])(*(torch.stack(c, 1) for c in zip(*frames)))
              if cfg.telemetry and frames else None)
    return result(state, track, PeriodSeries(*(torch.stack(c, 1)
                                               for c in zip(*rows))),
                  frames)


def batch_states(states) -> Any:
    """Stack per-lane states (or any NamedTuples of one structure)
    leaf-wise along a new leading P axis; placed leaves stack block by
    block (`mesh.stack_lanes`)."""
    states = list(states)
    if not states:
        raise ValueError("batch_states: empty state list")
    return tree_map(lambda *xs: pmesh.stack_lanes(xs), *states)


def lane_result(result, p: int):
    """Lane `p` of a batched result (indexes every stacked leaf, a
    placed leaf block by block; a None telemetry slot stays None)."""
    return tree_map(lambda x: x.lane(p) if isinstance(x, pmesh.Sharded)
                    else x[p], result)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def study_milestones(result, plan, periods: int) -> tuple[np.ndarray, dict]:
    """(crash steps, milestone arrays) restricted to crashed subjects,
    from any runner's result; a CompactTrack already is this restriction
    (same order)."""
    names = (("suspect", "first_suspect"), ("dead_view", "first_dead_view"),
             ("disseminated", "disseminated"))
    if isinstance(result.track, CompactTrack):
        milestones = {name: _host(getattr(result.track, f)).astype(np.int64)
                      for name, f in names}
        return _host(result.track.crash_step).astype(np.int64), milestones
    crash = _host(faults.base_of(plan).crash_step)
    crashed = crash < periods
    milestones = {
        name: _host(getattr(result.track, f))[crashed].astype(np.int64)
        for name, f in names}
    return crash[crashed].astype(np.int64), milestones


def detection_summary(result, plan, periods: int) -> dict:
    """Host-side digest: detection-latency distribution in periods
    (obs/analyze.py `summarize_detection`)."""
    crash, milestones = study_milestones(result, plan, periods)
    if not crash.size:
        return {"crashed": 0}
    return analyze.summarize_detection(
        crash, milestones, int(_host(result.series.false_dead_views)[-1]))

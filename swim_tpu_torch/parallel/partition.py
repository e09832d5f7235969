"""The dense, ring and rumor engines partitioned over every device, as
the reference's GSPMD partitions them (`swim_tpu/sim/experiments.py`
`_run_study` / `_run_study_batch`, `swim_tpu/cli.py` simulate: the
plan and the state placed with `pmesh.shard_state` on `make_mesh()`,
XLA partitioning the single-program step over the node axis).

`partitions(mesh)`: a study partitions exactly when the mesh holds two
or more distinct devices.  On one card (the default mesh is then 8
slots of it) or with a named device the studies keep their one-device
path; on one device the reference's GSPMD partitions nothing either.

  * ring: the reference's GSPMD ring and its shard_map ring are
    bitwise equal, and the port's `ring_shard.mapped_step` is bitwise
    `ring.step` in every configuration the ring study runs, so the
    partitioned ring is `ring_shard.place` / `mapped_step` and its
    per-shard census (`runner._placed_knowers`).
  * dense and rumor: row-partitioned.  Each shard holds its rows of
    every node-axis field (dense's [N, N] `key`, `retransmit`,
    `deadline` and `lha`; rumor's [S, R] `knows`, `inc_self`, `lha`)
    and runs the engine's own `step` on them with a `ShardRows`
    (models/common.py's `Rows`) whose gathers, sums and maxima are the
    mesh's collectives.  The plan, the rumor table, the tombstones and
    the scalars are replicated, and every shard gets the period's whole
    randomness on its device (drawn once, copied once to each other
    device) and cuts its rows from it.  A wave's sender rows pick its
    payload (and advance dense's counts), one gather shares the picks in
    node order, and each shard merges the messages addressed to its
    rows, so nothing is dropped: no slack, no overflow, no plan
    refused.  The one-device step is the same code with all N rows.

A batch's placed trees carry a leading lane axis (`place(...,
lanes=1)`; `start` given a stacked program): each shard runs its lanes
under its thread's own vmap, the randomness copied to each device once
a period holds every lane, and a batched study's vmap is crossed as
ring_shard's step crosses it.

The node axis must split evenly over the mesh (the reference's
placement refuses an uneven split the same way).  `place`,
`build_step`, `build_run` and `start` take the engine's name; the
ring's go to `ring_shard`.  Each shard computes on its own device, and
the copies between devices go through the collectives, ordered by
events and counted in `Mesh.copied_bytes` (the randomness copied to
each other device before the shards start is not counted).
"""
from __future__ import annotations

import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.models.common import Rows
from swim_tpu_torch.obs.engine import frame_from_tap, stack_frames
from swim_tpu_torch.ops import scatter
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import ring_shard
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.sim.faults import FaultPlan, FaultProgram
from swim_tpu_torch.utils import prng, threefry
from swim_tpu_torch.utils.tree import tree_map

I32 = torch.int32
I64 = torch.int64

ENGINES = ("dense", "ring", "rumor")

# the node axis of each field (None = replicated)
STATE_SPECS = {
    "dense": dense.DenseState(key=0, retransmit=0, deadline=0, lha=0,
                              step=None),
    "rumor": rumor.RumorState(
        knows=0, inc_self=0, lha=0, gone_key=None, subject=None,
        rkey=None, birth=None, sent_node=None, sent_time=None,
        confirmed=None, overflow=None, step=None),
}
# every sender and receiver reads the plan's node lanes: replicated
_PLAN = FaultPlan(*(None,) * len(FaultPlan._fields))
PLAN_SPECS = {
    FaultPlan: _PLAN,
    FaultProgram: FaultProgram(_PLAN, *(None,) * (len(FaultProgram._fields)
                                                  - 1)),
}
_MODELS = {"dense": (dense, prng.draw_period),
           "rumor": (rumor, rumor.draw_period_rumor)}


def partitions(mesh: pmesh.Mesh) -> bool:
    """True where a study partitions over `mesh`: two or more distinct
    devices."""
    return len(mesh.distinct) >= 2


def _check(cfg: SwimConfig, engine: str, mesh: pmesh.Mesh) -> None:
    if engine not in ENGINES:
        raise ValueError(f"no partitioned '{engine}' engine; the "
                         f"partitioned engines are {ENGINES}")
    if cfg.n_nodes % mesh.size:
        raise ValueError(f"n_nodes={cfg.n_nodes} must divide over "
                         f"{mesh.size} shards")


class ShardRows(Rows):
    """Shard `rank`'s block of rows [rank * S, (rank + 1) * S) and the
    collectives `coll` that join the blocks (see common.Rows)."""

    def __init__(self, n: int, d: int, rank: int, coll: pmesh.Collectives):
        self.m = n // d
        self.off = rank * self.m
        self.rank = rank
        self.coll = coll

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return x.narrow(0, self.off, self.m)

    def mine(self, idx: torch.Tensor) -> torch.Tensor:
        return (idx >= self.off) & (idx < self.off + self.m)

    def local(self, idx: torch.Tensor, val: torch.Tensor):
        mine = self.mine(idx)
        mask = mine.reshape(mine.shape + (1,) * (val.dim() - mine.dim()))
        return torch.where(mine, idx - self.off, 0), val & mask

    def gather(self, xs: tuple) -> tuple:
        return tuple(x.reshape((x.shape[0] * x.shape[1],)
                               + tuple(x.shape[2:]))
                     for x in self.coll.stack_many(self.rank, tuple(xs)))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.coll.psum(self.rank, x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.coll.pmax(self.rank, x)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        return self.pmax(x.to(torch.uint8)) > 0

    def compact(self, valid: torch.Tensor, cols: tuple, width: int):
        """Each block's first min(S, width) valid candidates, in order,
        gathered in node order: they hold the first `width` valid ones
        of all N, in node order.  What a block drops is counted, and the
        count summed over the blocks (a reader that keeps `width` of
        them counts the rest as overflow: the same sum)."""
        w = max(1, min(self.m, width))
        ci = scatter.first_true(valid, w, self.m)
        got = ci < self.m
        cic = ci.clamp(max=self.m - 1).to(I64)
        out = self.gather((got, *(torch.where(got, c[cic], 0)
                                  for c in cols)))
        return out, self.psum((valid.sum(dtype=I32) - w).clamp(min=0))


class PartitionedStep:
    """step(state, plan, rnd) of `engine` ("dense" or "rumor") on a
    placed state and plan (`place`) and a whole period's randomness, as
    the engine's draw gives it: the placed next state, with
    cfg.telemetry `(state, EngineFrame)` (the tap's counts summed over
    the shards, equal on every shard)."""

    def __init__(self, cfg: SwimConfig, mesh: pmesh.Mesh, engine: str):
        _check(cfg, engine, mesh)
        if engine == "ring":
            raise ValueError("the partitioned ring is ring_shard's step "
                             "(build_step)")
        self.cfg = cfg
        self.mesh = mesh
        self.engine = engine

    def __call__(self, state, plan, rnd):
        level = pmesh.lane_level((state, plan, rnd))
        if level is None:
            return self._run(state, plan, rnd, None)
        # under a batched study's vmap, as ring_shard.ShardedStep
        args, dims = pmesh.unwrap_lanes((state, plan, rnd), level)
        return pmesh.wrap_lanes(self._run(*args, dims), level)

    def _run(self, state, plan, rnd, dims):
        """The step on placed trees; `dims` None for one study, else
        the lane dims of (state, plan, rnd) for a batch's physical
        lane-stacked trees, whose every shard runs its lanes under its
        thread's own vmap (the randomness copied to each device holds
        every lane)."""
        cfg, mesh = self.cfg, self.mesh
        model = _MODELS[self.engine][0]
        rnds = {dev: tree_map(lambda x, dev=dev: x.to(dev), rnd)
                for dev in mesh.distinct}

        def body(rank, coll):
            dev = mesh.devices[rank]
            rows = ShardRows(cfg.n_nodes, mesh.size, rank, coll)

            def one(st, pl, rn):
                tap = {} if cfg.telemetry else None
                st = model.step(cfg, st, pl, rn, tap=tap, rows=rows)
                return ((st, frame_from_tap(tap, dev)) if cfg.telemetry
                        else (st,))

            args = (pmesh.block(state, rank), pmesh.block(plan, rank),
                    rnds[dev])
            if dims is None:
                return one(*args)
            return torch.func.vmap(one, in_dims=(
                pmesh.block(dims[0], rank), pmesh.block(dims[1], rank),
                dims[2]))(*args)

        out = pmesh.run_spmd(mesh, body)
        st = pmesh.gather_blocks([o[0] for o in out],
                                 STATE_SPECS[self.engine],
                                 int(dims is not None))
        return (st, out[0][1]) if cfg.telemetry else st


def place(cfg: SwimConfig, mesh: pmesh.Mesh, engine: str, state, plan,
          lanes: int = 0):
    """(placed state, placed plan): the ring's by `ring_shard.place`;
    dense's and rumor's node-axis fields split into row blocks, the
    rest and the plan (a FaultPlan or a FaultProgram) replicated.  With
    `lanes` = 1 both are a batch's, every leaf with a leading lane
    axis."""
    _check(cfg, engine, mesh)
    if engine == "ring":
        return ring_shard.place(cfg, mesh, state, plan, lanes)
    return (pmesh.place_tree(state, STATE_SPECS[engine], mesh, lanes),
            pmesh.place_tree(plan, PLAN_SPECS[type(plan)], mesh, lanes))


def build_step(cfg: SwimConfig, mesh: pmesh.Mesh, engine: str):
    """The partitioned step(state, plan, rnd) on placed trees: the
    ring's `ring_shard.mapped_step`, else a PartitionedStep.  The study
    runners take it as their `step_fn`; it reads the plan's type (a
    FaultPlan or a FaultProgram) when it runs."""
    _check(cfg, engine, mesh)
    if engine == "ring":
        return ring_shard.mapped_step(cfg, mesh)
    return PartitionedStep(cfg, mesh, engine)


def build_run(cfg: SwimConfig, mesh: pmesh.Mesh, engine: str,
              periods: int):
    """run(state, plan, root_key): `periods` partitioned periods from a
    placed state, each period's randomness drawn as the engine's `run`
    draws it (`root_key` a threefry key or an int seed).  The placed
    state; with cfg.telemetry (state, EngineFrame of [periods]
    series)."""
    if engine == "ring":
        return ring_shard.build_run(cfg, mesh, periods)
    step_fn = build_step(cfg, mesh, engine)
    draw = _MODELS[engine][1]

    def run(state, plan, root_key):
        if isinstance(root_key, int):
            root_key = threefry.key(root_key)
        t0 = int(pmesh.assemble(state.step))
        frames = []
        for t in range(t0, t0 + periods):
            out = step_fn(state, plan, draw(root_key, t, cfg,
                                            mesh.devices[0]))
            if cfg.telemetry:
                state, frame = out
                frames.append(frame)
            else:
                state = out
        return (state, stack_frames(frames)) if cfg.telemetry else state

    return run


def start(cfg: SwimConfig, engine: str, plan, mesh: pmesh.Mesh | None = None):
    """(mesh, placed initial state, placed plan, partitioned step) on
    `mesh` (None: `pmesh.make_mesh()`).  A batch's stacked plan
    (`faults.lanes_of`: P lanes) starts P fresh states placed with
    their lane axis."""
    mesh = pmesh.make_mesh() if mesh is None else mesh
    init = {"dense": dense, "ring": ring, "rumor": rumor}[engine].init_state
    lanes = faults.lanes_of(plan)
    fresh = [init(cfg, mesh.devices[0]) for _ in range(max(lanes, 1))]
    state = runner.batch_states(fresh) if lanes else fresh[0]
    del fresh
    state, plan = place(cfg, mesh, engine, state, plan, int(lanes > 0))
    return mesh, state, plan, build_step(cfg, mesh, engine)

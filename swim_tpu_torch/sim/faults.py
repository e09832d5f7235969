"""Fault injection as tensors (port of `swim_tpu/sim/faults.py`).

  * crash-stop: `crash_step[N]`, the period at which a node halts for
    good (NEVER = no crash);
  * packet loss: one Bernoulli `loss` probability per directed message;
  * partition: uint8 `partition_id[N]` labels; over [partition_start,
    partition_end) messages between different labels are dropped;
  * join: `join_step[N]`, the period a node becomes a member.

Builders take the device explicitly (None = the CUDA card).

A `FaultProgram` adds piecewise per-node link and gray-failure segments
to a FaultPlan (reference faults.py:137-339); `link_lanes` turns them
into the per-node u16 thresholds the rotor waves add to the loss
threshold.  A `ProgramBatch` stacks P programs of one N along a leading
P axis, padded to one segment capacity (`experiments._run_study_batch`
runs a study per lane, one step a period over the lane axis).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.ops import u32
from swim_tpu_torch.utils import threefry
from swim_tpu_torch.utils.tree import tree_map

NEVER = int(np.int32(2**31 - 1))


class FaultPlan(NamedTuple):
    crash_step: torch.Tensor       # int32[N], NEVER = no crash
    loss: torch.Tensor             # float32 scalar in [0, 1)
    partition_id: torch.Tensor     # uint8[N] group labels
    partition_start: torch.Tensor  # int32 scalar (inclusive)
    partition_end: torch.Tensor    # int32 scalar (exclusive)
    join_step: torch.Tensor        # int32[N] (<= 0 = founding member)


def none(n: int, device=None) -> FaultPlan:
    """A perfect network: no crashes, no loss, no partition."""
    dev = devmod.resolve(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return FaultPlan(
        crash_step=torch.full((n,), NEVER, **i32),
        loss=torch.tensor(0.0, dtype=torch.float32, device=dev),
        partition_id=torch.zeros((n,), dtype=torch.uint8, device=dev),
        partition_start=torch.tensor(0, **i32),
        partition_end=torch.tensor(0, **i32),
        join_step=torch.zeros((n,), **i32),
    )


def _ids_and_steps(plan: FaultPlan, node_ids, at_step):
    dev = plan.crash_step.device
    ids = torch.as_tensor(np.asarray(node_ids, np.int64), device=dev)
    at = torch.as_tensor(np.broadcast_to(np.asarray(at_step, np.int64),
                                         ids.shape).copy(),
                         device=dev).to(torch.int32)
    return ids, at


def with_joins(plan: FaultPlan, node_ids, at_step) -> FaultPlan:
    """Nodes that join (or rejoin under a fresh id) at the given period."""
    ids, at = _ids_and_steps(plan, node_ids, at_step)
    js = plan.join_step.clone()
    js.scatter_reduce_(0, ids, at, "amax")
    return plan._replace(join_step=js)


def with_loss(plan: FaultPlan, loss: float) -> FaultPlan:
    return plan._replace(loss=torch.tensor(
        np.float32(loss), dtype=torch.float32, device=plan.loss.device))


def with_crashes(plan: FaultPlan, node_ids, at_step) -> FaultPlan:
    """Crash the given nodes at the given period(s)."""
    ids, at = _ids_and_steps(plan, node_ids, at_step)
    cs = plan.crash_step.clone()
    cs.scatter_reduce_(0, ids, at, "amin")
    return plan._replace(crash_step=cs)


def with_random_crashes(plan: FaultPlan, key: tuple[int, int],
                        fraction: float, start: int, end: int) -> FaultPlan:
    """Crash ~`fraction` of nodes, each at a uniform period in
    [start, end): the reference's draw for `key = threefry.key(seed)`
    (`jax.random.key(seed)`), so both packages crash the same nodes at
    the same periods."""
    n = plan.crash_step.shape[0]
    dev = plan.crash_step.device
    k_pick, k_when = threefry.split(key, 2)
    hit = threefry.uniform(k_pick, (n,), dev) < torch.tensor(
        np.float32(fraction), device=dev)
    # the crash periods are drawn only where a node is hit
    at = hit.nonzero()[:, 0]
    when = threefry.randint(k_when, (n,), start, max(end, start + 1), dev,
                            at=at)
    crash_step = plan.crash_step.clone()
    crash_step[at] = torch.minimum(crash_step[at], when)
    return plan._replace(crash_step=crash_step)


def with_partition(plan: FaultPlan, group_of, start: int,
                   end: int) -> FaultPlan:
    """Two-or-more-way partition over [start, end) periods; labels must
    fit uint8."""
    group = np.asarray(group_of)
    if group.size and (group.min() < 0 or group.max() > 255):
        raise ValueError(
            f"partition labels must be in [0, 255] (uint8 wire dtype): "
            f"got range [{group.min()}, {group.max()}]")
    dev = plan.crash_step.device
    return plan._replace(
        partition_id=torch.as_tensor(group.astype(np.uint8), device=dev),
        partition_start=torch.tensor(start, dtype=torch.int32, device=dev),
        partition_end=torch.tensor(end, dtype=torch.int32, device=dev),
    )


def halves(n: int) -> np.ndarray:
    """Label array for a 2-way even split."""
    g = np.zeros((n,), np.uint8)
    g[n // 2:] = 1
    return g


# ---------------------------------------------------------------------
# FaultProgram: piecewise per-node link/gray fault schedules
# ---------------------------------------------------------------------

KIND_NONE = 0        # inert slot (padding)
KIND_SEND_LOSS = 1   # add to the sender-side loss threshold (all legs)
KIND_RECV_LOSS = 2   # add to the receiver-side loss threshold (all legs)
KIND_LINK_LOSS = 3   # symmetric: both send and receive legs
KIND_GRAY = 4        # reply legs only: the node's acks get lost

SEG_KINDS = {
    "send_loss": KIND_SEND_LOSS,
    "recv_loss": KIND_RECV_LOSS,
    "link_loss": KIND_LINK_LOSS,
    "gray": KIND_GRAY,
}

LANE_MAX = 65535  # u16 wire ceiling for one lane


class FaultProgram(NamedTuple):
    """FaultPlan plus a piecewise fault schedule of S segments.  S == 0
    means "no program": `split_program` strips the wrapper, so the
    engine runs the plain-plan step.  Lanes are u16 thresholds in the
    loss legs' integer geometry (`bits >= thr`, thr = ceil(p * 65536)),
    composed with the loss threshold by addition."""

    base: FaultPlan
    domain_id: torch.Tensor   # uint8[N] failure-domain labels
    seg_start: torch.Tensor   # int32[S] first period (inclusive)
    seg_end: torch.Tensor     # int32[S] last period (exclusive)
    seg_period: torch.Tensor  # int32[S] flap cycle length, 0 = always on
    seg_on: torch.Tensor      # int32[S] on-duty periods per cycle
    seg_domain: torch.Tensor  # int32[S] target domain, -1 = every node
    seg_kind: torch.Tensor    # int32[S] KIND_*
    seg_level: torch.Tensor   # u32[S] (int32 carrier) u16 threshold


def level_to_threshold(p: float) -> int:
    """Probability -> u16 lane threshold: ceil(p * 65536), clamped to
    the u16 wire."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"fault level must be in [0, 1]: got {p}")
    return min(int(np.ceil(p * 65536.0)), LANE_MAX)


def empty_program(n: int, device=None) -> FaultProgram:
    """A FaultProgram with zero segments wrapping a perfect network."""
    return as_program(none(n, device))


def as_program(plan: FaultPlan, domain_id=None,
               capacity: int = 0) -> FaultProgram:
    """Wrap a FaultPlan with `capacity` inert segment slots."""
    n = plan.crash_step.shape[0]
    dev = plan.crash_step.device
    if domain_id is None:
        dom = torch.zeros((n,), dtype=torch.uint8, device=dev)
    else:
        dom = torch.as_tensor(np.asarray(domain_id).astype(np.uint8),
                              device=dev)
    s = int(capacity)
    zi = torch.zeros((s,), dtype=torch.int32, device=dev)
    return FaultProgram(
        base=plan, domain_id=dom, seg_start=zi, seg_end=zi.clone(),
        seg_period=zi.clone(), seg_on=zi.clone(),
        seg_domain=torch.full((s,), -1, dtype=torch.int32, device=dev),
        seg_kind=zi.clone(), seg_level=zi.clone())


def with_segment(prog: FaultProgram, slot: int, *, start: int, end: int,
                 kind: str, level: float, domain: int = -1,
                 period: int = 0, on: int = 0) -> FaultProgram:
    """Fill one segment slot."""
    if kind not in SEG_KINDS:
        raise ValueError(
            f"unknown segment kind {kind!r}; one of {sorted(SEG_KINDS)}")
    if period > 0 and not 0 < on <= period:
        raise ValueError(
            f"flap duty must satisfy 0 < on <= period: {on}/{period}")
    vals = dict(seg_start=start, seg_end=end, seg_period=period, seg_on=on,
                seg_domain=domain, seg_kind=SEG_KINDS[kind],
                seg_level=u32.carrier(level_to_threshold(level)))
    out = {}
    for name, v in vals.items():
        arr = getattr(prog, name).clone()
        arr[slot] = v
        out[name] = arr
    return prog._replace(**out)


def pad_program(prog: FaultProgram, capacity: int) -> FaultProgram:
    """Grow a program's segment axis to `capacity` with inert slots
    (KIND_NONE at level 0 on domain -1: they add 0 to every lane)."""
    s = int(prog.seg_kind.shape[0])
    pad = int(capacity) - s
    if pad < 0:
        raise ValueError(
            f"pad_program: capacity {capacity} < current {s} segments")
    if pad == 0:
        return prog
    dev = prog.seg_kind.device
    zi = torch.zeros((pad,), dtype=torch.int32, device=dev)
    cat = torch.cat
    return prog._replace(
        seg_start=cat([prog.seg_start, zi]), seg_end=cat([prog.seg_end, zi]),
        seg_period=cat([prog.seg_period, zi]), seg_on=cat([prog.seg_on, zi]),
        seg_domain=cat([prog.seg_domain, torch.full_like(zi, -1)]),
        seg_kind=cat([prog.seg_kind, zi]),
        seg_level=cat([prog.seg_level, zi]))


class ProgramBatch(NamedTuple):
    """`size` FaultPrograms stacked leaf-wise along a new leading P
    axis, all of one N and padded to one segment capacity S: inert
    padding slots add 0 to every lane, so a padded lane runs as its
    program does."""

    program: FaultProgram  # leaves stacked: base [P, N] / [P], segs [P, S]
    size: int              # P


def stack_programs(progs, capacity: int | None = None) -> ProgramBatch:
    """Stack a program library into one ProgramBatch.  All members share
    one node count; segment axes are padded to `capacity` (default: the
    library's largest)."""
    progs = list(progs)
    if not progs:
        raise ValueError("stack_programs: empty program list")
    ns = {int(p.domain_id.shape[0]) for p in progs}
    if len(ns) != 1:
        raise ValueError(
            f"stack_programs: mixed node counts {sorted(ns)}; a batch "
            f"shares one N")
    cap = max(int(p.seg_kind.shape[0]) for p in progs)
    if capacity is not None:
        if int(capacity) < cap:
            raise ValueError(
                f"stack_programs: capacity {capacity} < library max {cap}")
        cap = int(capacity)
    padded = [pad_program(p, cap) for p in progs]
    return ProgramBatch(program=tree_map(lambda *xs: torch.stack(xs),
                                         *padded), size=len(progs))


def lane_program(batch: ProgramBatch, p: int) -> FaultProgram:
    """Lane `p`'s FaultProgram (indexes every stacked leaf)."""
    if not 0 <= p < batch.size:
        raise IndexError(f"lane {p} out of range for batch of {batch.size}")
    return tree_map(lambda x: x[p], batch.program)


def split_program(plan) -> tuple[FaultPlan, FaultProgram | None]:
    """(base plan, program-or-None).  None for a plain FaultPlan and for
    a FaultProgram with zero segments, so an empty program runs exactly
    the plain-plan step."""
    if isinstance(plan, FaultProgram):
        if plan.seg_kind.shape[0] == 0:
            return plan.base, None
        return plan.base, plan
    if isinstance(plan, FaultPlan):
        return plan, None
    raise TypeError(f"not a FaultPlan or FaultProgram: {type(plan)!r}")


def base_of(plan) -> FaultPlan:
    return plan.base if isinstance(plan, FaultProgram) else plan


def lanes_of(plan) -> int:
    """The lanes of a batch's stacked plan or program (its node lanes
    [P, N], `stack_programs`); 0 for one study's plan."""
    crash = base_of(plan).crash_step
    return crash.shape[0] if crash.dim() == 2 else 0


def link_lanes(prog: FaultProgram, step):
    """Per-node (send_thr, recv_thr, reply_thr) lanes at period `step`
    (a device scalar or int): u32 values in int32 carriers, each the
    wrapping u32 sum of the active segments' levels on the node's
    domain, saturated at LANE_MAX.  All S segments at once ([S, N]);
    an integer sum is the same in any order."""
    t = torch.as_tensor(step, dtype=torch.int32,
                        device=prog.seg_kind.device)
    dom = prog.domain_id.to(torch.int32)
    in_window = (t >= prog.seg_start) & (t < prog.seg_end)
    phase = torch.remainder(t - prog.seg_start, prog.seg_period.clamp(min=1))
    duty = (prog.seg_period == 0) | (phase < prog.seg_on)
    hit = ((prog.seg_domain < 0)[:, None]
           | (dom[None, :] == prog.seg_domain[:, None]))         # [S, N]
    amt = torch.where((in_window & duty)[:, None] & hit,
                      u32.to_u64(prog.seg_level)[:, None], 0)    # int64
    kind = prog.seg_kind[:, None]

    def lane(sel):
        tot = torch.where(sel, amt, 0).sum(dim=0) & u32.MASK32
        return tot.clamp(max=LANE_MAX).to(torch.int32)

    return (lane((kind == KIND_SEND_LOSS) | (kind == KIND_LINK_LOSS)),
            lane((kind == KIND_RECV_LOSS) | (kind == KIND_LINK_LOSS)),
            lane(kind == KIND_GRAY))


def float_delivery(plan: FaultPlan, prog, step, up: torch.Tensor):
    """The dense and rumor engines' fault test at period `step`:
    `delivered(src, dst, u, reply=False)` -> bool[M] for a batch of
    messages src -> dst with f32 uniforms `u`.  Both ends are up, no
    active partition separates them, and u clears the threshold: the
    global loss plus, under a program, the sender's send lane, the
    receiver's recv lane and, for a reply, the sender's gray lane,
    summed left to right as the reference's."""
    part_on = partition_active(plan, step)
    pid = plan.partition_id
    loss_f = plan.loss.to(torch.float32)
    if prog is not None:
        # u16 lane thresholds -> exact f32 probabilities (the scale is a
        # power of two)
        send_f, recv_f, reply_f = (lane.to(torch.float32) * (1.0 / 65536.0)
                                   for lane in link_lanes(prog, step))

    def delivered(src, dst, u, reply=False):
        cut = part_on & (pid[src] != pid[dst])
        thr = loss_f
        if prog is not None:
            thr = thr + send_f[src]
            thr = thr + recv_f[dst]
            if reply:
                thr = thr + reply_f[src]
        return up[src] & up[dst] & ~cut & (u >= thr)

    return delivered


def crashed_mask(plan: FaultPlan, step) -> torch.Tensor:
    """bool[N]: which nodes have crash-stopped by period `step`."""
    return plan.crash_step <= step


def partition_active(plan: FaultPlan, step) -> torch.Tensor:
    return (plan.partition_start <= step) & (plan.partition_end > step)


def to_numpy(plan: FaultPlan) -> FaultPlan:
    """The plan's fields as numpy arrays in the reference's dtypes."""
    return FaultPlan(*(x.cpu().numpy() for x in plan))

"""Fault injection as tensors (port of `swim_tpu/sim/faults.py`).

  * crash-stop: `crash_step[N]`, the period at which a node halts for
    good (NEVER = no crash);
  * packet loss: one Bernoulli `loss` probability per directed message;
  * partition: uint8 `partition_id[N]` labels; over [partition_start,
    partition_end) messages between different labels are dropped;
  * join: `join_step[N]`, the period a node becomes a member.

Builders take the device explicitly (None = the CUDA card).
`FaultProgram` lanes are not part of this port yet: `split_program`
raises on anything but a plain FaultPlan.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swim_tpu_torch import device as devmod

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


def with_random_crashes(plan: FaultPlan, gen: torch.Generator,
                        fraction: float, start: int, end: int) -> FaultPlan:
    """Crash ~`fraction` of nodes, each at a uniform period in
    [start, end).  Draws from `gen` (on the generator's device), so the
    crash sets differ from the reference's `jax.random` ones."""
    n = plan.crash_step.shape[0]
    dev = plan.crash_step.device
    hit = torch.rand((n,), generator=gen, device=gen.device) < fraction
    when = torch.randint(start, max(end, start + 1), (n,), generator=gen,
                         device=gen.device, dtype=torch.int32)
    hit, when = hit.to(dev), when.to(dev)
    return plan._replace(crash_step=torch.where(
        hit, torch.minimum(plan.crash_step, when), plan.crash_step))


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


def split_program(plan) -> tuple[FaultPlan, None]:
    """(base plan, None).  The reference also accepts a FaultProgram
    (per-node link/gray lanes); the port does not carry those yet."""
    if isinstance(plan, FaultPlan):
        return plan, None
    raise NotImplementedError(
        "FaultProgram lanes are not ported yet (ROADMAP.md Queue 1, "
        "'FaultProgram lanes'); pass a plain FaultPlan")


def crashed_mask(plan: FaultPlan, step) -> torch.Tensor:
    """bool[N]: which nodes have crash-stopped by period `step`."""
    return plan.crash_step <= step


def partition_active(plan: FaultPlan, step) -> torch.Tensor:
    return (plan.partition_start <= step) & (plan.partition_end > step)

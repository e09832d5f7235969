"""What the dense and rumor engines share: the repeat of a node axis
over the k indirect probes, the block of rows a step holds (`Rows`),
the run loop and the one-device Engine.  Each engine supplies its
`init_state`, `step` and per-period draw."""
from __future__ import annotations

import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.sim import faults
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.utils import threefry


def repeat(x: torch.Tensor, k: int) -> torch.Tensor:
    """jnp.repeat(x, k) for a 1-D x, without repeat_interleave's size
    read."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


class Rows:
    """The node rows a dense or rumor step holds, and how its blocks
    meet: here all N rows on one device, every method the identity.
    parallel/partition.py's `ShardRows` holds one shard's block
    [off, off + m) and joins the blocks through the mesh's collectives.

    `take(x)` is the held rows of a whole node-axis tensor; `mine(idx)`
    marks the global row ids that are held; `local(idx, val)` turns
    global row ids into held-row indices, the values (bool [M] or
    [M, B]) of rows held elsewhere masked off at index 0;
    `gather(xs)` concatenates every block's tensors of xs in node order;
    `psum`, `pmax` and `any` reduce over the blocks; `compact` gathers
    the Phase D candidates of every block."""

    def __init__(self, n: int):
        self.off, self.m = 0, n

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mine(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(idx, dtype=torch.bool)

    def local(self, idx: torch.Tensor, val: torch.Tensor):
        return idx, val

    def any(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def compact(self, valid: torch.Tensor, cols: tuple, width: int):
        """((valid, *cols), dropped): candidates of the held rows whose
        first `width` valid ones, in node order, are all a reader of
        the first `width` needs (0 dropped here: every row is kept)."""
        return (valid, *cols), 0

    def gather(self, xs: tuple) -> tuple:
        return tuple(xs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x


def run_periods(cfg: SwimConfig, state, plan: FaultPlan, seed: int,
                periods: int, step, draw):
    """`periods` periods of `step(cfg, state, plan, rnd)` from `state`,
    with `draw(key, t, cfg, device)` from `threefry.key(seed)`: the
    reference's `run(cfg, state, plan, jax.random.key(seed), periods)`.
    Reads state.step once."""
    key = threefry.key(seed)
    t0 = int(state.step)
    dev = state.step.device
    for t in range(t0, t0 + periods):
        state = step(cfg, state, plan, draw(key, t, cfg, dev))
    return state


class Engine:
    """(cfg, plan, state) on one device, stepping with `run_periods`.
    A subclass names its engine's `init_state`, `step` and `draw`."""

    init_state = step = draw = None

    def __init__(self, cfg: SwimConfig, plan: FaultPlan, seed: int = 0,
                 device=None):
        self.device = devmod.resolve(device)
        plan_dev = faults.base_of(plan).crash_step.device
        if plan_dev != self.device:
            raise ValueError(f"plan lives on {plan_dev}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.plan = plan
        self.seed = seed
        self.state = type(self).init_state(cfg, self.device)

    def run(self, periods: int):
        cls = type(self)
        self.state = run_periods(self.cfg, self.state, self.plan, self.seed,
                                 periods, cls.step, cls.draw)
        return self.state

"""What the dense and rumor engines share: the repeat of a node axis
over the k indirect probes, the run loop and the one-device Engine.
Each engine supplies its `init_state`, `step` and per-period draw."""
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

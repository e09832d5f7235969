"""Per-period randomness of the dense and rumor engines (port of
`swim_tpu/utils/prng.py`).

Every random choice of protocol period `t` comes from
`draw_period(key, t, cfg, device)`: nine float32 uniforms in [0, 1),
the reference's `draw_period(jax.random.key(seed), t, cfg)` bit for bit
for `key = threefry.key(seed)`.  The key arithmetic (`fold_in`,
`split`) is done on the host; the uniforms are drawn on `device`.
`to_numpy` copies a period's draws to the host for the scalar oracles
(models/oracle.py, models/rumor_oracle.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.utils import threefry


class PeriodRandomness(NamedTuple):
    """Every draw of one protocol period (f32 uniforms; Bernoulli
    decisions compare against the rates where they are used)."""

    target_u: torch.Tensor    # [N]    probe target selection
    proxy_u: torch.Tensor     # [N, k] proxy selection (per slot)
    loss_w1: torch.Tensor     # [N]    PING i -> T(i)
    loss_w2: torch.Tensor     # [N]    ACK T(i) -> i (indexed by pinger i)
    loss_w3: torch.Tensor     # [N, k] PING-REQ i -> p
    loss_w4: torch.Tensor     # [N, k] proxy PING p -> T(i)
    loss_w5: torch.Tensor     # [N, k] target ACK T(i) -> p
    loss_w6: torch.Tensor     # [N, k] relay ACK p -> i
    lha_u: torch.Tensor       # [N]    Lifeguard probe thinning


def draw_period(key, step: int, cfg: SwimConfig,
                device) -> PeriodRandomness:
    """Period `step`'s draws from the threefry key `key`; for a list of
    P keys (a batched study's lanes) every draw gains a leading P axis,
    lane p bitwise key p's."""
    n, k = cfg.n_nodes, cfg.k_indirect
    ks = threefry.split(threefry.fold_in(key, step), 9)
    shapes = ((n,), (n, k), (n,), (n,), (n, k), (n, k), (n, k), (n, k),
              (n,))
    return PeriodRandomness(*(threefry.uniform(kk, shape, device)
                              for kk, shape in zip(ks, shapes)))


def host(x) -> np.ndarray:
    """A tensor on any device (or an array) as a numpy array of its
    dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_numpy(r: PeriodRandomness) -> PeriodRandomness:
    """Host copies for the scalar oracle (every draw is float32)."""
    return PeriodRandomness(*(host(x) for x in r))

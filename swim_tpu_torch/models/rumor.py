"""Lifeguard's dynamic suspicion timeout (the port's copy of
`dynamic_timeout_py` / `dynamic_timeout_table` of
`swim_tpu/models/rumor.py`; the rumor engine itself is not ported).

A suspicion starts at `suspicion_max_periods` and shrinks towards
`suspicion_periods` as independent suspectors (sentinels) join it,
logarithmically in their count.
"""
from __future__ import annotations

import functools
import math

import torch

from swim_tpu_torch.config import SwimConfig


def dynamic_timeout_py(cfg: SwimConfig, filled: int) -> int:
    """Timeout in periods for `filled` sentinels (plain Python)."""
    base_to = float(cfg.suspicion_periods)
    max_to = float(cfg.suspicion_max_periods)
    c_tot = float(cfg.k_indirect + 1)
    frac = math.log(max(float(filled), 1.0)) / math.log(c_tot + 1.0)
    return int(math.ceil(max(base_to, max_to - (max_to - base_to) * frac)))


@functools.lru_cache(maxsize=16)
def dynamic_timeout_table(cfg: SwimConfig, device) -> torch.Tensor:
    """int32[S + 1]: timeout per filled-sentinel count.  Built on the
    host and moved to `device` once per (cfg, device)."""
    return torch.tensor([dynamic_timeout_py(cfg, f)
                         for f in range(cfg.sentinels + 1)],
                        dtype=torch.int32, device=device)

"""Carry state, plans and randomness between numpy and the port.

The reference's values arrive as numpy arrays (what `np.asarray` gives
for a JAX array).  uint32 arrays become int32 carriers by
`.view(np.int32)` and come back by `.view(np.uint32)`: the bytes do not
change.  bool, uint8, int32 and float32 arrays keep their dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.models.ring import RingRandomness, RingState, U32_FIELDS
from swim_tpu_torch.sim.faults import FaultPlan

_RND_U32 = frozenset({"loss_w1", "loss_w2", "loss_w3", "loss_w4",
                      "loss_w5", "loss_w6", "lha_u"})


def _to_torch(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def _to_numpy(t: torch.Tensor, u32: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if u32 else a


def state_from_numpy(d: dict, device=None) -> RingState:
    """RingState from a dict (or RingState-like mapping) of numpy arrays
    keyed by field name."""
    dev = devmod.resolve(device)
    return RingState(**{f: _to_torch(d[f], dev) for f in RingState._fields})


def state_to_numpy(state: RingState) -> dict[str, np.ndarray]:
    """Field name -> numpy array in the reference's dtype."""
    return {f: _to_numpy(getattr(state, f), f in U32_FIELDS)
            for f in RingState._fields}


def plan_from_numpy(d: dict, device=None) -> FaultPlan:
    dev = devmod.resolve(device)
    return FaultPlan(**{f: _to_torch(d[f], dev) for f in FaultPlan._fields})


def randomness_from_numpy(d: dict, device=None) -> RingRandomness:
    """RingRandomness from the reference's rotor fields (its `pull`
    field, None in rotor mode, is not carried)."""
    dev = devmod.resolve(device)
    return RingRandomness(**{f: _to_torch(d[f], dev)
                             for f in RingRandomness._fields})


def randomness_to_numpy(rnd: RingRandomness) -> dict[str, np.ndarray]:
    return {f: _to_numpy(getattr(rnd, f), f in _RND_U32)
            for f in RingRandomness._fields}

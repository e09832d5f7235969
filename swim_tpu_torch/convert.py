"""Carry state, plans and randomness between numpy and the port.

The reference's values arrive as numpy arrays (what `np.asarray` gives
for a JAX array).  uint32 arrays become int32 carriers by
`.view(np.int32)` and come back by `.view(np.uint32)`: the bytes do not
change.  bool, uint8, int32 and float32 arrays keep their dtype.

States of the three engines (RingState, DenseState, RumorState) share
`state_from_numpy(d, device, cls)` / `state_to_numpy`; the dense and
rumor engines' randomness is `period_randomness_from_numpy` /
`rumor_randomness_from_numpy` (all float32).  The serving hub's
external originations are `ext_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.models.ring import (ExtOriginations, PullRandomness,
                                        RingRandomness, RingState)
from swim_tpu_torch.models.rumor import RumorRandomness
from swim_tpu_torch.sim.faults import FaultPlan, FaultProgram
from swim_tpu_torch.utils.prng import PeriodRandomness

# u32 fields (int32 carriers in the port) of each engine's state
STATE_U32 = {RingState: ring.U32_FIELDS, dense.DenseState: dense.U32_FIELDS,
             rumor.RumorState: rumor.U32_FIELDS}

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


def state_from_numpy(d: dict, device=None, cls=RingState):
    """An engine state `cls` (RingState, DenseState or RumorState) from a
    mapping of numpy arrays keyed by field name."""
    dev = devmod.resolve(device)
    return cls(**{f: _to_torch(d[f], dev) for f in cls._fields})


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """Field name -> numpy array in the reference's dtype."""
    u32 = STATE_U32[type(state)]
    return {f: _to_numpy(getattr(state, f), f in u32)
            for f in state._fields}


def plan_from_numpy(d: dict, device=None) -> FaultPlan:
    dev = devmod.resolve(device)
    return FaultPlan(**{f: _to_torch(d[f], dev) for f in FaultPlan._fields})


def program_from_numpy(d: dict, device=None) -> FaultProgram:
    """FaultProgram from a mapping of numpy arrays by field name, whose
    `base` is itself such a mapping."""
    dev = devmod.resolve(device)
    return FaultProgram(base=plan_from_numpy(d["base"], dev), **{
        f: _to_torch(d[f], dev) for f in FaultProgram._fields if f != "base"})


def randomness_from_numpy(d: dict, device=None) -> RingRandomness:
    """RingRandomness from the reference's fields; its `pull` field is
    None (rotor mode) or a mapping of the PullRandomness arrays."""
    dev = devmod.resolve(device)
    pull = d.get("pull")
    if isinstance(pull, np.ndarray) and pull.dtype == object:
        pull = pull.item()          # np.asarray of the reference's None
    if pull is not None:
        pull = PullRandomness(**{f: _to_torch(pull[f], dev)
                                 for f in PullRandomness._fields})
    return RingRandomness(pull=pull, **{
        f: _to_torch(d[f], dev) for f in RingRandomness._fields
        if f != "pull"})


def randomness_to_numpy(rnd: RingRandomness) -> dict:
    out = {f: _to_numpy(getattr(rnd, f), f in _RND_U32)
           for f in RingRandomness._fields if f != "pull"}
    out["pull"] = (None if rnd.pull is None else
                   {f: _to_numpy(getattr(rnd.pull, f), False)
                    for f in PullRandomness._fields})
    return out


def ext_from_numpy(d: dict, device=None) -> ExtOriginations:
    """ExtOriginations from the reference's four [E] arrays by field
    name (the uint32 `key` becomes its int32 carrier)."""
    dev = devmod.resolve(device)
    return ExtOriginations(**{f: _to_torch(d[f], dev)
                              for f in ExtOriginations._fields})


def period_randomness_from_numpy(d: dict, device=None) -> PeriodRandomness:
    """The dense engine's draws from a mapping of float32 arrays."""
    dev = devmod.resolve(device)
    return PeriodRandomness(**{f: _to_torch(d[f], dev)
                               for f in PeriodRandomness._fields})


def rumor_randomness_from_numpy(d: dict, device=None) -> RumorRandomness:
    """The rumor engine's draws: `base` a mapping of the nine base
    arrays, `resample_u` an array."""
    return RumorRandomness(
        base=period_randomness_from_numpy(d["base"], device),
        resample_u=_to_torch(d["resample_u"], devmod.resolve(device)))


def tuple_to_numpy(nt) -> dict[str, np.ndarray]:
    """A NamedTuple of tensors (a study's track or series) as numpy
    arrays by field name, in their torch dtype."""
    return {f: _to_numpy(getattr(nt, f), False) for f in nt._fields}


def tuple_from_numpy(cls, d: dict, device=None):
    """NamedTuple `cls` (CompactTrack, StudyTrack, PeriodSeries, ...)
    from numpy arrays by field name."""
    dev = devmod.resolve(device)
    return cls(**{f: _to_torch(d[f], dev) for f in cls._fields})

"""Engine telemetry: the per-period EngineFrame tap (port of
`swim_tpu/obs/engine.py`).

The engines' `step` functions take an optional `tap` dict.  When the
caller passes one (`cfg.telemetry` decides where a runner drives the
engine), the step writes int32 scalar tensors into it, computed on the
device from the period's own values; the state it returns is the
state of a step without the tap, bit for bit.

Frame fields (all int32, per period):

  sel_slots_selected  valid piggyback slots selected across all senders
  sel_rows_saturated  live senders whose selection used the full budget B
  sel_slots_max       largest per-sender valid-slot count
  win_occupancy       transmissible candidates at selection time (ring:
                      set bits in the eligible start-of-period window;
                      rumor: heard eligible rumors; dense: pending
                      retransmit entries)
  waves_delivered     messages delivered across every wave this period
  probes_failed       probes with neither direct nor relayed ack
  overflow            cumulative origination overflow (post-step state)
  index_overflow      cumulative view-index overflow (ring engine)

A frame is a NamedTuple of 0-d int32 tensors on the engine's device; a
run stacks them once, after its last period, into int32[T] fields.  No
field is read to the host inside a period.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from swim_tpu_torch.models import ring

I32 = torch.int32


class EngineFrame(NamedTuple):
    """One period's telemetry counters (int32 scalars; int32[T] when
    stacked)."""

    sel_slots_selected: torch.Tensor
    sel_rows_saturated: torch.Tensor
    sel_slots_max: torch.Tensor
    win_occupancy: torch.Tensor
    waves_delivered: torch.Tensor
    probes_failed: torch.Tensor
    overflow: torch.Tensor
    index_overflow: torch.Tensor


def empty_frame(device) -> EngineFrame:
    return EngineFrame(*(torch.zeros((), dtype=I32, device=device)
                         for _ in EngineFrame._fields))


def frame_from_tap(tap: dict, device) -> EngineFrame:
    """A frame from whatever keys the engine filled; the others are
    int32 zeros on `device`."""
    return EngineFrame(*(
        tap[name].to(I32) if name in tap
        else torch.zeros((), dtype=I32, device=device)
        for name in EngineFrame._fields))


def stack_frames(frames: list) -> EngineFrame:
    """Per-period frames stacked into int32[T] fields."""
    return EngineFrame(*(torch.stack(col) for col in zip(*frames)))


def concat_frames(parts: list) -> EngineFrame:
    """Stacked frames of consecutive runs joined along the period axis."""
    return EngineFrame(*(torch.cat(col) for col in zip(*parts)))


class RecordedRun(NamedTuple):
    """A telemetry run's result: final state and stacked EngineFrame[T].
    `.step` is the state's period counter."""

    state: Any
    frames: EngineFrame

    @property
    def step(self):
        return self.state.step


def recorded_ring_run(cfg, state, plan, root_key: tuple[int, int],
                      periods: int, *, plain: bool = False) -> RecordedRun:
    """`ring.run` with the telemetry tap: the reference's
    `recorded_ring_run(cfg, state, plan, jax.random.key(seed), periods)`
    for `root_key = threefry.key(seed)`.  Reads state.step once; the
    frames are stacked after the last period.  `plain` runs the
    kernels' plain versions."""
    dev = state.win.device
    frames = []
    for rnd in ring.period_randomness(cfg, root_key, int(state.step),
                                      periods, dev):
        tap: dict = {}
        state = ring.step(cfg, state, plan, rnd, plain=plain, tap=tap)
        frames.append(frame_from_tap(tap, dev))
    if not frames:
        return RecordedRun(state, EngineFrame(*(
            torch.zeros((0,), dtype=I32, device=dev)
            for _ in EngineFrame._fields)))
    return RecordedRun(state, stack_frames(frames))

"""Tracing and step timing (port of `swim_tpu/utils/profiling.py`).

Two tools:

  * `trace(logdir)` - a context manager around `torch.profiler.profile`
    with CPU and CUDA activities; on exit it writes a Chrome trace of
    whatever ran inside into `logdir` (`<logdir>/torch.pt.trace.json`),
    which obs/prof.py `top_ops_from_trace` reads;
  * `StepTimer` - wall-clock periods/sec over explicit laps, fenced by
    `torch.cuda.synchronize()` on the result's device.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch

TRACE_FILE = "torch.pt.trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace (CPU and, with a card, CUDA
    activities) into `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as p:
        yield p
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    p.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _leaves(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)


def block_until_ready(result: Any) -> None:
    """Wait until the device that holds `result`'s tensors is idle."""
    for t in _leaves(result):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class StepTimer:
    """Measure protocol periods/sec over explicit laps.

    >>> timer = StepTimer()
    >>> with timer.lap(periods=50) as lap:
    ...     lap["result"] = engine.run(50)        # doctest: +SKIP
    >>> timer.periods_per_sec                     # doctest: +SKIP
    """

    def __init__(self):
        self.periods = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def lap(self, periods: int, result: Any = None):
        """Time one lap of `periods` protocol periods.  Only completed
        laps count: a body that raises adds neither periods nor
        seconds."""
        t0 = time.perf_counter()
        holder = {}
        yield holder
        out = holder.get("result", result)
        if out is not None:
            block_until_ready(out)
        self.seconds += time.perf_counter() - t0
        self.periods += periods

    @property
    def periods_per_sec(self) -> float:
        return self.periods / self.seconds if self.seconds else 0.0

    def summary(self) -> dict[str, float]:
        return {"periods": float(self.periods),
                "seconds": round(self.seconds, 4),
                "periods_per_sec": round(self.periods_per_sec, 2)}

"""Clock abstraction: one protocol implementation, two notions of time
(port of `swim_tpu/core/clock.py`).

  * `SimClock`: a deterministic discrete-event scheduler.  Tests and
    in-process clusters advance virtual time by hand, so multi-node runs
    are exactly reproducible on one host.
  * `AsyncioClock`: wraps a running asyncio loop for real deployments
    (the UDP transports).

Timers are the only way a Node observes time, so the protocol logic is
the same under both.
"""

from __future__ import annotations

import abc
import heapq
import itertools
from typing import Callable


class TimerHandle:
    __slots__ = ("cancelled", "_cancel_fn")

    def __init__(self, cancel_fn: Callable[[], None] | None = None):
        self.cancelled = False
        self._cancel_fn = cancel_fn

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            if self._cancel_fn is not None:
                self._cancel_fn()


class Clock(abc.ABC):
    @abc.abstractmethod
    def now(self) -> float:
        """Current time in seconds."""

    @abc.abstractmethod
    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        """Schedule `fn` after `delay` seconds; returns a cancellable
        handle."""


class SimClock(Clock):
    """Deterministic virtual time. Ties break by schedule order."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._heap: list[tuple[float, int, TimerHandle,
                               Callable[[], None]]] = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        h = TimerHandle()
        heapq.heappush(self._heap,
                       (self._now + max(delay, 0.0), next(self._seq), h, fn))
        return h

    # -- driving ------------------------------------------------------------

    def advance(self, dt: float) -> int:
        """Run all timers due within the next `dt` seconds; returns count."""
        return self.advance_to(self._now + dt)

    def advance_to(self, deadline: float) -> int:
        fired = 0
        while self._heap and self._heap[0][0] <= deadline:
            when, _, h, fn = heapq.heappop(self._heap)
            self._now = when
            if not h.cancelled:
                fired += 1
                fn()
        self._now = deadline
        return fired

    def pending(self) -> int:
        return sum(1 for _, _, h, _ in self._heap if not h.cancelled)


class AsyncioClock(Clock):
    """Real time via an asyncio event loop."""

    def __init__(self, loop=None):
        import asyncio

        self._loop = loop or asyncio.get_event_loop()

    def now(self) -> float:
        return self._loop.time()

    def call_later(self, delay: float, fn: Callable[[], None]) -> TimerHandle:
        timer = self._loop.call_later(delay, fn)
        return TimerHandle(timer.cancel)

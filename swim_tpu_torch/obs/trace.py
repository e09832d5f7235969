"""Structured protocol/serve-path tracing: spans + pluggable sinks (port
of `swim_tpu/obs/trace.py`).

A `Span` is one traced episode: a probe round (direct ping → indirect
ping-req fan-out → ack/nack → verdict), a suspicion (start →
independent confirmations → refute/confirm), or — the serving hub's
datagram lifecycle (obs/servetrace.py) — one datagram from frontend
receipt through the work queue or the device-mirror flush to its
reply.  Emitters push spans through a pluggable `TraceSink`; the
default is no sink at all (a `None` check on the hot path — zero
allocation when tracing is off).

Span schema (the JSONL shape written by `JsonlSink`):

  {"kind": "probe" | "suspicion" | "serve",
   "node": <observer id>, "subject": <member id>,
   "start": <clock seconds>, "end": <clock seconds>,
   "outcome": probe: "ack" | "fail";
              suspicion: "confirmed" | "refuted" | "superseded";
              serve: "echo_reply" | "gossip_flushed" | "deliver" |
                     "ack" | "admit" | "leave" | "rejected_queue",
   "events": [[<clock seconds>, <name>], ...]}

Event names: probe spans use "ping", "ping-req", "ack", "nack";
suspicion spans use "confirm" (one per independent suspector beyond
the originator).  Serve spans (node = session row, -1 pre-admission;
subject = wire opcode) use "queued" (bounded work-queue put), "handled"
(worker dequeue — queue wait is handled minus queued), "flush" (the
device-mirror period that carried a gossip update — coalesce-batching
delay), and "send" (DELIVER/ECHO reply handed to the frontend).
"""

from __future__ import annotations

import dataclasses
import json
from typing import IO, Protocol


@dataclasses.dataclass
class Span:
    kind: str                 # "probe" | "suspicion" | "serve"
    node: int
    subject: int
    start: float
    end: float | None = None
    outcome: str | None = None
    events: list[tuple[float, str]] = dataclasses.field(default_factory=list)

    def event(self, t: float, name: str) -> None:
        self.events.append((t, name))

    def finish(self, t: float, outcome: str) -> "Span":
        self.end = t
        self.outcome = outcome
        return self

    def to_dict(self) -> dict:
        return {"kind": self.kind, "node": self.node,
                "subject": self.subject, "start": self.start,
                "end": self.end, "outcome": self.outcome,
                "events": [[t, name] for t, name in self.events]}


class TraceSink(Protocol):
    def emit(self, span: Span) -> None: ...


class NullSink:
    """Swallows spans (explicit off; nodes also accept trace=None)."""

    def emit(self, span: Span) -> None:
        pass


class ListSink:
    """Collects spans in memory — tests and notebook inspection."""

    def __init__(self):
        self.spans: list[Span] = []

    def emit(self, span: Span) -> None:
        self.spans.append(span)


class JsonlSink:
    """Writes one JSON object per finished span to a file or stream."""

    def __init__(self, target: str | IO[str]):
        if isinstance(target, str):
            self._file: IO[str] = open(target, "a")
            self._owns = True
        else:
            self._file = target
            self._owns = False

    def emit(self, span: Span) -> None:
        self._file.write(json.dumps(span.to_dict()) + "\n")

    def close(self) -> None:
        self._file.flush()
        if self._owns:
            self._file.close()

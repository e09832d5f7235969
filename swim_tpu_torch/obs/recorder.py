"""Bounded flight recorder for engine telemetry frames (port of
`swim_tpu/obs/recorder.py`).

Keeps the last K periods of `EngineFrame` counters in a host-side ring
buffer and writes them as JSONL on demand or on an anomaly.  The dump
describes itself: line 1 is a header object (schema version, dump
reason, frame field names, config snapshot, optional per-collective ICI
byte tally, optional embedded study milestones and health findings),
every following line is one period's frame.  For the same frames and
configuration the bytes are the reference's.

`FlightRecorder.load` reads a dump back into a NamedTuple of int64
arrays shaped like stacked frames, so `utils/metrics.series_digest`
and `obs/analyze.py` work on the dump alone.

With `monitor=HealthMonitor(...)` every recorded row streams through
the rules engine; `auto_dump_reason()` surfaces an error-severity
finding as a `"health:<rule>"` dump reason and `dump` embeds the
findings in the header.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from collections import namedtuple
from typing import Any

import numpy as np
import torch

from swim_tpu_torch.obs.engine import EngineFrame
from swim_tpu_torch.obs.health import HealthMonitor

KIND = "swim_tpu_flight_recorder"
VERSION = 1


def write_jsonl(path: str, header: dict, rows: Any) -> str:
    """The self-describing JSONL dump: line 1 a header object
    (kind/version/...), every following line one row."""
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return path


# Host-side per-period counters recorded in the same row as the engine
# frame: the study runners' false_dead_views series, and the fault
# schedule's gray_nodes / flap_active gauges (read by the
# gray_undetected / flap_false_dead health rules).
AUX_FIELDS = ("false_dead_views", "gray_nodes", "flap_active")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class FlightRecorder:
    """Host-side ring buffer of the last `capacity` telemetry frames."""

    def __init__(self, cfg: Any = None, capacity: int = 64,
                 ici_bytes: dict | None = None,
                 monitor: HealthMonitor | None = None):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = capacity
        self.cfg = cfg
        self.ici_bytes = ici_bytes
        self.monitor = monitor
        self._frames: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self._aux_seen: set[str] = set()

    def __len__(self) -> int:
        return len(self._frames)

    def record(self, period: int, frame: Any) -> None:
        """Append one period.  `frame` is an EngineFrame of scalars or any
        mapping or NamedTuple with (a subset of) its fields, plus optional
        AUX_FIELDS.  Missing fields record 0; an unknown key raises
        KeyError (a typo would otherwise record zeros)."""
        if hasattr(frame, "_asdict"):
            frame = frame._asdict()
        unknown = set(frame) - set(EngineFrame._fields) - set(AUX_FIELDS)
        if unknown:
            raise KeyError(
                f"unknown telemetry field(s) {sorted(unknown)} — frames "
                "carry EngineFrame fields "
                f"{list(EngineFrame._fields)} plus aux {list(AUX_FIELDS)} "
                "(swim_tpu_torch/obs/engine.py; a typo here would "
                "otherwise silently record zeros)")
        row = {"period": int(period)}
        for name in EngineFrame._fields:
            row[name] = int(frame.get(name, 0))
        for name in AUX_FIELDS:
            if name in frame:
                row[name] = int(frame[name])
                self._aux_seen.add(name)
        self._frames.append(row)
        if self.monitor is not None:
            self.monitor.observe(int(period), row)

    def record_stacked(self, frames: Any, start_period: int = 0,
                       aux: dict[str, Any] | None = None) -> None:
        """Feed a stacked EngineFrame ([T] tensors or arrays) period by
        period.  Each field is read to the host once.  `aux` carries [T]
        series of AUX_FIELDS (e.g. the runners' false_dead_views) merged
        into the same rows."""
        cols = {name: _host(getattr(frames, name))
                for name in EngineFrame._fields}
        for name, arr in (aux or {}).items():
            cols[name] = _host(arr)
        t_len = len(next(iter(cols.values())))
        for t in range(t_len):
            self.record(start_period + t,
                        {name: cols[name][t] for name in cols})

    def auto_dump_reason(self) -> str | None:
        """`"health:<rule>"` when the attached monitor holds an
        error-severity finding, else None."""
        if self.monitor is None:
            return None
        return self.monitor.auto_dump_reason()

    def dump(self, path: str, reason: str = "on_demand",
             extra: dict | None = None) -> str:
        """Write the buffer as JSONL (header line + one line a period).
        `extra` merges more sections into the header (e.g. the detection
        study's milestone arrays); the core keys win on a collision."""
        header = dict(extra or {})
        header.update({
            "kind": KIND,
            "version": VERSION,
            "reason": reason,
            "fields": list(EngineFrame._fields) + sorted(self._aux_seen),
            "capacity": self.capacity,
            "periods": len(self._frames),
        })
        if self.cfg is not None:
            header["cfg"] = dataclasses.asdict(self.cfg)
        if self.ici_bytes is not None:
            header["ici_bytes"] = self.ici_bytes
        if self.monitor is not None:
            header["health"] = self.monitor.summary()
        return write_jsonl(path, header, self._frames)

    @staticmethod
    def load(path: str) -> tuple[dict, Any]:
        """Read a dump back: (header, frames), `frames` a NamedTuple of
        int64 arrays ([T] per field, plus `period`)."""
        with open(path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        if not lines or lines[0].get("kind") != KIND:
            raise ValueError(f"{path} is not a {KIND} dump")
        header, rows = lines[0], lines[1:]
        fields = ["period"] + list(header["fields"])
        Frames = namedtuple("RecordedFrames", fields)
        return header, Frames(*(
            np.asarray([row.get(name, 0) for row in rows], np.int64)
            for name in fields))

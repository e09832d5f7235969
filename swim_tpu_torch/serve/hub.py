"""Serving hub: async session admission over a free-running ring engine
(port of `swim_tpu/serve/hub.py`).

`ServeHub` admits thousands of concurrent external cores onto one
ring-engine simulation on one device:

  NO BARRIER.  The engine steps whenever its caller says so
    (`step_periods`, or `start(auto_period)` on its own thread); no
    session clock gates it.  A session proves liveness by ACKing its
    mirrored rotor pings; one that stops is EVICTED: its reserved row is
    crash-gated and the cluster detects the death organically.
  BOUNDED WORK QUEUE.  Admission (HELLO), clean departure (BYE) and
    eviction are items on a bounded `queue.Queue` drained by a worker
    thread, so the device step never waits on socket I/O and a join
    storm degrades to rejections, not latency.
  BATCHED ROW MIRRORING.  Every session's gossip queued for a period
    becomes one fixed-capacity `ring.ExtOriginations` batch, joined to
    Phase D.  The four [E] lanes are staged in one pinned [4, E] int32
    block (with the period's rotor offsets behind them) and reach the
    card by ONE non-blocking copy; a small ring of such blocks, each
    with an event, keeps a block from being refilled before its copy
    ran.  Slots past the capacity spill to the next period.  The empty
    batch stays on the device.  The placement is billed as the
    reference bills it: 16 bytes a slot (obs/ici.py `ext_mirror_rows`).

An untraced period makes no host sync: the probe offset that the
session mirror needs is the host's own copy (`ring.rotor_offsets`),
and the fault plan is copied only when an eviction or kill changed it,
by the engine thread.  A traced period ends its `engine_step` phase at
a CUDA synchronize, so the phase holds the card's work, not its
dispatch.  Keys on the host are u32: the state's int32 carriers are
viewed as uint32 before a compare or a max.

Wire protocol (datagram): a fixed `!BII` header (op, a, b) + optional
payload.  Sessions are keyed by their reserved ROW, not by socket, so
many sessions share one client socket.

  HELLO  (c->h)  a=client nonce          -> WELCOME a=row b=nonce
                                          | REJECT a=reason b=nonce
  BYE    (c->h)  a=row                   clean leave: row returns to
                                         the free pool, NO plan change
  DGRAM  (c->h)  a=src row b=dst node    payload = core/codec.py bytes
                                         (gossip -> injections; ACK ->
                                         liveness credit; PING -> a
                                         synthesized ack)
  DELIVER(h->c)  a=sender b=dst row      payload = codec bytes
                                         (mirrored rotor pings, acks)
  ECHO   (c->h)  a,b opaque              -> ECHO_REPLY a,b, answered
                                         straight from the frontend
                                         drain (the load harness's RTT
                                         probe)

Hub-synthesized acks carry empty gossip unless `mirror_gossip=True`.
"""

from __future__ import annotations

import collections
import queue
import socket
import struct
import threading

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.core import codec
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs import servetrace
from swim_tpu_torch.obs.health import Finding
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.types import (MsgKind, Status, key_incarnation,
                                  key_status, opinion_key)
from swim_tpu_torch.utils import threefry

WORD = 32

# Static capacity of the coalesced per-period ExtOriginations batch
# (16 bytes a slot: the obs/ici.py ext_mirror_rows term).
EXT_CAPACITY = 64

# ------------------------------------------------------------ wire format

HDR = struct.Struct("!BII")

OP_HELLO = 1
OP_BYE = 2
OP_DGRAM = 3
OP_WELCOME = 4
OP_DELIVER = 5
OP_ECHO = 6
OP_ECHO_REPLY = 7
OP_REJECT = 8

REJ_FULL = 1        # no free reserved row
REJ_QUEUE = 2       # admission queue full (join storm back-pressure)


def pack(op: int, a: int = 0, b: int = 0, payload: bytes = b"") -> bytes:
    return HDR.pack(op, a & 0xFFFFFFFF, b & 0xFFFFFFFF) + payload


def unpack(data: bytes) -> tuple[int, int, int, bytes]:
    op, a, b = HDR.unpack_from(data, 0)
    return op, a, b, data[HDR.size:]


# --------------------------------------------------------- gauge surface

SESSION_GAUGES: dict[str, str] = {
    "swim_session_admitted":
        "Sessions admitted onto reserved rows since hub start",
    "swim_session_evicted":
        "Sessions evicted (stall/disconnect; their rows were "
        "crash-gated and die organically)",
    "swim_session_active":
        "Sessions currently attached to reserved rows",
    "swim_session_clock_lag_periods":
        "Periods since a session's last liveness credit (per-session "
        "series when the report carries a session table)",
    "swim_session_mirror_bytes_per_period":
        "Bytes of the coalesced per-step ExtOriginations placement "
        "(the obs/ici.py ext_mirror_rows term: 16 per slot)",
    "swim_session_mirror_spill_slots":
        "Queued gossip slots that missed their period's fixed-capacity "
        "ExtOriginations batch (EXT_CAPACITY spill — injected late, "
        "never dropped; persistent spill fires ext_mirror_overflow)",
}


def gauge_values(report: dict) -> dict[str, float]:
    """SESSION_GAUGES values from one `ServeHub.report()` dict (the
    expo.render_sessions scalar fallback; clock lag collapses to the
    WORST attached session)."""
    sessions = report.get("sessions") or []
    worst = max((float(s.get("clock_lag_periods", 0)) for s in sessions),
                default=0.0)
    return {
        "swim_session_admitted": float(report.get("admitted", 0)),
        "swim_session_evicted": float(report.get("evicted", 0)),
        "swim_session_active": float(report.get("active", 0)),
        "swim_session_clock_lag_periods": worst,
        "swim_session_mirror_bytes_per_period":
            float(report.get("mirror_bytes_per_period", 0)),
        "swim_session_mirror_spill_slots":
            float(report.get("mirror_spill_slots", 0)),
    }


# ------------------------------------------------------------- frontends


class _SocketFrontend:
    """Plain Python UDP frontend (the no-toolchain fallback): one
    socket, one drain thread, same callback contract as the pump."""

    kind = "socket"

    def __init__(self, host: str, port: int, on_datagram):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.25)
        self.local_address = self._sock.getsockname()
        self._on = on_datagram
        self._closing = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while not self._closing:
            try:
                data, addr = self._sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._on(addr, data)
            except Exception:  # noqa: BLE001 — a broken handler must not
                pass           # kill the drain loop (pump contract)

    def send(self, to, payload: bytes) -> None:
        try:
            self._sock.sendto(payload, to)
        except OSError:
            pass               # datagram loss is legal on this seam

    def stats(self) -> dict[str, int]:
        return {}

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


class _PumpFrontend:
    """The udppump epoll datapath as hub frontend: sends enqueue into
    the pump's outbox, inbound datagrams arrive in batches on the
    drainer thread, one GIL crossing per batch (native/udppump.cpp)."""

    kind = "udppump"

    def __init__(self, host: str, port: int, on_datagram):
        from swim_tpu_torch.native.transport import NativeUDPTransport

        self._t = NativeUDPTransport(host, port)
        self._t.set_receiver(on_datagram)
        self.local_address = self._t.local_address

    def send(self, to, payload: bytes) -> None:
        self._t.send(to, payload)

    def stats(self) -> dict[str, int]:
        return self._t.stats()

    def close(self) -> None:
        self._t.close()


def make_frontend(host: str, port: int, on_datagram, prefer: str = "auto"):
    """The hub datapath: `"udppump"` (native epoll, raises without the
    toolchain), `"socket"` (pure Python), or `"auto"` (pump when
    available — the promoted default)."""
    if prefer not in ("auto", "udppump", "socket"):
        raise ValueError(f"bad frontend {prefer!r}")
    if prefer in ("auto", "udppump"):
        from swim_tpu_torch.native import transport as native_transport

        if native_transport.is_available():
            return _PumpFrontend(host, port, on_datagram)
        if prefer == "udppump":
            raise RuntimeError("native udppump unavailable (no toolchain)")
    return _SocketFrontend(host, port, on_datagram)


# ------------------------------------------------------------------- hub


class _Client:
    """One admitted session: a reserved row plus its return address."""

    __slots__ = ("row", "addr", "joined_t", "last_ack_t", "pings_sent",
                 "pings_acked")

    def __init__(self, row: int, addr, t: int):
        self.row = row
        self.addr = addr            # None: in-process attach (no sends)
        self.joined_t = t
        self.last_ack_t = t
        self.pings_sent = 0
        self.pings_acked = 0


class Stager:
    """The per-period host-to-device placement of one int32 block.

    On a CUDA device each block is staged in pinned host memory and
    copied with `non_blocking=True`; a block is refilled only once the
    event recorded after its copy has completed (checked with `query`,
    which never waits: a busy ring grows by one block instead).  On the
    CPU the block is copied."""

    def __init__(self, width: int, device: torch.device):
        self.width = width
        self.device = device
        self._ring: list[tuple[torch.Tensor, torch.cuda.Event]] = []

    def put(self, values: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(values.astype(np.int32, copy=True))
        for i, (block, ev) in enumerate(self._ring):
            if ev.query():
                break
        else:
            block = torch.empty((self.width,), dtype=torch.int32,
                                pin_memory=True)
            ev = torch.cuda.Event()
            self._ring.append((block, ev))
        block.numpy()[:values.shape[0]] = values
        out = block[:values.shape[0]].to(self.device, non_blocking=True)
        ev.record(torch.cuda.current_stream(self.device))
        return out


def stage_period(stage: Stager, batch: list, cap: int, offs: list[int]
                 ) -> tuple[ring.ExtOriginations | None, torch.Tensor]:
    """A period's external batch (the first four fields of each item:
    subject, u32 key, origin, hearer; at most `cap`) and its rotor
    offsets `offs`, placed on the device by one staged copy.  Returns
    (ext, offsets); ext is None for an empty batch (the caller keeps a
    device-resident empty one)."""
    if not batch:
        return None, stage.put(np.asarray(offs, np.int32))
    lanes = np.zeros((4, cap), np.uint32)
    lanes[0] = np.uint32(0xFFFFFFFF)            # subject -1: empty
    for i, item in enumerate(batch):
        lanes[:, i] = [v & 0xFFFFFFFF for v in item[:4]]
    staged = stage.put(np.concatenate(
        [lanes.view(np.int32).reshape(-1), np.asarray(offs, np.int32)]))
    return (ring.ExtOriginations(*staged[:4 * cap].view(4, cap)),
            staged[4 * cap:])


class ServeHub:
    """Async-admission serving hub over one ring-engine simulation.

    `reserved_rows` are the engine node ids sessions may attach to;
    admission assigns a free one (the step's shapes never change: the
    plan and the fixed-capacity ExtOriginations batch are the only
    inputs that do).  Drive the engine with `step_periods(k)`
    (deterministic: tests and the load harness) or
    `start(auto_period=s)` (free-running).  `attach()`/`detach()` are
    the in-process admission path (same worker internals, no sockets).
    `device=None` is the CUDA card (swim_tpu_torch/device.py); the
    engine's tensors all live on that one device.
    """

    def __init__(self, cfg: SwimConfig, reserved_rows: list[int],
                 seed: int = 0, host: str = "127.0.0.1", port: int = 0,
                 ext_capacity: int = EXT_CAPACITY, ack_grace: int = 3,
                 queue_capacity: int = 1024, frontend: str = "auto",
                 mirror_gossip: bool = False,
                 trace: "servetrace.ServeTrace | bool | None" = None,
                 device=None):
        if cfg.ring_probe != "rotor":
            raise ValueError("ServeHub requires the rotor probe (the "
                             "mirrored-ping seam is rotor-shaped)")
        ring.check_slice(cfg)
        self.cfg = cfg
        self.n = cfg.n_nodes
        rows = list(reserved_rows)
        if len(set(rows)) != len(rows):
            raise ValueError("duplicate reserved rows")
        for r in rows:
            if not 0 <= r < self.n:
                raise ValueError("reserved rows must be node ids")
        self.reserved_rows = rows
        self.ext_capacity = int(ext_capacity)
        self.ack_grace = int(ack_grace)
        self.mirror_gossip = bool(mirror_gossip)
        self.device = devmod.resolve(device)
        dev = self.device
        self._key = threefry.key(seed)
        self.state = ring.init_state(cfg, dev)
        self.t = 0
        self._ext_empty = ring.ext_none(self.ext_capacity, dev)
        # one staged block a period: the four ext lanes, then the rotor
        # offsets [s_off, q_off...]
        self._n_offs = 1 + cfg.k_indirect
        self._stage = Stager(4 * self.ext_capacity + self._n_offs, dev)
        # host-side fault mirrors (the device plan is rebuilt on change,
        # generation-checked)
        self._crash = np.full((self.n,), np.iinfo(np.int32).max // 2,
                              np.int32)
        self._join = np.zeros((self.n,), np.int32)
        self._plan_const = dict(
            loss=torch.zeros((), dtype=torch.float32, device=dev),
            partition_id=torch.zeros((self.n,), dtype=torch.uint8,
                                     device=dev),
            partition_start=torch.full((), 1 << 30, dtype=torch.int32,
                                       device=dev),
            partition_end=torch.full((), 1 << 30, dtype=torch.int32,
                                     device=dev))
        self._plan = None
        self._plan_dirty = True
        self._plan_gen = 0
        self._inject: list[tuple] = []
        self._lock = threading.Lock()
        # bounded work queue: the ONLY path from socket I/O to hub
        # membership state; the device step never waits on it
        self._work: queue.Queue = queue.Queue(maxsize=queue_capacity)
        self._free: collections.deque[int] = collections.deque(rows)
        self._clients: dict[int, _Client] = {}
        self._findings: list[Finding] = []
        self._stats = {"admitted": 0, "evicted": 0, "left": 0,
                       "rejected_full": 0, "queue_drops": 0,
                       "mirror_updates": 0, "mirror_bytes": 0,
                       "mirror_spill_slots": 0, "mirror_spill_periods": 0,
                       "datagrams": 0, "echoes": 0}
        self._spill_streak = 0
        # serve-path tracing (obs/servetrace.py): default off, a None
        # check on every hot path; it reads clocks and appends to host
        # buffers only, so engine state is the same traced or not
        self.trace = servetrace.coerce(trace)
        if self.mirror_gossip:
            self._mirror_table()
            self._prev_rows: dict[int, np.ndarray] = {}
        self._closing = False
        self.frontend = make_frontend(host, port, self._on_datagram,
                                      frontend)
        self.address = self.frontend.local_address
        self._worker = threading.Thread(target=self._admission_worker,
                                        daemon=True)
        self._worker.start()
        self._engine_thread: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle

    def start(self, auto_period: float = 0.05) -> None:
        """Free-running mode: step one period every `auto_period`
        seconds until close(), on a thread of its own."""
        def loop() -> None:
            import time

            while not self._closing:
                self._period()
                time.sleep(auto_period)

        self._engine_thread = threading.Thread(target=loop, daemon=True)
        self._engine_thread.start()

    def close(self) -> None:
        self._closing = True
        try:
            self._work.put_nowait(None)
        except queue.Full:
            pass
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=10)
        self._worker.join(timeout=10)
        self.frontend.close()

    # ------------------------------------------------------ admission path

    def _on_datagram(self, addr, data: bytes) -> None:
        """Frontend drain callback (pump or socket thread).  Never
        touches device state and never blocks: membership changes go
        through the bounded queue, everything else reads host mirrors."""
        if len(data) < HDR.size:
            return
        tr = self.trace
        t_in = tr.now() if tr is not None else 0.0
        op, a, b, payload = unpack(data)
        if op == OP_ECHO:
            # answered straight from the drain: the RTT probe measures
            # the datapath, not the engine
            with self._lock:
                self._stats["echoes"] += 1
            self.frontend.send(addr, pack(OP_ECHO_REPLY, a, b))
            if tr is not None:
                s = tr.datagram_span(t_in, op)
                t = tr.now()
                s.event(t, "send")
                tr.emit(s.finish(t, "echo_reply"))
        elif op == OP_HELLO:
            span = tr.datagram_span(t_in, op) if tr is not None else None
            try:
                if span is None:
                    self._work.put_nowait(("admit", addr, a))
                else:
                    span.event(tr.now(), "queued")
                    self._work.put_nowait(("admit", addr, a, span))
            except queue.Full:
                with self._lock:
                    self._stats["queue_drops"] += 1
                self.frontend.send(addr, pack(OP_REJECT, REJ_QUEUE, a))
                if span is not None:
                    t = tr.now()
                    span.event(t, "send")
                    tr.emit(span.finish(t, "rejected_queue"))
        elif op == OP_BYE:
            span = tr.datagram_span(t_in, op, row=a) \
                if tr is not None else None
            try:
                if span is None:
                    self._work.put_nowait(("leave", a, addr))
                else:
                    span.event(tr.now(), "queued")
                    self._work.put_nowait(("leave", a, addr, span))
            except queue.Full:
                with self._lock:     # client may re-send; worst case the
                    self._stats["queue_drops"] += 1   # row stalls out
        elif op == OP_DGRAM:
            self._on_session_datagram(addr, a, b, payload, t_in=t_in)

    def _admission_worker(self) -> None:
        """Drains the bounded work queue: admissions, clean leaves,
        evictions, on a thread of its own (it places nothing on the
        device: an eviction's plan change is copied by the engine
        thread)."""
        while True:
            item = self._work.get()
            if item is None:
                return
            try:
                kind = item[0]
                # optional 4th element: a "serve" span minted at
                # frontend receipt; "handled" marks worker dequeue
                span = item[3] if len(item) > 3 else None
                tr = self.trace
                if span is not None and tr is not None:
                    span.event(tr.now(), "handled")
                if kind == "admit":
                    self._do_admit(item[1], item[2])
                elif kind == "leave":
                    self._do_leave(item[1], item[2])
                elif kind == "evict":
                    self._do_evict(item[1], item[2])
                if span is not None and tr is not None:
                    tr.emit(span.finish(tr.now(), kind))
            except Exception:  # noqa: BLE001 — one bad item must not
                pass           # kill the admission plane

    def _do_admit(self, addr, nonce: int) -> None:
        with self._lock:
            row = self._free.popleft() if self._free else None
            if row is not None:
                self._clients[row] = _Client(row, addr, self.t)
                self._stats["admitted"] += 1
            else:
                self._stats["rejected_full"] += 1
        if addr is None:
            return
        if row is None:
            self.frontend.send(addr, pack(OP_REJECT, REJ_FULL, nonce))
        else:
            self.frontend.send(addr, pack(OP_WELCOME, row, nonce))

    def _do_leave(self, row: int, addr) -> None:
        """Clean departure: the row returns to the free pool with NO
        plan change, so silent join/leave churn leaves the engine state
        bit for bit as it was."""
        with self._lock:
            c = self._clients.get(row)
            if c is None or (addr is not None and c.addr != addr):
                return
            del self._clients[row]
            self._free.append(row)
            self._stats["left"] += 1

    def _do_evict(self, row: int, reason: str) -> None:
        with self._lock:
            c = self._clients.pop(row, None)
            if c is None:
                return
            self._stats["evicted"] += 1
            lag = self.t - c.last_ack_t
            self._findings.append(Finding(
                rule="session_evicted", severity="warn", period=self.t,
                value=float(lag), threshold=float(self.ack_grace),
                message=f"session row {row} evicted ({reason}): "
                        f"{lag} periods without liveness credit"))
        # the row is NOT returned to the pool: it is crash-gated and the
        # cluster detects the death organically
        self.kill(row)

    def attach(self) -> int | None:
        """Synchronously admit an in-process session; returns its row
        (None when the pool is exhausted)."""
        with self._lock:
            before = set(self._clients)
        self._do_admit(None, 0)
        with self._lock:
            new = set(self._clients) - before
        return new.pop() if new else None

    def detach(self, row: int) -> None:
        """Synchronously leave (clean): the in-process BYE."""
        self._do_leave(row, None)

    def evict(self, row: int, reason: str = "test") -> None:
        """Synchronously evict: crash-gate the row + health finding."""
        self._do_evict(row, reason)

    # ------------------------------------------------------- fault wiring

    def kill(self, node_id: int) -> None:
        with self._lock:
            if 0 <= node_id < self.n and self._crash[node_id] > self.t:
                self._crash[node_id] = self.t
                self._plan_dirty = True
                self._plan_gen += 1

    def _alive(self, node_id: int) -> bool:
        return (0 <= node_id < self.n and self._crash[node_id] > self.t
                and self._join[node_id] <= self.t)

    def _device_plan(self) -> FaultPlan:
        """The FaultPlan on the device; on a change (engine thread only)
        the crash and join rows go over in one copy."""
        with self._lock:
            rebuild = self._plan_dirty or self._plan is None
            gen = self._plan_gen
            if rebuild:
                rows = np.stack([self._crash, self._join])
        if rebuild:
            block = torch.from_numpy(rows)
            if self.device.type == "cuda":
                block = block.pin_memory().to(self.device, non_blocking=True)
            self._plan = FaultPlan(crash_step=block[0], join_step=block[1],
                                   **self._plan_const)
            with self._lock:
                if self._plan_gen == gen:
                    self._plan_dirty = False
        return self._plan

    # ------------------------------------------------------- session seam

    def _on_session_datagram(self, addr, src: int, dst: int,
                             payload: bytes, t_in: float = 0.0) -> None:
        """One DGRAM from session row `src` toward engine node `dst`
        (codec bytes).  Runs on the frontend thread; reads host mirrors
        only: the engine may be mid-step on another thread."""
        with self._lock:
            c = self._clients.get(src)
            if c is None or (c.addr is not None and c.addr != addr):
                return
            self._stats["datagrams"] += 1
        tr = self.trace
        if tr is not None and not t_in:
            t_in = tr.now()          # in-process callers skip the drain
        try:
            kind = codec.peek_kind(payload)
        except codec.DecodeError:
            return
        if kind == MsgKind.ACK:
            with self._lock:
                c.pings_acked = c.pings_sent
                c.last_ack_t = self.t
            if tr is not None:
                tr.emit(tr.datagram_span(t_in, OP_DGRAM, row=src)
                        .finish(tr.now(), "ack"))
            return
        try:
            msg = codec.decode(payload)
        except codec.DecodeError:
            return
        span = tr.datagram_span(t_in, OP_DGRAM, row=src) \
            if tr is not None else None
        self._queue_injections(dst if self._alive(dst) else src,
                               msg.gossip, span=span)
        if kind == MsgKind.PING and self._alive(dst):
            # answer from host state at datagram time (empty gossip
            # unless mirror_gossip)
            ack = codec.Message(kind=MsgKind.ACK, sender=dst,
                                probe_seq=msg.probe_seq,
                                on_behalf=msg.on_behalf)
            self._deliver(src, dst, ack)
            if span is not None and span.end is None and not msg.gossip:
                # a pure ping closes at the synthesized ack's send;
                # gossip-carrying datagrams close at their flush period
                t = tr.now()
                span.event(t, "send")
                tr.emit(span.finish(t, "deliver"))

    def _queue_injections(self, hearer: int,
                          gossip: tuple[codec.WireUpdate, ...],
                          span=None) -> None:
        first = True
        for u in gossip:
            if not 0 <= u.member < self.n:
                continue
            key = opinion_key(int(u.status), u.incarnation)
            if self.mirror_gossip and key <= self._best_key(u.member):
                continue             # stale against the table mirror
            org = u.origin if 0 <= u.origin < self.n else hearer
            if span is not None and first:
                span.event(self.trace.now(), "queued")
            with self._lock:
                if span is not None and first:
                    # the span rides the datagram's first queued slot:
                    # its flush period stamps the coalesce delay
                    self._inject.append((u.member, key, org, hearer,
                                         span))
                    first = False
                else:
                    self._inject.append((u.member, key, org, hearer))

    def _deliver(self, row: int, sender: int, msg: codec.Message) -> None:
        with self._lock:
            c = self._clients.get(row)
            addr = c.addr if c is not None else None
        if addr is not None:
            self.frontend.send(addr, pack(OP_DELIVER, sender, row,
                                          codec.encode(msg)))

    # ------------------------------------------------------------- engine

    def step_periods(self, k: int) -> None:
        for _ in range(k):
            self._period()

    def _period(self) -> None:
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._period_body()
        else:
            self._period_body()

    def _period_body(self) -> None:
        tr = self.trace
        if tr is not None:
            tr.begin(self.t)
        # 1. eviction scan: a session that missed its last ack_grace
        # mirrored pings is queued for eviction (membership changes stay
        # on the worker thread)
        with self._lock:
            stale = [c.row for c in self._clients.values()
                     if c.pings_sent - c.pings_acked > self.ack_grace]
        for row in stale:
            try:
                self._work.put_nowait(("evict", row, "stall"))
            except queue.Full:
                break                # retry next period
        if tr is not None:
            tr.lap("evict_scan")
        # 2. the batched row mirror: the queued gossip, up to capacity,
        # becomes one ExtOriginations batch; the rest spills to the next
        # period (late, never dropped; persistent spill is a finding)
        with self._lock:
            batch = self._inject[:self.ext_capacity]
            self._inject = self._inject[self.ext_capacity:]
            spill = len(self._inject)
            if spill > 0:
                self._stats["mirror_spill_slots"] += spill
                self._stats["mirror_spill_periods"] += 1
                self._spill_streak += 1
                if self._spill_streak >= 2:
                    self._findings.append(Finding(
                        rule="ext_mirror_overflow", severity="warn",
                        period=self.t, value=float(spill),
                        threshold=float(self.ext_capacity),
                        message=f"ext mirror overflow: {spill} gossip "
                                f"slots spilled past the "
                                f"{self.ext_capacity}-slot batch for "
                                f"{self._spill_streak} consecutive "
                                f"periods"))
            else:
                self._spill_streak = 0
        offs = ring.rotor_offsets(self.cfg, self.t)
        cap = self.ext_capacity
        ext, offsets = stage_period(self._stage, batch, cap, offs)
        if ext is not None:
            with self._lock:
                self._stats["mirror_updates"] += 1
                self._stats["mirror_bytes"] += 16 * cap
            if tr is not None:
                # gossip spans riding this batch close at their flush
                t_flush = tr.now()
                for item in batch:
                    if len(item) > 4 and item[4].end is None:
                        item[4].event(t_flush, "flush")
                        tr.emit(item[4].finish(t_flush, "gossip_flushed"))
        else:
            ext = self._ext_empty        # the device-resident empty batch
        if tr is not None:
            tr.lap("inject_coalesce")
        # 3. one engine period (shapes fixed: churn changes no shape)
        rnd = ring.draw_period_ring(self._key, self.t, self.cfg,
                                    self.device, offsets=offsets)
        self.state = ring.step(self.cfg, self.state, self._device_plan(),
                               rnd, ext=ext)
        if tr is not None:
            # device-synced phase edge: without it the eager dispatch
            # returns before the card's work and that work would show in
            # a later phase
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            tr.lap("engine_step")
        s_off = offs[0]
        if tr is not None:
            tr.lap("s_off_get")
        self.t += 1
        # 4. mirror the rotor probe of every attached session
        if self.mirror_gossip:
            self._mirror_table()
        with self._lock:
            attached = list(self._clients.values())
        for c in attached:
            prober = (c.row - s_off) % self.n
            if not self._alive(prober):
                continue             # no probe of this row this period
            gossip: tuple = ()
            if self.mirror_gossip:
                gossip = self._fresh_updates(c.row, prober)
            with self._lock:
                c.pings_sent += 1
            self._deliver(c.row, prober, codec.Message(
                kind=MsgKind.PING, sender=prober, probe_seq=self.t,
                gossip=gossip))
        if tr is not None:
            tr.lap("mirror_fanout")
            tr.end()

    # ------------------------------------------------- state decoding
    # (host mirrors, used only with mirror_gossip=True; each read waits
    # for the card)

    def _mirror_table(self) -> None:
        self._subject = self.state.subject.cpu().numpy()
        self._rkey = self.state.rkey.cpu().numpy().view(np.uint32)

    def _best_key(self, member: int) -> int:
        mask = self._subject == member
        return int(self._rkey[mask].max()) if mask.any() else 0

    def _resolved_row(self, x: int) -> np.ndarray:
        g = ring.geometry(self.cfg)
        win_x = self.state.win[x].cpu().numpy().view(np.uint32)
        cold_x = self.state.cold[:, x].cpu().numpy().view(np.uint32)
        t = int(self.state.step)
        first_gw = t * g.ow - g.ww
        win_ring0 = first_gw % g.rw
        words = cold_x.copy()
        for w in range(g.ww):
            words[(win_ring0 + w) % g.rw] = win_x[w]
        return np.unpackbits(words.astype("<u4").view(np.uint8),
                             bitorder="little").astype(bool)

    def _fresh_updates(self, row: int,
                       origin: int) -> tuple[codec.WireUpdate, ...]:
        cur = self._resolved_row(row)
        prev = self._prev_rows.get(row)
        self._prev_rows[row] = cur
        fresh = cur if prev is None else (cur & ~prev)
        out = []
        for sl in np.nonzero(fresh)[0].tolist()[:255]:
            subj = int(self._subject[sl])
            if subj < 0:
                continue
            k = int(self._rkey[sl])
            out.append(codec.WireUpdate(
                member=subj, status=Status(key_status(k)),
                incarnation=key_incarnation(k), addr=("sim", subj),
                origin=origin))
        return tuple(out)

    # ------------------------------------------------------------ reports

    def findings(self) -> list[Finding]:
        with self._lock:
            return list(self._findings)

    def report(self) -> dict:
        """Point-in-time session stats (the SESSION_GAUGES input)."""
        with self._lock:
            sessions = [{"row": c.row,
                         "clock_lag_periods": self.t - c.last_ack_t}
                        for c in self._clients.values()]
            return {"nodes": self.n,
                    "periods": self.t,
                    "frontend": self.frontend.kind,
                    "admitted": self._stats["admitted"],
                    "evicted": self._stats["evicted"],
                    "left": self._stats["left"],
                    "active": len(self._clients),
                    "rejected_full": self._stats["rejected_full"],
                    "queue_drops": self._stats["queue_drops"],
                    "mirror_updates": self._stats["mirror_updates"],
                    "mirror_bytes": self._stats["mirror_bytes"],
                    "mirror_bytes_per_period": 16 * self.ext_capacity,
                    "mirror_spill_slots":
                        self._stats["mirror_spill_slots"],
                    "mirror_spill_periods":
                        self._stats["mirror_spill_periods"],
                    "datagrams": self._stats["datagrams"],
                    "echoes": self._stats["echoes"],
                    "sessions": sessions}

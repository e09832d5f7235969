"""Engine-backed bridge: a foreign core's peers ARE the tensor simulation
(port of `swim_tpu/bridge/engine_server.py`).

Where bridge/server.py hosts an event-driven cluster of real
core/node.py nodes, `EngineBridgeServer` hosts an N-node RING-ENGINE
simulation (models/ring.py) on one device and couples K externally
driven node ids to it over the lockstep TCP protocol (bridge/protocol.py),
so untouched foreign SWIM cores (native/bridge_client.cpp, or the Python
`Node` through bridge/client.py) probe, gossip with and detect failures
among tens of thousands of tensor-simulated peers AND each other.

The seam, per protocol period (one `STEP` accumulation of
cfg.protocol_period):

  outbound (engine -> core): the reserved row X is the core's SHADOW in
    tensor state.  After each period the server diffs X's resolved
    heard-bits, decodes the newly heard ring slots through the rumor
    table, and DELIVERs them as the piggyback of the ping that the rotor
    prober (X - s_t) sent X inside the engine.
  inbound (core -> engine): every datagram the core SENDs is decoded
    (core/codec.py); its gossip updates become Phase-D external
    originations (`ring.ExtOriginations`) with the datagram's receiving
    engine node as the hearer.  Pings and ping-reqs are answered at once
    from engine state (alive target: a synthesized ack carrying the
    target's transmissible window selection).
  liveness: no ack for `ack_grace` ping flushes -> crash_step[X] = now,
    and the engine detects the silent core organically.

The reference's deviations D1-D4 hold unchanged (docs/BRIDGE.md): row X
keeps its mechanical engine behaviour; an injected update whose rumor
exists dedups onto its slot, and stale ones are dropped host-side;
replies are synthesized at datagram time; every core -> engine leg (and
each synthesized reply leg) draws Bernoulli(loss) from the seeded host
RNG `np.random.default_rng(seed * 7919 + 17)`, in the reference's order.

On the device: every period is one `ring.step` with the period's
ExtOriginations batch, so a CUDA device launches the hand-written
kernels (in the default wave scope selb and wavemerge once a wave,
coldsel once).  The batch, the rotor offsets and the joined ids go over
in one staged copy (serve/hub.py `stage_period`); the probe offset that
the mirror needs is the host's own (`ring.rotor_offsets`), and the
period counter `t` stays on the host (it equals `state.step`).  After
the step the rumor table (subject, rkey), the tombstones (gone_key) and
the heard words of every joined id (one `index_select` of win rows and
one of cold columns) come back in ONE device-to-host copy.  The state's
int32 carriers are viewed as uint32 on the host, so a DEAD key (bit 31
set) orders above every live one.  `ring.step` updates `cold` in place:
every read of `self.state` from a session thread happens under
`_engine`.
"""
from __future__ import annotations

import socket
import threading
import time

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.core import codec
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs.health import Finding
from swim_tpu_torch.serve.hub import Stager, stage_period
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.types import (MsgKind, Status, key_incarnation,
                                  key_status, opinion_key)
from swim_tpu_torch.utils import threefry

WORD = 32


def _status_of(key: int) -> Status:
    return Status(key_status(key))


def _inc_of(key: int) -> int:
    return key_incarnation(key)


def _pack_key(status: Status, inc: int) -> int:
    # types.opinion_key clamps inc to INC_MAX: a hostile or corrupt wire
    # incarnation >= 2^30 would otherwise shift into the sticky DEAD bit
    return opinion_key(int(status), inc)


def _row_bits(win_x: np.ndarray, cold_x: np.ndarray, t: int,
              g: ring.RingGeometry) -> np.ndarray:
    """bool[R]: a node's heard-bits from its window words and its cold
    column (uint32), after `t` periods (ring.resolved_words for one
    node)."""
    win_ring0 = (t * g.ow - g.ww) % g.rw
    words = cold_x.copy()
    for w in range(g.ww):
        words[(win_ring0 + w) % g.rw] = win_x[w]
    return np.unpackbits(words.astype("<u4").view(np.uint8),
                         bitorder="little").astype(bool)


class _Session:
    """One TCP connection hosting one or more external node ids."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.ids: list[int] = []
        self.clock = 0.0                 # this session's virtual time
        self.outq: list[bp.Frame] = []
        self.live = True
        self.last_step_wall = time.monotonic()
        self.step_pending = False        # STEP read, waiting on _engine


class EngineBridgeServer:
    """Multi-client lockstep server over a ring-engine simulation.

    K external cores (each its own TCP session; a session may HELLO
    several ids, like ExternalNodeHost) co-simulate against one tensor
    cluster.  Time is conservative lockstep across sessions: each STEP
    advances only that session's virtual clock, and an engine period
    runs when EVERY live joined session has reached the period boundary
    (the barrier is the min over session clocks).  A session that
    disconnects leaves the barrier; its rows then miss their
    mirrored-probe acks and are crash-gated after `ack_grace` periods,
    so the remaining cores detect the departure organically.

    Datagrams between two external ids short-circuit over the wire (one
    D4 loss draw, no tensor involvement): the server is the hub, and two
    foreign cores can probe and gossip with each other while both stay
    coupled to the tensor cluster.

    `device=None` is the CUDA card (swim_tpu_torch/device.py), resolved
    once here: the periods run on whichever session thread crosses the
    barrier, and every tensor is made on this device.
    """

    def __init__(self, cfg: SwimConfig, external_id: int | None = None,
                 seed: int = 0, host: str = "127.0.0.1", port: int = 0,
                 ext_capacity: int = 16, ack_grace: int = 3,
                 join_sample: int = 128,
                 external_ids: list[int] | None = None,
                 stall_timeout: float = 60.0, device=None):
        if cfg.ring_probe != "rotor":
            raise ValueError("EngineBridgeServer requires the rotor probe "
                             "(the mirrored-ping seam is rotor-shaped)")
        ring.check_slice(cfg)
        if external_ids is None:
            if external_id is None:
                raise ValueError("pass external_id or external_ids")
            external_ids = [external_id]
        elif external_id is not None:
            raise ValueError("pass external_id OR external_ids, not both")
        self.cfg = cfg
        self.n = cfg.n_nodes
        for x in external_ids:
            if not 0 <= x < self.n:
                raise ValueError("external ids must be N node ids")
        if len(set(external_ids)) != len(external_ids):
            raise ValueError("duplicate external ids")
        self.xs = list(external_ids)
        self.x = self.xs[0]              # the first (or only) external id
        self.ext_capacity = ext_capacity
        self.ack_grace = ack_grace
        self.join_sample = join_sample
        self.stall_timeout = stall_timeout   # wall s without a STEP
        #                                      before a session stops
        #                                      gating the barrier
        self.device = devmod.resolve(device)
        dev = self.device
        self._geom = ring.geometry(cfg)
        self._key = threefry.key(seed)
        self.state = ring.init_state(cfg, dev)
        self.t = 0                       # completed protocol periods
        self._ext_empty = ring.ext_none(ext_capacity, dev)
        # one staged block a period: the ext lanes, the rotor offsets,
        # then the joined ids whose rows the mirror reads
        self._n_offs = 1 + cfg.k_indirect
        self._stage = Stager(4 * ext_capacity + self._n_offs
                             + len(self.xs), dev)
        # host-side fault mirrors (device plan rebuilt on change)
        self._crash = np.full((self.n,), np.iinfo(np.int32).max // 2,
                              np.int32)
        self._join = np.zeros((self.n,), np.int32)
        self._loss = 0.0
        self._plan_const = dict(
            partition_id=torch.zeros((self.n,), dtype=torch.uint8,
                                     device=dev),
            partition_start=torch.full((), 1 << 30, dtype=torch.int32,
                                       device=dev),
            partition_end=torch.full((), 1 << 30, dtype=torch.int32,
                                     device=dev))
        self._plan = None
        self._plan_dirty = True
        self._plan_gen = 0               # bumped on every fault mutation
        # injections queued for the next period boundary
        self._inject: list[tuple[int, int, int, int]] = []  # subj,key,org,hear
        self._rng = np.random.default_rng(seed * 7919 + 17)  # D4 wire loss
        # host mirrors of the rumor table (refreshed after every period;
        # u32 views of the int32 carriers)
        self._subject = np.full((self._geom.rw * WORD,), -1, np.int32)
        self._rkey = np.zeros((self._geom.rw * WORD,), np.uint32)
        self._gone = np.zeros((self.n,), np.uint32)
        self.d2h_copies = 0              # device-to-host copies, all told
        # per-external-id seam state
        self._prev_rows: dict[int, np.ndarray] = {}
        self._last_acks: dict[int, int] = {}
        # ack-opportunity accounting for the liveness gate: a "ping
        # flush" is one outq flush that carried >=1 mirrored ping for
        # the id, the only events the core can possibly ack.  After an
        # id joins, all three dicts are mutated under self._engine
        # (STEP/SEND handlers and _run_period all hold it); the HELLO
        # handler initializes the id's keys under self._lock alone,
        # which is safe only because the id is not yet in _prev_rows
        # (the gate's iteration set) at that point.
        self._ping_pending: dict[int, bool] = {}   # queued, not flushed
        self._ping_flushes: dict[int, int] = {}    # flushes with pings
        self._ack_flush: dict[int, int] = {}       # _ping_flushes @ ack
        self._ext_crashed: dict[int, bool] = {x: False for x in self.xs}
        self.findings: list[Finding] = []   # session_evicted health trail
        self._owner: dict[int, _Session] = {}    # joined id -> session
        self._claimed: set[int] = set()          # ids ever HELLO'd
        self._sessions: list[_Session] = []
        self._lock = threading.Lock()    # guards queues/_inject/_crash
        #                                  (test hooks run off-thread)
        self._engine = threading.Lock()  # serializes period execution
        #                                  and every read of self.state
        self._closing = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(max(len(self.xs), 1))
        self.address = self._sock.getsockname()
        self._thread: threading.Thread | None = None

    @property
    def _x_crashed(self) -> bool:
        return self._ext_crashed[self.x]

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def join(self, timeout: float = 300.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        # unblock handler threads parked in read_frame: close every
        # session socket too (a reader then sees EOF/OSError and exits)
        with self._lock:
            sessions = list(self._sessions)
        for sess in sessions:
            try:
                sess.sock.close()
            except OSError:
                pass

    def _serve(self) -> None:
        """Accept loop: one handler thread per session.  Exits (closing
        the listen socket) once every external id has been claimed and
        all sessions have disconnected, or on close()."""
        self._sock.settimeout(0.25)
        handlers: list[threading.Thread] = []
        try:
            while not self._closing:
                with self._lock:
                    done = (len(self._claimed) == len(self.xs)
                            and not any(s.live for s in self._sessions)
                            and self._claimed)
                if done:
                    return
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                sess = _Session(conn)
                with self._lock:
                    self._sessions.append(sess)
                th = threading.Thread(target=self._serve_session,
                                      args=(sess,), daemon=True)
                th.start()
                handlers.append(th)
        finally:
            for th in handlers:
                th.join(timeout=10)
            try:
                self._sock.close()
            except OSError:
                pass

    def _serve_session(self, sess: _Session) -> None:
        try:
            while True:
                f = bp.read_frame(sess.sock)
                if f is None or f.op == bp.BYE:
                    return
                self._handle(sess, f)
        except (ValueError, OSError):
            return
        finally:
            with self._lock:
                sess.live = False
            sess.sock.close()

    # ------------------------------------------------------------- protocol

    def _session_gates(self, s: _Session, now: float) -> bool:
        """Whether session s gates the barrier: live, joined, and not
        wall-clock-stalled.  Shared by _gating_clocks and _run_period's
        crash-gate, which must agree.  Only STEP frames refresh the wall
        stamp (a wedged client spamming SENDs must still stall out), and
        a session whose STEP is read but queued behind the engine lock
        (step_pending) always gates.  Caller holds self._lock."""
        return bool(s.live and s.ids
                    and (s.step_pending
                         or now - s.last_step_wall <= self.stall_timeout))

    def _gating_clocks(self) -> list[float]:
        """Virtual clocks of the sessions that gate the barrier.  A
        session that keeps its socket open but stops STEPping stops
        gating after `stall_timeout` wall seconds; its rows then miss
        their mirrored-probe acks and die organically.  Caller holds
        self._lock."""
        now = time.monotonic()
        return [s.clock for s in self._sessions
                if self._session_gates(s, now)]

    def _handle(self, sess: _Session, f: bp.Frame) -> None:
        if f.op == bp.HELLO:
            with self._lock:
                ok = f.a in self.xs and f.a not in self._claimed
                if ok:
                    self._claimed.add(f.a)
                    self._owner[f.a] = sess
                    sess.ids.append(f.a)
                    self._last_acks[f.a] = self.t
                    self._ping_pending[f.a] = False
                    self._ping_flushes[f.a] = 0
                    self._ack_flush[f.a] = 0
                    # join pins this session's clock at engine time
                    sess.clock = max(
                        sess.clock, self.t * self.cfg.protocol_period)
            if not ok:
                bp.write_frame(sess.sock,
                               bp.Frame(bp.ERROR, a=bp.ERR_ID_TAKEN))
                return
            with self._engine:
                # serialized against _run_period, which updates the
                # state (cold in place) on another session's thread
                self._prev_rows[f.a] = self._resolved_row(f.a)
            bp.write_frame(sess.sock,
                           bp.Frame(bp.WELCOME, a=f.a, t=sess.clock))
        elif f.op == bp.SEND:
            if f.a in sess.ids:
                with self._engine:
                    # the seam reads self.t, self.state and the table
                    # mirrors, which a period updates non-atomically
                    self._on_datagram(f.a, f.b, f.payload)
        elif f.op == bp.STEP:
            # stamp at STEP READ time, before the engine lock: a session
            # queued behind a slow period (the first one builds the
            # kernels) must not be charged the server's own lock hold
            with self._lock:
                sess.last_step_wall = time.monotonic()
                sess.step_pending = True
            with self._engine:
                with self._lock:
                    sess.clock += f.t
                    sess.step_pending = False
                    sess.last_step_wall = time.monotonic()
                # conservative barrier: run whole periods while EVERY
                # gating session has crossed the next boundary
                while True:
                    boundary = (self.t + 1) * self.cfg.protocol_period
                    with self._lock:
                        gating = self._gating_clocks()
                    if not gating or min(gating) < boundary - 1e-9:
                        break
                    self._run_period()
                with self._lock:
                    flush, sess.outq = sess.outq, []
                    # the ack-grace clock ticks on DELIVERED pings, not
                    # engine time: mirrored pings still queued here
                    # cannot have been acked
                    for x in sess.ids:
                        if self._ping_pending.get(x):
                            self._ping_pending[x] = False
                            self._ping_flushes[x] += 1
            for fr in flush:
                bp.write_frame(sess.sock, fr)
            bp.write_frame(sess.sock, bp.Frame(bp.TIME, t=sess.clock))
        elif f.op == bp.KILL:
            self.kill(f.a)
        elif f.op == bp.SET_LOSS:
            with self._lock:
                self._loss = float(f.t)
                self._plan_dirty = True
                self._plan_gen += 1

    # --------------------------------------------------------- fault wiring

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
        """The FaultPlan on the device (crash_step i32, loss f32,
        partition_id u8, join_step i32), rebuilt from the host mirrors
        when a kill or SET_LOSS changed them: the crash and join rows go
        over in one copy.  Generation-checked, so a mutation landing
        during the build keeps its dirty mark."""
        with self._lock:
            rebuild = self._plan_dirty or self._plan is None
            gen = self._plan_gen
            if rebuild:
                rows = np.stack([self._crash, self._join])
                loss = self._loss
        if rebuild:
            block = torch.from_numpy(rows)
            if self.device.type == "cuda":
                block = block.pin_memory().to(self.device, non_blocking=True)
            self._plan = FaultPlan(
                crash_step=block[0], join_step=block[1],
                loss=torch.full((), loss, dtype=torch.float32,
                                device=self.device),
                **self._plan_const)
            with self._lock:
                if self._plan_gen == gen:
                    self._plan_dirty = False
        return self._plan

    # -------------------------------------------------------- inbound seam

    def _queue_injections(self, hearer: int,
                          gossip: tuple[codec.WireUpdate, ...]) -> None:
        for u in gossip:
            if not 0 <= u.member < self.n:
                continue
            key = _pack_key(u.status, u.incarnation)
            if key <= self._best_key(u.member):
                continue                 # stale vs table/tombstone (D2)
            org = u.origin if 0 <= u.origin < self.n else hearer
            with self._lock:
                self._inject.append((u.member, key, org, hearer))

    def _credit_ack(self, x: int) -> None:
        """Liveness credit for external id x (caller holds _engine)."""
        self._last_acks[x] = self.t
        self._ack_flush[x] = self._ping_flushes.get(x, 0)

    def _lost(self) -> bool:
        """Bernoulli loss draw for one bridge datagram leg (D4)."""
        return self._loss > 0.0 and self._rng.random() < self._loss

    def _on_datagram(self, src: int, dst: int, payload: bytes) -> None:
        """One datagram from external node `src` (session-verified by
        the caller).  A dst owned by another LIVE session short-circuits
        over the wire after one D4 loss draw; everything else is the
        engine seam."""
        with self._lock:
            owner = self._owner.get(dst)
            owner_live = owner is not None and owner.live
        if owner_live and dst != src:
            if self._lost():
                return
            # the mirrored rotor prober of an external id can itself be
            # another external id; the probed core's ACK then rides this
            # hub path and earns the same liveness credit (header-only
            # peek: no full gossip parse per datagram)
            try:
                if codec.peek_kind(payload) == MsgKind.ACK:
                    self._credit_ack(src)
            except codec.DecodeError:
                pass
            with self._lock:
                owner.outq.append(bp.Frame(bp.DELIVER, a=src, b=dst,
                                           payload=payload))
            return
        try:
            msg = codec.decode(payload)
        except codec.DecodeError:
            return
        if not self._alive(dst) or self._lost():
            return     # datagram to a dead node, or lost on the wire:
            #            nothing is heard and nothing replies (D4)
        self._queue_injections(dst, msg.gossip)
        if msg.kind == MsgKind.ACK:
            self._credit_ack(src)
        elif msg.kind == MsgKind.PING:
            if self._lost():             # ack leg draws its own loss
                return
            ack = codec.Message(kind=MsgKind.ACK, sender=dst,
                                probe_seq=msg.probe_seq,
                                on_behalf=msg.on_behalf,
                                gossip=self._transmissible(dst))
            self._deliver(src, dst, ack)
        elif msg.kind == MsgKind.PING_REQ:
            tgt = msg.target
            # proxy round-trip: two more legs (proxy->tgt, tgt->proxy)
            # plus the relay ack leg, each drawing loss
            if (self._alive(tgt) and not self._lost()
                    and not self._lost() and not self._lost()):
                ack = codec.Message(kind=MsgKind.ACK, sender=dst,
                                    probe_seq=msg.probe_seq,
                                    on_behalf=tgt,
                                    gossip=self._transmissible(tgt))
                self._deliver(src, dst, ack)
        elif msg.kind == MsgKind.JOIN:
            if self._lost():             # reply leg draws loss too (D4)
                return
            self._deliver(src, dst, codec.Message(
                kind=MsgKind.JOIN_REPLY, sender=dst,
                gossip=self._join_snapshot(exclude=src)))

    def _deliver(self, x: int, sender: int, msg: codec.Message) -> None:
        """Queue a DELIVER to external id x's owning session."""
        with self._lock:
            owner = self._owner.get(x)
            if owner is None or not owner.live:
                return
            owner.outq.append(bp.Frame(bp.DELIVER, a=sender, b=x,
                                       payload=codec.encode(msg)))

    # -------------------------------------------------------- outbound seam

    def _run_period(self) -> None:
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._period_body()
        else:
            self._period_body()

    def _period_body(self) -> None:
        # liveness gate: a silent core is a crashed member (per id).
        # For a gating session the grace clock ticks on ACK
        # OPPORTUNITIES (outq flushes that carried mirrored pings), not
        # on engine time: a multi-period catch-up burst by a lagging
        # session is ONE opportunity.  A session that stopped gating
        # never flushes again, so for it the clock falls back to engine
        # periods since its last ack.
        now = time.monotonic()
        for x in list(self._prev_rows):
            if self._ext_crashed[x]:
                continue
            with self._lock:
                owner = self._owner.get(x)
                gating = (owner is not None
                          and self._session_gates(owner, now))
            if gating:
                lag = (self._ping_flushes.get(x, 0)
                       - self._ack_flush.get(x, 0))
            else:
                lag = self.t - self._last_acks[x]
            if lag > self.ack_grace:
                self.kill(x)
                self._ext_crashed[x] = True
                cause = "ack-grace" if gating else "stall/disconnect"
                self.findings.append(Finding(
                    rule="session_evicted", severity="warn",
                    period=self.t, value=float(lag),
                    threshold=float(self.ack_grace),
                    message=f"external id {x} evicted ({cause}): "
                            f"{lag} periods without an ack; row "
                            "crash-gated"))
        with self._lock:
            batch, self._inject = (self._inject[:self.ext_capacity],
                                   self._inject[self.ext_capacity:])
        offs = ring.rotor_offsets(self.cfg, self.t)
        xs = list(self._prev_rows)
        ext, tail = stage_period(self._stage, batch, self.ext_capacity,
                                 offs + xs)
        rnd = ring.draw_period_ring(self._key, self.t, self.cfg,
                                    self.device,
                                    offsets=tail[:self._n_offs])
        self.state = ring.step(self.cfg, self.state, self._device_plan(),
                               rnd, ext=self._ext_empty if ext is None
                               else ext)
        s_off = offs[0]
        self.t += 1
        # refresh the table mirrors, then mirror the rotor probe of
        # every joined external id
        win_xs, cold_xs = self._refresh_mirrors(tail[self._n_offs:])
        for i, x in enumerate(xs):
            row = _row_bits(win_xs[i], cold_xs[i], self.t, self._geom)
            fresh = row & ~self._prev_rows[x]
            self._prev_rows[x] = row
            prober = (x - s_off) % self.n
            if not self._alive(prober):
                continue                 # no probe of x this period
            updates = self._slots_to_updates(np.nonzero(fresh)[0], prober)
            self._ping_pending[x] = True     # ack opportunity at next flush
            for chunk in range(0, max(len(updates), 1), 255):
                ping = codec.Message(
                    kind=MsgKind.PING, sender=prober, probe_seq=self.t,
                    gossip=tuple(updates[chunk:chunk + 255]))
                self._deliver(x, prober, ping)

    # ------------------------------------------------------- state decoding

    def _refresh_mirrors(self, idx: torch.Tensor
                         ) -> tuple[np.ndarray, np.ndarray]:
        """subject, rkey and gone_key into the host mirrors, and the
        window words [K, WW] and cold columns [K, RW] of the K ids in
        `idx` (int32, on the device), all by one device-to-host copy."""
        st, g = self.state, self._geom
        block = torch.cat([
            st.subject, st.rkey, st.gone_key,
            st.win.index_select(0, idx).reshape(-1),
            st.cold.index_select(1, idx).t().reshape(-1)]).cpu().numpy()
        self.d2h_copies += 1
        r, k = g.rw * WORD, idx.shape[0]
        self._subject = block[:r]
        self._rkey = block[r:2 * r].view(np.uint32)
        self._gone = block[2 * r:2 * r + self.n].view(np.uint32)
        rest = block[2 * r + self.n:].view(np.uint32)
        return (rest[:k * g.ww].reshape(k, g.ww),
                rest[k * g.ww:].reshape(k, g.rw))

    def _resolved_row(self, x: int) -> np.ndarray:
        """bool[R]: node x's current heard-bits, read from the device
        (caller holds _engine)."""
        st = self.state
        win_x = st.win[x].cpu().numpy().view(np.uint32)
        cold_x = st.cold[:, x].cpu().numpy().view(np.uint32)
        self.d2h_copies += 2
        return _row_bits(win_x, cold_x, self.t, self._geom)

    def _best_key(self, member: int) -> int:
        """The strongest table/tombstone key held for member, unsigned
        (host mirrors only: this runs per gossip update)."""
        mask = self._subject == member
        best = int(self._rkey[mask].max()) if mask.any() else 0
        return max(best, int(self._gone[member]))

    def _slots_to_updates(self, slots: np.ndarray,
                          origin: int) -> list[codec.WireUpdate]:
        out = []
        for sl in slots.tolist():
            subj = int(self._subject[sl])
            if subj < 0:
                continue
            key = int(self._rkey[sl])
            out.append(codec.WireUpdate(
                member=subj, status=_status_of(key), incarnation=_inc_of(key),
                addr=("sim", subj), origin=origin))
        return out

    def _transmissible(self, j: int) -> tuple[codec.WireUpdate, ...]:
        """Node j's current piggyback: up to B used slots of its window
        (host mirror of the engine's first-B window selection); one
        small device read (caller holds _engine)."""
        g = self._geom
        win_j = self.state.win[j].cpu().numpy().view(np.uint32)
        self.d2h_copies += 1
        first_gw = self.t * g.ow - g.ww
        r_tot = g.rw * WORD
        out = []
        b = min(self.cfg.max_piggyback, g.ww * WORD)
        for w in range(g.ww - 1, -1, -1):              # newest word first
            word = int(win_j[w])
            while word and len(out) < b:
                bit = (word & -word).bit_length() - 1
                word &= word - 1
                sl = (((first_gw + w) % g.rw) * WORD + bit) % r_tot
                subj = int(self._subject[sl])
                if subj < 0:
                    continue
                key = int(self._rkey[sl])
                out.append(codec.WireUpdate(
                    member=subj, status=_status_of(key),
                    incarnation=_inc_of(key), addr=("sim", subj), origin=j))
            if len(out) >= b:
                break
        return tuple(out)

    def _join_snapshot(self, exclude: int) -> tuple[codec.WireUpdate, ...]:
        """Up to `join_sample` alive members, spread across the id space
        (the wire gossip count is u8, and SWIM only needs a partial view
        to bootstrap probing).  `exclude` is the requesting joiner."""
        stride = max(1, self.n // self.join_sample)
        out = []
        for m in range(0, self.n, stride):
            if m != exclude and self._alive(m):
                out.append(codec.WireUpdate(
                    member=m, status=Status.ALIVE, incarnation=0,
                    addr=("sim", m), origin=m))
            if len(out) >= min(self.join_sample, 255):
                break
        return tuple(out)

    # ------------------------------------------------------------ test hooks

    def inject_update(self, subject: int, status: Status, inc: int,
                      origin: int, hearer: int) -> None:
        """Queue a rumor injection directly (bypasses the wire)."""
        with self._lock:
            self._inject.append(
                (subject, _pack_key(status, inc), origin, hearer))

    def deliver_forged(self, sender: int,
                       updates: list[codec.WireUpdate],
                       to: int | None = None) -> None:
        """DELIVER a forged gossip-bearing ping to a core WITHOUT
        touching tensor state (default target: the first external id).
        Forging suspect(X) on the wire only means that any alive(X,
        inc >= 1) that later appears in tensor state can ONLY be the
        core's refutation arriving through the injection seam (the
        engine's own proof is inc_self[X] staying 0)."""
        self._deliver(self.x if to is None else to, sender, codec.Message(
            kind=MsgKind.PING, sender=sender, probe_seq=0,
            gossip=tuple(updates)))

    def table_keys(self, subject: int) -> list[int]:
        """All live table keys about `subject` (host mirror, u32)."""
        return [int(k) for k in self._rkey[self._subject == subject]]

"""The port's serving hub (swim_tpu_torch/serve) on the CPU, and against
the JAX package's hub.

The 13 cases of tests/test_serve.py on `device="cpu"`: the wire format
and the eviction rule, admission over real datagrams (HELLO -> WELCOME,
BYE recycles the row, pool exhaustion answers REJECT(full), a full work
queue REJECT(queue), ECHO answered from the drain) on both frontends
(the Python socket and the udppump datapath), eviction of a silent
session with its finding, churn neutrality (quiet, fixed-session and
join/leave-storm hubs leave every state field bitwise equal), the
batched mirror, the gauge surface (the port's `gauge_values` equal to
the reference's, and the reference's exposition renderer reading the
port's report), and a small `run_load`.  Two cross-package cases: a
scripted in-process sequence (attach, gossip with a spill, ACKs, an
eviction, a kill) through the JAX hub and the port's hub gives equal
state digests after every period and equal reports and findings; and
`run_load` at 4,096 nodes gives the JAX package's clean-arm digest.
Tolerance: exact (sha256 digests).  Every socket wait has a deadline
and every hub is closed in `finally`.
"""
from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.obs import expo as jexpo
from swim_tpu.serve import hub as jhub
from swim_tpu.serve import load as jload
from swim_tpu_torch import SwimConfig, golden
from swim_tpu_torch.core import codec
from swim_tpu_torch.obs.health import HEALTH_RULES
from swim_tpu_torch.serve import hub as hub_mod
from swim_tpu_torch.serve import load as serve_load
from swim_tpu_torch.serve.hub import (OP_BYE, OP_ECHO, OP_ECHO_REPLY,
                                      OP_HELLO, OP_REJECT, OP_WELCOME,
                                      REJ_FULL, REJ_QUEUE, SESSION_GAUGES,
                                      ServeHub, gauge_values, pack, unpack)
from swim_tpu_torch.types import MsgKind, Status

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# small knobs; the hub semantics are size-independent
GEOM = dict(k_indirect=1, ring_window_periods=3, suspicion_mult=2.0,
            ring_view_c=2, ring_sel_scope="period")
N = 256
FRONTENDS = ["socket", "udppump"]


def make_hub(reserved_rows, **kw):
    kw.setdefault("frontend", "socket")
    return ServeHub(SwimConfig(n_nodes=N, **GEOM),
                    reserved_rows=reserved_rows, device="cpu", **kw)


def wait_until(pred, timeout: float = 5.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def client_sock() -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.settimeout(2.0)
    return s


def recv_op(sock: socket.socket, op: int, timeout: float = 5.0):
    """Drain until a frame with opcode `op` arrives; returns (a, b)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            data, _ = sock.recvfrom(65535)
        except socket.timeout:
            continue
        got, a, b, _ = unpack(data)
        if got == op:
            return a, b
    raise AssertionError(f"no op={op} frame within {timeout}s")


class TestWireFormat:
    def test_pack_unpack_roundtrip(self):
        data = pack(hub_mod.OP_DGRAM, 7, 123456789, b"payload")
        assert unpack(data) == (hub_mod.OP_DGRAM, 7, 123456789, b"payload")
        assert data == jhub.pack(jhub.OP_DGRAM, 7, 123456789, b"payload")

    def test_rule_registered(self):
        assert HEALTH_RULES["session_evicted"][0] == "warn"


@pytest.mark.parametrize("frontend", FRONTENDS)
class TestAdmission:
    def test_hello_welcome_bye_recycles_row(self, frontend):
        hub = make_hub([5, 6], frontend=frontend)
        c = client_sock()
        try:
            assert hub.report()["frontend"] == frontend
            c.sendto(pack(OP_HELLO, 42, 0), hub.address)
            row, nonce = recv_op(c, OP_WELCOME)
            assert nonce == 42 and row in (5, 6)
            assert hub.report()["active"] == 1
            c.sendto(pack(OP_BYE, row, 0), hub.address)
            wait_until(lambda: hub.report()["active"] == 0,
                       what="BYE to release the row")
            c.sendto(pack(OP_HELLO, 43, 0), hub.address)
            _, nonce2 = recv_op(c, OP_WELCOME)
            assert nonce2 == 43
            assert hub.report()["left"] == 1
        finally:
            c.close()
            hub.close()

    def test_pool_exhaustion_rejects_full(self, frontend):
        hub = make_hub([9], frontend=frontend)
        c = client_sock()
        try:
            c.sendto(pack(OP_HELLO, 1, 0), hub.address)
            recv_op(c, OP_WELCOME)
            c.sendto(pack(OP_HELLO, 2, 0), hub.address)
            assert recv_op(c, OP_REJECT) == (REJ_FULL, 2)
            assert hub.report()["rejected_full"] == 1
        finally:
            c.close()
            hub.close()

    def test_full_work_queue_rejects_with_backpressure(self, frontend):
        """With the admission worker wedged and the queue full, a HELLO
        is answered REJECT(queue) straight from the drain; the queued
        items are admitted once the worker unwedges."""
        hub = make_hub([1, 2, 3], queue_capacity=1, frontend=frontend)
        c = client_sock()
        addr = c.getsockname()
        gate = threading.Event()
        orig_admit = hub._do_admit
        hub._do_admit = lambda a, n: (gate.wait(10), orig_admit(a, n))
        try:
            hub._on_datagram(addr, pack(OP_HELLO, 0, 0))
            time.sleep(0.2)       # worker picks item 0 up and parks
            hub._on_datagram(addr, pack(OP_HELLO, 1, 0))
            hub._on_datagram(addr, pack(OP_HELLO, 2, 0))
            reason, _ = recv_op(c, OP_REJECT)
            assert reason == REJ_QUEUE
            wait_until(lambda: hub.report()["queue_drops"] >= 1,
                       what="queue_drops stat")
            gate.set()
            wait_until(lambda: hub.report()["admitted"] >= 1,
                       what="post-storm admission")
        finally:
            gate.set()
            c.close()
            hub.close()

    def test_echo_answered_from_the_drain(self, frontend):
        hub = make_hub([1], frontend=frontend)
        c = client_sock()
        try:
            c.sendto(pack(OP_ECHO, 11, 22), hub.address)
            assert recv_op(c, OP_ECHO_REPLY) == (11, 22)
            assert hub.report()["echoes"] == 1
        finally:
            c.close()
            hub.close()


class TestEviction:
    def test_silent_session_is_evicted_with_finding(self):
        hub = make_hub([17], ack_grace=1)
        try:
            row = hub.attach()
            assert row == 17
            hub.step_periods(5)      # pings pile up unacked
            wait_until(lambda: hub.report()["evicted"] == 1,
                       what="stalled session eviction")
            f = hub.findings()[0]
            assert f.rule == "session_evicted" and f.severity == "warn"
            assert f.value > f.threshold == float(hub.ack_grace)
            assert "evicted" in f.message
            assert int(hub._crash[row]) <= hub.t
            assert hub.attach() is None
            assert hub.report()["active"] == 0
        finally:
            hub.close()

    def test_acking_session_survives(self):
        hub = make_hub([17], ack_grace=1)
        try:
            row = hub.attach()
            ack = codec.encode(codec.Message(kind=MsgKind.ACK, sender=row))
            for _ in range(5):
                hub.step_periods(1)
                hub._on_session_datagram(None, row, 0, ack)
            assert hub.report()["evicted"] == 0
            assert hub.report()["active"] == 1
        finally:
            hub.close()


class TestChurnNeutrality:
    def test_join_leave_storm_is_bitwise_neutral(self):
        """Quiet hub vs fixed-session hub vs join/leave-storm hub: every
        state field bitwise equal."""
        periods = 4
        rows = list(range(8))

        def make():
            return make_hub(rows, seed=3, ack_grace=periods + 2)

        quiet, fixed, storm = make(), make(), make()
        try:
            for _ in rows:
                fixed.attach()
            held: list[int] = []
            for t in range(periods):
                quiet.step_periods(1)
                fixed.step_periods(1)
                for _ in range(3):
                    r = storm.attach()
                    if r is not None:
                        held.append(r)
                storm.step_periods(1)
                for r in held[: 2 + t % 2]:
                    storm.detach(r)
                del held[: 2 + t % 2]
            for r in held:
                storm.detach(r)
            assert storm.report()["admitted"] > storm.report()["active"]
            for name in quiet.state._fields:
                q = getattr(quiet.state, name)
                assert torch.equal(q, getattr(fixed.state, name)), name
                assert torch.equal(q, getattr(storm.state, name)), name
        finally:
            quiet.close()
            fixed.close()
            storm.close()


class TestBatchedMirror:
    def test_gossip_coalesces_into_one_placed_batch(self):
        hub = make_hub([3], ack_grace=99)
        try:
            row = hub.attach()
            subject = 77
            msg = codec.Message(
                kind=MsgKind.PING, sender=row, probe_seq=1,
                gossip=(codec.WireUpdate(
                    member=subject, status=Status.SUSPECT, incarnation=0,
                    addr=("sim", subject), origin=row),))
            hub._on_session_datagram(None, row, (row + 1) % N,
                                     codec.encode(msg))
            assert hub.report()["datagrams"] == 1
            hub.step_periods(1)
            rep = hub.report()
            assert rep["mirror_updates"] == 1
            assert rep["mirror_bytes"] == 16 * hub.ext_capacity
            assert rep["mirror_bytes_per_period"] == 16 * hub.ext_capacity
            subj = hub.state.subject.numpy()
            keys = hub.state.rkey.numpy().view(np.uint32)
            assert (keys[subj == subject] > 0).any()
        finally:
            hub.close()


class TestGaugeSurface:
    REPORT = {"nodes": 8, "admitted": 2, "evicted": 1, "active": 1,
              "mirror_bytes_per_period": 1024,
              "sessions": [{"row": 3, "clock_lag_periods": 0},
                           {"row": 5, "clock_lag_periods": 4}]}

    def test_gauge_values_cover_the_registry(self):
        vals = gauge_values(self.REPORT)
        assert set(vals) == set(SESSION_GAUGES)
        assert vals["swim_session_admitted"] == 2.0
        assert vals["swim_session_clock_lag_periods"] == 4.0  # worst row
        assert vals == jhub.gauge_values(self.REPORT)
        assert SESSION_GAUGES == jhub.SESSION_GAUGES

    def test_render_sessions_exposition(self):
        """The port has no exposition renderer yet: the reference's
        renders a live port hub's report with every gauge."""
        hub = make_hub([3, 5])
        try:
            hub.attach()
            hub.attach()
            hub.step_periods(1)
            text = jexpo.render_sessions(hub.report())
        finally:
            hub.close()
        assert "swim_session_active" in text
        assert 'session="5"' in text
        for name in SESSION_GAUGES:
            assert name in text


class _SlowSocket:
    """A socket whose receives return 30 ms late."""

    def __init__(self, sock):
        self._sock = sock

    def recvfrom(self, size):
        data = self._sock.recvfrom(size)
        time.sleep(0.03)
        return data

    def __getattr__(self, name):
        return getattr(self._sock, name)


class _SendLog(dict):
    """The sampler's seq -> send-time table, keeping every send time it
    is given in `sent`, in send order."""

    def __init__(self):
        super().__init__()
        self.sent: list[float] = []

    def __setitem__(self, seq, t):
        self.sent.append(t)
        super().__setitem__(seq, t)


class _SlowFirstSocketArm(serve_load._ClientArm):
    """A client arm whose first socket's receive thread runs slow, with
    the send time of every echo logged as the sampler records it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._echo_sent = _SendLog()
        self.send_times = self._echo_sent.sent

    def _recv_loop(self, sock):
        if sock is self._socks[0]:
            sock = _SlowSocket(sock)
        super()._recv_loop(sock)


class TestLoadHarnessSmoke:
    @pytest.mark.parametrize("frontend", FRONTENDS)
    def test_run_load_small(self, frontend):
        res = serve_load.run_load(n_nodes=512, sessions=8, periods=2,
                                  n_sockets=4, echo_samples=50,
                                  frontend=frontend, device="cpu")
        assert res["ok_parity"], res
        assert res["frontend"] == frontend
        assert res["clean"]["admission"]["sessions"] == 8
        assert res["storm"]["admission"]["sessions"] == 8
        assert res["clean"]["rtt_ms"]["samples"] > 0
        assert res["p99_rtt_ms"] >= res["p50_rtt_ms"] >= 0.0
        assert res["clean"]["digest"] == res["storm"]["digest"]

    def test_echoes_are_sampled_while_the_engine_steps(self):
        # the port's sampler sends no echo once the engine has stopped
        # stepping (the first always goes); unset, it sends them all.
        # Each socket has its own receive thread, which appends a window
        # when its reply arrives: the windows come in arrival order, not
        # send order.  Here the first socket's thread is slowed, as the
        # whole suite's load once did, so its replies land late; what
        # the sampler guarantees is checked instead: every echo sent
        # got one window, the windows ordered by their begin are the
        # sends ordered by send time, each ends at or after its begin,
        # and the RTT recorded beside it is that window's
        hub = make_hub(list(range(4)))
        arm = _SlowFirstSocketArm(hub.address, 4, n_sockets=2)
        try:
            stepped = threading.Event()
            stepped.set()
            arm.sample_echoes(40, settle_s=5.0, stop=stepped)
            assert len(arm.rtts_ms) == 1
            arm.sample_echoes(6, settle_s=5.0, stop=threading.Event())
            assert len(arm.rtts_ms) == 7
            assert not arm._echo_sent          # every echo answered
            windows = arm.echo_windows
            assert len(windows) == len(arm.rtts_ms) == 7
            for (begin, end), rtt in zip(windows, arm.rtts_ms):
                assert end >= begin
                assert rtt == (end - begin) * 1e3
            starts = sorted(b for b, _ in windows)
            assert len(set(starts)) == 7       # one window per send
            assert starts == sorted(arm.send_times)
        finally:
            arm.close()
            hub.close()


# ------------------------------------------------------- cross-package

SCRIPT_N = 512
SCRIPT_PERIODS = 10


def scripted(hub, digest) -> list[str]:
    """attach 8 rows; each period every live row's gossip PING (period
    SERVE_SPILL_PERIOD spills past the batch) and ACK; the last row
    evicted before period 5, node 300 killed before period 7."""
    rows = [hub.attach() for _ in range(8)]
    out = []
    for t in range(SCRIPT_PERIODS):
        for src, dst, payload in golden.serve_datagrams(hub.n, t, rows):
            hub._on_session_datagram(None, src, dst, payload)
        if t == 5:
            hub.evict(rows.pop())
        if t == 7:
            hub.kill(300)
        hub.step_periods(1)
        out.append(digest(hub.state))
    return out


def test_scripted_sequence_equals_the_jax_hub():
    kw = dict(reserved_rows=list(range(8)), seed=5, ack_grace=99,
              frontend="socket")
    anchor = serve_load.SERVE_ANCHOR
    ref = jhub.ServeHub(JaxSwimConfig(n_nodes=SCRIPT_N, **anchor), **kw)
    hub = ServeHub(SwimConfig(n_nodes=SCRIPT_N, **anchor), device="cpu",
                   **kw)
    try:
        want = scripted(ref, jload.state_digest)
        got = scripted(hub, serve_load.state_digest)
        assert got == want
        assert len(set(got)) == SCRIPT_PERIODS
        rep = hub.report()
        assert rep == ref.report()
        assert rep["mirror_spill_slots"] > 0 and rep["evicted"] == 1
        assert [f.to_dict() for f in hub.findings()] == \
            [f.__dict__ for f in ref.findings()]
    finally:
        ref.close()
        hub.close()


def test_run_load_gives_the_jax_clean_digest():
    args = dict(n_nodes=4096, sessions=16, periods=3, frontend="socket")
    got = serve_load.run_load(device="cpu", **args)
    want = jload.run_load(**args)
    assert got["ok_parity"] and want["ok_parity"]
    assert got["clean"]["digest"] == want["clean"]["digest"]
    assert got["storm"]["digest"] == want["storm"]["digest"]

"""The port's EngineBridgeServer (foreign cores over the ring engine)
against the JAX package's.

  * golden.drive_bridge (one raw-socket session: HELLO, STEPs acking the
    mirrored pings, a ping carrying a suspicion claim, a KILL, SET_LOSS,
    a forged suspect(X) the session refutes) against the reference's
    server (JAX on the CPU) and the port's (`device="cpu"`): the chained
    digest of the frames received and the state after EVERY period are
    equal, so are the findings, and the port's last digest is
    golden.GOLDEN_DIGEST_BRIDGE; `t` kept on the host equals
    `state.step`;
  * a silent core (ack_grace=2, the reference's TestSilentCore at 1,024
    nodes): the same states after every period, the core crash-gated
    and confirmed DEAD in tensor state, the same findings;
  * two sessions behind the conservative barrier (the reference's
    TestCatchUpBurst at 512 nodes): engine time held, a catch-up burst,
    nobody crash-gated, the same final state and period count;
  * the port's compiled bridge_client against the port's engine server
    at 2,048 nodes (skips without g++), and a Python core through
    `ExternalNodeHost`: join, detect a killed tensor peer, refute a
    forged suspicion into tensor state;
  * the host mirrors: `_resolved_row` equals `ring.resolved_words`; u32
    keys order a DEAD key (bit 31 set) above every live one.
Each reference server compiles its own step: three are built here.
Tolerance: exact.
"""
from __future__ import annotations

import socket

import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JSwimConfig
from swim_tpu.bridge import EngineBridgeServer as JEngineBridgeServer
from swim_tpu_torch import SwimConfig, golden, native
from swim_tpu_torch.bridge import EngineBridgeServer, ExternalNodeHost
from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.core import codec
from swim_tpu_torch.models import ring
from swim_tpu_torch.sim import faults
from swim_tpu_torch.types import MsgKind, Status
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEOM = golden.BRIDGE_GEOM


def jax_digest(state) -> str:
    return golden.digest({f: np.asarray(getattr(state, f))
                          for f in state._fields})


def servers(n: int, **kw):
    """(reference server, port server) on the same config, started."""
    ref = JEngineBridgeServer(JSwimConfig(n_nodes=n, **GEOM), **kw)
    port = EngineBridgeServer(SwimConfig(n_nodes=n, **GEOM), device="cpu",
                              **kw)
    ref.start()
    port.start()
    return ref, port


def stop(*srvs) -> None:
    for s in srvs:
        s.close()
        s.join(timeout=30)


def u32_keys(server, member: int) -> list[int]:
    gone = server.state.gone_key[member]
    gone = int(gone) if isinstance(gone, torch.Tensor) else \
        int(np.asarray(gone))
    return server.table_keys(member) + [gone & 0xFFFFFFFF]


def alive_keys(server, member: int) -> list[int]:
    """ALIVE keys with a bumped incarnation: refutations."""
    return [k for k in u32_keys(server, member)
            if k >= 2 and not k >> 31 and not k & 1]


def dead_view_of(server, member: int) -> bool:
    return any(k >> 31 for k in u32_keys(server, member))


def findings(server) -> list[dict]:
    return [f.to_dict() for f in server.findings]


def test_golden_script_matches_the_reference():
    kw = dict(external_id=golden.BRIDGE_N - 1, seed=golden.BRIDGE_SEED)
    ref, port = servers(golden.BRIDGE_N, **kw)
    try:
        want = golden.drive_bridge(ref, digest=jax_digest)
        got = golden.drive_bridge(port)
    finally:
        stop(ref, port)
    for t, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"frames or state differ after period {t}"
    assert len(got) == len(want) == golden.BRIDGE_PERIODS
    assert got[-1] == golden.GOLDEN_DIGEST_BRIDGE
    assert findings(port) == findings(ref)
    assert port.t == int(port.state.step) == ref.t
    # the script's protocol outcome: the killed peer is DEAD in tensor
    # state, the forged suspicion was refuted by the session alone
    x = port.x
    assert dead_view_of(port, golden.BRIDGE_N // 16)
    assert alive_keys(port, x) and int(port.state.inc_self[x]) == 0
    assert not port._x_crashed and not dead_view_of(port, x)
    assert port.table_keys(x) == ref.table_keys(x)


def silent_session(server, x: int, periods: int, digest) -> list[str]:
    """HELLO, then `periods` STEPs acking nothing."""
    sock = socket.create_connection(server.address)
    out = []
    try:
        bp.write_frame(sock, bp.Frame(bp.HELLO, a=x))
        assert bp.read_frame(sock).op == bp.WELCOME
        for _ in range(periods):
            bp.write_frame(sock, bp.Frame(bp.STEP, t=1.0))
            while bp.read_frame(sock).op != bp.TIME:
                pass
            out.append(digest(server.state))
        bp.write_frame(sock, bp.Frame(bp.BYE))
    finally:
        sock.close()
    return out


def test_silent_core_is_detected_like_the_reference():
    n, x = 1024, 1000
    ref, port = servers(n, external_id=x, seed=4, ack_grace=2)
    try:
        want = silent_session(ref, x, 30, jax_digest)
        got = silent_session(port, x, 30, golden.digest)
    finally:
        stop(ref, port)
    for t, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"state differs after period {t}"
    assert port._x_crashed and ref._x_crashed
    assert dead_view_of(port, x), [hex(k) for k in u32_keys(port, x)]
    evs = findings(port)
    assert evs == findings(ref)
    assert [f["rule"] for f in evs] == ["session_evicted"]
    assert f"external id {x}" in evs[0]["message"]


def step_session(sock, dt: float, me: int) -> float:
    """Raw-socket STEP: drain the flush, ack mirrored pings."""
    bp.write_frame(sock, bp.Frame(bp.STEP, t=dt))
    while (f := bp.read_frame(sock)).op != bp.TIME:
        msg = codec.decode(f.payload)
        if msg.kind == MsgKind.PING:
            bp.write_frame(sock, bp.Frame(
                bp.SEND, a=me, b=f.a, payload=codec.encode(codec.Message(
                    kind=MsgKind.ACK, sender=me, probe_seq=msg.probe_seq,
                    on_behalf=msg.on_behalf))))
    return f.t


def catch_up_burst(server) -> list[int]:
    """B races 6 periods ahead of A (time held), A catches up in one
    STEP (a burst), then both step 3 more; returns server.t after each
    stage."""
    xa, xb = 100, 200
    sa = socket.create_connection(server.address)
    sb = socket.create_connection(server.address)
    ts = []
    try:
        for s, x in ((sa, xa), (sb, xb)):
            bp.write_frame(s, bp.Frame(bp.HELLO, a=x))
            assert bp.read_frame(s).op == bp.WELCOME
        for _ in range(6):
            step_session(sb, 1.0, xb)
        ts.append(server.t)
        step_session(sa, 6.0, xa)
        ts.append(server.t)
        for _ in range(3):
            step_session(sb, 1.0, xb)
            step_session(sa, 1.0, xa)
        ts.append(server.t)
        for s in (sa, sb):
            bp.write_frame(s, bp.Frame(bp.BYE))
    finally:
        sa.close()
        sb.close()
    return ts


def test_two_session_barrier_matches_the_reference():
    kw = dict(external_ids=[100, 200], seed=11, ack_grace=2,
              stall_timeout=120.0)
    ref, port = servers(512, **kw)
    try:
        want = catch_up_burst(ref)
        got = catch_up_burst(port)
    finally:
        stop(ref, port)
    assert got == want
    assert got[0] == 0, "the barrier did not hold behind A"
    assert got[1] >= 5, "the catch-up burst did not run"
    assert golden.digest(port.state) == jax_digest(ref.state)
    assert port._ext_crashed == ref._ext_crashed == {100: False,
                                                     200: False}
    assert findings(port) == findings(ref) == []


def test_python_core_joins_detects_and_refutes():
    n = 2048
    x, victim = n - 1, 128               # victim is in the join sample
    cfg = SwimConfig(n_nodes=n, **GEOM)
    server = EngineBridgeServer(cfg, external_id=x, seed=2, device="cpu")
    server.start()
    host = ExternalNodeHost(server.address, quantum=0.5)
    try:
        node = host.add_node(cfg, x, seeds=[7], seed=5)
        host.run(6.0)
        assert len(node.members.ids()) >= 16
        host.kill(victim)
        host.run(24.0)
        op = node.members.opinion(victim)
        assert op is not None and op.status == Status.DEAD, op
        assert int(server.state.inc_self[x]) == 0
        server.deliver_forged(3, [codec.WireUpdate(
            x, Status.SUSPECT, 0, ("sim", x), 3)])
        host.run(10.0)
        assert alive_keys(server, x), [hex(k) for k in u32_keys(server, x)]
        assert int(server.state.inc_self[x]) == 0
        assert not server._x_crashed and not dead_view_of(server, x)
        false_dead = [m for m in node.members.ids() if m != victim
                      and node.members.opinion(m).status == Status.DEAD]
        assert not false_dead, false_dead
    finally:
        host.close()
        stop(server)


@pytest.fixture(scope="module")
def client_bin():
    path = native.bridge_client_bin()
    if path is None:
        pytest.skip("no native toolchain (g++)")
    return path


def test_cpp_core_against_the_port_engine(client_bin):
    """The compiled C++ core joins 2,048 engine nodes, kills victim 128
    at 8 s, and refutes a suspicion forged once the engine is past
    period 12."""
    import subprocess
    import time

    n = 2048
    x, victim = n - 1, 128
    server = EngineBridgeServer(SwimConfig(n_nodes=n, **GEOM),
                                external_id=x, seed=6, device="cpu")
    server.start()
    host, port = server.address
    proc = subprocess.Popen(
        [client_bin, str(host), str(port), str(x), "7", "36.0", "0.5",
         str(victim), "8.0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while server.t < 12 and proc.poll() is None:
            assert time.time() < deadline, "co-simulation stalled"
            time.sleep(0.02)
        server.deliver_forged(3, [codec.WireUpdate(
            x, Status.SUSPECT, 0, ("sim", x), 3)])
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
        stop(server)
    assert proc.returncode == 0, err[-2000:]
    members, self_inc = {}, None
    for line in out.splitlines():
        parts = line.split()
        if parts and parts[0] == "member":
            members[int(parts[1])] = (int(parts[2]), int(parts[3]))
        elif parts and parts[0] == "self":
            self_inc = int(parts[2])
    assert len(members) >= 64, len(members)
    assert members.get(victim, (None,))[0] == int(Status.DEAD)
    assert not [m for m, (st, _) in members.items()
                if m != victim and st == int(Status.DEAD)]
    assert self_inc is not None and self_inc >= 1
    assert int(server.state.inc_self[x]) == 0 and alive_keys(server, x)
    assert not server._x_crashed and not dead_view_of(server, x)


def test_resolved_row_matches_canonical_layout():
    """The host re-derives one node's win/cold ring-word layout; pin it
    to ring.resolved_words over several periods."""
    n = 128
    cfg = SwimConfig(n_nodes=n, **GEOM)
    server = EngineBridgeServer(cfg, external_id=0, device="cpu")
    server.close()
    plan = faults.with_crashes(faults.none(n, "cpu"), [5], [1])
    state = ring.init_state(cfg, "cpu")
    key = threefry.key(3)
    for t in range(6):
        state = ring.step(cfg, state, plan,
                          ring.draw_period_ring(key, t, cfg, "cpu"))
        server.state, server.t = state, t + 1
        canon = ring.resolved_words(cfg, state).numpy().view(np.uint32)
        for x in (0, 5, n - 1):
            bits = np.unpackbits(canon[x].astype("<u4").view(np.uint8),
                                 bitorder="little").astype(bool)
            np.testing.assert_array_equal(server._resolved_row(x), bits,
                                          err_msg=f"t={t}")


def test_u32_mirrors_order_a_dead_key_first():
    """A tombstone or table key with bit 31 set is the strongest: a
    stale wire claim against it is dropped, and the key decodes DEAD."""
    from swim_tpu_torch.bridge import engine_server as es

    server = EngineBridgeServer(SwimConfig(n_nodes=64, **GEOM),
                                external_id=63, device="cpu")
    server.close()
    dead = 0x80000000 | (3 << 1)
    server._gone[9] = dead
    server._subject[:2] = [9, 9]
    server._rkey[:2] = [5 << 1, 0x7FFFFFFE]
    assert server._best_key(9) == dead
    assert es._status_of(dead) == Status.DEAD and es._inc_of(dead) == 3
    server._queue_injections(1, (codec.WireUpdate(
        9, Status.ALIVE, 1000, ("sim", 9), 2),))
    assert server._inject == []
    server._queue_injections(1, (codec.WireUpdate(
        10, Status.SUSPECT, 1, ("sim", 10), 2),))
    assert server._inject == [(10, (1 << 1) | 1, 2, 1)]
    assert server.table_keys(9) == [5 << 1, 0x7FFFFFFE]

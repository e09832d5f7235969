"""The port's lockstep bridge (protocol, BridgeServer, client) against
the JAX package's.

  * every frame of `swim_tpu_torch/bridge/protocol.py` packs to the
    reference's bytes and unpacks from them; bad frames raise alike;
  * a port `ExternalNodeHost` core joins a port `BridgeServer` of 8
    in-process Nodes and detects a kill (the reference's
    test_external_node_joins_and_detects_failures), and the in-process
    nodes' opinions, counters and network counters equal those of the
    same script against the reference's BridgeServer and host;
  * the port's compiled `bridge_client` (native/bridge_client.cpp)
    passes the reference's test_c_core_joins_and_detects_failures
    against the port's BridgeServer (skips without g++);
  * claiming an in-process node's id is refused; `metrics_port` serves
    /metrics (tests/test_torch_instruments.py holds its scrape to the
    reference's).
Tolerance: exact.
"""
from __future__ import annotations

import subprocess

import pytest
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JSwimConfig
from swim_tpu.bridge import BridgeServer as JBridgeServer
from swim_tpu.bridge import ExternalNodeHost as JExternalNodeHost
from swim_tpu.bridge import protocol as jbp
from swim_tpu_torch import SwimConfig, native
from swim_tpu_torch.bridge import BridgeServer, ExternalNodeHost
from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.types import Status

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FRAMES = [
    ("HELLO", dict(a=100)),
    ("WELCOME", dict(a=100, t=12.5)),
    ("SEND", dict(a=100, b=3, payload=b"\x01\x02datagram")),
    ("STEP", dict(t=0.25)),
    ("DELIVER", dict(a=3, b=100, payload=b"")),
    ("TIME", dict(t=99.0)),
    ("KILL", dict(a=7)),
    ("SET_LOSS", dict(t=0.1)),
    ("BYE", {}),
    ("ERROR", dict(a=bp.ERR_ID_TAKEN)),
    ("DELIVER", dict(a=2**32 - 1, b=0, payload=bytes(range(256)) * 9)),
]


@pytest.mark.parametrize("op, kw", FRAMES, ids=[f[0] for f in FRAMES])
def test_frame_bytes_match_the_reference(op, kw):
    f = bp.Frame(getattr(bp, op), **kw)
    wire = jbp.pack(jbp.Frame(getattr(jbp, op), **kw))
    assert bp.pack(f) == wire
    assert bp.unpack(wire[4:]) == f


def test_bad_frames_rejected():
    with pytest.raises(ValueError):
        bp.unpack(bytes([42]))
    with pytest.raises(ValueError):
        bp.pack(bp.Frame(99))


def test_read_frame_over_a_socket_pair():
    import socket

    a, b = socket.socketpair()
    try:
        for op, kw in FRAMES:
            bp.write_frame(a, bp.Frame(getattr(bp, op), **kw))
        for op, kw in FRAMES:
            assert bp.read_frame(b) == bp.Frame(getattr(bp, op), **kw)
        a.close()
        assert bp.read_frame(b) is None          # clean EOF
    finally:
        b.close()


def joins_and_detects(server_cls, host_cls, cfg) -> dict:
    """The reference's scenario: an external core (id 100) joins 8
    in-process nodes through node 0, then kills node 3 through the
    bridge.  Returns what every side believes."""
    server = server_cls(cfg, n_internal=8, seed=3)
    server.start()
    host = host_cls(server.address, quantum=0.25)
    try:
        ext = host.add_node(cfg, 100, seeds=[0], seed=100)
        host.run(10.0)
        joined = (len(ext.members),
                  [int(n.members.opinion(100).status) for n in server.nodes])
        host.kill(3)
        host.run(45.0)
    finally:
        host.close()
        server.join()

    def view(node):
        return sorted((m.id, int(m.opinion.status), m.opinion.incarnation)
                      for m in node.members.members())

    return dict(
        joined=joined, ext=view(ext),
        ext_counters={k: v.value for k, v in ext.registry.counters.items()},
        nodes=[(view(n), {k: v.value for k, v in
                          n.registry.counters.items()})
               for n in server.nodes],
        network=(server.network.sent, server.network.delivered))


def test_external_node_joins_and_detects_failures():
    got = joins_and_detects(BridgeServer, ExternalNodeHost,
                            SwimConfig(n_nodes=9))
    # the external core joined: it knows everyone, everyone knows it
    assert got["joined"] == (9, [int(Status.ALIVE)] * 8)
    # and it, like every live in-process node, sees node 3 dead
    assert (3, int(Status.DEAD), 0) in got["ext"]
    for i, (view, _) in enumerate(got["nodes"]):
        if i != 3:
            assert (3, int(Status.DEAD), 0) in view
            assert any(m == 100 and s == int(Status.ALIVE)
                       for m, s, _ in view)
    want = joins_and_detects(JBridgeServer, JExternalNodeHost,
                             JSwimConfig(n_nodes=9))
    assert got == want


def test_claiming_internal_node_id_is_rejected():
    cfg = SwimConfig(n_nodes=4)
    server = BridgeServer(cfg, n_internal=3, seed=1)
    server.start()
    host = ExternalNodeHost(server.address)
    try:
        with pytest.raises(ValueError, match="rejected"):
            host.add_node(cfg, 0, seeds=[1])
        assert server.network._endpoints[("sim", 0)] \
            is server.nodes[0].transport
    finally:
        host.close()
        server.join()


def test_metrics_port_names_the_roadmap_item():
    """`metrics_port`, refused until the exposition was ported, binds
    a /metrics endpoint that answers once the server starts, and
    `close` shuts it."""
    import urllib.request

    server = BridgeServer(SwimConfig(n_nodes=4), n_internal=3,
                          metrics_port=0)
    server.start()
    try:
        host, port = server.metrics_address
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=10) as resp:
            body = resp.read().decode()
        assert body.startswith("# HELP swim_build_info")
        assert 'swim_health_status ' in body
    finally:
        server.close()
        server.join()
    assert server.metrics_address is not None


@pytest.fixture(scope="module")
def client_bin():
    path = native.bridge_client_bin()
    if path is None:
        pytest.skip("no native toolchain (g++)")
    return path


def parse_members(stdout: str) -> dict[int, tuple[int, int]]:
    out = {}
    for line in stdout.splitlines():
        parts = line.split()
        if parts and parts[0] == "member":
            out[int(parts[1])] = (int(parts[2]), int(parts[3]))
    return out


def test_c_core_joins_and_detects_failures(client_bin):
    cfg = SwimConfig(n_nodes=9)
    server = BridgeServer(cfg, n_internal=8, seed=3)
    server.start()
    try:
        host, port = server.address
        r = subprocess.run(
            [client_bin, str(host), str(port), "100", "0",
             "55.0", "0.25", "3", "10.0"],
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        members = parse_members(r.stdout)
        assert set(members) == set(range(8)), sorted(members)
        assert members[3][0] == int(Status.DEAD), members
        live_wrong = [m for m, (st, _) in members.items()
                      if m != 3 and st == int(Status.DEAD)]
        assert not live_wrong, f"C core falsely killed {live_wrong}"
        for n in server.nodes:
            if n.id == 3:
                continue
            op = n.members.opinion(100)
            assert op is not None and op.status == Status.ALIVE, n.id
            op3 = n.members.opinion(3)
            assert op3 is not None and op3.status == Status.DEAD, n.id
    finally:
        server.join()

"""The port's native codec and UDP transports against the JAX package's.

`swim_tpu_torch/native/codec.cpp` (through `native/codec.py`) and the
port's Python codec must write the bytes of the reference's
`core/codec.py` for a seeded set of messages (every kind, empty to
maximal gossip sections, hosts with NUL bytes), read each other's bytes
back, and reject malformed datagrams alike.  The port's asyncio
`UDPTransport` and the udppump `NativeUDPTransport` (with `loop=`) carry
a five-node cluster of the port's Nodes over loopback sockets: join,
converge, detect a crash.  The native tests skip without g++.
Tolerance: exact bytes.
"""
from __future__ import annotations

import asyncio
import random

import pytest
from _net import all_judge, all_see, wait_until  # tests/ is on sys.path

from swim_tpu.core import codec as jcodec
from swim_tpu.types import MsgKind as JMsgKind
from swim_tpu.types import Status as JStatus
from swim_tpu_torch import SwimConfig, native
from swim_tpu_torch.core import codec
from swim_tpu_torch.core.clock import AsyncioClock
from swim_tpu_torch.core.node import Node
from swim_tpu_torch.core.transport import UDPTransport
from swim_tpu_torch.types import MsgKind, Status


@pytest.fixture
def ncodec():
    """The native codec's binding (built with g++ at first use)."""
    if native.codec_lib() is None:
        pytest.skip("no native toolchain (g++)")
    from swim_tpu_torch.native import codec as ncodec

    return ncodec


@pytest.fixture
def pump_transport():
    """NativeUDPTransport (the udppump, built with g++ at first use)."""
    if native.pump_lib() is None:
        pytest.skip("no native toolchain (g++)")
    from swim_tpu_torch.native.transport import NativeUDPTransport

    return NativeUDPTransport


def random_fields(rng: random.Random) -> dict:
    def addr():
        host = rng.choice(["", "sim", "127.0.0.1", "nul\x00host",
                           "host-" + "x" * rng.randint(0, 40)])
        return (host, rng.randrange(0, 2**32))

    kind = rng.randrange(0, 6)
    keep_seq = kind in (0, 1, 2, 3)
    return dict(
        kind=kind, sender=rng.randrange(0, 2**32),
        probe_seq=rng.randrange(0, 2**32) if keep_seq else 0,
        target=rng.randrange(0, 2**32) if kind == 1 else 0,
        target_addr=addr() if kind == 1 else ("", 0),
        on_behalf=rng.randrange(0, 2**32) if kind in (0, 2, 3) else 0,
        gossip=[(rng.randrange(0, 2**32), rng.randrange(0, 3),
                 rng.randrange(0, 2**32), addr(), rng.randrange(0, 2**32))
                for _ in range(rng.choice([0, 1, 3, 50, 200]))])


def build(mod, msg_kind, status, f):
    """A Message of codec module `mod` from drawn fields (only the
    fields the wire carries for the kind, so it round-trips)."""
    return mod.Message(
        kind=msg_kind(f["kind"]), sender=f["sender"],
        probe_seq=f["probe_seq"], target=f["target"],
        target_addr=f["target_addr"], on_behalf=f["on_behalf"],
        gossip=tuple(mod.WireUpdate(m, status(s), i, a, o)
                     for m, s, i, a, o in f["gossip"]))


SEEDS = (1234, 99, 7)


@pytest.mark.parametrize("seed", SEEDS)
def test_python_codec_writes_the_reference_bytes(seed):
    rng = random.Random(seed)
    for _ in range(100):
        f = random_fields(rng)
        msg = build(codec, MsgKind, Status, f)
        wire = jcodec.encode(build(jcodec, JMsgKind, JStatus, f))
        assert codec.encode(msg) == wire
        assert codec.decode(wire) == msg


@pytest.mark.parametrize("seed", SEEDS)
def test_native_codec_writes_the_reference_bytes(ncodec, seed):
    rng = random.Random(seed)
    for _ in range(100):
        f = random_fields(rng)
        msg = build(codec, MsgKind, Status, f)
        wire = jcodec.encode(build(jcodec, JMsgKind, JStatus, f))
        assert ncodec.encode(msg) == wire
        assert ncodec.decode(wire) == msg
        assert codec.peek_kind(wire) == msg.kind


def test_native_codec_maximum_message(ncodec):
    """255 updates with 255-byte hosts (about 70 KiB): the wire format's
    largest message, through both codecs."""
    big = codec.Message(kind=MsgKind.JOIN_REPLY, sender=1, gossip=tuple(
        codec.WireUpdate(i, Status.ALIVE, i, ("h" * 255, 2**32 - 1), i)
        for i in range(255)))
    wire = jcodec.encode(jcodec.Message(
        kind=JMsgKind.JOIN_REPLY, sender=1, gossip=tuple(
            jcodec.WireUpdate(i, JStatus.ALIVE, i, ("h" * 255, 2**32 - 1),
                              i) for i in range(255))))
    assert len(wire) > 65536
    assert ncodec.encode(big) == wire == codec.encode(big)
    assert ncodec.decode(wire) == big


def test_malformed_datagrams_rejected_alike(ncodec):
    rng = random.Random(7)
    cases = [b"", b"\x00", b"W\x01", bytes([0x58, 1, 0, 0, 0, 0, 0, 0])]
    for _ in range(200):
        wire = bytearray(codec.encode(build(codec, MsgKind, Status,
                                            random_fields(rng))))
        op = rng.randrange(3)
        if op == 0 and len(wire) > 1:
            wire = wire[:rng.randrange(1, len(wire))]
        elif op == 1:
            wire[rng.randrange(len(wire))] ^= 0xFF
        else:
            wire += bytes([rng.randrange(256)])
        cases.append(bytes(wire))
    accepted = 0
    for wire in cases:
        out = []
        for dec, err in ((codec.decode, codec.DecodeError),
                         (ncodec.decode, codec.DecodeError),
                         (jcodec.decode, jcodec.DecodeError)):
            try:
                m = dec(wire)
                out.append(jcodec.encode(m) if dec is jcodec.decode
                           else codec.encode(m))
            except err:
                out.append(None)
        assert out[0] == out[1] == out[2], wire.hex()
        accepted += out[0] is not None
    assert accepted > 0


async def _cluster_over(make_transport) -> None:
    """Five port Nodes at 50 ms periods: join through node 0, converge,
    then node 4 crashes and the rest declare it DEAD."""
    cfg = SwimConfig(n_nodes=5, protocol_period=0.05, suspicion_mult=2.0)
    loop = asyncio.get_running_loop()
    clock = AsyncioClock(loop)
    transports = [await make_transport(loop) for _ in range(5)]
    nodes = [Node(cfg, i, t, clock, seed=i)
             for i, t in enumerate(transports)]
    try:
        nodes[0].start()
        for n in nodes[1:]:
            n.start(seeds=[transports[0].local_address])
        await wait_until(lambda: all_see(nodes, 5, Status.ALIVE))
        assert all_see(nodes, 5), [len(n.members) for n in nodes]
        nodes[4].stop()
        transports[4].close()
        await wait_until(lambda: all_judge(nodes[:4], 4, Status.DEAD))
        for n in nodes[:4]:
            op = n.members.opinion(4)
            assert op is not None and op.status == Status.DEAD, (n.id, op)
    finally:
        for n, t in zip(nodes[:4], transports[:4]):
            n.stop()
            t.close()


def test_udp_cluster_join_converge_detect():
    async def make(loop):
        return await UDPTransport.create("127.0.0.1", 0)

    asyncio.run(_cluster_over(make))


def test_udp_transport_round_trip():
    async def scenario():
        a = await UDPTransport.create("127.0.0.1", 0)
        b = await UDPTransport.create("127.0.0.1", 0)
        got = []
        b.set_receiver(lambda src, payload: got.append((src, payload)))
        try:
            for i in range(20):
                a.send(b.local_address, b"dgram-%d" % i)
            await wait_until(lambda: len(got) == 20, timeout=10.0)
            assert sorted(p for _, p in got) == sorted(
                b"dgram-%d" % i for i in range(20))
            assert {src for src, _ in got} == {a.local_address}
        finally:
            a.close()
            b.close()

    asyncio.run(scenario())


def test_native_udp_cluster_with_loop(pump_transport):
    """NativeUDPTransport(loop=...) marshals receiver callbacks onto the
    loop, so AsyncioClock-driven Nodes see single-threaded delivery."""
    async def make(loop):
        return pump_transport(loop=loop)

    asyncio.run(_cluster_over(make))


def test_native_udp_loop_delivers_on_the_loop_thread(pump_transport):
    import threading

    async def scenario():
        loop = asyncio.get_running_loop()
        a, b = pump_transport(), pump_transport(loop=loop)
        threads = []
        b.set_receiver(lambda src, p: threads.append(threading.get_ident()))
        try:
            for _ in range(10):
                a.send(b.local_address, b"x")
            await wait_until(lambda: len(threads) == 10, timeout=10.0)
            assert set(threads) == {threading.get_ident()}
        finally:
            a.close()
            b.close()

    asyncio.run(scenario())

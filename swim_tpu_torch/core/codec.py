"""Binary wire codec for SWIM protocol messages (port of
`swim_tpu/core/codec.py`; its bytes are the reference's).

Datagram format (network byte order):

    header:  magic 'W' | version u8 | kind u8 | sender_id u32
    body:    per-kind fields (below)
    gossip:  count u8, then count x update
    update:  member u32 | status u8 | incarnation u32 | origin u32 | address
    address: host_len u8 | host utf-8 | port u32 (u32: in-process
             transports use node ids as ports, which exceed u16)

Every message carries a gossip section, possibly empty: dissemination
rides on the failure detector's traffic.
"""
from __future__ import annotations

import dataclasses
import struct

from swim_tpu_torch.types import MsgKind, Status, Update

MAGIC = 0x57  # 'W'
VERSION = 1
_HDR = struct.Struct("!BBBI")
_UPD = struct.Struct("!IBII")

Address = tuple[str, int]


@dataclasses.dataclass(frozen=True)
class WireUpdate:
    """A membership update plus the member's address."""

    member: int
    status: Status
    incarnation: int
    addr: Address
    # originator of the claim (SUSPECT: the suspecting node; DEAD: the
    # declarer); relaying preserves it
    origin: int = 0

    @property
    def update(self) -> Update:
        return Update(self.member, self.status, self.incarnation)


@dataclasses.dataclass(frozen=True)
class Message:
    kind: MsgKind
    sender: int
    probe_seq: int = 0
    target: int = 0           # PING_REQ / proxy PING: the probed member
    target_addr: Address = ("", 0)  # PING_REQ: where the proxy finds it
    on_behalf: int = 0        # proxy PING/ACK relay bookkeeping
    gossip: tuple[WireUpdate, ...] = ()


def _pack_addr(addr: Address) -> bytes:
    host = addr[0].encode()
    if len(host) > 255:
        raise ValueError("host too long")
    return bytes([len(host)]) + host + struct.pack("!I", addr[1])


def _unpack_addr(buf: bytes, off: int) -> tuple[Address, int]:
    ln = buf[off]
    off += 1
    host = buf[off:off + ln].decode()
    off += ln
    (port,) = struct.unpack_from("!I", buf, off)
    return (host, port), off + 4


def encode(msg: Message) -> bytes:
    out = [_HDR.pack(MAGIC, VERSION, int(msg.kind), msg.sender)]
    k = msg.kind
    if k in (MsgKind.PING, MsgKind.ACK, MsgKind.NACK):
        out.append(struct.pack("!II", msg.probe_seq, msg.on_behalf))
    elif k == MsgKind.PING_REQ:
        out.append(struct.pack("!II", msg.probe_seq, msg.target))
        out.append(_pack_addr(msg.target_addr))
    elif k not in (MsgKind.JOIN, MsgKind.JOIN_REPLY):
        raise ValueError(f"unknown kind {k}")
    if len(msg.gossip) > 255:
        raise ValueError("gossip section too large")
    out.append(bytes([len(msg.gossip)]))
    for u in msg.gossip:
        out.append(_UPD.pack(u.member, int(u.status), u.incarnation,
                             u.origin))
        out.append(_pack_addr(u.addr))
    return b"".join(out)


class DecodeError(ValueError):
    pass


def peek_kind(buf: bytes) -> MsgKind:
    """The kind from the header alone (magic and version checked, the
    body not parsed): for paths that route on kind only."""
    try:
        magic, version, kind, _ = _HDR.unpack_from(buf, 0)
    except struct.error as e:
        raise DecodeError(str(e)) from e
    if magic != MAGIC:
        raise DecodeError("bad magic")
    if version != VERSION:
        raise DecodeError(f"unsupported version {version}")
    try:
        return MsgKind(kind)
    except ValueError as e:
        raise DecodeError(str(e)) from e


def decode(buf: bytes) -> Message:
    try:
        magic, version, kind, sender = _HDR.unpack_from(buf, 0)
        if magic != MAGIC:
            raise DecodeError("bad magic")
        if version != VERSION:
            raise DecodeError(f"unsupported version {version}")
        kind = MsgKind(kind)
        off = _HDR.size
        probe_seq = target = on_behalf = 0
        target_addr: Address = ("", 0)
        if kind in (MsgKind.PING, MsgKind.ACK, MsgKind.NACK):
            probe_seq, on_behalf = struct.unpack_from("!II", buf, off)
            off += 8
        elif kind == MsgKind.PING_REQ:
            probe_seq, target = struct.unpack_from("!II", buf, off)
            off += 8
            target_addr, off = _unpack_addr(buf, off)
        count = buf[off]
        off += 1
        gossip = []
        for _ in range(count):
            member, status, inc, origin = _UPD.unpack_from(buf, off)
            off += _UPD.size
            addr, off = _unpack_addr(buf, off)
            gossip.append(WireUpdate(member, Status(status), inc, addr,
                                     origin))
        return Message(kind=kind, sender=sender, probe_seq=probe_seq,
                       target=target, target_addr=target_addr,
                       on_behalf=on_behalf, gossip=tuple(gossip))
    except DecodeError:
        raise
    except (struct.error, IndexError, UnicodeDecodeError, ValueError) as e:
        raise DecodeError(f"malformed datagram: {e}") from e

"""Bridge wire protocol: length-prefixed binary frames over TCP (port of
`swim_tpu/bridge/protocol.py`; the same bytes).

The contract for an EXTERNAL protocol core to take part in a simulated
cluster (docs/BRIDGE.md holds the normative spec).  The format is
codegen-free: length-prefixed structs any language writes in a dozen
lines (native/bridge_client.cpp is one such core).

Frame:  u32le body_length | body;   body: u8 opcode | fields (little-endian)

  opcode  dir  fields
  HELLO    c->s  u32 node_id          claim an external node id
  WELCOME  s->c  u32 node_id, f64 now
  SEND     c->s  u32 src, u32 dst, rest=payload   (opaque datagram bytes)
  STEP     c->s  f64 dt               advance virtual time (lockstep)
  DELIVER  s->c  u32 src, u32 dst, rest=payload   datagrams for bridged nodes
  TIME     s->c  f64 now              end-of-STEP marker
  KILL     c->s  u32 node_id          crash-stop any node (fault injection)
  SET_LOSS c->s  f64 loss             global Bernoulli loss
  BYE      c->s  -                    clean shutdown
  ERROR    s->c  u32 code             protocol error (ERR_*); HELLO with an
                                      already-claimed id -> ERR_ID_TAKEN

Time only moves on STEP: the co-simulation is deterministic lockstep.
The server runs its side up to the new time, streams DELIVER frames for
the bridged nodes and finishes the batch with TIME.  Payloads are opaque
bytes end to end; a core that talks to the server's nodes speaks the
datagram codec of core/codec.py.
"""

from __future__ import annotations

import socket
import struct
from typing import NamedTuple

(HELLO, WELCOME, SEND, STEP, DELIVER, TIME, KILL, SET_LOSS, BYE,
 ERROR) = range(1, 11)

ERR_ID_TAKEN = 1   # HELLO claimed an id that already has an endpoint

_U32 = struct.Struct("<I")
_OP_U32 = struct.Struct("<BI")
_OP_F64 = struct.Struct("<Bd")
_OP_U32_F64 = struct.Struct("<BId")
_OP_2U32 = struct.Struct("<BII")

MAX_FRAME = 1 << 20


class Frame(NamedTuple):
    op: int
    a: int = 0        # node id / src
    b: int = 0        # dst
    t: float = 0.0    # time / dt / loss
    payload: bytes = b""


def pack(f: Frame) -> bytes:
    if f.op in (HELLO, KILL, ERROR):
        body = _OP_U32.pack(f.op, f.a)
    elif f.op == WELCOME:
        body = _OP_U32_F64.pack(f.op, f.a, f.t)
    elif f.op in (SEND, DELIVER):
        body = _OP_2U32.pack(f.op, f.a, f.b) + f.payload
    elif f.op in (STEP, TIME, SET_LOSS):
        body = _OP_F64.pack(f.op, f.t)
    elif f.op == BYE:
        body = bytes([f.op])
    else:
        raise ValueError(f"unknown opcode {f.op}")
    return _U32.pack(len(body)) + body


def unpack(body: bytes) -> Frame:
    op = body[0]
    if op in (HELLO, KILL, ERROR):
        return Frame(op, a=_OP_U32.unpack(body)[1])
    if op == WELCOME:
        _, a, t = _OP_U32_F64.unpack(body)
        return Frame(op, a=a, t=t)
    if op in (SEND, DELIVER):
        _, a, b = _OP_2U32.unpack(body[:_OP_2U32.size])
        return Frame(op, a=a, b=b, payload=body[_OP_2U32.size:])
    if op in (STEP, TIME, SET_LOSS):
        return Frame(op, t=_OP_F64.unpack(body)[1])
    if op == BYE:
        return Frame(op)
    raise ValueError(f"unknown opcode {op}")


def read_frame(sock: socket.socket) -> Frame | None:
    """Blocking read of one frame; None on clean EOF."""
    hdr = _read_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = _U32.unpack(hdr)
    if not 1 <= length <= MAX_FRAME:
        raise ValueError(f"bad frame length {length}")
    body = _read_exact(sock, length)
    if body is None:
        raise ValueError("truncated frame")
    return unpack(body)


def write_frame(sock: socket.socket, f: Frame) -> None:
    sock.sendall(pack(f))


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    """n bytes, or None on clean EOF; raises if the peer dies mid-read."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise ValueError("connection closed mid-frame")
            return None
        buf.extend(chunk)
    return bytes(buf)

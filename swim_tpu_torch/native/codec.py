"""ctypes binding for the native wire codec (codec.cpp; port of
`swim_tpu/native/codec.py`).

`encode` / `decode` are twins of core/codec.py on the same Message /
WireUpdate dataclasses, byte for byte (tests/test_torch_native.py).
Through this binding the native codec is not faster than the Python one:
building the dataclasses dominates.  Its role is a second, independently
written implementation of the wire format that cross-checks the Python
codec, and the parsing layer for datapaths that stay in C structs.
"""

from __future__ import annotations

import ctypes

from swim_tpu_torch.core.codec import DecodeError, Message, WireUpdate
from swim_tpu_torch.native import codec_lib
from swim_tpu_torch.types import MsgKind, Status

_MAX_HOST = 255
_MAX_GOSSIP = 255
# true wire maximum: 7 header + (8 + 260 addr) body + 1 count +
# 255 x (13 + 260) updates, about 69.9 KiB: round up to 128 KiB
_MAX_DGRAM = 1 << 17


class _WireAddr(ctypes.Structure):
    # host as c_uint8 (NOT c_char): ctypes NUL-truncates c_char-array
    # reads, which would silently diverge from the Python codec on hosts
    # containing 0x00 bytes
    _fields_ = [("host_len", ctypes.c_uint8),
                ("host", ctypes.c_uint8 * _MAX_HOST),
                ("port", ctypes.c_uint32)]


class _WireUpd(ctypes.Structure):
    _fields_ = [("member", ctypes.c_uint32),
                ("status", ctypes.c_uint8),
                ("incarnation", ctypes.c_uint32),
                ("origin", ctypes.c_uint32),
                ("addr", _WireAddr)]


class _WireMsg(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_uint8),
                ("sender", ctypes.c_uint32),
                ("probe_seq", ctypes.c_uint32),
                ("target", ctypes.c_uint32),
                ("on_behalf", ctypes.c_uint32),
                ("target_addr", _WireAddr),
                ("n_gossip", ctypes.c_uint16),
                ("gossip", _WireUpd * _MAX_GOSSIP)]


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = codec_lib()
        if lib is None:
            raise RuntimeError("native codec unavailable (no toolchain)")
        lib.swim_encode.restype = ctypes.c_int
        lib.swim_encode.argtypes = [ctypes.POINTER(_WireMsg),
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int]
        lib.swim_decode.restype = ctypes.c_int
        lib.swim_decode.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int, ctypes.POINTER(_WireMsg)]
        _lib = lib
    return _lib


def is_available() -> bool:
    return codec_lib() is not None


def _set_addr(wa: _WireAddr, addr) -> None:
    host = addr[0].encode()
    if len(host) > _MAX_HOST:
        raise ValueError("host too long")
    wa.host_len = len(host)
    ctypes.memmove(wa.host, host, len(host))
    wa.port = addr[1]


def _get_addr(wa: _WireAddr):
    return (bytes(wa.host[:wa.host_len]).decode(), wa.port)


def _to_wire(msg: Message) -> _WireMsg:
    m = _WireMsg()
    m.kind = int(msg.kind)
    m.sender = msg.sender
    m.probe_seq = msg.probe_seq
    m.target = msg.target
    m.on_behalf = msg.on_behalf
    _set_addr(m.target_addr, msg.target_addr)
    if len(msg.gossip) > _MAX_GOSSIP:
        raise ValueError("gossip section too large")
    m.n_gossip = len(msg.gossip)
    for i, u in enumerate(msg.gossip):
        g = m.gossip[i]
        g.member = u.member
        g.status = int(u.status)
        g.incarnation = u.incarnation
        g.origin = u.origin
        _set_addr(g.addr, u.addr)
    return m


def _from_wire(m: _WireMsg) -> Message:
    gossip = tuple(
        WireUpdate(g.member, Status(g.status), g.incarnation,
                   _get_addr(g.addr), g.origin)
        for g in m.gossip[:m.n_gossip])
    return Message(kind=MsgKind(m.kind), sender=m.sender,
                   probe_seq=m.probe_seq, target=m.target,
                   target_addr=_get_addr(m.target_addr),
                   on_behalf=m.on_behalf, gossip=gossip)


def encode(msg: Message) -> bytes:
    lib = _get_lib()
    m = _to_wire(msg)
    out = (ctypes.c_uint8 * _MAX_DGRAM)()
    n = lib.swim_encode(ctypes.byref(m), out, _MAX_DGRAM)
    if n < 0:
        raise ValueError("encode failed")
    return bytes(out[:n])


def decode(buf: bytes) -> Message:
    lib = _get_lib()
    m = _WireMsg()
    arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
    rc = lib.swim_decode(arr, len(buf), ctypes.byref(m))
    if rc != 0:
        raise DecodeError(f"malformed datagram (native rc={rc})")
    try:
        return _from_wire(m)
    except (ValueError, UnicodeDecodeError) as e:
        raise DecodeError(f"malformed datagram: {e}") from e

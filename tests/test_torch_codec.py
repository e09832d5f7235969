"""The port's wire codec and wire types against the JAX package's.

`swim_tpu_torch/core/codec.py` must write the reference's bytes for
every message (hypothesis-drawn), read them back, peek the kind from
the header, and raise DecodeError on every truncation; the wire half of
`swim_tpu_torch/types.py` must agree with `swim_tpu.types` on every
key.  Tolerance: exact (bytes and ints).
"""
from __future__ import annotations

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from swim_tpu import types as jtypes
from swim_tpu.core import codec as jcodec
from swim_tpu_torch import types
from swim_tpu_torch.core import codec

U32 = st.integers(0, 2**32 - 1)
ADDR = st.tuples(st.text(max_size=12), U32)


@st.composite
def messages(draw):
    kind = draw(st.sampled_from(list(types.MsgKind)))
    gossip = draw(st.lists(st.tuples(U32, st.sampled_from(list(
        types.Status)), U32, ADDR, U32), max_size=6))
    return dict(kind=int(kind), sender=draw(U32), probe_seq=draw(U32),
                target=draw(U32), target_addr=draw(ADDR),
                on_behalf=draw(U32), gossip=gossip)


def build(mod, tmod, m):
    """A Message of codec module `mod` (types module `tmod`) from the
    drawn fields."""
    return mod.Message(
        kind=tmod.MsgKind(m["kind"]), sender=m["sender"],
        probe_seq=m["probe_seq"], target=m["target"],
        target_addr=m["target_addr"], on_behalf=m["on_behalf"],
        gossip=tuple(mod.WireUpdate(member=g[0],
                                    status=tmod.Status(int(g[1])),
                                    incarnation=g[2], addr=g[3],
                                    origin=g[4]) for g in m["gossip"]))


def wire_fields(msg) -> tuple:
    kind = msg.kind
    fields = [int(kind), msg.sender]
    if kind in (types.MsgKind.PING, types.MsgKind.ACK, types.MsgKind.NACK):
        fields += [msg.probe_seq, msg.on_behalf]
    elif kind == types.MsgKind.PING_REQ:
        fields += [msg.probe_seq, msg.target, msg.target_addr]
    fields.append([(u.member, int(u.status), u.incarnation, u.addr,
                    u.origin) for u in msg.gossip])
    return tuple(fields)


@settings(max_examples=200, deadline=None)
@given(messages())
def test_encode_bytes_equal_the_reference(m):
    assert codec.encode(build(codec, types, m)) == \
        jcodec.encode(build(jcodec, jtypes, m))


@settings(max_examples=200, deadline=None)
@given(messages())
def test_decode_and_peek_round_trip(m):
    msg = build(codec, types, m)
    data = codec.encode(msg)
    back = codec.decode(data)
    assert wire_fields(back) == wire_fields(msg)
    assert codec.peek_kind(data) == msg.kind
    ref = jcodec.decode(data)
    assert wire_fields(back) == wire_fields(ref)


@settings(max_examples=50, deadline=None)
@given(messages())
def test_truncation_raises_decode_error(m):
    data = codec.encode(build(codec, types, m))
    for cut in range(len(data)):
        with pytest.raises(codec.DecodeError):
            codec.decode(data[:cut])
    with pytest.raises(codec.DecodeError):
        codec.peek_kind(data[:6])


def test_bad_header_raises():
    data = codec.encode(codec.Message(kind=types.MsgKind.ACK, sender=3))
    for bad in (b"X" + data[1:], data[:1] + b"\x09" + data[2:],
                data[:2] + b"\x77" + data[3:]):
        with pytest.raises(codec.DecodeError):
            codec.decode(bad)
        with pytest.raises(codec.DecodeError):
            codec.peek_kind(bad)
    with pytest.raises(ValueError):
        codec.encode(codec.Message(kind=types.MsgKind.ACK, sender=0,
                                   gossip=tuple(codec.WireUpdate(
                                       0, types.Status.ALIVE, 0,
                                       ("h", 0)) for _ in range(256))))


@given(st.sampled_from(list(types.Status)), st.integers(0, 2**31))
def test_wire_type_helpers_match(status, inc):
    key = types.opinion_key(int(status), inc)
    assert key == jtypes.opinion_key(int(status), inc)
    assert types.key_status(key) == jtypes.key_status(key)
    assert types.key_incarnation(key) == jtypes.key_incarnation(key)
    a = types.Opinion(status, inc)
    b = types.Opinion(types.Status.SUSPECT, inc // 2)
    ja = jtypes.Opinion(jtypes.Status(int(status)), inc)
    jb = jtypes.Opinion(jtypes.Status.SUSPECT, inc // 2)
    assert a.key() == ja.key()
    assert types.merge(a, b).key() == jtypes.merge(ja, jb).key()
    assert types.supersedes(a, b) == jtypes.supersedes(ja, jb)
    u = types.Update(7, status, inc)
    assert u.opinion == types.Opinion(status, inc)


def test_enums_match():
    assert {k.name: int(k) for k in types.MsgKind} == \
        {k.name: int(k) for k in jtypes.MsgKind}
    assert {k.name: int(k) for k in types.Status} == \
        {k.name: int(k) for k in jtypes.Status}
    assert types.INC_MAX == jtypes.INC_MAX

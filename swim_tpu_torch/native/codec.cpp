// Native SWIM wire codec: C ABI twin of core/codec.py (a copy of the
// reference package's native/codec.cpp).
//
// Format (network byte order, see core/codec.py):
//
//   header:  magic 'W' | version u8 | kind u8 | sender_id u32
//   body:    kind-dependent (probe_seq/on_behalf | probe_seq/target/addr)
//   gossip:  count u8, then count x (member u32 | status u8 | inc u32 |
//            origin u32 | addr)
//   address: host_len u8 | host bytes | port u32
//
// Byte parity with the Python codec is tested in tests/test_torch_native.py.
// The C structs use fixed-capacity buffers so the ABI needs no allocator
// handshake with ctypes.  native/bridge_client.cpp #includes this file.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kMagic = 0x57;
constexpr uint8_t kVersion = 1;
constexpr int kMaxHost = 255;
constexpr int kMaxGossip = 255;

// MsgKind values must match types.py
constexpr uint8_t kPing = 0, kPingReq = 1, kAck = 2, kNack = 3, kJoin = 4,
                  kJoinReply = 5;

inline void put_u32(uint8_t *p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
inline uint32_t get_u32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

extern "C" {

struct WireAddr {
  uint8_t host_len;
  char host[kMaxHost];
  uint32_t port;
};

struct WireUpd {
  uint32_t member;
  uint8_t status;
  uint32_t incarnation;
  uint32_t origin;
  WireAddr addr;
};

struct WireMsg {
  uint8_t kind;
  uint32_t sender;
  uint32_t probe_seq;
  uint32_t target;
  uint32_t on_behalf;
  WireAddr target_addr;
  uint16_t n_gossip;
  WireUpd gossip[kMaxGossip];
};

// Returns bytes written, or -1 if `cap` is too small / msg malformed.
int swim_encode(const WireMsg *m, uint8_t *out, int cap) {
  if (m->n_gossip > kMaxGossip) return -1;
  int off = 0;
  auto need = [&](int n) { return off + n <= cap; };
  auto put_addr = [&](const WireAddr &a) -> bool {
    if (!need(1 + a.host_len + 4)) return false;
    out[off++] = a.host_len;
    std::memcpy(out + off, a.host, a.host_len);
    off += a.host_len;
    put_u32(out + off, a.port);
    off += 4;
    return true;
  };
  if (!need(7)) return -1;
  out[off++] = kMagic;
  out[off++] = kVersion;
  out[off++] = m->kind;
  put_u32(out + off, m->sender); off += 4;
  switch (m->kind) {
    case kPing: case kAck: case kNack:
      if (!need(8)) return -1;
      put_u32(out + off, m->probe_seq); off += 4;
      put_u32(out + off, m->on_behalf); off += 4;
      break;
    case kPingReq:
      if (!need(8)) return -1;
      put_u32(out + off, m->probe_seq); off += 4;
      put_u32(out + off, m->target); off += 4;
      if (!put_addr(m->target_addr)) return -1;
      break;
    case kJoin: case kJoinReply:
      break;
    default:
      return -1;
  }
  if (!need(1)) return -1;
  out[off++] = (uint8_t)m->n_gossip;
  for (int i = 0; i < m->n_gossip; ++i) {
    const WireUpd &u = m->gossip[i];
    if (!need(13)) return -1;
    put_u32(out + off, u.member); off += 4;
    out[off++] = u.status;
    put_u32(out + off, u.incarnation); off += 4;
    put_u32(out + off, u.origin); off += 4;
    if (!put_addr(u.addr)) return -1;
  }
  return off;
}

// Returns 0 on success, negative error code on malformed input.
int swim_decode(const uint8_t *buf, int len, WireMsg *m) {
  int off = 0;
  auto need = [&](int n) { return off + n <= len; };
  auto get_addr = [&](WireAddr *a) -> bool {
    if (!need(1)) return false;
    a->host_len = buf[off++];
    if (!need(a->host_len + 4)) return false;
    std::memcpy(a->host, buf + off, a->host_len);
    off += a->host_len;
    a->port = get_u32(buf + off);
    off += 4;
    return true;
  };
  std::memset(m, 0, sizeof(WireMsg));
  if (!need(7)) return -2;
  if (buf[off++] != kMagic) return -3;
  if (buf[off++] != kVersion) return -4;
  m->kind = buf[off++];
  if (m->kind > kJoinReply) return -5;
  m->sender = get_u32(buf + off); off += 4;
  switch (m->kind) {
    case kPing: case kAck: case kNack:
      if (!need(8)) return -2;
      m->probe_seq = get_u32(buf + off); off += 4;
      m->on_behalf = get_u32(buf + off); off += 4;
      break;
    case kPingReq:
      if (!need(8)) return -2;
      m->probe_seq = get_u32(buf + off); off += 4;
      m->target = get_u32(buf + off); off += 4;
      if (!get_addr(&m->target_addr)) return -2;
      break;
    default:
      break;
  }
  if (!need(1)) return -2;
  m->n_gossip = buf[off++];
  for (int i = 0; i < m->n_gossip; ++i) {
    WireUpd &u = m->gossip[i];
    if (!need(13)) return -2;
    u.member = get_u32(buf + off); off += 4;
    u.status = buf[off++];
    if (u.status > 2) return -6;
    u.incarnation = get_u32(buf + off); off += 4;
    u.origin = get_u32(buf + off); off += 4;
    if (!get_addr(&u.addr)) return -2;
  }
  return 0;
}

}  // extern "C"

// Foreign-core bridge conformance client: a self-contained SWIM protocol
// core in C++ (a copy of the reference package's native/bridge_client.cpp)
// that joins a simulated cluster over the TCP lockstep bridge
// (bridge/protocol.py) and participates fully: join via snapshot,
// piggybacked gossip, probe/ack/ping-req failure detection, suspicion
// timers, incarnation refutation.
//
// The wire contract is implementable from scratch outside Python: this
// core shares only the datagram codec (codec.cpp) with the package.  It
// runs against bridge/server.py's BridgeServer (real Nodes) and against
// bridge/engine_server.py's EngineBridgeServer (ring-engine peers on the
// card); tests/test_torch_bridge.py, tests/test_torch_engine_bridge.py
// and chip_smoke.py drive it.  native.bridge_client_bin() builds it.
//
// Scope: the vanilla protocol of docs/PROTOCOL.md §3-§5 under the stock
// config (1 s period, k=3, B=6; timeouts as core/node.py computes them).
// Lifeguard extensions are not implemented here.
//
// Usage:
//   bridge_client HOST PORT NODE_ID SEED_ID DURATION [QUANTUM]
//                 [KILL_ID KILL_AT]
// Drives the co-simulation DURATION virtual seconds in QUANTUM slices;
// optionally injects KILL(KILL_ID) at virtual time KILL_AT. On exit,
// prints one line per known member: "member <id> <status> <incarnation>"
// (status 0=alive 1=suspect 2=dead) and "self <id> <incarnation>".

#include "codec.cpp"

#include <algorithm>
#include <arpa/inet.h>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <netdb.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

namespace {

// ------------------------------------------------------------ frame layer
// Bridge frames: u32le length | u8 opcode | little-endian fields
// (bridge/protocol.py).

enum Op : uint8_t {
  HELLO = 1, WELCOME = 2, SEND = 3, STEP = 4, DELIVER = 5, TIME = 6,
  KILL = 7, SET_LOSS = 8, BYE = 9, ERROR_OP = 10,
};

int g_sock = -1;

void die(const char *msg) {
  std::fprintf(stderr, "bridge_client: %s\n", msg);
  std::exit(1);
}

void send_all(const uint8_t *p, size_t n) {
  while (n) {
    ssize_t w = ::send(g_sock, p, n, 0);
    if (w <= 0) die("send failed");
    p += w;
    n -= (size_t)w;
  }
}

void recv_all(uint8_t *p, size_t n) {
  while (n) {
    ssize_t r = ::recv(g_sock, p, n, 0);
    if (r <= 0) die("connection closed");
    p += r;
    n -= (size_t)r;
  }
}

void put_u32le(uint8_t *p, uint32_t v) {
  p[0] = v; p[1] = v >> 8; p[2] = v >> 16; p[3] = v >> 24;
}
uint32_t get_u32le(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
void put_f64le(uint8_t *p, double v) { std::memcpy(p, &v, 8); }
double get_f64le(const uint8_t *p) {
  double v;
  std::memcpy(&v, p, 8);
  return v;
}

void frame_send(const std::vector<uint8_t> &body) {
  uint8_t hdr[4];
  put_u32le(hdr, (uint32_t)body.size());
  send_all(hdr, 4);
  send_all(body.data(), body.size());
}

std::vector<uint8_t> frame_recv() {
  uint8_t hdr[4];
  recv_all(hdr, 4);
  uint32_t len = get_u32le(hdr);
  if (len == 0 || len > (1u << 20)) die("bad frame length");
  std::vector<uint8_t> body(len);
  recv_all(body.data(), len);
  return body;
}

void send_hello(uint32_t id) {
  std::vector<uint8_t> b(5);
  b[0] = HELLO;
  put_u32le(&b[1], id);
  frame_send(b);
}

void send_step(double dt) {
  std::vector<uint8_t> b(9);
  b[0] = STEP;
  put_f64le(&b[1], dt);
  frame_send(b);
}

void send_kill(uint32_t id) {
  std::vector<uint8_t> b(5);
  b[0] = KILL;
  put_u32le(&b[1], id);
  frame_send(b);
}

void send_bye() {
  frame_send({BYE});
}

void send_datagram(uint32_t src, uint32_t dst, const uint8_t *payload,
                   int len) {
  std::vector<uint8_t> b(9 + len);
  b[0] = SEND;
  put_u32le(&b[1], src);
  put_u32le(&b[5], dst);
  std::memcpy(&b[9], payload, len);
  frame_send(b);
}

// --------------------------------------------------------------- SWIM core

enum Status : uint8_t { ALIVE = 0, SUSPECT = 1, DEAD = 2 };

struct Member {
  Status status = ALIVE;
  uint32_t incarnation = 0;
};

struct GossipEntry {
  Status status;
  uint32_t incarnation;
  uint32_t origin;
  int sends = 0;
};

struct Timer {
  double at;
  int kind;       // 0=tick 1=probe_timeout 2=period_end 3=susp_expire
  //                 4=relay_expire
  uint64_t a = 0;
  uint64_t b = 0;
  bool cancelled = false;
};

struct Probe {
  uint32_t target;
  bool acked = false;
};

struct Relay {
  uint32_t requester;
  uint32_t rseq;
};

struct Swim {
  uint32_t id;
  double period = 1.0;
  int k_indirect = 3;
  int max_piggyback = 6;
  double suspicion_mult = 5.0;
  double retransmit_mult = 4.0;

  double now = 0.0;
  uint32_t inc_self = 0;
  uint64_t seq_next = 1;
  uint64_t rng = 0x9E3779B97F4A7C15ull;

  std::map<uint32_t, Member> members;           // excludes self
  std::map<uint32_t, GossipEntry> gossip;       // member -> freshest claim
  std::map<uint64_t, Probe> probes;
  std::map<uint64_t, Relay> relays;
  std::map<uint32_t, double> susp_started;      // member -> start (info)
  std::vector<Timer> timers;
  std::vector<uint32_t> probe_order;
  size_t probe_pos = 0;

  uint64_t rand64() {
    rng ^= rng << 13; rng ^= rng >> 7; rng ^= rng << 17;
    return rng;
  }

  double log_n() {
    double n = std::max((double)(members.size() + 1), 10.0);
    return std::max(1.0, std::log10(n));
  }
  int retransmit_limit() {
    return std::max(1, (int)std::ceil(retransmit_mult * log_n()));
  }
  double suspicion_timeout() { return suspicion_mult * log_n() * period; }
  double probe_timeout() { return 0.3 * period; }

  void add_timer(double delay, int kind, uint64_t a = 0, uint64_t b = 0) {
    timers.push_back({now + delay, kind, a, b, false});
  }

  // ---- membership lattice (docs/PROTOCOL.md §2) ----
  bool apply(uint32_t m, Status st, uint32_t inc) {
    Member &e = members[m];                 // inserts ALIVE(0) if new
    // precedence: DEAD sticky, higher incarnation wins, then
    // DEAD > SUSPECT > ALIVE at equal incarnation
    bool better;
    if (e.status == DEAD) {
      better = false;
    } else if (st == DEAD) {
      better = true;
    } else if (inc != e.incarnation) {
      better = inc > e.incarnation;
    } else {
      better = st > e.status;
    }
    if (!better) return false;
    e.status = st;
    e.incarnation = inc;
    return true;
  }

  void enqueue(uint32_t m, Status st, uint32_t inc, uint32_t origin) {
    gossip[m] = GossipEntry{st, inc, origin, 0};
  }

  void note_member(uint32_t m) {
    if (m == id) return;
    if (!members.count(m)) {
      members[m] = Member{};
      probe_order.push_back(m);
      enqueue(m, ALIVE, 0, id);
    }
  }

  void apply_and_gossip(uint32_t m, Status st, uint32_t inc,
                        uint32_t origin) {
    if (m == id) {
      // claim about us: refute suspicion (death is sticky, keep running)
      if (st == SUSPECT && inc >= inc_self) {
        inc_self = inc + 1;
        enqueue(id, ALIVE, inc_self, id);
      }
      return;
    }
    note_member(m);
    if (!apply(m, st, inc)) return;
    enqueue(m, st, inc, origin);
    if (st == SUSPECT) {
      susp_started[m] = now;
      add_timer(suspicion_timeout(), 3, m, inc);
    } else {
      susp_started.erase(m);
    }
  }

  // ---- piggyback ----
  int fill_gossip(WireMsg *msg) {
    // fewest-sends-first selection of <= B live entries
    std::vector<std::pair<int, uint32_t>> order;
    int limit = retransmit_limit();
    for (auto &kv : gossip)
      if (kv.second.sends < limit)
        order.push_back({kv.second.sends, kv.first});
    std::sort(order.begin(), order.end());
    int nsel = std::min((int)order.size(), max_piggyback);
    msg->n_gossip = (uint16_t)nsel;
    for (int i = 0; i < nsel; ++i) {
      uint32_t m = order[i].second;
      GossipEntry &e = gossip[m];
      e.sends++;
      WireUpd &u = msg->gossip[i];
      u.member = m;
      u.status = (uint8_t)e.status;
      u.incarnation = e.incarnation;
      u.origin = e.origin;
      u.addr.host_len = 3;
      std::memcpy(u.addr.host, "sim", 3);
      u.addr.port = m;
    }
    return nsel;
  }

  void transmit(uint32_t dst, WireMsg *msg) {
    uint8_t buf[65536];
    int n = swim_encode(msg, buf, sizeof buf);
    if (n < 0) die("encode failed");
    send_datagram(id, dst, buf, n);
  }

  WireMsg make(uint8_t kind) {
    WireMsg m;
    std::memset(&m, 0, sizeof m);
    m.kind = kind;
    m.sender = id;
    return m;
  }

  // ---- protocol tick ----
  void tick() {
    add_timer(period, 0);
    if (probe_order.empty()) return;
    if (probe_pos >= probe_order.size()) {
      // reshuffle each epoch (SWIM §4.3 randomized round-robin)
      for (size_t i = probe_order.size(); i > 1; --i)
        std::swap(probe_order[i - 1], probe_order[rand64() % i]);
      probe_pos = 0;
    }
    uint32_t target = probe_order[probe_pos++];
    uint64_t seq = seq_next++;
    probes[seq] = Probe{target};
    WireMsg m = make(kPing);
    m.probe_seq = (uint32_t)seq;
    fill_gossip(&m);
    transmit(target, &m);
    add_timer(probe_timeout(), 1, seq);
    add_timer(0.95 * period, 2, seq);
  }

  void on_probe_timeout(uint64_t seq) {
    auto it = probes.find(seq);
    if (it == probes.end() || it->second.acked) return;
    uint32_t target = it->second.target;
    // k distinct live proxies (excluding self, the target, and anyone
    // not believed ALIVE — vanilla SWIM samples without replacement)
    std::vector<uint32_t> pool;
    for (auto &kv : members)
      if (kv.first != target && kv.second.status == ALIVE)
        pool.push_back(kv.first);
    for (int i = 0; i < k_indirect && !pool.empty(); ++i) {
      size_t pick = rand64() % pool.size();
      uint32_t p = pool[pick];
      pool.erase(pool.begin() + pick);
      WireMsg m = make(kPingReq);
      m.probe_seq = (uint32_t)seq;
      m.target = target;
      m.target_addr.host_len = 3;
      std::memcpy(m.target_addr.host, "sim", 3);
      m.target_addr.port = target;
      fill_gossip(&m);
      transmit(p, &m);
    }
  }

  void on_period_end(uint64_t seq) {
    auto it = probes.find(seq);
    if (it == probes.end()) return;
    Probe p = it->second;
    probes.erase(it);
    if (p.acked) return;
    auto &e = members[p.target];
    if (e.status == ALIVE)
      apply_and_gossip(p.target, SUSPECT, e.incarnation, id);
  }

  void on_susp_expired(uint32_t m, uint32_t inc) {
    auto it = members.find(m);
    if (it == members.end() || it->second.status != SUSPECT ||
        it->second.incarnation != inc)
      return;
    apply_and_gossip(m, DEAD, it->second.incarnation, id);
  }

  // ---- receive ----
  void on_datagram(uint32_t src, const uint8_t *buf, int len) {
    WireMsg m;
    if (swim_decode(buf, len, &m) != 0) return;
    note_member(m.sender);
    for (int i = 0; i < m.n_gossip; ++i) {
      const WireUpd &u = m.gossip[i];
      apply_and_gossip(u.member, (Status)u.status, u.incarnation, u.origin);
    }
    switch (m.kind) {
      case kPing: {
        WireMsg a = make(kAck);
        a.probe_seq = m.probe_seq;
        a.on_behalf = m.on_behalf;
        fill_gossip(&a);
        transmit(m.sender, &a);
        break;
      }
      case kPingReq: {
        uint64_t sub = seq_next++;
        relays[sub] = Relay{m.sender, m.probe_seq};
        WireMsg p = make(kPing);
        p.probe_seq = (uint32_t)sub;
        p.on_behalf = m.sender;
        fill_gossip(&p);
        transmit(m.target_addr.port, &p);
        add_timer(probe_timeout(), 4, sub);
        break;
      }
      case kAck: {
        auto rit = relays.find(m.probe_seq);
        if (rit != relays.end()) {
          Relay r = rit->second;
          relays.erase(rit);
          WireMsg a = make(kAck);
          a.probe_seq = r.rseq;
          a.on_behalf = m.sender;
          fill_gossip(&a);
          transmit(r.requester, &a);
          break;
        }
        auto pit = probes.find(m.probe_seq);
        if (pit != probes.end()) pit->second.acked = true;
        break;
      }
      case kJoin: {
        // snapshot reply (chunked; our table is small)
        WireMsg r = make(kJoinReply);
        int i = 0;
        for (auto &kv : members) {
          if (i >= 200) break;
          WireUpd &u = r.gossip[i++];
          u.member = kv.first;
          u.status = (uint8_t)kv.second.status;
          u.incarnation = kv.second.incarnation;
          u.origin = id;
          u.addr.host_len = 3;
          std::memcpy(u.addr.host, "sim", 3);
          u.addr.port = kv.first;
        }
        r.n_gossip = (uint16_t)i;
        transmit(m.sender, &r);
        break;
      }
      default:
        break;     // kJoinReply/kNack: gossip merge already did the work
    }
  }

  // ---- virtual-time advance: fire timers in order up to `to` ----
  void advance_to(double to) {
    for (;;) {
      int best = -1;
      for (size_t i = 0; i < timers.size(); ++i)
        if (!timers[i].cancelled && timers[i].at <= to + 1e-12 &&
            (best < 0 || timers[i].at < timers[best].at))
          best = (int)i;
      if (best < 0) break;
      Timer t = timers[best];
      timers.erase(timers.begin() + best);
      now = std::max(now, t.at);
      switch (t.kind) {
        case 0: tick(); break;
        case 1: on_probe_timeout(t.a); break;
        case 2: on_period_end(t.a); break;
        case 3: on_susp_expired((uint32_t)t.a, (uint32_t)t.b); break;
        case 4: relays.erase(t.a); break;
      }
    }
    now = std::max(now, to);
  }
};

}  // namespace

int main(int argc, char **argv) {
  if (argc < 6)
    die("usage: bridge_client HOST PORT NODE_ID SEED_ID DURATION "
        "[QUANTUM] [KILL_ID KILL_AT]");
  const char *host = argv[1];
  int port = std::atoi(argv[2]);
  uint32_t node_id = (uint32_t)std::atoll(argv[3]);
  uint32_t seed_id = (uint32_t)std::atoll(argv[4]);
  double duration = std::atof(argv[5]);
  double quantum = argc > 6 ? std::atof(argv[6]) : 0.25;
  long kill_id = argc > 8 ? std::atol(argv[7]) : -1;
  double kill_at = argc > 8 ? std::atof(argv[8]) : -1.0;

  struct addrinfo hints = {}, *res;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  std::snprintf(portbuf, sizeof portbuf, "%d", port);
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || !res)
    die("resolve failed");
  g_sock = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (g_sock < 0 || ::connect(g_sock, res->ai_addr, res->ai_addrlen) != 0)
    die("connect failed");
  freeaddrinfo(res);

  send_hello(node_id);
  auto wf = frame_recv();
  if (wf[0] == ERROR_OP) die("server rejected node id");
  if (wf[0] != WELCOME) die("expected WELCOME");

  Swim node;
  node.id = node_id;
  node.now = get_f64le(&wf[5]);

  // JOIN the cluster through the seed, then start ticking (randomized
  // first-tick offset, as core/node.py does)
  node.note_member(seed_id);
  {
    WireMsg j = node.make(kJoin);
    node.transmit(seed_id, &j);
  }
  node.add_timer(0.5 * node.period, 0);

  bool killed = false;
  double end = node.now + duration;
  while (node.now < end - 1e-9) {
    if (kill_id >= 0 && !killed && node.now >= kill_at) {
      send_kill((uint32_t)kill_id);
      killed = true;
    }
    double dt = std::min(quantum, end - node.now);
    send_step(dt);
    std::vector<std::pair<uint32_t, std::vector<uint8_t>>> deliveries;
    double server_now = node.now;
    for (;;) {
      auto f = frame_recv();
      if (f[0] == TIME) {
        server_now = get_f64le(&f[1]);
        break;
      }
      if (f[0] != DELIVER) die("unexpected frame mid-step");
      uint32_t src = get_u32le(&f[1]);
      deliveries.emplace_back(
          src, std::vector<uint8_t>(f.begin() + 9, f.end()));
    }
    for (auto &d : deliveries)
      node.on_datagram(d.first, d.second.data(), (int)d.second.size());
    node.advance_to(server_now);
  }
  send_bye();
  ::close(g_sock);

  for (auto &kv : node.members)
    std::printf("member %u %u %u\n", kv.first,
                (unsigned)kv.second.status, kv.second.incarnation);
  std::printf("self %u %u\n", node.id, node.inc_self);
  return 0;
}

// Native UDP datapath: an epoll-driven socket pump on its own thread
// (a copy of the reference package's native/udppump.cpp).
//
// A native thread owns the socket and two lock-protected rings; Python
// drains inbound batches and enqueues outbound datagrams: one GIL
// crossing per BATCH, not per datagram, and the socket stays serviced
// while the interpreter is busy (the serving hub's drain thread shares
// the interpreter with the engine thread's launches).
//
// C ABI only, consumed via ctypes (native/transport.py).

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxDgram = 65536;

struct Dgram {
  uint32_t ip;     // network order
  uint16_t port;   // host order
  std::vector<uint8_t> data;
};

struct Pump {
  int fd = -1;
  int efd = -1;          // eventfd: wake the loop for sends/shutdown
  int epfd = -1;
  uint16_t bound_port = 0;
  uint32_t bound_ip = 0;
  std::thread thr;
  std::atomic<bool> stop{false};
  std::mutex in_mu, out_mu;
  std::vector<Dgram> inbox, outbox;
  std::atomic<uint64_t> rx{0}, tx{0}, drops{0};

  void loop() {
    std::vector<uint8_t> buf(kMaxDgram);
    epoll_event evs[4];
    while (!stop.load(std::memory_order_acquire)) {
      int n = epoll_wait(epfd, evs, 4, 100);
      if (n < 0 && errno != EINTR) break;
      for (int i = 0; i < n; ++i) {
        if (evs[i].data.fd == efd) {
          uint64_t junk;
          (void)!read(efd, &junk, sizeof junk);
        }
      }
      // drain socket
      for (;;) {
        sockaddr_in src{};
        socklen_t slen = sizeof src;
        ssize_t got = recvfrom(fd, buf.data(), buf.size(), MSG_DONTWAIT,
                               (sockaddr *)&src, &slen);
        if (got < 0) break;
        Dgram d;
        d.ip = src.sin_addr.s_addr;
        d.port = ntohs(src.sin_port);
        d.data.assign(buf.begin(), buf.begin() + got);
        std::lock_guard<std::mutex> lk(in_mu);
        if (inbox.size() < 65536) {
          inbox.push_back(std::move(d));
          rx.fetch_add(1, std::memory_order_relaxed);
        } else {
          drops.fetch_add(1, std::memory_order_relaxed);
        }
      }
      // flush outbox
      std::vector<Dgram> out;
      {
        std::lock_guard<std::mutex> lk(out_mu);
        out.swap(outbox);
      }
      for (auto &d : out) {
        sockaddr_in dst{};
        dst.sin_family = AF_INET;
        dst.sin_addr.s_addr = d.ip;
        dst.sin_port = htons(d.port);
        if (sendto(fd, d.data.data(), d.data.size(), 0, (sockaddr *)&dst,
                   sizeof dst) >= 0)
          tx.fetch_add(1, std::memory_order_relaxed);
        else  // e.g. EMSGSIZE: a >64K join snapshot exceeds one datagram
          drops.fetch_add(1, std::memory_order_relaxed);
      }
    }
  }
};

}  // namespace

extern "C" {

// Create and bind; returns an opaque handle or null. `ip` is dotted quad.
void *pump_create(const char *ip, uint16_t port) {
  auto *p = new Pump();
  p->fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  if (p->fd < 0) { delete p; return nullptr; }
  int one = 1;
  setsockopt(p->fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1 ||
      bind(p->fd, (sockaddr *)&addr, sizeof addr) < 0) {
    close(p->fd); delete p; return nullptr;
  }
  sockaddr_in got{};
  socklen_t glen = sizeof got;
  getsockname(p->fd, (sockaddr *)&got, &glen);
  p->bound_port = ntohs(got.sin_port);
  p->bound_ip = got.sin_addr.s_addr;
  p->efd = eventfd(0, EFD_NONBLOCK);
  p->epfd = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = p->fd;
  bool ok = p->efd >= 0 && p->epfd >= 0 &&
            epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->fd, &ev) == 0;
  ev.data.fd = p->efd;
  ok = ok && epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->efd, &ev) == 0;
  if (!ok) {  // fd exhaustion etc: fail loudly, not with a deaf handle
    close(p->fd);
    if (p->efd >= 0) close(p->efd);
    if (p->epfd >= 0) close(p->epfd);
    delete p;
    return nullptr;
  }
  p->thr = std::thread([p] { p->loop(); });
  return p;
}

uint16_t pump_port(void *h) { return ((Pump *)h)->bound_port; }

void pump_send(void *h, const char *ip, uint16_t port, const uint8_t *buf,
               int len) {
  auto *p = (Pump *)h;
  if (p == nullptr) return;
  Dgram d;
  if (inet_pton(AF_INET, ip, &d.ip) != 1) {
    p->drops.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  d.port = port;
  d.data.assign(buf, buf + len);
  {
    std::lock_guard<std::mutex> lk(p->out_mu);
    p->outbox.push_back(std::move(d));
  }
  uint64_t one = 1;
  (void)!write(p->efd, &one, sizeof one);
}

// Drain up to `cap` datagrams. For each: writes src ip (u32 HOST order),
// src port (u16), length (u16) into the meta array (4 fields of u32 per
// entry for ctypes simplicity) and the payload into `out` back to back.
// Returns the number of datagrams; lengths[i] gives payload boundaries.
int pump_recv(void *h, uint8_t *out, int out_cap, uint32_t *meta, int cap) {
  auto *p = (Pump *)h;
  std::vector<Dgram> batch;
  {
    std::lock_guard<std::mutex> lk(p->in_mu);
    batch.swap(p->inbox);
  }
  int n = 0, off = 0;
  for (auto &d : batch) {
    if (n >= cap || off + (int)d.data.size() > out_cap) {
      // put the rest back (front of inbox, preserving order)
      std::lock_guard<std::mutex> lk(p->in_mu);
      p->inbox.insert(p->inbox.begin(), batch.begin() + n, batch.end());
      break;
    }
    std::memcpy(out + off, d.data.data(), d.data.size());
    meta[4 * n + 0] = ntohl(d.ip);  // host order; Python re-encodes big-endian
    meta[4 * n + 1] = d.port;
    meta[4 * n + 2] = (uint32_t)d.data.size();
    meta[4 * n + 3] = 0;
    off += d.data.size();
    ++n;
  }
  return n;
}

void pump_stats(void *h, uint64_t *rx, uint64_t *tx, uint64_t *drops) {
  auto *p = (Pump *)h;
  *rx = p->rx.load(); *tx = p->tx.load(); *drops = p->drops.load();
}

void pump_destroy(void *h) {
  auto *p = (Pump *)h;
  p->stop.store(true, std::memory_order_release);
  uint64_t one = 1;
  (void)!write(p->efd, &one, sizeof one);
  if (p->thr.joinable()) p->thr.join();
  close(p->fd); close(p->efd); close(p->epfd);
  delete p;
}

}  // extern "C"

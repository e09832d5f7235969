"""Bridge server: host a simulated cluster that external cores can join
(port of `swim_tpu/bridge/server.py`).

`BridgeServer` owns a SimClock and SimNetwork pre-populated with
in-process `Node`s and speaks the lockstep protocol of
bridge/protocol.py with external co-processes.  Every bridged node is a
first-class SimNetwork endpoint: loss, partitions, kills and latency
apply to its traffic exactly as to the in-process nodes', which makes
the server a conformance harness for any external SWIM implementation
(native/bridge_client.cpp is one).

Determinism: virtual time advances only inside STEP handling, under one
lock, so a (server seed, client script) pair replays identically.
"""

from __future__ import annotations

import socket
import threading

from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.core.clock import SimClock
from swim_tpu_torch.core.node import Node
from swim_tpu_torch.core.transport import (Address, InProcessTransport,
                                           SimNetwork)


def _make_metrics_server(host: str, port: int, nodes: list[Node]):
    """Stdlib HTTP server exposing GET /metrics (Prometheus text 0.0.4):
    per-node typed registries, a `swim_build_info` gauge, the current
    `swim_health_*` gauges (obs/health.py real-node rules evaluated per
    scrape; `swim-tpu-torch observe URL --follow` tails this), and, when
    a profile artifact exists (obs/prof.py `default_artifact_path`,
    written by `swim-tpu-torch profile --out auto`), the latest
    `swim_prof_*` phase-attribution gauges."""
    import http.server

    from swim_tpu_torch.obs.expo import (render_health, render_profile,
                                         render_prometheus)
    from swim_tpu_torch.obs.health import evaluate_registries
    from swim_tpu_torch.obs.prof import load_artifact

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):                                  # noqa: N802
            if self.path.split("?")[0] != "/metrics":
                self.send_error(404)
                return
            body = render_prometheus(
                (({"node": str(n.id)}, n.registry) for n in nodes),
                build_labels={"nodes": str(len(nodes))})
            body += render_health(
                evaluate_registries(n.registry for n in nodes))
            profile = load_artifact()      # best-effort; None when absent
            if profile is not None:
                body += render_profile(profile)
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):                         # quiet
            pass

    return http.server.ThreadingHTTPServer((host, port), Handler)


class BridgeServer:
    """`metrics_port` (optional) additionally serves Prometheus text
    exposition (obs/expo.py) over plain HTTP: GET /metrics renders every
    in-process node's typed counter/histogram registry with a `node`
    label.  0 binds an ephemeral port (tests); None (the default) serves
    no metrics endpoint."""

    def __init__(self, cfg: SwimConfig, n_internal: int, seed: int = 0,
                 loss: float = 0.0, host: str = "127.0.0.1", port: int = 0,
                 metrics_port: int | None = None):
        self.cfg = cfg
        self.clock = SimClock()
        self.network = SimNetwork(self.clock, seed=seed, loss=loss)
        self.nodes: list[Node] = []
        for i in range(n_internal):
            t = InProcessTransport(self.network, i)
            self.nodes.append(Node(cfg, i, t, self.clock,
                                   seed=seed * 7919 + i))
        self._bridged: dict[int, InProcessTransport] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.address: Address = self._sock.getsockname()
        self._thread: threading.Thread | None = None
        self._metrics_httpd = None
        self.metrics_address: Address | None = None
        if metrics_port is not None:
            self._metrics_httpd = _make_metrics_server(
                host, metrics_port, self.nodes)
            self.metrics_address = self._metrics_httpd.server_address[:2]
        self._started = False
        self._closing = False
        self._lock = threading.Lock()   # serializes command handling:
        # virtual time and the network mutate under exactly one client
        # command at a time, so multi-client co-simulation stays
        # deterministic given the interleaving of their STEPs

    # ---------------------------------------------------------------- server

    def start(self) -> None:
        """Start internal nodes (bootstrapped full-mesh) + service thread."""
        members = [(n.id, n.transport.local_address) for n in self.nodes]
        for n in self.nodes:
            n.bootstrap(members)
            n.start()
        self._started = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        if self._metrics_httpd is not None:
            threading.Thread(target=self._metrics_httpd.serve_forever,
                             daemon=True).start()

    def _serve(self) -> None:
        """Accept co-process clients until every connected client has hung
        up (at least one must connect first) or close() fires. Each
        connection gets a reader thread; command handling serializes on
        self._lock, so virtual time and the network mutate under exactly
        one client command at a time — multi-client co-simulation stays
        deterministic given the interleaving of the clients' STEPs."""
        self._sock.settimeout(0.2)
        workers: list[threading.Thread] = []
        try:
            while not self._closing:
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    if workers and not any(w.is_alive() for w in workers):
                        break
                    continue
                except OSError:
                    break
                w = threading.Thread(target=self._serve_conn, args=(conn,),
                                     daemon=True)
                w.start()
                workers.append(w)
        finally:
            self._sock.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        outbox: list[tuple[int, int, bytes]] = []
        owned: set[int] = set()
        try:
            while True:
                try:
                    f = bp.read_frame(conn)
                except (ValueError, OSError):
                    return  # torn frame / dead peer: drop this client only
                if f is None or f.op == bp.BYE:
                    return
                with self._lock:
                    # only wire writes are recoverable here; a protocol-
                    # engine error inside _handle must propagate loudly,
                    # not masquerade as a client disconnect
                    try:
                        self._handle(conn, f, outbox, owned)
                    except OSError:
                        return
        finally:
            with self._lock:
                # a vanished client's nodes must not black-hole traffic or
                # squat their ids: detach so a reconnect can re-claim
                for node_id in owned:
                    ep = self._bridged.pop(node_id, None)
                    if ep is not None:
                        self.network.detach(ep.local_address)
            conn.close()

    def _handle(self, conn: socket.socket, f: bp.Frame,
                outbox: list[tuple[int, int, bytes]],
                owned: set[int]) -> None:
        if f.op == bp.HELLO:
            if self._attach(f.a, outbox):
                owned.add(f.a)
                bp.write_frame(conn, bp.Frame(bp.WELCOME, a=f.a,
                                              t=self.clock.now()))
            else:
                bp.write_frame(conn, bp.Frame(bp.ERROR, a=bp.ERR_ID_TAKEN))
        elif f.op == bp.SEND:
            # only a connection's own nodes may transmit through it —
            # multi-client conformance runs must not let one client
            # attribute traffic to another's implementation. (KILL stays
            # global on purpose: it is harness fault injection, not node
            # behavior.) Faults then apply to the send like anyone's.
            ep = self._bridged.get(f.a) if f.a in owned else None
            if ep is not None:
                ep.send(("sim", f.b), f.payload)
        elif f.op == bp.STEP:
            self.clock.advance(f.t)
            out = list(outbox)
            outbox.clear()
            for src, dst, payload in out:
                bp.write_frame(conn, bp.Frame(bp.DELIVER, a=src, b=dst,
                                              payload=payload))
            bp.write_frame(conn, bp.Frame(bp.TIME, t=self.clock.now()))
        elif f.op == bp.KILL:
            self.kill(f.a)
        elif f.op == bp.SET_LOSS:
            self.network.set_loss(f.t)

    def _attach(self, node_id: int,
                outbox: list[tuple[int, int, bytes]]) -> bool:
        """Claim an endpoint for an external node, delivering into its
        owning connection's outbox; False if the id is taken (claiming an
        internal node's id would silently hijack its endpoint — the
        harness must reject that, not swallow it)."""
        if node_id in self._bridged or any(n.id == node_id
                                           for n in self.nodes):
            return False
        ep = InProcessTransport(self.network, node_id)

        def receiver(src: Address, payload: bytes, _id=node_id):
            outbox.append((src[1], _id, payload))

        ep.set_receiver(receiver)
        self._bridged[node_id] = ep
        return True

    # ------------------------------------------------------------- controls

    def kill(self, node_id: int) -> None:
        self.network.kill(("sim", node_id))
        for n in self.nodes:
            if n.id == node_id:
                n.stop()

    def close(self) -> None:
        """Stop accepting new clients; existing connections finish.  The
        /metrics endpoint closes (its serving thread runs once `start`
        has run)."""
        self._closing = True
        if self._metrics_httpd is not None:
            if self._started:
                self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
            self._metrics_httpd = None

    def join(self, timeout: float = 10.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

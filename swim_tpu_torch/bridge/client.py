"""Bridge client: run protocol cores in THIS process against a remote
simulated cluster (port of `swim_tpu/bridge/client.py`).

`ExternalNodeHost` hosts complete `Node` protocol engines that know
nothing about the bridge: they see only a `Clock` and a `Transport`.

With several clients on one server, every client's STEP advances the
SHARED clock, so a node's worst-case receive lag is about n_clients x
quantum; choose quantum well under probe timeout / n_clients when
co-simulating several processes.

Lockstep loop (per `run(duration)` call, in `quantum`-sized slices):
  1. STEP(dt): the server advances shared virtual time and returns
     DELIVER frames for our nodes and the new TIME;
  2. deliveries are handed to the local nodes' receivers;
  3. the local SimClock advances to the server's time, firing node
     timers, whose sends become SEND frames (applied server-side next
     quantum: the <= quantum skew is the bridge's one timing
     approximation).
"""

from __future__ import annotations

import socket

from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.core.clock import SimClock
from swim_tpu_torch.core.node import Node
from swim_tpu_torch.core.transport import Address, Transport


class BridgeTransport(Transport):
    """Transport instance whose wire is the bridge connection."""

    def __init__(self, host: "ExternalNodeHost", node_id: int):
        self._host = host
        self._addr: Address = ("sim", node_id)
        self._receiver = None

    def send(self, to: Address, payload: bytes) -> None:
        self._host._send(self._addr[1], to[1], payload)

    def set_receiver(self, receiver) -> None:
        self._receiver = receiver

    @property
    def local_address(self) -> Address:
        return self._addr


class ExternalNodeHost:
    """Hosts protocol cores client-side, lockstepped to a BridgeServer."""

    def __init__(self, address: Address, quantum: float = 0.1):
        self.quantum = quantum
        self.clock = SimClock()
        self.nodes: dict[int, Node] = {}
        self._transports: dict[int, BridgeTransport] = {}
        self._sock = socket.create_connection(address)

    # ------------------------------------------------------------- lifecycle

    def add_node(self, cfg: SwimConfig, node_id: int,
                 seeds: list[int] = (), seed: int | None = None) -> Node:
        bp.write_frame(self._sock, bp.Frame(bp.HELLO, a=node_id))
        f = bp.read_frame(self._sock)
        if f is None or f.op == bp.ERROR:
            raise ValueError(f"bridge rejected node id {node_id}: {f}")
        if f.op != bp.WELCOME:
            raise ConnectionError(f"expected WELCOME, got {f}")
        self.clock.advance_to(f.t)
        transport = BridgeTransport(self, node_id)
        node = Node(cfg, node_id, transport, self.clock, seed=seed)
        self.nodes[node_id] = node
        self._transports[node_id] = transport
        node.start(seeds=[("sim", s) for s in seeds])
        return node

    def close(self) -> None:
        try:
            bp.write_frame(self._sock, bp.Frame(bp.BYE))
        except OSError:
            pass
        self._sock.close()

    # ------------------------------------------------------------- controls

    def kill(self, node_id: int) -> None:
        """Fault injection on the server's network (any node, either side)."""
        bp.write_frame(self._sock, bp.Frame(bp.KILL, a=node_id))
        node = self.nodes.get(node_id)
        if node is not None:
            node.stop()

    def set_loss(self, loss: float) -> None:
        bp.write_frame(self._sock, bp.Frame(bp.SET_LOSS, t=loss))

    # --------------------------------------------------------------- driving

    def run(self, duration: float) -> None:
        """Advance the co-simulation `duration` virtual seconds."""
        end = self.clock.now() + duration
        while self.clock.now() < end - 1e-9:
            dt = min(self.quantum, end - self.clock.now())
            bp.write_frame(self._sock, bp.Frame(bp.STEP, t=dt))
            deliveries: list[bp.Frame] = []
            while True:
                f = bp.read_frame(self._sock)
                if f is None:
                    raise ConnectionError("bridge closed mid-step")
                if f.op == bp.TIME:
                    now = f.t
                    break
                if f.op != bp.DELIVER:
                    raise ConnectionError(f"unexpected frame mid-step: {f}")
                deliveries.append(f)
            for d in deliveries:
                # through the Transport seam: the node registered its
                # receiver via set_receiver and knows nothing of the bridge
                t = self._transports.get(d.b)
                if t is not None and t._receiver is not None:
                    t._receiver(("sim", d.a), d.payload)
            self.clock.advance_to(now)

    # --------------------------------------------------------------- internal

    def _send(self, src: int, dst: int, payload: bytes) -> None:
        bp.write_frame(self._sock, bp.Frame(bp.SEND, a=src, b=dst,
                                            payload=payload))

"""In-process cluster harness (port of `swim_tpu/core/cluster.py`).

Builds N Nodes over one SimNetwork and SimClock with deterministic
virtual time, fault injection hooks and convergence queries: the
multi-node fixture of the tests and of the real-node scenario arm
(sim/scenario.py `replay_storm`).
"""

from __future__ import annotations

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.core.clock import SimClock
from swim_tpu_torch.core.node import Node
from swim_tpu_torch.core.transport import InProcessTransport, SimNetwork
from swim_tpu_torch.types import Status


class SimCluster:
    def __init__(self, cfg: SwimConfig, seed: int = 0, loss: float = 0.0,
                 latency: float = 0.001, trace=None,
                 duplicate: float = 0.0, replay: float = 0.0):
        # `trace`: optional obs/trace.py TraceSink shared by every node:
        # probe and suspicion lifecycle spans from the whole cluster.
        # `duplicate`/`replay`: adversarial delivery (SimNetwork), the
        # replay-storm scenario's idempotence workload.
        self.cfg = cfg
        self.clock = SimClock()
        self.network = SimNetwork(self.clock, seed=seed, loss=loss,
                                  latency=latency, duplicate=duplicate,
                                  replay=replay)
        self.nodes: list[Node] = []
        roster = []
        for i in range(cfg.n_nodes):
            t = InProcessTransport(self.network, i)
            self.nodes.append(Node(cfg, i, t, self.clock,
                                   seed=seed * 7919 + i, trace=trace))
            roster.append((i, t.local_address))
        for node in self.nodes:
            node.bootstrap(roster)

    def start(self) -> None:
        for n in self.nodes:
            n.start()

    def run(self, seconds: float) -> None:
        self.clock.advance(seconds)

    # -- fault injection ----------------------------------------------------

    def kill(self, node_id: int) -> None:
        """Crash-stop: the node's messages stop flowing; its timers die."""
        self.network.kill(("sim", node_id))
        self.nodes[node_id].stop()

    def partition_halves(self) -> None:
        n = self.cfg.n_nodes
        a = [("sim", i) for i in range(n // 2)]
        b = [("sim", i) for i in range(n // 2, n)]
        self.network.partition(a, b)

    def heal(self) -> None:
        self.network.heal_all()

    # -- queries ------------------------------------------------------------

    def views_of(self, member: int) -> list[Status]:
        return [n.members.opinion(member).status
                if n.members.opinion(member) else None
                for n in self.nodes]

    def all_consider(self, member: int, status: Status,
                     among: list[int] | None = None) -> bool:
        among = among if among is not None else range(self.cfg.n_nodes)
        return all(
            (op := self.nodes[i].members.opinion(member)) is not None
            and op.status == status
            for i in among)

    def converged_all_alive(self) -> bool:
        return all(
            self.all_consider(m, Status.ALIVE)
            for m in range(self.cfg.n_nodes))

    def detection_time(self, victim: int, timeout_s: float,
                       tick: float = 0.1) -> float | None:
        """Advance time until some live node stops believing `victim` ALIVE;
        returns elapsed seconds (None on timeout)."""
        start = self.clock.now()
        live = [i for i in range(self.cfg.n_nodes) if i != victim]
        while self.clock.now() - start < timeout_s:
            self.clock.advance(tick)
            for i in live:
                op = self.nodes[i].members.opinion(victim)
                if op is not None and op.status != Status.ALIVE:
                    return self.clock.now() - start
        return None

"""The port's host protocol layer against the JAX package's.

`swim_tpu_torch/core/` (clock, transport, gossip, membership, node,
cluster) and `obs/registry.py` are copies of the reference's pure-Python
modules; a seed must give the reference's events.  Each SimCluster case
runs both packages with the same seed, faults and duration, and compares
every node's membership opinions and addresses, registry counters and
histograms, Lifeguard score, the network's counters and every trace
span.  Also: `ops/lattice.merge` on u32 keys with bit 31 set (a DEAD
key), `utils/metrics.aggregate_nodes`, and the units of the queue, the
table and the clock against the reference's.  Tolerance: exact.
"""
from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JSwimConfig
from swim_tpu.core import clock as jclock
from swim_tpu.core import cluster as jcluster
from swim_tpu.core import gossip as jgossip
from swim_tpu.core import membership as jmembership
from swim_tpu.core.codec import WireUpdate as JWireUpdate
from swim_tpu.obs import trace as jtrace
from swim_tpu.ops import lattice as jlattice
from swim_tpu.types import Opinion as JOpinion
from swim_tpu.types import Status as JStatus
from swim_tpu.utils import metrics as jmetrics
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.core import clock, cluster, gossip, membership
from swim_tpu_torch.core.codec import WireUpdate
from swim_tpu_torch.obs import registry, trace
from swim_tpu_torch.ops import lattice
from swim_tpu_torch.types import Opinion, Status
from swim_tpu_torch.utils import metrics

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (n, SimCluster keywords, SwimConfig keywords, kills [(at, node)],
#  partition [(at, heal_at)], seconds)
CLUSTER_CASES = {
    "bootstrap_2": (2, {}, {}, [], None, 8.0),
    "bootstrap_3": (3, {}, {}, [], None, 8.0),
    "loss": (12, dict(loss=0.10), dict(k_indirect=3), [], None, 20.0),
    "crash_detected": (16, {}, dict(k_indirect=3), [(2.0, 5)], None, 30.0),
    "lifeguard": (12, dict(loss=0.05), dict(lifeguard=True), [(3.0, 2)],
                  None, 25.0),
    "partition_heal": (10, {}, dict(suspicion_mult=2.0), [], (2.0, 9.0),
                       20.0),
    "replay_storm": (16, dict(loss=0.05, duplicate=0.3, replay=0.3),
                     dict(k_indirect=2), [], None, 12.0),
}


def snapshot(c, spans) -> dict:
    nodes = []
    for node in c.nodes:
        nodes.append(dict(
            id=node.id, lha=node.lha, inc=node.members.incarnation,
            members=sorted((m.id, m.addr, int(m.opinion.status),
                            m.opinion.incarnation)
                           for m in node.members.members()),
            counters={k: v.value for k, v in
                      node.registry.counters.items()},
            histograms={k: (h.counts, h.sum, h.count) for k, h in
                        node.registry.histograms.items()}))
    net = c.network
    return dict(nodes=nodes, now=c.clock.now(),
                network=(net.sent, net.delivered, net.duplicated,
                         net.replayed),
                spans=[s.to_dict() for s in spans])


def run_case(pkg: str, name: str, seed: int = 3) -> dict:
    n, ckw, kw, kills, part, seconds = CLUSTER_CASES[name]
    if pkg == "jax":
        cfg = JSwimConfig(n_nodes=n, **kw)
        sink = jtrace.ListSink()
        c = jcluster.SimCluster(cfg, seed=seed, trace=sink, **ckw)
    else:
        cfg = SwimConfig(n_nodes=n, **kw)
        sink = trace.ListSink()
        c = cluster.SimCluster(cfg, seed=seed, trace=sink, **ckw)
    c.start()
    events = sorted([(at, "kill", node) for at, node in kills]
                    + ([(part[0], "part", 0), (part[1], "heal", 0)]
                       if part else []))
    for at, what, node in events:
        c.run(at - c.clock.now())
        if what == "kill":
            c.kill(node)
        elif what == "part":
            c.partition_halves()
        else:
            c.heal()
    c.run(seconds - c.clock.now())
    return snapshot(c, sink.spans)


@pytest.mark.parametrize("name", sorted(CLUSTER_CASES))
def test_sim_cluster_matches_the_reference(name):
    want, got = run_case("jax", name), run_case("torch", name)
    assert got["network"] == want["network"]
    assert got["spans"] == want["spans"]
    assert got == want
    assert got["network"][0] > 0 and got["spans"]


def test_crash_is_detected_and_everyone_else_alive():
    """The parity case's protocol outcome, in the port alone."""
    n, _, kw, _, _, _ = CLUSTER_CASES["crash_detected"]
    c = cluster.SimCluster(SwimConfig(n_nodes=n, **kw), seed=1)
    c.start()
    c.run(2.0)
    c.kill(5)
    c.run(28.0)
    live = [i for i in range(n) if i != 5]
    assert c.all_consider(5, Status.DEAD, among=live)
    for m in live:
        assert c.all_consider(m, Status.ALIVE, among=live)


def test_detection_time_matches_the_reference():
    out = []
    for mod, cfg_cls in ((jcluster, JSwimConfig), (cluster, SwimConfig)):
        c = mod.SimCluster(cfg_cls(n_nodes=8), seed=9)
        c.start()
        c.run(3.0)
        c.kill(4)
        out.append(c.detection_time(4, timeout_s=30.0))
    assert out[0] == out[1] and out[1] is not None


def u32_keys(rng, shape) -> np.ndarray:
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    keys[..., 0] = 0x80000000          # DEAD, incarnation 0
    keys[..., 1] = 0x7FFFFFFF          # the strongest live key
    return keys


def test_lattice_merge_is_the_unsigned_max():
    rng = np.random.default_rng(4)
    a, b = u32_keys(rng, (64,)), u32_keys(rng, (64,))
    b[:8] = 0xFFFFFFFF - np.arange(8, dtype=np.uint32)   # DEAD, high inc
    got = lattice.merge(torch.from_numpy(a.view(np.int32)),
                        torch.from_numpy(b.view(np.int32)))
    want = np.asarray(jlattice.merge(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # a DEAD key beats every live one, whatever the incarnation
    dead = torch.tensor([np.uint32(0x80000000).view(np.int32)])
    live = torch.tensor([0x7FFFFFFF], dtype=torch.int32)
    assert lattice.merge(dead, live).item() == dead.item()
    assert lattice.is_dead(lattice.merge(live, dead)).item()


class _Stats:
    def __init__(self, stats, lha):
        self.stats, self.lha = stats, lha


def test_aggregate_nodes_matches_the_reference():
    rng = np.random.default_rng(7)
    nodes = []
    for _ in range(5):
        stats = {k: int(rng.integers(0, 50))
                 for k in registry.NODE_COUNTERS}
        nodes.append(_Stats(stats, int(rng.integers(0, 8))))
    assert metrics.aggregate_nodes(nodes) == jmetrics.aggregate_nodes(nodes)
    assert metrics.aggregate_nodes([]) == jmetrics.aggregate_nodes([])


def test_aggregate_nodes_over_a_cluster():
    c = cluster.SimCluster(SwimConfig(n_nodes=6, lifeguard=True), seed=2)
    c.start()
    c.run(5.0)
    want = jcluster.SimCluster(JSwimConfig(n_nodes=6, lifeguard=True),
                               seed=2)
    want.start()
    want.run(5.0)
    got = metrics.aggregate_nodes(c.nodes)
    assert got == jmetrics.aggregate_nodes(want.nodes)
    assert got["nodes"] == 6 and got["probes"] > 0 and "lha_max" in got


def test_registry_declares_the_reference_metrics():
    from swim_tpu.obs import registry as jregistry

    assert registry.NODE_COUNTERS == jregistry.NODE_COUNTERS
    assert registry.NODE_HISTOGRAMS == jregistry.NODE_HISTOGRAMS
    reg = registry.MetricsRegistry.node_default()
    stats = reg.stats_view()
    stats["probes"] += 2
    assert reg.counter("probes").value == 2
    with pytest.raises(KeyError, match="not declared"):
        stats["undeclared"] += 1
    h = reg.histogram("probe_rtt_seconds")
    for v in (0.001, 0.3, 99.0):
        reg.observe("probe_rtt_seconds", v)
    jh = jregistry.Histogram("x", "", jregistry.DEFAULT_BUCKETS)
    for v in (0.001, 0.3, 99.0):
        jh.observe(v)
    assert h.counts == jh.counts and h.cumulative() == jh.cumulative()


def test_piggyback_queue_matches_the_reference():
    rng = random.Random(5)
    q, jq = gossip.PiggybackQueue(4), jgossip.PiggybackQueue(4)
    for step in range(60):
        m = rng.randrange(12)
        st, inc = rng.randrange(3), rng.randrange(3)
        if rng.random() < 0.6:
            q.enqueue(WireUpdate(m, Status(st), inc, ("sim", m), 1))
            jq.enqueue(JWireUpdate(m, JStatus(st), inc, ("sim", m), 1))
        got = [(u.member, int(u.status), u.incarnation)
               for u in q.select(3)]
        want = [(u.member, int(u.status), u.incarnation)
                for u in jq.select(3)]
        assert got == want, step
        if step % 7 == 0:
            q.gc(3)
            jq.gc(3)
        assert len(q) == len(jq)


def test_membership_table_matches_the_reference():
    t = membership.MembershipTable(0, ("sim", 0), random.Random(11))
    jt = jmembership.MembershipTable(0, ("sim", 0), random.Random(11))
    seen, jseen = [], []
    t.listeners.append(lambda m, o, n: seen.append((m, n.status,
                                                    n.incarnation)))
    jt.listeners.append(lambda m, o, n: jseen.append((m, n.status,
                                                      n.incarnation)))
    rng = random.Random(12)
    for _ in range(80):
        m = rng.randrange(1, 10)
        st, inc = rng.randrange(3), rng.randrange(3)
        assert t.apply(m, ("sim", m), Opinion(Status(st), inc)) == \
            jt.apply(m, ("sim", m), JOpinion(JStatus(st), inc))
        assert t.next_probe_target() == jt.next_probe_target()
        assert t.random_members(2, {0}) == jt.random_members(2, {0})
    assert t.refute() == Opinion(Status.ALIVE, jt.refute().incarnation)
    assert [(m, int(s), i) for m, s, i in seen] == \
        [(m, int(s), i) for m, s, i in jseen]


def test_sim_clock_matches_the_reference():
    out = []
    for mod in (clock, jclock):
        c = mod.SimClock()
        fired = []
        handles = [c.call_later(d, lambda d=d: fired.append((c.now(), d)))
                   for d in (0.5, 0.1, 0.1, 2.0, -1.0)]
        handles[3].cancel()
        c.call_later(0.2, lambda: c.call_later(
            0.1, lambda: fired.append((c.now(), "nested"))))
        n = c.advance(1.0)
        out.append((fired, n, c.pending(), c.now()))
    assert out[0] == out[1]

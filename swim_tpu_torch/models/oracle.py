"""Scalar SWIM oracle (port of `swim_tpu/models/oracle.py`) — the
readable, testable gold standard.

Implements exactly the period-synchronous protocol of docs/PROTOCOL.md in
plain Python + NumPy, one message at a time. The port's dense engine
(models/dense.py) must produce *bitwise identical* state given the same
`PeriodRandomness` draws (as numpy arrays through `prng.to_numpy`, which
`step` applies itself); tests/test_torch_oracle.py enforces it.

Deliberately unoptimized: clarity over speed (usable to a few hundred nodes).
Views are stored as packed lattice keys (swim_tpu/types.opinion_key) so state
comparison with the engines is a plain array equality.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.types import Status, key_incarnation, key_status, opinion_key
from swim_tpu_torch.utils.prng import PeriodRandomness

NO_DEADLINE = np.int32(2**31 - 1)


@dataclasses.dataclass
class OracleState:
    """Full simulator state after some number of periods."""

    key: np.ndarray         # u32[N, N] — key[i, j]: i's opinion of j
    retransmit: np.ndarray  # i32[N, N] — gossip sends of i's update about j
    deadline: np.ndarray    # i32[N, N] — suspicion expiry period (NO_DEADLINE)
    lha: np.ndarray         # i32[N]    — Lifeguard local health score
    step: int               # periods completed


def init_state(cfg: SwimConfig) -> OracleState:
    n = cfg.n_nodes
    return OracleState(
        key=np.full((n, n), opinion_key(Status.ALIVE, 0), np.uint32),
        # Counters start at the limit: the initial full-alive view is common
        # knowledge and is not gossiped (matches a converged cluster).
        retransmit=np.full((n, n), cfg.retransmit_limit, np.int32),
        deadline=np.full((n, n), NO_DEADLINE, np.int32),
        lha=np.zeros((n,), np.int32),
        step=0,
    )


def _select_uniform(u: np.float32, candidates: list[int]) -> int:
    """Pick candidates[floor(u * c)] — float32 math to match the engine."""
    c = len(candidates)
    idx = int(np.float32(u) * np.float32(c))
    return candidates[min(idx, c - 1)]


class Oracle:
    """Drives OracleState one protocol period at a time."""

    def __init__(self, cfg: SwimConfig, plan: FaultPlan):
        from swim_tpu_torch.sim import faults as _faults

        self.cfg = cfg
        self.plan = _faults.to_numpy(plan)
        self.state = init_state(cfg)

    # -- fault model -------------------------------------------------------

    def crashed(self, i: int, t: int) -> bool:
        return t >= int(self.plan.crash_step[i])

    def joined(self, i: int, t: int) -> bool:
        return t >= int(self.plan.join_step[i])

    def active(self, i: int, t: int) -> bool:
        return self.joined(i, t) and not self.crashed(i, t)

    def delivered(self, src: int, dst: int, t: int, u_loss: float) -> bool:
        if not (self.active(src, t) and self.active(dst, t)):
            return False
        p = self.plan
        if (int(p.partition_start) <= t < int(p.partition_end)
                and int(p.partition_id[src]) != int(p.partition_id[dst])):
            return False
        return np.float32(u_loss) >= np.float32(p.loss)

    # -- gossip ------------------------------------------------------------

    def piggyback_selection(self, sender: int, forced: int = -1) -> list[int]:
        """Subjects piggybacked on each of `sender`'s messages this wave.

        Eligible updates (retransmit counter below the limit), fewest
        retransmissions first, ties by subject id; at most B. Lifeguard's
        buddy system can force one subject in ahead of the ranking.
        """
        st, cfg = self.state, self.cfg
        eligible = [j for j in range(cfg.n_nodes)
                    if st.retransmit[sender, j] < cfg.retransmit_limit]
        eligible.sort(key=lambda j: (int(st.retransmit[sender, j]), j))
        sel = eligible[:cfg.max_piggyback]
        if forced >= 0 and forced not in sel:
            sel = [forced] + sel[:cfg.max_piggyback - 1]
        return sel

    def _merge_update(self, dst: int, subject: int, new_key: int, t: int):
        """Lattice-join one received update into dst's view."""
        st, cfg = self.state, self.cfg
        old = int(st.key[dst, subject])
        if int(new_key) <= old:
            return
        st.key[dst, subject] = np.uint32(new_key)
        st.retransmit[dst, subject] = 0  # new information → re-gossip it
        new_status = key_status(int(new_key))
        if new_status == Status.SUSPECT:
            # Everyone who learns of a suspicion starts (or restarts, for a
            # higher incarnation) a suspicion timer — whoever expires first
            # gossips the death.
            st.deadline[dst, subject] = t + self._suspicion_periods(dst)
        else:
            st.deadline[dst, subject] = NO_DEADLINE

    def _suspicion_periods(self, node: int) -> int:
        # Vanilla timeout. Lifeguard's dynamic-suspicion shortening (by
        # independent confirmations) lands with the Lifeguard milestone and
        # must stay in lockstep with the dense engine.
        return self.cfg.suspicion_periods

    # -- one protocol period ----------------------------------------------

    def step(self, rnd: PeriodRandomness) -> None:
        from swim_tpu_torch.utils import prng as _prng

        st, cfg = self.state, self.cfg
        n, k, t = cfg.n_nodes, cfg.k_indirect, st.step
        rnd = _prng.to_numpy(rnd)
        up = [i for i in range(n) if self.active(i, t)]

        # ---- Phase A: all random choices (docs/PROTOCOL.md §4) ----
        from swim_tpu_torch.ops.sampling import py_round_robin_target

        rr = cfg.target_selection == "round_robin"
        epoch, pos = divmod(t, n - 1)
        target = {}
        proxies = {}
        for i in up:
            # not-yet-joined nodes are in nobody's membership list
            cands = [j for j in range(n)
                     if j != i and key_status(int(st.key[i, j])) != Status.DEAD
                     and self.joined(j, t)]
            if rr:
                # §4.3 round-robin walks the node's per-epoch Feistel
                # shuffle; believed-dead targets probed, fail fast; a
                # not-yet-joined target means an idle period
                ti = py_round_robin_target(i, epoch, pos, n)
                if not self.joined(ti, t):
                    continue
            else:
                if not cands:
                    continue
                ti = _select_uniform(rnd.target_u[i], cands)
            target[i] = ti
            cands2 = [j for j in cands if j != ti]
            if cands2:
                proxies[i] = [_select_uniform(rnd.proxy_u[i, s], cands2)
                              for s in range(k)]
            else:
                proxies[i] = []

        # ---- Waves. Each wave: selections from wave-start state, all
        # deliveries merged at wave end (the lattice join commutes). ----

        def run_wave(messages):
            """messages: list of (src, dst, u_loss, forced_subject)."""
            # selections & counter increments from wave-start state
            sends = []
            for src, dst, u_loss, forced in messages:
                sel = self.piggyback_selection(src, forced)
                payload = [(j, int(st.key[src, j])) for j in sel]
                ok = self.delivered(src, dst, t, u_loss)
                sends.append((src, dst, ok, payload, sel))
            # counters advance for every *sent* message (delivered or not)
            for src, dst, ok, payload, sel in sends:
                for j in sel:
                    st.retransmit[src, j] += 1
            # deliveries merge at wave end
            for src, dst, ok, payload, sel in sends:
                if ok:
                    for j, kj in payload:
                        self._merge_update(dst, j, kj, t)
            return sends

        def buddy_subject(src: int, dst: int) -> int:
            """Force-include dst's suspect update when pinging it (Lifeguard)."""
            if (cfg.lifeguard and cfg.buddy
                    and key_status(int(st.key[src, dst])) == Status.SUSPECT):
                return dst
            return -1

        # W1: direct pings i → T(i)
        w1 = run_wave([(i, target[i], rnd.loss_w1[i], buddy_subject(i, target[i]))
                       for i in sorted(target)])
        got_ping = {}
        for src, dst, ok, *_ in w1:
            if ok:
                got_ping.setdefault(dst, []).append(src)

        # W2: acks T(i) → i for every ping that arrived
        w2 = run_wave([(dst, src, rnd.loss_w2[src], -1)
                       for dst in sorted(got_ping) for src in got_ping[dst]])
        acked = {src for _, src, ok, *_ in w2 if ok}

        # W3: ping-req fan-out from probers whose direct ack did not arrive
        need_indirect = [i for i in sorted(target)
                         if i not in acked and proxies[i]]
        w3_msgs, w3_tag = [], []
        for i in need_indirect:
            for s in range(k):
                w3_msgs.append((i, proxies[i][s], rnd.loss_w3[i, s], -1))
                w3_tag.append((i, s))
        w3 = run_wave(w3_msgs)
        w3_ok = {tag: m[2] for tag, m in zip(w3_tag, w3)}

        # W4: proxies probe the target on the requester's behalf
        w4_msgs, w4_tag = [], []
        for i in need_indirect:
            for s in range(k):
                if w3_ok[(i, s)]:
                    w4_msgs.append((proxies[i][s], target[i],
                                    rnd.loss_w4[i, s],
                                    buddy_subject(proxies[i][s], target[i])))
                    w4_tag.append((i, s))
        w4 = run_wave(w4_msgs)
        w4_ok = {tag: m[2] for tag, m in zip(w4_tag, w4)}

        # W5: target acks each proxy whose ping arrived
        w5_msgs, w5_tag = [], []
        for (i, s), ok in w4_ok.items():
            if ok:
                w5_msgs.append((target[i], proxies[i][s], rnd.loss_w5[i, s], -1))
                w5_tag.append((i, s))
        w5 = run_wave(w5_msgs)
        w5_ok = {tag: m[2] for tag, m in zip(w5_tag, w5)}

        # W6: proxies relay the ack back to the requester
        w6_msgs, w6_tag = [], []
        for (i, s), ok in w5_ok.items():
            if ok:
                w6_msgs.append((proxies[i][s], i, rnd.loss_w6[i, s], -1))
                w6_tag.append((i, s))
        w6 = run_wave(w6_msgs)
        relayed = {i for (i, s), m in zip(w6_tag, w6) if m[2]}

        # ---- End of period bookkeeping (docs/PROTOCOL.md §3) ----

        # 1. probe verdicts (health S read at probe time, updated after)
        for i in sorted(target):
            ok = (i in acked) or (i in relayed)
            s_probe = int(st.lha[i])
            if cfg.lifeguard:
                # LHA score: failed round raises S, clean round lowers it.
                s_new = s_probe + (1 if not ok else -1)
                st.lha[i] = np.int32(min(max(s_new, 0), cfg.lha_max))
            if ok:
                continue
            if cfg.lifeguard:
                # LHA probe thinning: unhealthy nodes are proportionally less
                # likely to raise a suspicion this period (PROTOCOL.md §7).
                if not (np.float32(rnd.lha_u[i])
                        < np.float32(1.0) / np.float32(1 + s_probe)):
                    continue
            tgt = target[i]
            cur = int(st.key[i, tgt])
            if key_status(cur) == Status.ALIVE:
                v = key_incarnation(cur)
                self._merge_update(i, tgt, opinion_key(Status.SUSPECT, v), t)

        # 2. refutation: a live node that sees itself suspected bumps its
        #    incarnation and gossips the new ALIVE.
        for j in up:
            cur = int(st.key[j, j])
            if key_status(cur) == Status.SUSPECT:
                v = key_incarnation(cur)
                st.key[j, j] = np.uint32(opinion_key(Status.ALIVE, v + 1))
                st.retransmit[j, j] = 0
                st.deadline[j, j] = NO_DEADLINE
                if cfg.lifeguard:
                    st.lha[j] = np.int32(min(int(st.lha[j]) + 1, cfg.lha_max))

        # 3. suspicion expiry → declare dead, gossip the confirm
        for i in up:
            for j in range(n):
                if (key_status(int(st.key[i, j])) == Status.SUSPECT
                        and int(st.deadline[i, j]) <= t):
                    v = key_incarnation(int(st.key[i, j]))
                    st.key[i, j] = np.uint32(opinion_key(Status.DEAD, v))
                    st.retransmit[i, j] = 0
                    st.deadline[i, j] = NO_DEADLINE

        st.step = t + 1

    def run(self, key, periods: int) -> OracleState:
        """`periods` periods of the port's draws from the threefry key
        `key` (`threefry.key(seed)`), drawn on the CPU."""
        from swim_tpu_torch.utils import prng

        for _ in range(periods):
            self.step(prng.to_numpy(
                prng.draw_period(key, self.state.step, self.cfg, "cpu")))
        return self.state

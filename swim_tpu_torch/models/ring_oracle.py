"""Scalar (numpy) twin of the ring engine (port of
`swim_tpu/models/ring_oracle.py`) — the bitwise gold standard.

The port's engine is models/ring.py and its parity test
tests/test_torch_oracle.py.  `step` reads numpy randomness: a period's
draws go through `to_numpy` first, which copies them to the host and
views the port's int32 carriers of the u32 loss thresholds as uint32
(the only place the carrier is undone).

Implements the ring engine's documented semantics — rotor waves,
word recycling, dissemination floor, top-C views, sentinel expiry, fresh-
lane allocation — in deliberately plain numpy, phase by phase, consuming
the SAME RingRandomness tensors, so tests/test_ring.py can require
bitwise-equal RingState trajectories in every regime (crash, loss,
partition, join, Lifeguard).  Deliberately unoptimized: clarity is the
point; it runs at N ≤ a few hundred.

The one structural liberty: per-node heard-bits are a bool matrix
`knows[N, R]` over ring slots instead of packed win/cold words; the
engine's (win, cold) pair is reconstructed for comparison by
`packed_state()`, and `mismatches` compares an engine state with the
oracle's as the reference's tests do.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models.ring import (WORD, PullRandomness, RingGeometry,
                                        RingRandomness, geometry)
from swim_tpu_torch.models.rumor import dynamic_timeout_py
from swim_tpu_torch.sim import faults as _faults
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.types import Status, key_incarnation, key_status, opinion_key
from swim_tpu_torch.utils.prng import host

# RingRandomness fields the reference draws as u32 (int32 carriers here)
_U32_DRAWS = frozenset({"loss_w1", "loss_w2", "loss_w3", "loss_w4",
                        "loss_w5", "loss_w6", "lha_u"})


def to_numpy(rnd: RingRandomness) -> RingRandomness:
    """A period's RingRandomness (tensors on any device) as numpy
    arrays in the reference's dtypes: the u32 draws viewed as uint32,
    the rest as they are."""
    fields = {}
    for name in RingRandomness._fields:
        if name == "pull":
            continue
        a = host(getattr(rnd, name))
        fields[name] = a.view(np.uint32) if name in _U32_DRAWS else a
    pull = None if rnd.pull is None else PullRandomness(
        *(host(x) for x in rnd.pull))
    return RingRandomness(pull=pull, **fields)


def _is_suspect(key: int) -> bool:
    return key_status(key) == Status.SUSPECT


def _is_dead(key: int) -> bool:
    return key_status(key) == Status.DEAD


@dataclasses.dataclass
class OracleRingState:
    knows: np.ndarray      # bool[N, R] heard-bits by ring slot
    inc_self: np.ndarray   # u32[N]
    lha: np.ndarray        # i32[N]
    gone_key: np.ndarray   # u32[N]
    subject: np.ndarray    # i32[R]
    rkey: np.ndarray       # u32[R]
    birth0: np.ndarray     # i32[R]
    sent_node: np.ndarray  # i32[R, S]
    sent_time: np.ndarray  # i32[R, S]
    confirmed: np.ndarray  # bool[R]
    overflow: int
    index_overflow: int
    step: int


class RingOracle:
    def __init__(self, cfg: SwimConfig, plan: FaultPlan):
        self.cfg = cfg
        self.g: RingGeometry = geometry(cfg)
        self.plan = _faults.to_numpy(plan)
        n, r, s = cfg.n_nodes, self.g.rw * WORD, cfg.sentinels
        self.state = OracleRingState(
            knows=np.zeros((n, r), bool),
            inc_self=np.zeros(n, np.uint32),
            lha=np.zeros(n, np.int32),
            gone_key=np.zeros(n, np.uint32),
            subject=np.full(r, -1, np.int32),
            rkey=np.zeros(r, np.uint32),
            birth0=np.zeros(r, np.int32),
            sent_node=np.full((r, s), -1, np.int32),
            sent_time=np.zeros((r, s), np.int32),
            confirmed=np.zeros(r, bool),
            overflow=0, index_overflow=0, step=0,
        )

    # ------------------------------------------------------------- helpers

    def _ring_col(self, gword: int) -> int:
        return int(np.mod(gword, self.g.rw))

    def _lane_slots(self, gword0: int) -> list[int]:
        """Ring slots of OB consecutive lanes starting at global word 0."""
        out = []
        for la in range(self.g.ow * WORD):
            out.append(self._ring_col(gword0 + la // WORD) * WORD
                       + la % WORD)
        return out

    # ---------------------------------------------------------------- step

    def step(self, rnd: RingRandomness) -> OracleRingState:
        cfg, g, st, plan = self.cfg, self.g, self.state, self.plan
        n, k = cfg.n_nodes, cfg.k_indirect
        r_tot, s_cap = g.rw * WORD, cfg.sentinels
        ob = g.ow * WORD
        t = st.step
        crashed = t >= plan.crash_step
        joined = t >= plan.join_step
        active = ~crashed & joined
        part_on = bool(plan.partition_start <= t < plan.partition_end)
        live_total = int(active.sum())
        loss = float(plan.loss)
        pid = plan.partition_id

        s_off = int(np.asarray(rnd.s_off))
        q_off = [int(x) for x in np.asarray(rnd.q_off)]
        u = {name: np.asarray(getattr(rnd, name))
             for name in ("loss_w1", "loss_w2", "loss_w3", "loss_w4",
                          "loss_w5", "loss_w6", "lha_u")}

        entry_gw0 = t * g.ow - g.ww
        fresh_gw0 = t * g.ow

        # --- Phase 0a: judge outgoing lanes --------------------------------
        # All decisions are made against the ENTRY-state table (the engine
        # evaluates glob_refuted/dissemination vectorized over the
        # unmodified state), so snapshot before applying any frees.
        out_slots = self._lane_slots(entry_gw0)
        entry_subject = st.subject.copy()
        entry_rkey = st.rkey.copy()
        entry_gone = st.gone_key.copy()
        carry = np.zeros(ob, bool)
        for la, sl in enumerate(out_slots):
            if entry_subject[sl] < 0:
                continue
            knowers = int((st.knows[:, sl] & active).sum())
            dissem = knowers >= live_total
            in_budget = (t - int(st.birth0[sl])) < g.spread
            key = int(entry_rkey[sl])
            sub = int(entry_subject[sl])
            refuted = bool(
                ((entry_subject == sub) & (entry_subject >= 0)
                 & (entry_rkey > key)).any()) or int(entry_gone[sub]) > key
            pending = (_is_suspect(key) and not st.confirmed[sl]
                       and not refuted)
            if not dissem and in_budget:
                carry[la] = True
            elif pending:
                pass                              # keep at the cold slot
            else:
                if dissem:
                    st.gone_key[sub] = max(st.gone_key[sub],
                                           np.uint32(key))
                elif _is_dead(key):
                    st.overflow += 1              # lost death certificate
                st.subject[sl] = -1

        # --- Phase 0b: invalidate previous generation of fresh lanes -------
        fresh_slots = self._lane_slots(fresh_gw0)
        for sl in fresh_slots:
            if st.subject[sl] < 0:
                continue
            knowers = int((st.knows[:, sl] & active).sum())
            sub = int(st.subject[sl])
            if knowers >= live_total:
                st.gone_key[sub] = max(st.gone_key[sub], st.rkey[sl])
            st.subject[sl] = -1

        # --- Phase 0c: move carried lanes ----------------------------------
        for la in range(ob):
            if not carry[la]:
                continue
            src, dst = out_slots[la], fresh_slots[la]
            st.subject[dst] = st.subject[src]
            st.rkey[dst] = st.rkey[src]
            st.birth0[dst] = st.birth0[src]
            st.confirmed[dst] = st.confirmed[src]
            st.sent_node[dst] = st.sent_node[src]
            st.sent_time[dst] = st.sent_time[src]
            st.knows[:, dst] = st.knows[:, src]
            st.subject[src] = -1
            # the old column's bits stay (the engine's flush writes the
            # full outgoing column to cold; freed slots' bits are stale
            # by contract and never consulted)
        for la in range(ob):                      # fresh non-carried: clean
            if not carry[la]:
                sl = fresh_slots[la]
                st.sent_node[sl] = -1
                st.sent_time[sl] = 0
                st.confirmed[sl] = False
                st.knows[:, sl] = False

        # --- per-subject top-C index (R3) ----------------------------------
        used = st.subject >= 0
        top = {s: [] for s in range(n)}           # subject -> [(key, slot)]
        for sl in np.nonzero(used)[0]:
            top[int(st.subject[sl])].append((int(st.rkey[sl]), int(sl)))
        top_c = {}
        sus_best = {}
        for s, entries in top.items():
            if not entries:
                continue
            entries.sort(key=lambda e: (-e[0], -e[1]))
            top_c[s] = entries[:g.c]
            if len(entries) > g.c:
                st.index_overflow += 1
            sus = [(kk, sl) for kk, sl in entries if _is_suspect(kk)]
            if sus:
                sus_best[s] = max(sus, key=lambda e: (e[0], e[1]))

        def knows_bit(node: int, slot: int) -> bool:
            return slot >= 0 and bool(st.knows[node, slot])

        def view_of(node: int, subj: int) -> int:
            best = max(opinion_key(Status.ALIVE, 0), int(st.gone_key[subj]))
            for kk, sl in top_c.get(subj, []):
                if knows_bit(node, sl):
                    best = max(best, kk)
            return best

        # --- Phases A+B: rotor waves ---------------------------------------
        window_slots = []
        first_gw = entry_gw0 + g.ow
        for w in range(g.ww):
            col = self._ring_col(first_gw + w)
            for b in range(WORD):
                window_slots.append(col * WORD + b)

        # Deviation R5 (docs/PROTOCOL.md): in "period" selection scope the
        # piggyback selection AND buddy knowledge are evaluated against a
        # start-of-period snapshot of the heard-bits; deliveries still
        # write st.knows live.  In "wave" scope sel_knows aliases st.knows,
        # so every wave's selection sees earlier waves' deliveries (exact
        # SWIM semantics).
        sel_knows = (st.knows.copy() if cfg.ring_sel_scope == "period"
                     else st.knows)

        def select_b(node: int) -> list[int]:
            """First-B transmissible window slots known to node, newest
            word first, LSB first within a word."""
            picked = []
            for w in range(g.ww - 1, -1, -1):
                for b in range(WORD):
                    sl = window_slots[w * WORD + b]
                    if (st.subject[sl] >= 0 and sel_knows[node, sl]):
                        picked.append(sl)
                        if len(picked) >= min(cfg.max_piggyback,
                                              g.ww * WORD):
                            return picked
            return picked

        def buddy(node: int, subj: int) -> list[int]:
            if not (cfg.lifeguard and cfg.buddy):
                return []
            e = sus_best.get(subj)
            if (e and e[1] >= 0 and bool(sel_knows[node, e[1]])
                    and e[1] in window_slots):
                return [e[1]]
            return []

        # integer loss threshold, mirroring the engine exactly: the
        # loss_w*/lha_u tensors carry raw u16 draws and delivery is
        # bits >= ceil(loss*65536) (see ring.RingRandomness)
        loss_thr = int(np.ceil(np.float32(loss) * np.float32(65536.0)))

        def delivered(src: int, dst: int, uu: int) -> bool:
            if not (active[src] and active[dst]):
                return False
            if part_on and pid[src] != pid[dst]:
                return False
            return uu >= loss_thr

        lha = st.lha.copy()
        if cfg.ring_probe == "rotor":
            # W1 + W2 (selection state mutates between waves, so evaluate
            # all of a wave's selections BEFORE any of its deliveries)
            tgt = [(i + s_off) % n for i in range(n)]
            # a not-yet-joined target: in nobody's membership list
            prober_mask = active & joined[np.asarray(tgt)]
            w1_payload = {}
            for i in range(n):
                if prober_mask[i]:
                    w1_payload[i] = select_b(i) + buddy(i, tgt[i])
            ok1 = np.zeros(n, bool)               # indexed by receiver j
            for j in range(n):
                i = (j - s_off) % n
                if i in w1_payload and delivered(i, j,
                                                 int(u["loss_w1"][j])):
                    ok1[j] = True
            for j in np.nonzero(ok1)[0]:
                for sl in w1_payload[(j - s_off) % n]:
                    st.knows[j, sl] = True

            w2_payload = {}
            for j in np.nonzero(ok1)[0]:
                w2_payload[int(j)] = select_b(int(j))
            ok2 = np.zeros(n, bool)               # indexed by receiver i
            for i in range(n):
                j = (i + s_off) % n
                if j in w2_payload and delivered(j, i,
                                                 int(u["loss_w2"][i])):
                    ok2[i] = True
            for i in np.nonzero(ok2)[0]:
                for sl in w2_payload[(i + s_off) % n]:
                    st.knows[i, sl] = True
            acked = ok2 & prober_mask

            need = prober_mask & ~acked
            relayed = np.zeros(n, bool)
            for a in range(k):
                q = q_off[a]
                d4 = s_off - q
                # W3
                p3 = {i: select_b(i) for i in range(n) if need[i]}
                ok3 = np.zeros(n, bool)           # by receiver p
                for p in range(n):
                    i = (p - q) % n
                    if i in p3 and delivered(i, p,
                                             int(u["loss_w3"][p, a])):
                        ok3[p] = True
                for p in np.nonzero(ok3)[0]:
                    for sl in p3[(p - q) % n]:
                        st.knows[p, sl] = True
                # W4
                p4 = {}
                for p in np.nonzero(ok3)[0]:
                    jj = (p + d4) % n
                    p4[int(p)] = select_b(int(p)) + buddy(int(p), jj)
                ok4 = np.zeros(n, bool)           # by receiver j
                for j in range(n):
                    p = (j - d4) % n
                    if p in p4 and delivered(p, j,
                                             int(u["loss_w4"][j, a])):
                        ok4[j] = True
                for j in np.nonzero(ok4)[0]:
                    for sl in p4[(j - d4) % n]:
                        st.knows[j, sl] = True
                # W5
                p5 = {int(j): select_b(int(j))
                      for j in np.nonzero(ok4)[0]}
                ok5 = np.zeros(n, bool)           # by receiver p
                for p in range(n):
                    j = (p + d4) % n
                    if j in p5 and delivered(j, p,
                                             int(u["loss_w5"][p, a])):
                        ok5[p] = True
                for p in np.nonzero(ok5)[0]:
                    for sl in p5[(p + d4) % n]:
                        st.knows[p, sl] = True
                # W6
                p6 = {int(p): select_b(int(p))
                      for p in np.nonzero(ok5)[0]}
                ok6 = np.zeros(n, bool)           # by receiver i
                for i in range(n):
                    p = (i + q) % n
                    if p in p6 and delivered(p, i,
                                             int(u["loss_w6"][i, a])):
                        ok6[i] = True
                for i in np.nonzero(ok6)[0]:
                    for sl in p6[(i + q) % n]:
                        st.knows[i, sl] = True
                relayed |= ok6 & need

            probe_ok = acked | relayed
            failed = prober_mask & ~probe_ok
            s_probe = st.lha.copy()
            if cfg.lifeguard:
                for i in range(n):
                    if prober_mask[i]:    # idle periods leave LHA alone
                        lha[i] = min(max(lha[i] + (1 if failed[i] else -1),
                                         0), cfg.lha_max)
                for i in range(n):
                    if failed[i] and not (int(u["lha_u"][i])
                                          * (1 + int(s_probe[i])) < 65536):
                        failed[i] = False
            susp_sub = list(tgt)
            susp_org = list(range(n))
            view_rows = list(range(n))
        else:
            # pull-uniform mode: mirror of ring.py's pull branch
            # (deviations P1-P4 there), same operation order: all
            # selections precomputed, all deliveries applied, THEN views.
            from swim_tpu_torch.models.ring import PULL_SRC_ATTEMPTS, py_pow_f32

            pr = rnd.pull
            m_u = np.asarray(pr.m_u)
            src_u = np.asarray(pr.src_u)
            d_fwd = np.asarray(pr.d_fwd)
            d_back = np.asarray(pr.d_back)
            px_u = np.asarray(pr.px_u)
            px_fwd = np.asarray(pr.px_fwd)
            px_back = np.asarray(pr.px_back)
            ack_u = np.asarray(pr.ack_u)
            ack_leg = np.asarray(pr.ack_leg)
            members_i = int(joined.sum())
            denom = np.float32(max(members_i - 1, 1))
            base0 = float(np.float32(np.float32(1.0)
                                     - np.float32(1.0) / denom))
            lf = np.float32(loss)
            thr2 = np.float32(1.0) - (np.float32(1.0) - lf) * (
                np.float32(1.0) - lf)
            sel_cache = {i: select_b(i) for i in range(n)}
            live_total_i = int(active.sum())

            def draw_id(j: int, uu) -> int:
                idx = int(np.float32(uu) * np.float32(n - 1))
                idx = min(idx, n - 2)
                return idx + (1 if idx >= j else 0)

            def cut(a_id: int, b_id: int) -> bool:
                return part_on and pid[a_id] != pid[b_id]

            failed = np.zeros(n, bool)
            src_arr = np.zeros(n, np.int32)
            deliveries: list[tuple[int, int]] = []   # (dst, sender)
            for j in range(n):
                ljj = live_total_i - (1 if active[j] else 0)
                if members_i >= 2:
                    p0j = np.float32(py_pow_f32(base0, max(ljj, 0)))
                else:
                    p0j = np.float32(1.0)
                probed = (np.float32(m_u[j]) >= p0j) and joined[j]
                src = draw_id(j, src_u[j, 0])
                src_ok = bool(active[src])
                for a in range(1, PULL_SRC_ATTEMPTS):
                    nxt = draw_id(j, src_u[j, a])
                    if not src_ok:
                        src = nxt
                    src_ok = src_ok or bool(active[nxt])
                src_arr[j] = src
                probe_live = probed and src_ok
                d_ok = (probe_live and active[j] and not cut(src, j)
                        and np.float32(d_fwd[j]) >= lf)
                if d_ok:
                    deliveries.append((j, src))
                acked_lane = d_ok and np.float32(d_back[j]) >= lf
                need = probe_live and not acked_lane
                relayed_lane = False
                px_deliver = False
                px_src = 0
                for b in range(k):
                    p_b = draw_id(j, px_u[j, b])
                    path_up = (need and active[p_b] and not cut(src, p_b)
                               and not cut(p_b, j))
                    w4_ok = (path_up and active[j]
                             and np.float32(px_fwd[j, b]) >= thr2)
                    if w4_ok and not px_deliver:
                        px_src = p_b
                        px_deliver = True
                    if w4_ok and np.float32(px_back[j, b]) >= thr2:
                        relayed_lane = True
                if px_deliver:
                    deliveries.append((j, px_src))
                aq = draw_id(j, ack_u[j])
                if (active[j] and active[aq] and not cut(j, aq)
                        and np.float32(ack_leg[j]) >= thr2):
                    deliveries.append((j, aq))
                failed[j] = probe_live and not (acked_lane or relayed_lane)
            for dst, sender in deliveries:
                for sl in sel_cache[sender]:
                    st.knows[dst, sl] = True
            susp_sub = list(range(n))
            susp_org = [int(x) for x in src_arr]
            view_rows = [int(x) for x in src_arr]

        # --- Phase C: suspicion verdicts (views read post-delivery) ---------
        mk_suspect = np.zeros(n, bool)
        re_suspect = np.zeros(n, bool)
        susp_key = np.zeros(n, np.uint32)
        for i in range(n):
            if not failed[i]:
                continue
            vk = view_of(view_rows[i], susp_sub[i])
            stt = key_status(vk)
            if stt == Status.ALIVE:
                mk_suspect[i] = True
            elif stt == Status.SUSPECT:
                re_suspect[i] = True
            susp_key[i] = opinion_key(Status.SUSPECT, key_incarnation(vk))

        refute = np.zeros(n, bool)
        new_inc = st.inc_self.copy()
        for i in range(n):
            if not active[i]:
                continue
            e = sus_best.get(i)
            if e and knows_bit(i, e[1]) \
                    and e[0] > opinion_key(Status.ALIVE,
                                           int(st.inc_self[i])):
                refute[i] = True
                new_inc[i] = np.uint32(key_incarnation(e[0]) + 1)
                if cfg.lifeguard:
                    lha[i] = min(lha[i] + 1, cfg.lha_max)

        # sentinel expiry
        confirm = np.zeros(r_tot, bool)
        conf_node = np.zeros(r_tot, np.int32)
        for sl in np.nonzero(st.subject >= 0)[0]:
            key = int(st.rkey[sl])
            if not _is_suspect(key) or st.confirmed[sl]:
                continue
            sub = int(st.subject[sl])
            dead_key = opinion_key(Status.DEAD, key_incarnation(key))
            if dead_key <= int(st.gone_key[sub]):
                continue
            filled = int((st.sent_node[sl] >= 0).sum())
            if cfg.lifeguard and cfg.dynamic_suspicion:
                tout = dynamic_timeout_py(cfg, filled)
            else:
                tout = cfg.suspicion_periods
            for si in range(s_cap):
                nd = int(st.sent_node[sl, si])
                if nd < 0 or plan.crash_step[nd] <= t:
                    continue
                if t < int(st.sent_time[sl, si]) + tout:
                    continue
                hk = int(st.gone_key[sub]) > key
                for kk, osl in top_c.get(sub, []):
                    if kk > key and knows_bit(nd, osl):
                        hk = True
                        break
                if not hk:
                    confirm[sl] = True
                    conf_node[sl] = nd
                    break

        # --- Phase D: new originations -------------------------------------
        cands = []                                # (subj, key, orig, srcslot,
        #                                            is_susp)
        for sl in np.nonzero(confirm)[0]:
            cands.append((int(st.subject[sl]),
                          opinion_key(Status.DEAD,
                                      key_incarnation(int(st.rkey[sl]))),
                          int(conf_node[sl]), int(sl), False))
        for i in range(n):
            if refute[i]:
                cands.append((i, opinion_key(Status.ALIVE, int(new_inc[i])),
                              i, -1, False))
        for i in range(n):
            if mk_suspect[i] or re_suspect[i]:
                cands.append((susp_sub[i], int(susp_key[i]),
                              susp_org[i], -1, True))
        total = len(cands)
        cands = cands[:ob]
        self.state.overflow = st.overflow + max(total - ob, 0)
        st.overflow = self.state.overflow

        free_lanes = [la for la in range(ob) if not carry[la]]
        seen = {}
        alloc_i = 0
        placements = []                           # (cand, slot, fresh?)
        for cand in cands:
            subj, key, orig, srcslot, is_susp = cand
            if (subj, key) in seen:
                placements.append((cand, seen[(subj, key)], False))
                continue
            existing = np.nonzero((st.subject == subj)
                                  & (st.rkey == np.uint32(key)))[0]
            if existing.size:
                sl = int(existing[0])
                seen[(subj, key)] = sl
                placements.append((cand, sl, False))
                continue
            if alloc_i < len(free_lanes):
                sl = fresh_slots[free_lanes[alloc_i]]
                alloc_i += 1
                seen[(subj, key)] = sl
                placements.append((cand, sl, True))
            else:
                st.overflow += 1

        for (subj, key, orig, srcslot, is_susp), sl, fresh in placements:
            if fresh:
                st.subject[sl] = subj
                st.rkey[sl] = np.uint32(key)
                st.birth0[sl] = t
                st.confirmed[sl] = False
                st.sent_node[sl] = -1
                st.sent_time[sl] = 0
                st.knows[:, sl] = False
                st.knows[orig, sl] = True
            if is_susp and st.subject[sl] >= 0:
                row = st.sent_node[sl]
                if orig not in row[row >= 0]:
                    fill = int((row >= 0).sum())
                    if fill < s_cap:
                        st.sent_node[sl, fill] = orig
                        st.sent_time[sl, fill] = t
            if (not is_susp) and srcslot >= 0:
                st.confirmed[srcslot] = True

        for i in range(n):
            if active[i]:
                st.inc_self[i] = new_inc[i]
                st.lha[i] = lha[i]
        st.step = t + 1
        return st

    # ------------------------------------------------------- comparison

    def packed_state(self):
        """(win, cold) u32 arrays equivalent to the engine's packing."""
        st, g = self.state, self.g
        n = self.cfg.n_nodes
        t = st.step
        first_gw = t * g.ow - g.ww
        win = np.zeros((n, g.ww), np.uint32)
        win_cols = set()
        for w in range(g.ww):
            col = self._ring_col(first_gw + w)
            win_cols.add(col)
            for b in range(WORD):
                sl = col * WORD + b
                win[:, w] |= (st.knows[:, sl].astype(np.uint32) << b)
        cold = np.zeros((n, g.rw), np.uint32)
        for col in range(g.rw):
            for b in range(WORD):
                sl = col * WORD + b
                cold[:, col] |= (st.knows[:, sl].astype(np.uint32) << b)
        return win, cold, sorted(win_cols)


def mismatches(orc: RingOracle, got: dict) -> list[str]:
    """The state fields in which the engine's state `got` (field name ->
    numpy array in the reference's dtypes, `convert.state_to_numpy`)
    differs from the oracle's, compared as the reference's
    tests/test_ring.py compares them: the table metadata only on live
    slots (`subject >= 0`; freed slots legitimately hold stale values)
    and `cold` only outside the window's columns (the engine flushes a
    window column into cold lazily, so cold's copy of a current window
    column is one generation stale by design)."""
    st = orc.state
    win, cold, win_cols = orc.packed_state()
    bad = []
    if not np.array_equal(win, got["win"]):
        bad.append("win")
    mask = np.ones(cold.shape[1], bool)
    mask[win_cols] = False
    if not np.array_equal(cold[:, mask], got["cold"].T[:, mask]):
        bad.append("cold")
    if not np.array_equal(st.subject, got["subject"]):
        bad.append("subject")
    live = st.subject >= 0
    for name in ("rkey", "birth0", "sent_node", "sent_time", "confirmed"):
        if not np.array_equal(getattr(st, name)[live], got[name][live]):
            bad.append(name)
    for name in ("inc_self", "lha", "gone_key"):
        if not np.array_equal(getattr(st, name), got[name]):
            bad.append(name)
    for name in ("overflow", "index_overflow"):
        if int(getattr(st, name)) != int(got[name]):
            bad.append(name)
    return bad

"""Scalar rumor-table oracle (port of `swim_tpu/models/rumor_oracle.py`) —
the readable gold standard for the rumor engine.

The port keeps the reference's text below; its engine is the port's
models/rumor.py, its draws the port's (`step` takes them as tensors on
any device or as numpy arrays, all float32), and its parity test
tests/test_torch_oracle.py.

The dense oracle (models/oracle.py) validates the dense engine, but
the rumor engine's full lifecycle — sentinel-based suspicion expiry,
Lifeguard dynamic timeouts, rumor retirement, tombstones, the origination
budget — deviates from the dense protocol by design (rumor.py docstring,
deviations 1–4), so round 1 could only validate it bitwise *pre-expiry*.
This module closes that gap: it implements the rumor engine's documented
semantics one message at a time in plain Python + NumPy, and
tests/test_rumor_vs_scalar.py enforces **bitwise identical** RumorState
evolution under the same RumorRandomness, through every phase, with
Lifeguard dynamic suspicion on or off.

Mirror discipline: every ordering rule the vectorized engine inherits from
its primitives is spelled out here as an explicit scalar rule —

  * candidate order  = (age, slot) ascending over eligible rumors, then
    ineligible slots by index (lax.top_k is stable on ties);
  * per-sender piggyback = first B known candidates in candidate order;
  * argmax witnesses (buddy, refutation) = FIRST index attaining the max;
  * origination order = table confirms by slot, refutes by node id,
    suspicions by node id; first `budget` valid candidates win;
  * slot allocation  = free slots in slot order;
  * sentinel joins   = candidate order within a rumor, first-free positions.

Deliberately unoptimized (clarity over speed; fine to a few hundred nodes).
Reference parity note: the reference (jpfuentes2/swim, Haskell — tree
unavailable at survey time, SURVEY.md §0) has no simulator; this oracle
specifies the TPU simulator's semantics, not the reference's code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models.rumor import (RESAMPLE_ATTEMPTS, RumorRandomness,
                                   _budget, _pig_window, dynamic_timeout_py)
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.types import (Status, key_incarnation, key_status,
                            opinion_key)


def _alive_key(inc: int) -> int:
    return opinion_key(Status.ALIVE, inc)


def _suspect_key(inc: int) -> int:
    return opinion_key(Status.SUSPECT, inc)


def _dead_key(inc: int) -> int:
    return opinion_key(Status.DEAD, inc)


def _is_suspect(key: int) -> bool:
    return key_status(key) == Status.SUSPECT


def _is_dead(key: int) -> bool:
    return key_status(key) == Status.DEAD


@dataclasses.dataclass
class RumorOracleState:
    """Field-for-field scalar mirror of rumor.RumorState."""

    knows: np.ndarray      # bool[N, R]
    inc_self: np.ndarray   # u32[N]
    lha: np.ndarray        # i32[N]
    gone_key: np.ndarray   # u32[N]
    subject: np.ndarray    # i32[R]
    rkey: np.ndarray       # u32[R]
    birth: np.ndarray      # i32[R]
    sent_node: np.ndarray  # i32[R, S]
    sent_time: np.ndarray  # i32[R, S]
    confirmed: np.ndarray  # bool[R]
    overflow: int
    step: int


def init_state(cfg: SwimConfig) -> RumorOracleState:
    n, r, s = cfg.n_nodes, cfg.rumor_slots, cfg.sentinels
    return RumorOracleState(
        knows=np.zeros((n, r), bool),
        inc_self=np.zeros((n,), np.uint32),
        lha=np.zeros((n,), np.int32),
        gone_key=np.zeros((n,), np.uint32),
        subject=np.full((r,), -1, np.int32),
        rkey=np.zeros((r,), np.uint32),
        birth=np.zeros((r,), np.int32),
        sent_node=np.full((r, s), -1, np.int32),
        sent_time=np.zeros((r, s), np.int32),
        confirmed=np.zeros((r,), bool),
        overflow=0,
        step=0,
    )


class RumorOracle:
    """Drives RumorOracleState one protocol period at a time."""

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

    def delivered(self, src: int, dst: int, t: int, u_loss) -> bool:
        if not (self.active(src, t) and self.active(dst, t)):
            return False
        p = self.plan
        if (int(p.partition_start) <= t < int(p.partition_end)
                and int(p.partition_id[src]) != int(p.partition_id[dst])):
            return False
        return np.float32(u_loss) >= np.float32(p.loss)

    # -- views (derived) ---------------------------------------------------

    def _opinion(self, i: int, subj: int) -> tuple[int, int]:
        """(key, witness rumor index or -1): i's view of subj via the
        heard-rumor join, floored at max(ALIVE(0), tombstone)."""
        st = self.state
        best, arg = 0, 0
        for r in range(self.cfg.rumor_slots):
            if (st.subject[r] == subj and st.subject[r] >= 0
                    and st.knows[i, r] and int(st.rkey[r]) > best):
                best, arg = int(st.rkey[r]), r
        floor = max(_alive_key(0), int(st.gone_key[subj]))
        if best > floor:
            return best, arg
        return floor, -1

    def _believes_dead(self, i: int, subj: int) -> bool:
        st = self.state
        if _is_dead(int(st.gone_key[subj])):
            return True
        for r in range(self.cfg.rumor_slots):
            if (st.subject[r] == subj and st.subject[r] >= 0
                    and st.knows[i, r] and _is_dead(int(st.rkey[r]))):
                return True
        return False

    # -- one protocol period ----------------------------------------------

    def step(self, rnd: RumorRandomness) -> None:
        from swim_tpu_torch.utils import prng as _prng

        cfg, st = self.cfg, self.state
        n, k, r_cap, s_cap = (cfg.n_nodes, cfg.k_indirect, cfg.rumor_slots,
                              cfg.sentinels)
        t = st.step
        base = _prng.to_numpy(rnd.base)
        resample_u = _prng.host(rnd.resample_u)
        up = [i for i in range(n) if self.active(i, t)]
        up_set = set(up)

        # ---- Phase 0: retirement (rumor.py deviation 1 + tombstones) ----
        used0 = st.subject >= 0
        age = t - st.birth
        window = cfg.gossip_window
        pend_horizon = (cfg.suspicion_max_periods
                        if cfg.lifeguard and cfg.dynamic_suspicion
                        else cfg.suspicion_periods) + 2
        is_susp_r = np.array([_is_suspect(int(kk)) for kk in st.rkey])
        is_dead_r = np.array([_is_dead(int(kk)) for kk in st.rkey])
        # same-subject matrix from the PRE-retirement table (the engine
        # computes it in Phase 0 and reuses it for expiry refutation)
        same_subj = (st.subject[:, None] == st.subject[None, :])
        live_total = len(up)
        knowers = np.array([int(sum(st.knows[i, r] for i in up))
                            for r in range(r_cap)])
        disseminated = knowers >= live_total
        for r in range(r_cap):
            if not used0[r]:
                continue
            gone_at = int(st.gone_key[st.subject[r]])
            glob_refuted = (gone_at > int(st.rkey[r])) or any(
                used0[r2] and same_subj[r, r2]
                and int(st.rkey[r2]) > int(st.rkey[r])
                for r2 in range(r_cap))
            pending = (is_susp_r[r] and not st.confirmed[r]
                       and not glob_refuted and age[r] < pend_horizon)
            if is_dead_r[r]:
                if disseminated[r]:
                    # retire into the tombstone floor
                    subj = int(st.subject[r])
                    st.gone_key[subj] = max(int(st.gone_key[subj]),
                                            int(st.rkey[r]))
                    st.subject[r] = -1
            elif not (age[r] < window or pending):
                st.subject[r] = -1
        used = st.subject >= 0

        # ---- Phase A: probe targets & proxies (deviation 3) --------------
        def draw_tgt(i: int, u) -> int:
            idx = int(np.float32(u) * np.float32(n - 1))
            idx = min(idx, n - 2)
            return idx + (1 if idx >= i else 0)

        target: dict[int, int] = {}
        prober: set[int] = set()
        if cfg.target_selection == "round_robin":
            from swim_tpu_torch.ops.sampling import py_round_robin_target

            epoch, pos = divmod(t, n - 1)
            for i in range(n):
                target[i] = py_round_robin_target(i, epoch, pos, n)
            prober = {i for i in up if self.joined(target[i], t)}
        else:
            def bad_tgt(i, ti):
                return self._believes_dead(i, ti) or not self.joined(ti, t)

            for i in range(n):
                ti = draw_tgt(i, base.target_u[i])
                bad = bad_tgt(i, ti)
                for a in range(RESAMPLE_ATTEMPTS):
                    nxt = draw_tgt(i, resample_u[i, a])
                    if bad:
                        ti = nxt
                        bad = bad_tgt(i, ti)
                target[i] = ti
                if i in up_set and not bad and n >= 2:
                    prober.add(i)

        proxies: dict[int, list[int]] = {}
        for i in range(n):
            lo, hi = min(i, target[i]), max(i, target[i])
            row = []
            for s in range(k):
                idx2 = int(np.float32(base.proxy_u[i, s])
                           * np.float32(max(n - 2, 1)))
                idx2 = min(idx2, max(n - 3, 0))
                p = idx2 + (1 if idx2 >= lo else 0)
                p = p + (1 if p >= hi else 0)
                row.append(p)
            proxies[i] = row
        has_proxy = n > 2

        # ---- Phase B: the period's piggyback candidate order -------------
        b_pig = min(cfg.max_piggyback, r_cap)
        w_pig = _pig_window(cfg)
        eligible = [r for r in range(r_cap)
                    if used[r] and 0 <= age[r] < window]
        cand = sorted(eligible, key=lambda r: (int(age[r]), r))
        cand += [r for r in range(r_cap) if r not in set(cand)]
        cand = cand[:w_pig]
        cand_valid = [used[r] and 0 <= age[r] < window for r in cand]

        def select(i: int) -> list[int]:
            """First-B known candidates (rumor ids) in candidate order."""
            out = []
            for pos, r in enumerate(cand):
                if cand_valid[pos] and st.knows[i, r]:
                    out.append(r)
                    if len(out) == b_pig:
                        break
            return out

        def buddy(src: int, dst: int) -> int:
            """First max-key suspect rumor about dst known to src, or -1."""
            if not (cfg.lifeguard and cfg.buddy):
                return -1
            best, arg = 0, 0
            for r in range(r_cap):
                if (used[r] and st.subject[r] == dst and st.knows[src, r]
                        and int(st.rkey[r]) > best):
                    best, arg = int(st.rkey[r]), r
            return arg if _is_suspect(best) else -1

        def run_wave(messages):
            """messages: (src, dst, sent, u_loss, forced rumor id).
            Selections read wave-start state; merges land at wave end.
            Returns the per-message delivered flags."""
            sends, oks = [], []
            for src, dst, sent, u_loss, forced in messages:
                sel = select(src) if sent else []
                ok = sent and self.delivered(src, dst, t, u_loss)
                sends.append((dst, sel, forced, ok))
                oks.append(ok)
            for dst, sel, forced, ok in sends:
                if ok:
                    for r in sel:
                        st.knows[dst, r] = True
                    if forced >= 0:
                        st.knows[dst, forced] = True
            return oks

        # W1 PING i→T(i)
        w1_msgs = [(i, target[i], i in prober, base.loss_w1[i],
                    buddy(i, target[i]) if i in prober else -1)
                   for i in range(n)]
        w1_ok = run_wave(w1_msgs)
        # W2 ACK T(i)→i (loss draw indexed by the pinger i)
        w2_msgs = [(target[i], i, w1_ok[i], base.loss_w2[i], -1)
                   for i in range(n)]
        w2_ok = run_wave(w2_msgs)
        acked = {i for i in range(n) if w2_ok[i]}
        # W3 PING-REQ i→p
        need = [i for i in range(n)
                if i in prober and i not in acked and has_proxy]
        need_set = set(need)
        w3_msgs = [(i, proxies[i][s], i in need_set, base.loss_w3[i, s], -1)
                   for i in range(n) for s in range(k)]
        w3_ok = run_wave(w3_msgs)
        # W4 proxy PING p→T(i)
        w4_msgs = []
        for m, (i, s) in enumerate(((i, s) for i in range(n)
                                    for s in range(k))):
            p = proxies[i][s]
            w4_msgs.append((p, target[i], w3_ok[m], base.loss_w4[i, s],
                            buddy(p, target[i]) if w3_ok[m] else -1))
        w4_ok = run_wave(w4_msgs)
        # W5 target ACK T(i)→p
        w5_msgs = []
        for m, (i, s) in enumerate(((i, s) for i in range(n)
                                    for s in range(k))):
            w5_msgs.append((target[i], proxies[i][s], w4_ok[m],
                            base.loss_w5[i, s], -1))
        w5_ok = run_wave(w5_msgs)
        # W6 relay ACK p→i
        w6_msgs = []
        for m, (i, s) in enumerate(((i, s) for i in range(n)
                                    for s in range(k))):
            w6_msgs.append((proxies[i][s], i, w5_ok[m],
                            base.loss_w6[i, s], -1))
        w6_ok = run_wave(w6_msgs)
        relayed = {i for i in range(n)
                   if any(w6_ok[i * k + s] for s in range(k))}

        # ---- Phase C: verdicts / refutation / expiry ---------------------
        failed = {i for i in prober if i not in acked and i not in relayed}
        s_probe = st.lha.copy()
        if cfg.lifeguard:
            for i in prober:
                delta = 1 if i in failed else -1
                st.lha[i] = np.int32(
                    min(max(int(st.lha[i]) + delta, 0), cfg.lha_max))
            failed = {i for i in failed
                      if np.float32(base.lha_u[i])
                      < np.float32(1.0) / np.float32(1 + int(s_probe[i]))}
        mk_suspect, re_suspect, susp_key = set(), set(), {}
        for i in range(n):
            vk, _ = self._opinion(i, target[i])
            susp_key[i] = _suspect_key(key_incarnation(vk))
            if i in failed:
                stat = key_status(vk)
                if stat == Status.ALIVE:
                    mk_suspect.add(i)
                elif stat == Status.SUSPECT:
                    re_suspect.add(i)

        refute, new_inc = set(), {}
        for i in range(n):
            best = _alive_key(int(st.inc_self[i]))
            for r in range(r_cap):
                if (used[r] and st.subject[r] == i and st.knows[i, r]
                        and int(st.rkey[r]) > best):
                    best = int(st.rkey[r])
            if i in up_set and _is_suspect(best):
                refute.add(i)
                new_inc[i] = key_incarnation(best) + 1
                st.inc_self[i] = np.uint32(new_inc[i])
                if cfg.lifeguard:
                    st.lha[i] = np.int32(min(int(st.lha[i]) + 1,
                                             cfg.lha_max))
            else:
                new_inc[i] = int(st.inc_self[i])

        # suspicion expiry via sentinels (deviation 2)
        confirm, conf_node = set(), {}
        for r in range(r_cap):
            if not (used[r] and is_susp_r[r] and not st.confirmed[r]):
                continue
            filled = int(np.sum(st.sent_node[r] >= 0))
            if cfg.lifeguard and cfg.dynamic_suspicion:
                timeout = dynamic_timeout_py(cfg, min(filled, s_cap))
            else:
                timeout = cfg.suspicion_periods
            dead_k = _dead_key(key_incarnation(int(st.rkey[r])))
            if not dead_k > int(st.gone_key[st.subject[r]]):
                continue
            for s in range(s_cap):
                node = int(st.sent_node[r, s])
                # a sentinel only fires while its node is still up
                if node < 0 or int(self.plan.crash_step[node]) <= t:
                    continue
                if t < int(st.sent_time[r, s]) + timeout:
                    continue
                refuted = any(
                    used[r2] and same_subj[r, r2]
                    and int(st.rkey[r2]) > int(st.rkey[r])
                    and st.knows[node, r2]
                    for r2 in range(r_cap))
                if not refuted:
                    confirm.add(r)
                    conf_node[r] = node
                    break

        # ---- Phase D: originations (deviation 4) -------------------------
        cb = _budget(cfg)
        cands = []  # (subj, key, orig, src_rumor, is_suspect_class)
        for r in range(r_cap):
            if r in confirm:
                cands.append((int(st.subject[r]),
                              _dead_key(key_incarnation(int(st.rkey[r]))),
                              conf_node[r], r, False))
        for i in range(n):
            if i in refute:
                cands.append((i, _alive_key(new_inc[i]), i, -1, False))
        for i in range(n):
            if i in mk_suspect or i in re_suspect:
                cands.append((target[i], susp_key[i], i, -1, True))
        self.state.overflow = int(self.state.overflow
                                  + max(len(cands) - cb, 0))
        cands = cands[:cb]

        # allocation: dedup within candidates (earlier wins), dedup vs the
        # post-retirement table, then free slots in slot order
        free_slots = [r for r in range(r_cap) if not used[r]]
        slot_of: dict[int, int] = {}   # candidate index → slot (-1 = none)
        seen: dict[tuple[int, int], int] = {}
        alloc_writes = []               # (slot, subj, key)
        n_alloc = 0
        for ci, (subj, keyv, orig, srcr, is_s) in enumerate(cands):
            if (subj, keyv) in seen:
                slot_of[ci] = slot_of[seen[(subj, keyv)]]
                continue
            seen[(subj, keyv)] = ci
            ex = next((r for r in range(r_cap)
                       if used[r] and int(st.subject[r]) == subj
                       and int(st.rkey[r]) == keyv), None)
            if ex is not None:
                slot_of[ci] = ex
                continue
            if n_alloc < len(free_slots) and n_alloc < cb:
                slot = free_slots[n_alloc]
                n_alloc += 1
                slot_of[ci] = slot
                alloc_writes.append((slot, subj, keyv))
            else:
                slot_of[ci] = -1
                self.state.overflow = int(self.state.overflow + 1)

        for slot, subj, keyv in alloc_writes:
            st.subject[slot] = np.int32(subj)
            st.rkey[slot] = np.uint32(keyv)
            st.birth[slot] = np.int32(t)
            st.confirmed[slot] = False
            st.sent_node[slot] = -1
            st.sent_time[slot] = 0
            st.knows[:, slot] = False   # clear heard bits of the reused slot

        for ci, (subj, keyv, orig, srcr, is_s) in enumerate(cands):
            slot = slot_of[ci]
            if slot >= 0:
                st.knows[orig, slot] = True   # originator hears its rumor

        # sentinel joins: placed suspect-class candidates, candidate order
        for ci, (subj, keyv, orig, srcr, is_s) in enumerate(cands):
            slot = slot_of[ci]
            if slot < 0 or not is_s:
                continue
            if any(int(st.sent_node[slot, s]) == orig for s in range(s_cap)):
                continue
            for s in range(s_cap):
                if int(st.sent_node[slot, s]) < 0:
                    st.sent_node[slot, s] = np.int32(orig)
                    st.sent_time[slot, s] = np.int32(t)
                    break

        # mark confirmed suspicions whose DEAD rumor landed
        for ci, (subj, keyv, orig, srcr, is_s) in enumerate(cands):
            if srcr >= 0 and slot_of[ci] >= 0:
                st.confirmed[srcr] = True

        st.step = t + 1

    def run(self, key, periods: int) -> RumorOracleState:
        """`periods` periods of the port's draws from the threefry key
        `key` (`threefry.key(seed)`), drawn on the CPU."""
        from swim_tpu_torch.models import rumor as rumor_mod

        for _ in range(periods):
            self.step(rumor_mod.draw_period_rumor(key, self.state.step,
                                                  self.cfg, "cpu"))
        return self.state

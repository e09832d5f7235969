"""Ring engine, period-scope rotor slice (port of `swim_tpu/models/ring.py`).

One protocol period for all N nodes, as the reference's `step` computes
it with `ring_sel_scope="period"` and rotor probing, vanilla protocol,
wide scalar wire: Phase 0 (judge the outgoing window words, recycle the
spreading ones, shift the window), the per-subject top-C index, one
first-B piggyback selection, the 2+4k message waves fused into one
window merge, the deferred cold flush with the C+1 view queries,
Phase C (refutation, sentinel expiry) and Phase D (originations).  The
reference's module docstring holds the protocol semantics and the
deviations R1-R5; this port reproduces its state bit for bit.

Three steps of the period are kernels: `select_first_b`
(ops/selb.py), `merge_waves` (ops/wavemerge.py) and
`cold_update_select` (ops/coldsel.py).  On CUDA tensors they launch the
hand-written kernels; on CPU tensors they run their plain versions.
`step(..., plain=True)` runs the plain versions on any device: it is
the reference `chip_smoke.py` holds the kernels against on the card.

Layouts and dtypes follow the reference; u32 arrays are int32 carriers
(ops/u32.py).  `step` updates the incoming `state.cold` in place (the
cold-ring flush, as the reference's kernel aliases it); every other
field of the incoming state is left untouched.

Host syncs: none inside `step`.  `run` reads `state.step` once and
copies the whole run's rotor offsets to the device once;
`draw_period_ring` without `offsets` copies them per call.  The
reference's
sentinel-probe `lax.cond` (ring.py:1612-1631) is taken as its
full-batch branch, which is bitwise equal to the compacted one and
needs no data-dependent branch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.ops import coldsel, lattice, sampling, selb, u32, wavemerge
from swim_tpu_torch.sim import faults
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.utils import threefry

WORD = 32
I32 = torch.int32


class RingGeometry(NamedTuple):
    """Static geometry derived from SwimConfig (plain Python ints)."""

    ow: int       # words originated per period (lane budget OB = 32*ow)
    ww: int       # window words (transmissible candidates = 32*ww)
    rw: int       # cold ring words (total slots R = 32*rw)
    c: int        # per-subject view index depth
    spread: int   # total spread budget in periods (recycle cutoff)
    life: int     # ring turnover in periods (rw = ow * life)


def geometry(cfg: SwimConfig) -> RingGeometry:
    ow = cfg.ring_orig_words
    wp = cfg.ring_window_periods
    spread = 2 * cfg.gossip_window
    life = max(cfg.suspicion_max_periods + 4, spread + 2, wp + 2)
    return RingGeometry(ow=ow, ww=ow * wp, rw=ow * life, c=cfg.ring_view_c,
                        spread=spread, life=life)


class RingState(NamedTuple):
    """The reference's 14 fields, same order, shapes and layouts; u32
    fields are int32 carriers.  `cold` is word-major [RW, N]."""

    win: torch.Tensor        # u32[N, WW]  heard-bits, youngest WW words
    cold: torch.Tensor       # u32[RW, N]  heard-bits, cold ring
    inc_self: torch.Tensor   # u32[N]
    lha: torch.Tensor        # i32[N]
    gone_key: torch.Tensor   # u32[N]   DEAD tombstone floor per subject
    subject: torch.Tensor    # i32[R]   -1 = free
    rkey: torch.Tensor       # u32[R]
    birth0: torch.Tensor     # i32[R]   first-generation birth
    sent_node: torch.Tensor  # i32[R, S]
    sent_time: torch.Tensor  # i32[R, S]
    confirmed: torch.Tensor  # bool[R]
    overflow: torch.Tensor        # i32
    index_overflow: torch.Tensor  # i32
    step: torch.Tensor            # i32


U32_FIELDS = frozenset({"win", "cold", "inc_self", "gone_key", "rkey"})


def init_state(cfg: SwimConfig, device=None) -> RingState:
    dev = devmod.resolve(device)
    g = geometry(cfg)
    n, r, s = cfg.n_nodes, g.rw * WORD, cfg.sentinels
    i32 = dict(dtype=I32, device=dev)
    return RingState(
        win=torch.zeros((n, g.ww), **i32),
        cold=torch.zeros((g.rw, n), **i32),
        inc_self=torch.zeros((n,), **i32),
        lha=torch.zeros((n,), **i32),
        gone_key=torch.zeros((n,), **i32),
        subject=torch.full((r,), -1, **i32),
        rkey=torch.zeros((r,), **i32),
        birth0=torch.zeros((r,), **i32),
        sent_node=torch.full((r, s), -1, **i32),
        sent_time=torch.zeros((r, s), **i32),
        confirmed=torch.zeros((r,), dtype=torch.bool, device=dev),
        overflow=torch.tensor(0, **i32),
        index_overflow=torch.tensor(0, **i32),
        step=torch.tensor(0, **i32),
    )


def check_slice(cfg: SwimConfig) -> None:
    """Raise NotImplementedError for a configuration this port does not
    run yet, naming the ROADMAP.md item that brings it."""
    todo = []
    if cfg.ring_sel_scope != "period":
        todo.append("ring_sel_scope='wave' (ROADMAP.md Queue 1: wave scope)")
    if cfg.ring_probe != "rotor":
        todo.append("ring_probe='pull' (ROADMAP.md Queue 1: pull mode)")
    if cfg.lifeguard:
        todo.append("lifeguard=True (ROADMAP.md Queue 1: Lifeguard and "
                    "buddy)")
    if cfg.ring_scalar_wire != "wide":
        todo.append("ring_scalar_wire='packed' (ROADMAP.md Queue 1: "
                    "sharding)")
    if 2 + 4 * cfg.k_indirect > wavemerge.MAX_WAVES:
        todo.append(f"k_indirect={cfg.k_indirect}: more than 32 waves do "
                    "not fuse (ROADMAP.md Queue 1: wave scope)")
    if cfg.telemetry or cfg.profiling:
        todo.append("telemetry/profiling taps (ROADMAP.md Queue 1: "
                    "instruments)")
    if todo:
        raise NotImplementedError(
            "not in the ported slice: " + "; ".join(todo))


# ----------------------------------------------------------- randomness


class RingRandomness(NamedTuple):
    s_off: torch.Tensor    # i32 scalar: probe offset in [1, N)
    q_off: torch.Tensor    # i32[k]: proxy offsets in [1, N)
    loss_w1: torch.Tensor  # u32[N]    u16 draw
    loss_w2: torch.Tensor  # u32[N]    u16 draw
    loss_w3: torch.Tensor  # u32[N, k] u16 draw
    loss_w4: torch.Tensor  # u32[N, k] u16 draw
    loss_w5: torch.Tensor  # u32[N, k] u16 draw
    loss_w6: torch.Tensor  # u32[N, k] u16 draw
    lha_u: torch.Tensor    # u32[N]    u16 draw (Lifeguard thinning)


def rotor_offsets(cfg: SwimConfig, step: int) -> list[int]:
    """[s_off, q_off[0..k)] of period `step`, on the host: position
    (step mod N-1) of an epoch-keyed shuffle of [0, N-1), plus k
    positions of a per-period shuffle, each + 1."""
    k, m = cfg.k_indirect, cfg.n_nodes - 1
    epoch, pos = divmod(step, m)
    mix = sampling._py_mix32
    ka = mix((epoch * 0x9E3779B9 + 0xABCD) & u32.MASK32)
    kb = mix((epoch ^ 0x7F4A7C15) & u32.MASK32)
    tk = step & u32.MASK32
    pka = mix((tk * 0x85EBCA6B + 0x51ED) & u32.MASK32)
    pkb = mix(tk ^ 0xC2B2AE35)
    return ([sampling.py_feistel(pos, m, ka, kb) + 1]
            + [sampling.py_feistel(a, m, pka, pkb) + 1 for a in range(k)])


def draw_period_ring(key: tuple[int, int], step: int, cfg: SwimConfig,
                     device=None, offsets: torch.Tensor | None = None
                     ) -> RingRandomness:
    """Period `step`'s randomness: the reference's
    `draw_period_ring(jax.random.key(seed), step, cfg)` for
    `key = threefry.key(seed)`.  `offsets` (int32[1+k] on the device,
    from `rotor_offsets`) saves the host-to-device copy per period."""
    dev = devmod.resolve(device)
    n, k = cfg.n_nodes, cfg.k_indirect
    if offsets is None:
        offsets = torch.tensor(rotor_offsets(cfg, step), dtype=I32,
                               device=dev)
    ks = threefry.split(threefry.fold_in(key, step), 4)

    def halves(bits):
        return bits & 0xFFFF, u32.lsr(bits, 16)

    loss_w1, loss_w2 = halves(threefry.bits(ks[0], (n,), dev))
    loss_w3, loss_w4 = halves(threefry.bits(ks[1], (n, k), dev))
    loss_w5, loss_w6 = halves(threefry.bits(ks[2], (n, k), dev))
    lha_u = halves(threefry.bits(ks[3], (n,), dev))[0]
    return RingRandomness(
        s_off=offsets[0], q_off=offsets[1:],
        loss_w1=loss_w1, loss_w2=loss_w2, loss_w3=loss_w3, loss_w4=loss_w4,
        loss_w5=loss_w5, loss_w6=loss_w6, lha_u=lha_u)


# ------------------------------------------------------ tensor helpers


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, val, col=None):
    """dst[idx] = val (dst[idx, col] = val with `col`), dropping entries
    whose idx lies outside [0, len(dst)): they write a spare row that is
    cut off afterwards, so no host sync filters them.  Callers keep the
    valid indices distinct, so the result is deterministic."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    i = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
    if col is None:
        ext[i] = val
    else:
        ext[i, col.to(torch.int64)] = val
    return ext[:n]


def _col_select_multi(mat: torch.Tensor, cols: list[torch.Tensor]):
    """[mat[i, c[i]] for c in cols]; an out-of-range c yields 0."""
    w = mat.shape[1]
    out = []
    for c in cols:
        v = mat.gather(1, c.clamp(0, w - 1).to(torch.int64)[:, None])[:, 0]
        out.append(torch.where((c >= 0) & (c < w), v, 0))
    return out


def _first_true_idx(valid: torch.Tensor, k: int) -> torch.Tensor:
    """int32[k]: ascending indices of the first k True entries of a 1-D
    bool vector, missing entries filled with n = len(valid)."""
    n = valid.shape[0]
    ids = torch.arange(n, dtype=I32, device=valid.device)
    key = torch.where(valid, ids, n)
    idx = torch.topk(key, min(k, n), largest=False, sorted=True).values
    if k > n:
        idx = torch.cat([idx, torch.full((k - n,), n, dtype=I32,
                                         device=valid.device)])
    return idx


def _lane_counts(words: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """int32[OW*32]: per-lane active-knower counts of u32[OW, N] words
    (lane w*32 + b counts active nodes with bit b of word w set)."""
    ow = words.shape[0]
    sh = torch.arange(WORD, dtype=I32, device=words.device)[None, :, None]
    masked = torch.where(active[None, :], words, 0)
    bits = (masked[:, None, :] >> sh) & 1                     # [OW, 32, N]
    return bits.sum(dim=2, dtype=I32).reshape(ow * WORD)


def _sum32(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=I32)


class GlobalOps:
    """Cross-node operations of the single-device engine: the rolls,
    drop-mode scatters and heard-bit lookups of the reference's GlobalOps
    (ring.py:625-756) that the rotor path calls, plus the three kernel
    steps (their plain versions with `plain`)."""

    def __init__(self, cfg: SwimConfig, device, plain: bool = False):
        self.n = cfg.n_nodes
        self.device = device
        self.plain = plain
        self.ids = torch.arange(self.n, dtype=I32, device=device)

    def roll_from(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Value of x at node (i + d) mod n for every row i; `d` is a
        device scalar, so the index is computed on the device."""
        idx = torch.remainder(self.ids.to(torch.int64) + d, self.n)
        return x[idx]

    def scatter_max(self, dst, idx, val, unsigned: bool):
        """dst[idx] <- max(dst[idx], val) (u32 order when `unsigned`);
        idx outside [0, n) drops (it adds the max identity at 0)."""
        valid = (idx >= 0) & (idx < dst.shape[0])
        v = u32.flip(val) if unsigned else val
        v = torch.where(valid, v, u32.SIGN)
        d = u32.flip(dst) if unsigned else dst.clone()
        d.scatter_reduce_(0, torch.where(valid, idx, 0).to(torch.int64), v,
                          "amax")
        return u32.flip(d) if unsigned else d

    def scatter_add(self, dst, idx, val: int):
        valid = (idx >= 0) & (idx < dst.shape[0])
        out = dst.clone()
        out.scatter_add_(0, torch.where(valid, idx, 0).to(torch.int64),
                         torch.where(valid, val, 0).to(dst.dtype))
        return out

    def knows_words(self, win, cold, slot_pos, rows, slot):
        """Heard-bit of global node ids `rows` for ring slots `slot`."""
        ok, wcol, word_r, bit = slot_pos(slot)
        rows = rows.to(torch.int64)
        word = torch.where(ok, win[rows, wcol.to(torch.int64)],
                           cold[word_r.to(torch.int64), rows])
        return (slot >= 0) & u32.bit_of(word, bit)

    # -- the three kernel steps ------------------------------------------
    def select_first_b(self, win_masked, b):
        if self.plain:
            return selb.select_first_b_plain(win_masked, b)
        return selb.select_first_b(win_masked, b)

    def cold_update_select(self, cold, flush_rows, flush_vals, q_rows):
        fn = (coldsel.cold_update_select_plain if self.plain
              else coldsel.cold_update_select)
        return fn(cold, flush_rows, flush_vals, q_rows)

    def merge_waves(self, win, sel, oks, offs):
        empty = torch.zeros((0, self.n), dtype=I32, device=self.device)
        fn = (wavemerge.merge_waves_plain if self.plain
              else wavemerge.merge_waves)
        return fn(win, sel, torch.stack(oks), torch.stack(offs), empty,
                  empty)


# ---------------------------------------------------------------- step


def step(cfg: SwimConfig, state: RingState, plan: FaultPlan,
         rnd: RingRandomness, *, plain: bool = False, ext=None, tap=None,
         prof=None) -> RingState:
    """One protocol period (reference ring.py:759-1841, rotor + period
    scope).  Consumes `state.cold` (updated in place)."""
    check_slice(cfg)
    if ext is not None or tap is not None or prof is not None:
        raise NotImplementedError(
            "ext/tap/prof are not in the ported slice (ROADMAP.md Queue "
            "1: ExtOriginations, instruments)")
    plan, _ = faults.split_program(plan)
    dev = state.win.device
    ops = GlobalOps(cfg, dev, plain=plain)
    g = geometry(cfg)
    n, k = cfg.n_nodes, cfg.k_indirect
    r_tot, s_cap = g.rw * WORD, cfg.sentinels
    ob = g.ow * WORD
    t = state.step
    ids = ops.ids
    rr = torch.arange(r_tot, dtype=I32, device=dev)
    lanes = torch.arange(ob, dtype=I32, device=dev)
    crashed = faults.crashed_mask(plan, t)
    joined = plan.join_step <= t
    active = ~crashed & joined
    part_on = faults.partition_active(plan, t)
    live_total = _sum32(active)

    subject, rkey, birth0 = state.subject, state.rkey, state.birth0
    snode, stime = state.sent_node, state.sent_time
    confirmed = state.confirmed
    gone_key = state.gone_key
    overflow = state.overflow
    cold = state.cold

    entry_gw0 = t * g.ow - g.ww        # entry win col 0's global word
    fresh_gw0 = t * g.ow               # this period's first fresh word

    # ---- Phase 0a: judge the outgoing words (entry win cols [0, OW)) ------
    out_cols = state.win[:, :g.ow]                             # u32[N, OW]
    out_knowers = _lane_counts(out_cols.T, active)             # i32[OB]
    out_rcol = torch.remainder(entry_gw0 + lanes // WORD, g.rw)
    out_slots = (out_rcol * WORD + lanes % WORD).to(torch.int64)
    out_sub = subject[out_slots]
    out_key = rkey[out_slots]
    out_used = out_sub >= 0
    out_dissem = out_knowers >= live_total
    in_budget = (t - birth0[out_slots]) < g.spread
    glob_refuted = (
        ((subject[None, :] == out_sub[:, None]) & (subject >= 0)[None, :]
         & u32.ugt(rkey[None, :], out_key[:, None])).any(dim=-1)
        | u32.ugt(gone_key[out_sub.clamp(min=0).to(torch.int64)], out_key))
    pending = (out_used & lattice.is_suspect(out_key)
               & ~confirmed[out_slots] & ~glob_refuted)
    carry = out_used & ~out_dissem & in_budget
    keep = out_used & ~carry & pending
    retire = out_used & ~carry & ~keep
    out_dead = out_used & lattice.is_dead(out_key)
    tomb = retire & out_dissem
    gone_key = ops.scatter_max(gone_key, torch.where(tomb, out_sub, n),
                               out_key, unsigned=True)
    overflow = overflow + _sum32(retire & out_dead & ~out_dissem)

    # ---- Phase 0b: invalidate the previous generation of the fresh cols ---
    fresh_rcol = torch.remainder(fresh_gw0 + lanes // WORD, g.rw)
    fresh_slots = fresh_rcol * WORD + lanes % WORD             # i32[OB]
    fs64 = fresh_slots.to(torch.int64)
    inv_sub = subject[fs64]
    inv_used = inv_sub >= 0
    inv_key = rkey[fs64]
    fresh_word_rows = torch.remainder(
        fresh_gw0 + torch.arange(g.ow, dtype=I32, device=dev), g.rw)
    fresh_rows = cold.index_select(0, fresh_word_rows.to(torch.int64))
    inv_knowers = _lane_counts(fresh_rows, active)
    inv_tomb = inv_used & (inv_knowers >= live_total)
    gone_key = ops.scatter_max(gone_key, torch.where(inv_tomb, inv_sub, n),
                               inv_key, unsigned=True)
    subject = _set_drop(subject, torch.where(inv_used, fresh_slots, r_tot),
                        -1)

    # ---- Phase 0c: move carried lanes old slot -> same lane of fresh word -
    mv_src = torch.where(carry, out_slots, r_tot).clamp(max=r_tot - 1)
    mv_dst = torch.where(carry, fresh_slots, r_tot)
    subject = _set_drop(subject, mv_dst, torch.where(carry, out_sub, -1))
    rkey = _set_drop(rkey, mv_dst, out_key)
    birth0 = _set_drop(birth0, mv_dst, birth0[mv_src])
    confirmed = _set_drop(confirmed, mv_dst, confirmed[mv_src])
    snode = _set_drop(snode, mv_dst, snode[mv_src])
    stime = _set_drop(stime, mv_dst, stime[mv_src])
    subject = _set_drop(subject, torch.where(carry | retire, out_slots,
                                             r_tot), -1)
    carry_mask = u32.pack_bits(carry.reshape(g.ow, WORD))      # u32[OW]

    # ---- Phase 0d: shift the window, carry bits (flush deferred) ----------
    flush_rows = torch.remainder(
        entry_gw0 + torch.arange(g.ow, dtype=I32, device=dev),
        g.rw).to(I32)                                          # i32[OW]
    flush_vals = out_cols.T.contiguous()                       # u32[OW, N]
    fresh_cols = out_cols & carry_mask[None, :]
    win = torch.cat([state.win[:, g.ow:], fresh_cols], dim=1)
    win_ring0 = torch.remainder(entry_gw0 + g.ow, g.rw)

    # ---- per-subject top-C index (R3) -------------------------------------
    used = subject >= 0
    sub_or_n = torch.where(used, subject, n)
    subj_cl = subject.clamp(min=0).to(torch.int64)
    top_key, top_slot = [], []
    remaining = used
    for _ in range(g.c):
        bk = ops.scatter_max(torch.zeros_like(ids),
                             torch.where(remaining, subject, n), rkey,
                             unsigned=True)
        bk_at_r = bk[subj_cl]
        hit = remaining & (rkey == bk_at_r) & (bk_at_r != 0)
        bs = ops.scatter_max(torch.full_like(ids, -1),
                             torch.where(hit, subject, n), rr,
                             unsigned=False)
        top_key.append(bk)
        top_slot.append(bs)
        remaining = remaining & ~(rr == bs[subj_cl])
    n_per_subj = ops.scatter_add(torch.zeros_like(ids), sub_or_n, 1)
    index_overflow = state.index_overflow + _sum32(n_per_subj > g.c)
    sus_hit = used & lattice.is_suspect(rkey)
    sus_bk = ops.scatter_max(torch.zeros_like(ids),
                             torch.where(sus_hit, subject, n), rkey,
                             unsigned=True)
    sus_slot = ops.scatter_max(
        torch.full_like(ids, -1),
        torch.where(sus_hit & (rkey == sus_bk[subj_cl]), subject, n), rr,
        unsigned=False)

    def slot_pos(slot):
        """(in_win, win_col, ring_word, bit) for ring slot array `slot`."""
        sl = slot.clamp(min=0)
        word_r = sl // WORD
        bit = sl % WORD
        off = torch.remainder(word_r - win_ring0, g.rw)
        return ((slot >= 0) & (off < g.ww), off.clamp(max=g.ww - 1),
                word_r, bit)

    # ---- Phases A+B: rotor waves ------------------------------------------
    pid = plan.partition_id
    loss_thr = torch.ceil(plan.loss.to(torch.float32) * 65536.0).to(I32)
    b_pig = min(cfg.max_piggyback, g.ww * WORD)
    win_slots_lin = torch.remainder(
        win_ring0 * WORD + torch.arange(g.ww * WORD, dtype=I32, device=dev),
        r_tot).to(torch.int64)
    elig = used[win_slots_lin].reshape(g.ww, WORD)
    elig_mask = u32.pack_bits(elig)                            # u32[WW]
    # period scope (deviation R5): one selection from the start-of-period
    # window, reused by every wave
    sel_base = ops.select_first_b(win & elig_mask[None, :], b_pig)

    s_off = rnd.s_off
    target = torch.remainder(ids + s_off, n)
    prober = active & ops.roll_from(joined, s_off)
    oks, offs = [], []

    def wave_ok(flag_at_sender, d, u):
        """bool[N] per receiver i: the message from (i + d) arrived."""
        flag_r = ops.roll_from(flag_at_sender, d)
        pid_r = ops.roll_from(pid, d)
        return flag_r & active & ~(part_on & (pid_r != pid)) & (u >= loss_thr)

    def deliver(ok, d):
        oks.append(ok)
        offs.append(d.to(I32))

    # W1: ping i -> i+s; W2: the ack back
    ok1 = wave_ok(prober & active, -s_off, rnd.loss_w1)
    deliver(ok1, -s_off)
    ok2 = wave_ok(ok1, s_off, rnd.loss_w2)
    deliver(ok2, s_off)
    acked = ok2 & prober
    need = prober & ~acked
    relayed = torch.zeros((n,), dtype=torch.bool, device=dev)
    for a in range(k):
        q = rnd.q_off[a]
        d4 = s_off - q
        ok3 = wave_ok(need, -q, rnd.loss_w3[:, a])       # W3 ping-req
        deliver(ok3, -q)
        ok4 = wave_ok(ok3, -d4, rnd.loss_w4[:, a])       # W4 proxy ping
        deliver(ok4, -d4)
        ok5 = wave_ok(ok4, d4, rnd.loss_w5[:, a])        # W5 target ack
        deliver(ok5, d4)
        ok6 = wave_ok(ok5, q, rnd.loss_w6[:, a])         # W6 relay ack
        deliver(ok6, q)
        relayed = relayed | (ok6 & need)
    win = ops.merge_waves(win, sel_base, oks, offs)

    probe_ok = acked | relayed
    failed = prober & ~probe_ok
    # view_of(ids, target) + Phase C's self-suspicion word: C+1 queries
    q_slots = [ops.roll_from(top_slot[lvl], s_off) for lvl in range(g.c)]
    q_slots.append(sus_slot)
    q_pos = [slot_pos(s) for s in q_slots]
    q_win = _col_select_multi(win, [p[1] for p in q_pos])
    cold, q_cold = ops.cold_update_select(
        cold, flush_rows, flush_vals,
        torch.stack([p[2] for p in q_pos]).to(I32).contiguous())
    q_kn = []
    for (ok, _, _, bit), wv, cv, s in zip(q_pos, q_win, q_cold, q_slots):
        word = torch.where(ok, wv, cv)
        q_kn.append((s >= 0) & u32.bit_of(word, bit))
    kn_back = [ops.roll_from(q_kn[lvl], -s_off) for lvl in range(g.c)]
    tk_subj = u32.umax(lattice.alive_key(torch.zeros_like(gone_key)),
                       gone_key)
    for lvl in range(g.c):
        tk_subj = u32.umax(tk_subj, torch.where(kn_back[lvl], top_key[lvl],
                                                0))
    viewed_tk = ops.roll_from(tk_subj, s_off)
    self_key = torch.where(q_kn[g.c], sus_bk, 0)
    susp_subject = target
    susp_orig = ids

    v_status = lattice.status_of(viewed_tk)
    mk_suspect = failed & (v_status == 0)
    re_suspect = failed & (v_status == 1)
    susp_key = lattice.suspect_key(lattice.incarnation_of(viewed_tk))

    # ---- Phase C: refutation + sentinel expiry ----------------------------
    refute = active & lattice.is_suspect(self_key) & u32.ugt(
        self_key, lattice.alive_key(state.inc_self))
    new_inc = torch.where(refute, lattice.incarnation_of(self_key) + 1,
                          state.inc_self)
    inc_self = new_inc

    timeout = cfg.suspicion_periods
    snode_cl = snode.clamp(min=0).to(torch.int64)
    sent_alive = (snode >= 0) & (plan.crash_step[snode_cl] > t)
    deadline_hit = sent_alive & (t >= stime + timeout)
    is_susp_r = lattice.is_suspect(rkey)
    subj_r = subject.clamp(min=0).to(torch.int64)
    gone_at_r = gone_key[subj_r]
    higher_known = u32.ugt(gone_at_r, rkey)[:, None].expand(snode.shape)
    oslots, cands = [], []
    for lvl in range(g.c):
        oslot = top_slot[lvl][subj_r]
        okey = top_key[lvl][subj_r]
        cands.append((u32.ugt(okey, rkey) & (oslot >= 0))[:, None])
        oslots.append(oslot[:, None].expand(snode.shape))
    s_lanes = snode.shape[1]
    rows_b = torch.cat([snode_cl] * g.c, dim=1)                # [R, S*C]
    slots_b = torch.cat(oslots, dim=1)
    # the reference's full-batch branch of its sentinel-probe lax.cond
    kn_b = ops.knows_words(win, cold, slot_pos, rows_b, slots_b)
    for lvl in range(g.c):
        kn = kn_b[:, lvl * s_lanes:(lvl + 1) * s_lanes]
        higher_known = higher_known | (cands[lvl] & kn)
    dead_key_r = lattice.dead_key(lattice.incarnation_of(rkey))
    can_confirm = deadline_hit & ~higher_known
    confirm = (used & is_susp_r & ~confirmed
               & u32.ugt(dead_key_r, gone_at_r) & can_confirm.any(dim=-1))
    conf_s = can_confirm.to(I32).argmax(dim=-1)
    conf_node = snode.gather(1, conf_s[:, None])[:, 0]

    # ---- Phase D: new originations into the free fresh lanes --------------
    suspect = mk_suspect | re_suspect
    m_cand = r_tot + 2 * n
    total = _sum32(confirm) + _sum32(refute) + _sum32(suspect)
    kk1 = torch.topk(torch.where(confirm, r_tot - rr, 0), ob).values
    ci1 = torch.where(kk1 > 0, r_tot - kk1, m_cand)
    ci2 = _first_true_idx(refute, ob)
    ci2 = torch.where(ci2 < n, r_tot + ci2, m_cand)
    ci3 = _first_true_idx(suspect, ob)
    ci3 = torch.where(ci3 < n, r_tot + n + ci3, m_cand)
    cand = torch.cat([ci1, ci2, ci3])
    mk_ = torch.topk(torch.where(cand < m_cand, m_cand - cand, 0), ob).values
    ci = torch.where(mk_ > 0, m_cand - mk_, m_cand)
    got = ci < m_cand
    is1 = ci < r_tot
    i1 = ci.clamp(0, r_tot - 1).to(torch.int64)
    is2 = got & ~is1 & (ci < r_tot + n)
    j2 = (ci - r_tot).clamp(0, n - 1)
    is3 = got & ~is1 & ~is2 & (ci < r_tot + 2 * n)
    j3 = (ci - r_tot - n).clamp(0, n - 1).to(torch.int64)
    sub3 = susp_subject[j3]
    key3 = susp_key[j3]
    org3 = susp_orig[j3]
    subj_c = torch.where(
        got, torch.where(is1, subject[i1], torch.where(is2, j2, sub3)), -1)
    key_c = torch.where(
        got, torch.where(
            is1, dead_key_r[i1],
            torch.where(is2,
                        lattice.alive_key(new_inc[j2.to(torch.int64)]),
                        key3)), 0)
    orig_c = torch.where(
        got, torch.where(is1, conf_node[i1].clamp(min=0),
                         torch.where(is2, j2, org3)), 0)
    hear_c = orig_c
    susp_c = is3
    srcslot_c = torch.where(got & is1, i1, -1)
    overflow = overflow + (total - ob).clamp(min=0)

    # dedup within candidates (earlier wins) and vs the live table
    eq = ((subj_c[:, None] == subj_c[None, :])
          & (key_c[:, None] == key_c[None, :]))
    earlier = torch.ones((ob, ob), dtype=torch.bool, device=dev).tril(-1)
    dup_mask = eq & earlier & got[None, :] & got[:, None]
    dup_prev = dup_mask.any(dim=-1)
    win_idx = dup_mask.to(I32).argmax(dim=-1)
    ex = (used[None, :] & (subj_c[:, None] == subject[None, :])
          & (key_c[:, None] == rkey[None, :]))
    ex_match = ex.any(dim=-1)
    ex_slot = ex.to(I32).argmax(dim=-1).to(I32)

    # free fresh lanes (those not carried), ascending, filled with OB
    free_lane = torch.sort(torch.where(~carry, lanes, ob)).values
    n_free = _sum32(~carry)
    place = got & ~dup_prev & ~ex_match
    apos = place.to(I32).cumsum(0, dtype=I32) - 1
    alloc_ok = place & (apos < n_free)
    lane_c = torch.where(alloc_ok,
                         free_lane[apos.clamp(0, ob - 1).to(torch.int64)], ob)
    slot_new = torch.where(
        alloc_ok, fresh_slots[lane_c.clamp(0, ob - 1).to(torch.int64)], -1)
    overflow = overflow + _sum32(place & ~alloc_ok)
    slot_f0 = torch.where(ex_match, ex_slot, slot_new)
    slot_f = torch.where(dup_prev, slot_f0[win_idx.to(torch.int64)], slot_f0)
    placed = got & (slot_f >= 0)

    wslot = torch.where(alloc_ok, slot_f, r_tot)
    subject = _set_drop(subject, wslot, subj_c)
    rkey = _set_drop(rkey, wslot, key_c)
    birth0 = _set_drop(birth0, wslot, t)
    confirmed = _set_drop(confirmed, wslot, False)
    snode = _set_drop(snode, wslot, -1)
    stime = _set_drop(stime, wslot, 0)

    # originators hear their rumor: add the one-hot into the fresh win
    # cols (add == or: freshly allocated lanes are bit-disjoint)
    fw = (lane_c // WORD).clamp(0, g.ow - 1).to(torch.int64)
    fbit = lane_c.clamp(0, ob - 1) % WORD
    rows = torch.where(alloc_ok, hear_c, 0).to(torch.int64)
    one = torch.ones_like(fbit, dtype=torch.int64)
    add = torch.where(alloc_ok, one << fbit.to(torch.int64), 0)
    fresh = u32.to_u64(win[:, g.ww - g.ow:])
    fresh.index_put_((rows, fw), add, accumulate=True)
    win[:, g.ww - g.ow:] = u32.from_u64(fresh)

    # sentinel joins
    joiner = placed & susp_c
    tgt_r = torch.where(joiner, slot_f, r_tot)
    tgt_cl = tgt_r.clamp(0, r_tot - 1).to(torch.int64)
    already = (snode[tgt_cl] == orig_c[:, None]).any(dim=-1) & joiner
    joiner = joiner & ~already
    tgt_r = torch.where(joiner, slot_f, r_tot)
    same_r = tgt_r[:, None] == tgt_r[None, :]
    grp_rank = (same_r & earlier & joiner[None, :]).sum(dim=-1, dtype=I32)
    fill_now = (snode[tgt_cl] >= 0).sum(dim=-1, dtype=I32)
    spos = fill_now + grp_rank
    j_ok = joiner & (spos < s_cap)
    wr = torch.where(j_ok, tgt_r, r_tot)
    ws = spos.clamp(0, s_cap - 1)
    snode = _set_drop(snode, wr, orig_c, col=ws)
    stime = _set_drop(stime, wr, t, col=ws)

    conf_slot = torch.where(placed & (srcslot_c >= 0), srcslot_c, r_tot)
    confirmed = _set_drop(confirmed, conf_slot, True)

    # inactive nodes are frozen
    inc_self = torch.where(active, inc_self, state.inc_self)
    lha = state.lha

    return RingState(
        win=win, cold=cold, inc_self=inc_self, lha=lha, gone_key=gone_key,
        subject=subject, rkey=rkey, birth0=birth0,
        sent_node=snode, sent_time=stime, confirmed=confirmed,
        overflow=overflow, index_overflow=index_overflow, step=t + 1,
    )


def run(cfg: SwimConfig, state: RingState, plan: FaultPlan, seed: int,
        periods: int, *, plain: bool = False) -> RingState:
    """`periods` protocol periods from `state`: the reference's
    `ring.run(cfg, state, plan, jax.random.key(seed), periods)`.  Reads
    state.step once and copies the run's rotor offsets once."""
    check_slice(cfg)
    if periods <= 0:
        return state
    dev = state.win.device
    t0 = int(state.step)
    root = threefry.key(seed)
    table = torch.tensor([rotor_offsets(cfg, t0 + i) for i in range(periods)],
                         dtype=I32, device=dev)
    for i in range(periods):
        rnd = draw_period_ring(root, t0 + i, cfg, dev, offsets=table[i])
        state = step(cfg, state, plan, rnd, plain=plain)
    return state


class RingEngine:
    """(cfg, plan, state) on one device, stepping with `run`."""

    def __init__(self, cfg: SwimConfig, plan: FaultPlan, seed: int = 0,
                 device=None):
        check_slice(cfg)
        self.device = devmod.resolve(device)
        if plan.crash_step.device != self.device:
            raise ValueError(f"plan lives on {plan.crash_step.device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.plan = plan
        self.seed = seed
        self.state = init_state(cfg, self.device)

    def run(self, periods: int) -> RingState:
        self.state = run(self.cfg, self.state, self.plan, self.seed, periods)
        return self.state

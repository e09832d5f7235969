"""Rumor engine (port of `swim_tpu/models/rumor.py`): the O(R*N) SWIM
simulation for 100,000 to 1,000,000 nodes.

The state is a bounded table of R rumors (a rumor is one membership
assertion: subject and lattice key) plus a heard-bit matrix
`knows[N, R]`; node i's view of subject j is the lattice join of
ALIVE(0), its own ALIVE if j == i, the tombstone floor `gone_key[j]`,
and every rumor about j it has heard.  One period: Phase 0 (retire
stale rumors; DEAD ones into `gone_key` once every live node heard
them), Phase A (probe targets, resampling believed-dead ones), Phase B
(the globally ordered piggyback candidates), the six message waves,
Phase C (probe verdicts, refutation, sentinel expiry with Lifeguard's
dynamic timeout) and Phase D (originations under a budget, with dedup
and slot allocation).  The reference's module docstring holds the
semantics and its four deviations from exact SWIM; this port
reproduces its state bit for bit under the same RumorRandomness.

Plain PyTorch: the reference runs this engine outside any Pallas
kernel.  u32 arrays are int32 carriers (ops/u32.py).

How the port keeps the reference's results:

  * row-local reductions over [N, R] (a view's max and its witness,
    `_believes_dead`, the self view, Lifeguard's buddy witness over
    N * k messages) run in chunks of ROW_CHUNK rows; at 1M nodes and
    R = 4096 the whole [N, R] temporaries would take 4-49 GB.  The
    chunks give the same bits.  Column counts of live knowers are
    summed in uint8 over groups of KNOW_GROUP rows (no [N, R] int
    copy), then in int32.
  * the period writes `knows` in place in a fresh [N + 1, R] buffer
    (a spare last row), returned as its first N rows: the bool scatters
    write only True, and the writes that the reference's scatter-max
    makes with False go to the spare row.
  * `jnp.nonzero(size=...)` is `scatter.first_true` (no host sync);
    `top_k` sort keys fold in the slot index where values tie, so the
    order is the reference's lower-index-first.
  * `argmax` keeps the first index on ties, as XLA's does.

`dynamic_timeout_py` / `dynamic_timeout_table` are Lifeguard's dynamic
suspicion timeout, shared with the ring engine: a suspicion starts at
`suspicion_max_periods` and shrinks towards `suspicion_periods` as
independent suspectors (sentinels) join it.

Host syncs: none inside `step` for uniform targets (round-robin reads
the Feistel cycle-walk's loop condition on the host).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models.common import Engine, Rows, repeat, run_periods
from swim_tpu_torch.ops import lattice, sampling, scatter, u32
from swim_tpu_torch.sim import faults
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.utils import threefry
from swim_tpu_torch.utils.prng import PeriodRandomness, draw_period
from swim_tpu_torch.utils.tree import tree_map

RESAMPLE_ATTEMPTS = 4
BIG = 2**30
I32 = torch.int32
I64 = torch.int64
# rows per chunk of the row-local [rows, R] reductions (1 GB of int32
# temporaries at R = 4096); tests shrink it to a few rows
ROW_CHUNK = 65536
# rows summed in uint8 before the int32 sum of the knower counts (< 256)
KNOW_GROUP = 128


def dynamic_timeout_py(cfg: SwimConfig, filled: int) -> int:
    """Timeout in periods for `filled` sentinels (plain Python)."""
    base_to = float(cfg.suspicion_periods)
    max_to = float(cfg.suspicion_max_periods)
    c_tot = float(cfg.k_indirect + 1)
    frac = math.log(max(float(filled), 1.0)) / math.log(c_tot + 1.0)
    return int(math.ceil(max(base_to, max_to - (max_to - base_to) * frac)))


@functools.lru_cache(maxsize=16)
def dynamic_timeout_table(cfg: SwimConfig, device) -> torch.Tensor:
    """int32[S + 1]: timeout per filled-sentinel count.  Built on the
    host and moved to `device` once per (cfg, device)."""
    return torch.tensor([dynamic_timeout_py(cfg, f)
                         for f in range(cfg.sentinels + 1)],
                        dtype=I32, device=device)


class RumorState(NamedTuple):
    """The reference's 12 fields: node-axis tensors, the rumor table,
    the scalars.  u32 fields are int32 carriers."""

    knows: torch.Tensor      # bool[N, R]  node i has heard rumor r
    inc_self: torch.Tensor   # u32[N]      own incarnation
    lha: torch.Tensor        # i32[N]      Lifeguard local health score
    gone_key: torch.Tensor   # u32[N]      DEAD tombstone floor per subject
    subject: torch.Tensor    # i32[R]      -1 = free slot
    rkey: torch.Tensor       # u32[R]      asserted lattice key
    birth: torch.Tensor      # i32[R]      period originated
    sent_node: torch.Tensor  # i32[R, S]   independent suspectors; -1 = empty
    sent_time: torch.Tensor  # i32[R, S]   period each began suspecting
    confirmed: torch.Tensor  # bool[R]     suspicion already produced DEAD
    overflow: torch.Tensor   # i32         originations dropped
    step: torch.Tensor       # i32         periods completed


U32_FIELDS = frozenset({"inc_self", "gone_key", "rkey"})


class RumorRandomness(NamedTuple):
    base: PeriodRandomness
    resample_u: torch.Tensor   # f32[N, RESAMPLE_ATTEMPTS]


def draw_period_rumor(key, step: int, cfg: SwimConfig,
                      device) -> RumorRandomness:
    """The reference's `draw_period_rumor(jax.random.key(seed), step,
    cfg)` for `key = threefry.key(seed)`: the nine base draws plus the
    resample draws of the `fold_in(fold_in(key, step), 0x5e71)` stream.
    For a list of P keys every draw gains a leading P axis."""
    rk = threefry.fold_in(threefry.fold_in(key, step), 0x5E71)
    return RumorRandomness(
        base=draw_period(key, step, cfg, device),
        resample_u=threefry.uniform(rk, (cfg.n_nodes, RESAMPLE_ATTEMPTS),
                                    device))


def _budget(cfg: SwimConfig) -> int:
    """Max originations per period (candidate compaction width)."""
    return min(cfg.rumor_slots, 256)


def _pig_window(cfg: SwimConfig) -> int:
    """Global candidate width W of the piggyback selection (>= B)."""
    b = min(cfg.max_piggyback, cfg.rumor_slots)
    return min(cfg.rumor_slots, max(8 * b, 64))


def init_state(cfg: SwimConfig, device=None) -> RumorState:
    dev = devmod.resolve(device)
    n, r, s = cfg.n_nodes, cfg.rumor_slots, cfg.sentinels
    i32 = dict(dtype=I32, device=dev)
    return RumorState(
        knows=torch.zeros((n, r), dtype=torch.bool, device=dev),
        inc_self=torch.zeros((n,), **i32),
        lha=torch.zeros((n,), **i32),
        gone_key=torch.zeros((n,), **i32),
        subject=torch.full((r,), -1, **i32),
        rkey=torch.zeros((r,), **i32),
        birth=torch.zeros((r,), **i32),
        sent_node=torch.full((r, s), -1, **i32),
        sent_time=torch.zeros((r, s), **i32),
        confirmed=torch.zeros((r,), dtype=torch.bool, device=dev),
        overflow=torch.tensor(0, **i32),
        step=torch.tensor(0, **i32),
    )


# ---------------------------------------------------------------------
# Views (derived, never stored), reduced in row chunks
# ---------------------------------------------------------------------


def _chunks(m: int):
    for c0 in range(0, m, ROW_CHUNK):
        yield c0, min(m, c0 + ROW_CHUNK)


def _rows(knows, rows, c0, c1):
    """Rows [c0, c1) of knows, or knows[rows[c0:c1]]."""
    if rows is None:
        return knows[c0:c1]
    return knows[rows[c0:c1].to(I64)]


def _heard_max(knows: torch.Tensor, subject: torch.Tensor,
               rkey: torch.Tensor, subj: torch.Tensor, rows=None):
    """(u32 max, first argmax) over r of where(knows[row, r] and rumor r
    is about subj[m], rkey[r], 0), per message m; row = m, or rows[m].
    Unused slots hold subject -1, which no node id equals.  The max is a
    signed max of the flipped keys (0 flips to the minimum)."""
    frk = u32.flip(rkey)[None, :]
    best, arg = [], []
    for c0, c1 in _chunks(subj.shape[0]):
        mk = _rows(knows, rows, c0, c1) & (subject[None, :]
                                           == subj[c0:c1, None])
        fv = torch.where(mk, frk, u32.SIGN)
        best.append(u32.flip(fv.amax(dim=-1)))
        arg.append(fv.argmax(dim=-1).to(I32))
    return torch.cat(best), torch.cat(arg)


def opinion_of(state: RumorState, subj: torch.Tensor):
    """Each node's opinion of one subject: (key u32[N], witness rumor
    i32[N]); the witness is -1 where the floor wins."""
    best, arg = _heard_max(state.knows, state.subject, state.rkey, subj)
    floor = u32.umax(lattice.alive_key(torch.zeros_like(best)),
                     state.gone_key[subj.to(I64)])
    return u32.umax(best, floor), torch.where(u32.ugt(best, floor), arg, -1)


def _believes_dead(state: RumorState, subj: torch.Tensor) -> torch.Tensor:
    """bool[N]: node i has heard a DEAD rumor about subj[i], or subj[i]
    lies under a DEAD tombstone."""
    subj_dead = torch.where((state.subject >= 0) & lattice.is_dead(
        state.rkey), state.subject, -1)
    out = [(state.knows[c0:c1] & (subj_dead[None, :] == subj[c0:c1, None])
            ).any(dim=-1) for c0, c1 in _chunks(subj.shape[0])]
    return torch.cat(out) | lattice.is_dead(state.gone_key[subj.to(I64)])


def live_knowers(knows: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """int32[R]: per rumor, the number of `up` nodes that heard it
    (sum(knows & up[:, None], 0)).  Groups of KNOW_GROUP rows are summed
    in uint8, then the group sums in int32, a chunk of rows at a time."""
    return _live_knowers_op(knows, up)


@torch.library.custom_op("swim_tpu_torch::live_knowers", mutates_args=())
def _live_knowers_op(knows: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """`live_knowers` of knows [..., N, R] and up [..., N] (leading lane
    axes broadcast).  A custom op so that its vmap rule can read the
    heard-bits as bytes off the lane-stacked matrix: some PyTorch
    versions cannot batch a dtype view under vmap."""
    n, r = knows.shape[-2:]
    lead = torch.broadcast_shapes(knows.shape[:-2], up.shape[:-1])
    out = torch.zeros((*lead, r), dtype=I32, device=knows.device)
    g = KNOW_GROUP
    for c0, c1 in _chunks(n):
        kn = (knows[..., c0:c1, :] & up[..., c0:c1, None]).view(torch.uint8)
        full = (c1 - c0) // g * g
        if full:
            part = kn[..., :full, :].reshape(*lead, -1, g, r).sum(
                dim=-2, dtype=torch.uint8)
            out += part.sum(dim=-2, dtype=I32)
        if full < c1 - c0:
            out += kn[..., full:, :].sum(dim=-2, dtype=I32)
    return out


@_live_knowers_op.register_fake
def _(knows, up):
    """The meta device's shapes (a mesh may hold meta shards)."""
    lead = torch.broadcast_shapes(knows.shape[:-2], up.shape[:-1])
    return knows.new_empty((*lead, knows.shape[-1]), dtype=I32)


def _live_knowers_vmap(info, in_dims, knows, up):
    """All lanes in one call, the lane axis leading."""
    kd, ud = in_dims
    knows = (knows.movedim(kd, 0) if kd is not None
             else knows.expand(info.batch_size, *knows.shape))
    return _live_knowers_op(knows, up if ud is None
                            else up.movedim(ud, 0)), 0


_live_knowers_op.register_vmap(_live_knowers_vmap)


def view_matrix(cfg: SwimConfig, state: RumorState) -> torch.Tensor:
    """u32[N, N] projected pairwise views (tests, small N)."""
    n = cfg.n_nodes
    dev = state.knows.device
    used = state.subject >= 0
    base = u32.umax(lattice.alive_key(torch.zeros_like(state.gone_key)),
                    state.gone_key)[None, :].expand(n, n).clone()
    ids = torch.arange(n, device=dev)
    base[ids, ids] = u32.umax(base[ids, ids],
                              lattice.alive_key(state.inc_self))
    vals = torch.where(state.knows & used[None, :], state.rkey[None, :], 0)
    out = u32.flip(torch.cat([base, base[:, :1]], dim=1))
    col = torch.where(used, state.subject, n).to(I64)
    out.scatter_reduce_(1, col[None, :].expand(n, -1), u32.flip(vals),
                        "amax")
    return u32.flip(out[:, :n])


# ---------------------------------------------------------------------
# One protocol period
# ---------------------------------------------------------------------


def _select_first_b(kn: torch.Tensor, cand_idx: torch.Tensor, b: int):
    """Per row of the priority-ordered candidate mask kn [M, W], the
    first b set columns: (rumor ids cand_idx[wpos] i32[M, b], valid).
    b <= 16 (the reference's lowest-set-bit rounds over packed bytes):
    missing entries point at column 0; b > 16 (its top_k over
    W - column for the first b set columns, 0 elsewhere): missing
    entries take the lowest unselected columns, in order."""
    m, w = kn.shape
    pos = kn.to(I32).cumsum(-1, dtype=I32)
    if b <= 16:
        want = torch.arange(1, b + 1, dtype=I32,
                            device=kn.device).expand(m, b).contiguous()
        wpos = torch.searchsorted(pos, want, out_int32=True)
        val = wpos < w
        wpos = torch.where(val, wpos, 0)
    else:
        col = torch.arange(w, dtype=I32, device=kn.device)
        prio = torch.where(kn & (pos <= b), w - col, 0)
        # unique keys: a selected column's prio (> 0) times w, else the
        # lower column first among the zeros
        _, wpos = torch.topk(prio * w + (w - 1 - col), b, dim=-1)
        val = prio.gather(1, wpos) > 0
    return cand_idx[wpos.to(I64)], val


class Table(NamedTuple):
    """The rumor table after Phase 0's retirement, with what the later
    phases read of it (the period's incoming keys are state.rkey)."""

    subject: torch.Tensor     # i32[R]  -1 = free, after retirement
    gone_key: torch.Tensor    # u32[N]  tombstones, after retirement
    used: torch.Tensor        # bool[R] subject >= 0
    age: torch.Tensor         # i32[R]  periods since birth
    is_susp_r: torch.Tensor   # bool[R]
    is_dead_r: torch.Tensor   # bool[R]
    same_subj: torch.Tensor   # bool[R, R] incoming subjects equal


def _retire(cfg: SwimConfig, state: RumorState, t, knowers: torch.Tensor,
            live_total: torch.Tensor) -> Table:
    """Phase 0: retire stale rumors, DEAD ones into `gone_key` once all
    `live_total` live nodes heard them (`knowers`: live knowers per
    rumor)."""
    used = state.subject >= 0
    age = t - state.birth
    pend_horizon = (cfg.suspicion_max_periods
                    if cfg.lifeguard and cfg.dynamic_suspicion
                    else cfg.suspicion_periods) + 2
    rkey = state.rkey
    is_susp_r = lattice.is_suspect(rkey)
    is_dead_r = lattice.is_dead(rkey)
    gone_at_subj = state.gone_key[state.subject.clamp(min=0).to(I64)]
    same_subj = state.subject[:, None] == state.subject[None, :]
    glob_refuted = ((same_subj & used[None, :]
                     & u32.ugt(rkey[None, :], rkey[:, None])).any(dim=-1)
                    | u32.ugt(gone_at_subj, rkey))
    pending = (is_susp_r & ~state.confirmed & ~glob_refuted
               & (age < pend_horizon))
    disseminated = knowers >= live_total
    retire_dead = used & is_dead_r & disseminated
    gone_key = scatter.scatter_max(
        state.gone_key, torch.where(retire_dead, state.subject,
                                    cfg.n_nodes), rkey, unsigned=True)
    keep = used & torch.where(is_dead_r, ~disseminated,
                              (age < cfg.gossip_window) | pending)
    subject = torch.where(keep, state.subject, -1)
    return Table(subject, gone_key, subject >= 0, age, is_susp_r, is_dead_r,
                 same_subj)


def _candidates(cfg: SwimConfig, tb: Table, rr: torch.Tensor):
    """Phase B, the global piggyback candidates (deviation 1):
    (eligible bool[R], cand_idx i32[W], cand_valid bool[W]), youngest
    first, ties by slot; ineligible slots by slot after them."""
    eligible = tb.used & (tb.age >= 0) & (tb.age < cfg.gossip_window)
    score = torch.where(eligible, tb.age * cfg.rumor_slots + rr, BIG + rr)
    cand_idx = torch.topk(score, _pig_window(cfg), largest=False,
                          sorted=True).indices.to(I32)
    return eligible, cand_idx, eligible[cand_idx.to(I64)]


def _deadlines(cfg: SwimConfig, state: RumorState, plan: FaultPlan, t,
               tb: Table):
    """Phase C's sentinel clocks (deviation 2): (deadline_hit bool[R,
    S]: a live sentinel's suspicion timed out, higher bool[R, R]: rumor
    r' outranks rumor r about the same subject)."""
    snode = state.sent_node
    if cfg.lifeguard and cfg.dynamic_suspicion:
        filled = (snode >= 0).sum(dim=-1)
        timeout = dynamic_timeout_table(cfg, snode.device)[
            filled.clamp(0, cfg.sentinels)][:, None]
    else:
        timeout = cfg.suspicion_periods
    sact = (snode >= 0) & (plan.crash_step[snode.clamp(min=0).to(I64)] > t)
    deadline_hit = sact & (t >= state.sent_time + timeout)
    rkey = state.rkey
    higher = (tb.same_subj & tb.used[None, :]
              & u32.ugt(rkey[None, :], rkey[:, None]))
    return deadline_hit, higher


def _confirm(state: RumorState, tb: Table, deadline_hit: torch.Tensor,
             refuted: torch.Tensor):
    """Timed-out suspicions no sentinel saw refuted: (confirm bool[R],
    the confirming sentinel i32[R], the DEAD keys u32[R])."""
    can_confirm = deadline_hit & ~refuted
    dead_key_r = lattice.dead_key(lattice.incarnation_of(state.rkey))
    confirm = (tb.used & tb.is_susp_r & ~state.confirmed
               & u32.ugt(dead_key_r,
                         tb.gone_key[tb.subject.clamp(min=0).to(I64)])
               & can_confirm.any(dim=-1))
    conf_s = can_confirm.to(I32).argmax(dim=-1)
    return confirm, state.sent_node.gather(1, conf_s[:, None])[:, 0], \
        dead_key_r


class Originated(NamedTuple):
    """The rumor table after Phase D, and where its candidates went."""

    subject: torch.Tensor
    rkey: torch.Tensor
    birth: torch.Tensor
    confirmed: torch.Tensor
    sent_node: torch.Tensor
    sent_time: torch.Tensor
    overflow: torch.Tensor
    newly: torch.Tensor       # bool[R]  slots allocated this period
    placed: torch.Tensor      # bool[cb] candidate holds a slot
    slot: torch.Tensor        # i32[cb]  its slot (-1 none)
    orig: torch.Tensor        # i32[cb]  its originator


def _originate(cfg: SwimConfig, state: RumorState, t, tb: Table,
               overflow: torch.Tensor, c_subj, c_key, c_orig, c_valid,
               c_src, c_susp) -> Originated:
    """Phase D (deviation 4): the first `_budget` valid candidates, in
    candidate order, deduplicated among themselves (the earlier wins)
    and against the table, take free slots; placed suspect-class
    candidates join their rumor's sentinels; confirmations mark their
    suspicion.  The caller clears the heard-bits of `newly` and lets
    the originators hear their rumors."""
    r_cap, s_cap = cfg.rumor_slots, cfg.sentinels
    dev = c_valid.device
    cb = _budget(cfg)
    subject, rkey, used = tb.subject, state.rkey, tb.used
    total = c_valid.sum(dtype=I32)
    m = c_valid.shape[0]
    ci = scatter.first_true(c_valid, cb, m)
    got = ci < m
    ci = ci.clamp(max=m - 1).to(I64)
    subj_c = torch.where(got, c_subj[ci], -1)
    key_c = torch.where(got, c_key[ci], 0)
    orig_c = torch.where(got, c_orig[ci], 0)
    src_c = torch.where(got, c_src[ci], -1)
    susp_c = got & c_susp[ci]
    overflow = overflow + (total - cb).clamp(min=0)

    # dedup within the candidates (the earlier wins)
    eq = (subj_c[:, None] == subj_c[None, :]) & (key_c[:, None]
                                                 == key_c[None, :])
    earlier = torch.ones((cb, cb), dtype=torch.bool, device=dev).tril(-1)
    dup_mask = eq & earlier & got[None, :] & got[:, None]
    dup_prev = dup_mask.any(dim=-1)
    win_idx = dup_mask.to(I32).argmax(dim=-1)

    # dedup against the table
    ex = (used[None, :] & (subj_c[:, None] == subject[None, :])
          & (key_c[:, None] == rkey[None, :]))
    ex_match = ex.any(dim=-1)
    ex_slot = ex.to(I32).argmax(dim=-1).to(I32)

    needs_slot = got & ~dup_prev & ~ex_match
    free_slots = scatter.first_true(~used, cb, r_cap)
    n_free = (~used).sum(dtype=I32)
    apos = needs_slot.to(I32).cumsum(0, dtype=I32) - 1
    alloc_ok = needs_slot & (apos < n_free.clamp(max=cb))
    slot_new = torch.where(alloc_ok,
                           free_slots[apos.clamp(0, cb - 1).to(I64)], -1)
    overflow = overflow + (needs_slot & ~alloc_ok).sum(dtype=I32)

    slot_f0 = torch.where(ex_match, ex_slot, slot_new)
    slot_f = torch.where(dup_prev, slot_f0[win_idx.to(I64)], slot_f0)
    placed = got & (slot_f >= 0)

    # write the allocated slots (distinct by construction)
    wslot = torch.where(alloc_ok, slot_f, r_cap)
    subject = scatter.set_drop(subject, wslot, subj_c)
    rkey_new = scatter.set_drop(rkey, wslot, key_c)
    birth = scatter.set_drop(state.birth, wslot, t)
    confirmed = scatter.set_drop(state.confirmed, wslot, False)
    snode = scatter.set_drop(state.sent_node, wslot, -1)
    stime = scatter.set_drop(state.sent_time, wslot, 0)
    newly = scatter.set_drop(torch.zeros_like(state.confirmed), wslot, True)

    # sentinel joins: a placed suspect-class candidate is an independent
    # suspector; it takes a free sentinel slot if it is new there
    joiner = placed & susp_c
    tgt_r = torch.where(joiner, slot_f, r_cap)
    tgt_cl = tgt_r.clamp(0, r_cap - 1).to(I64)
    already = (snode[tgt_cl] == orig_c[:, None]).any(dim=-1) & joiner
    joiner = joiner & ~already
    tgt_r = torch.where(joiner, slot_f, r_cap)
    same_r = tgt_r[:, None] == tgt_r[None, :]
    grp_rank = (same_r & earlier & joiner[None, :]).sum(dim=-1, dtype=I32)
    fill_now = (snode[tgt_cl] >= 0).sum(dim=-1, dtype=I32)
    spos = fill_now + grp_rank
    j_ok = joiner & (spos < s_cap)
    wr = torch.where(j_ok, tgt_r, r_cap)
    ws = spos.clamp(0, s_cap - 1)
    snode = scatter.set_drop(snode, wr, orig_c, col=ws)
    stime = scatter.set_drop(stime, wr, t, col=ws)

    # mark the confirmed suspicions whose DEAD rumor landed
    confirmed = scatter.set_drop(
        confirmed, torch.where(placed & (src_c >= 0), src_c, r_cap), True)
    return Originated(subject, rkey_new, birth, confirmed, snode, stime,
                      overflow, newly, placed, slot_f, orig_c)


def _choose(cfg: SwimConfig, st: RumorState, own: torch.Tensor,
            up_own: torch.Tensor, joined: torch.Tensor, rnd: RumorRandomness,
            t):
    """Phase A (deviation 3) for the prober rows `own` (global ids)
    whose heard-bits are `st.knows`, `rnd` cut to those rows: (target
    i32[m], prober bool[m], proxies i32[m, k])."""
    n = cfg.n_nodes
    base = rnd.base
    n_m1 = float(n - 1)     # exact in f32 for n < 2**24

    def draw_tgt(u):
        idx = (u * n_m1).to(I32).clamp(max=n - 2)
        return idx + (idx >= own).to(I32)

    if cfg.target_selection == "round_robin":
        m = own.shape[0]
        epoch = (t // (n - 1)).expand(m).contiguous()
        pos = (t % (n - 1)).expand(m).contiguous()
        target = sampling.round_robin_target(own, epoch, pos, n)
        prober = up_own & joined[target.to(I64)]
    else:
        target = draw_tgt(base.target_u)
        bad = _believes_dead(st, target) | ~joined[target.to(I64)]
        for a in range(RESAMPLE_ATTEMPTS):
            nxt = draw_tgt(rnd.resample_u[:, a])
            target = torch.where(bad, nxt, target)
            bad = bad & (_believes_dead(st, target)
                         | ~joined[target.to(I64)])
        prober = up_own & ~bad & (n >= 2)

    # proxies: uniform over j not in {i, T(i)}
    lo = torch.minimum(own, target)
    hi = torch.maximum(own, target)
    idx2 = (base.proxy_u * float(max(n - 2, 1))).to(I32).clamp(
        max=max(n - 3, 0))
    prox = idx2 + (idx2 >= lo[:, None]).to(I32)
    prox = prox + (prox >= hi[:, None]).to(I32)                # i32[m, k]
    # only n <= 2 reaches n here, where no proxy message is sent; the
    # reference's gathers clamp the index the same way
    return target, prober, prox.clamp(max=n - 1)


def step(cfg: SwimConfig, state: RumorState, plan: FaultPlan,
         rnd: RumorRandomness, *, tap=None, prof=None,
         rows: Rows | None = None) -> RumorState:
    """One protocol period for all N nodes (reference rumor.py:212-649).
    The incoming state is left untouched.  `tap`, a dict, receives the
    period's EngineFrame fields (obs/engine.py; no index_overflow) as
    int32 device scalars; the selection statistics are those of the
    first wave's selection, which reads the start-of-period heard-bits.
    `prof`, an obs/prof.py PhaseProbe, marks the ends of select, merge,
    commit and (beside a tap) telemetry_tap; in prefix mode the step
    returns the captured live set of its phase.

    `rows` (common.Rows; None: all N) is the block of rows whose
    `knows`, `inc_self` and `lha` the state holds, the table, the
    tombstones, `plan` and `rnd` whole: a partitioned step
    (parallel/partition.py) runs this body on each shard's block.  The
    knower counts are summed over the blocks; the probers choose on
    their own rows and one gather shares the choices; each wave's
    sender rows select, one gather shares the selections, and the
    receiver rows hear the messages addressed to them; the sentinels'
    verdicts are joined over the blocks and the originations of each
    block gathered in node order, so every block runs the same
    allocation."""
    n, k, r_cap = cfg.n_nodes, cfg.k_indirect, cfg.rumor_slots
    rows = rows or Rows(n)
    m = rows.m
    plan, prog = faults.split_program(plan)
    t = state.step
    base = rnd.base
    dev = state.knows.device
    ids = torch.arange(n, dtype=I32, device=dev)
    rr = torch.arange(r_cap, dtype=I32, device=dev)
    crashed = faults.crashed_mask(plan, t)
    joined = plan.join_step <= t
    up = ~crashed & joined
    own, up_own = rows.take(ids), rows.take(up)

    # ---- Phase 0: retire stale rumors -------------------------------------
    tb = _retire(cfg, state, t, rows.psum(live_knowers(state.knows, up_own)),
                 up.sum(dtype=I32))
    subject, gone_key, used = tb.subject, tb.gone_key, tb.used
    rkey = state.rkey
    st = state._replace(subject=subject, gone_key=gone_key)

    # ---- Phase A: probe targets (deviation 3) -----------------------------
    target, prober, prox = rows.gather(_choose(
        cfg, st, own, up_own, joined, tree_map(rows.take, rnd), t))
    has_proxy = n > 2
    delivered = faults.float_delivery(plan, prog, t, up)

    # ---- Phase B: global piggyback candidates (deviation 1) ---------------
    b_pig = min(cfg.max_piggyback, r_cap)
    eligible, cand_idx, cand_valid = _candidates(cfg, tb, rr)
    cand64 = cand_idx.to(I64)

    if prof is not None and prof.cut("select", target):
        return prof.capture(target=target, prox=prox, prober=prober,
                            cand_idx=cand_idx, cand_valid=cand_valid,
                            subject=subject, gone_key=gone_key)

    # the period's heard-bits, written in place; row m is the spare row
    # that takes the writes of False (made from `knows`, so that under
    # vmap it carries the lane axis)
    kbuf = torch.cat([state.knows, state.knows.new_zeros((1, r_cap))])
    knows = kbuf[:m]
    true = torch.ones((), dtype=torch.bool, device=dev)
    first_val = []          # the first wave's val [m, B], for the tap

    def wave(src, dst, sent, u_loss, forced, reply=False):
        """One message wave: per-sender first-B selection, then the
        receivers hear the selected rumors (and the forced one)."""
        src64, dst64 = src.to(I64), dst.to(I64)
        kn = knows.index_select(1, cand64) & cand_valid[None, :]
        sel, val = _select_first_b(kn, cand_idx, b_pig)
        if tap is not None and not first_val:
            first_val.append(val)
        sel, val = rows.gather((sel, val))
        ok = sent & delivered(src64, dst64, u_loss, reply)
        d_row, upd = rows.local(dst64, val[src64] & ok[:, None])  # [M, B]
        kbuf[torch.where(upd, d_row[:, None], m), sel[src64].to(I64)] = true
        d_row, fok = rows.local(dst64, ok & (forced >= 0))
        kbuf[torch.where(fok, d_row, m), forced.clamp(min=0).to(I64)] = true
        return ok

    buddy_on = cfg.lifeguard and cfg.buddy

    def buddy(src, dst):
        """Rumor index of src's SUSPECT witness about dst, -1 if none,
        read on the sender's rows (a shard's 1 + index, 0 where it is
        not the sender, sum to the values)."""
        if not buddy_on:
            return torch.full(src.shape, -1, dtype=I32, device=dev)
        mine = rows.mine(src)
        best, arg = _heard_max(knows, subject, rkey, dst,
                               rows=torch.where(mine, src - rows.off, 0))
        forced = torch.where(lattice.is_suspect(best), arg, -1)
        return rows.psum(torch.where(mine, forced + 1, 0)) - 1

    none_n = torch.full((n,), -1, dtype=I32, device=dev)
    none_nk = torch.full((n * k,), -1, dtype=I32, device=dev)
    src3 = repeat(ids, k)
    dst3 = prox.reshape(-1)
    tgt4 = repeat(target, k)

    w1_ok = wave(ids, target, prober, base.loss_w1, buddy(ids, target))
    acked = wave(target, ids, w1_ok, base.loss_w2, none_n, reply=True)
    need = prober & ~acked & has_proxy
    w3_ok = wave(src3, dst3, repeat(need, k), base.loss_w3.reshape(-1),
                 none_nk)
    w4_ok = wave(dst3, tgt4, w3_ok, base.loss_w4.reshape(-1),
                 buddy(dst3, tgt4))
    w5_ok = wave(tgt4, dst3, w4_ok, base.loss_w5.reshape(-1), none_nk,
                 reply=True)
    w6_ok = wave(dst3, src3, w5_ok, base.loss_w6.reshape(-1), none_nk,
                 reply=True)
    relayed = w6_ok.reshape(n, k).any(dim=-1)
    st = st._replace(knows=knows)

    if prof is not None and prof.cut("merge", knows):
        return prof.capture(knows=knows, acked=acked, relayed=relayed)

    # ---- Phase C: end-of-period verdicts, on the rows held ----------------
    # 1. probe verdicts
    target = rows.take(target)
    prober = rows.take(prober)
    failed = prober & ~(rows.take(acked) | rows.take(relayed))
    lha = state.lha
    if cfg.lifeguard:
        bump = torch.where(failed, 1, -1).to(I32)
        lha = torch.where(prober, (lha + bump).clamp(0, cfg.lha_max), lha)
        thin = rows.take(base.lha_u) < (1.0 / (1 + state.lha).to(
            torch.float32))
        failed = failed & thin
    viewed_tk, _ = opinion_of(st, target)
    v_status = lattice.status_of(viewed_tk)
    mk_suspect = failed & (v_status == 0)            # new suspicion
    re_suspect = failed & (v_status == 1)            # independent suspector
    susp_key = lattice.suspect_key(lattice.incarnation_of(viewed_tk))

    # 2. refutation (own view of self is SUSPECT -> bump incarnation)
    self_max, _ = _heard_max(knows, subject, rkey, own)
    self_best = u32.umax(self_max, lattice.alive_key(state.inc_self))
    refute = up_own & lattice.is_suspect(self_best)
    new_inc = torch.where(refute, lattice.incarnation_of(self_best) + 1,
                          state.inc_self)
    inc_self = new_inc
    if cfg.lifeguard:
        lha = torch.where(refute, (lha + 1).clamp(0, cfg.lha_max), lha)

    # 3. suspicion expiry via sentinels (deviation 2), each sentinel's
    # refutation read on its row
    deadline_hit, higher = _deadlines(cfg, state, plan, t, tb)
    s_row, s_mine = rows.local(state.sent_node.clamp(min=0).to(I64),
                               torch.ones_like(deadline_hit))
    refuted = rows.any(torch.stack(
        [(higher & knows[s_row[:, s]]).any(dim=-1)
         for s in range(cfg.sentinels)], dim=-1) & s_mine)        # [R, S]
    confirm, conf_node, dead_key_r = _confirm(state, tb, deadline_hit,
                                              refuted)

    # ---- Phase D: originations (deviation 4) ------------------------------
    # candidate order is priority: confirms, then refutes, then suspects,
    # each in node order
    cb = _budget(cfg)
    (rv, rsubj, rkey_c, rorig), rdrop = rows.compact(
        refute, (own, lattice.alive_key(new_inc), own), cb)
    (sv, ssubj, skey_c, sorig), sdrop = rows.compact(
        mk_suspect | re_suspect, (target, susp_key, own), cb)
    mc = rv.shape[0]
    od = _originate(
        cfg, state, t, tb, state.overflow + rdrop + sdrop,
        c_subj=torch.cat([subject, rsubj, ssubj]),
        c_key=torch.cat([dead_key_r, rkey_c, skey_c]),
        c_orig=torch.cat([conf_node.clamp(min=0), rorig, sorig]),
        c_valid=torch.cat([confirm, rv, sv]),
        c_src=torch.cat([rr, torch.full((2 * mc,), -1, dtype=I32,
                                        device=dev)]),
        c_susp=torch.cat([torch.zeros((r_cap + mc,), dtype=torch.bool,
                                      device=dev),
                          torch.ones((mc,), dtype=torch.bool, device=dev)]))
    # clear the heard-bits of reused slots, then the originators hear
    # their rumors
    knows &= ~od.newly[None, :]
    o_row, o_val = rows.local(od.orig.to(I64), od.placed)
    kbuf[torch.where(o_val, o_row, m), od.slot.clamp(min=0).to(I64)] = true

    # inactive nodes are frozen (their heard-bits of reused slots are
    # still cleared above)
    inc_self = torch.where(up_own, inc_self, state.inc_self)
    lha = torch.where(up_own, lha, state.lha)

    if prof is not None and prof.cut("commit", od.rkey, u32=True):
        return prof.capture(
            knows=knows, inc_self=inc_self, lha=lha, gone_key=gone_key,
            subject=od.subject, rkey=od.rkey, birth=od.birth,
            snode=od.sent_node, stime=od.sent_time, confirmed=od.confirmed,
            overflow=od.overflow)

    if tap is not None:
        row_bits = first_val[0].sum(dim=-1, dtype=I32)           # [m]
        counts = rows.psum(torch.stack([
            row_bits.sum(dtype=I32),
            ((row_bits >= b_pig) & up_own).sum(dtype=I32),
            failed.sum(dtype=I32)]))
        tap["sel_slots_selected"] = counts[0]
        tap["sel_rows_saturated"] = counts[1]
        tap["sel_slots_max"] = rows.pmax(row_bits.max())
        # heard (node, eligible rumor) pairs at period start: per-rumor
        # heard counts (< 2**31), summed with the reference's int32 wrap
        heard = rows.psum(live_knowers(state.knows, torch.ones_like(up_own)))
        tap["win_occupancy"] = u32.from_u64(
            torch.where(eligible, heard, 0).sum(dtype=I64))
        tap["waves_delivered"] = torch.cat(
            [w1_ok, acked, w3_ok, w4_ok, w5_ok, w6_ok]).sum(dtype=I32)
        tap["probes_failed"] = counts[2]
        tap["overflow"] = od.overflow
        if prof is not None:
            prof.cut("telemetry_tap", tap["sel_slots_selected"])

    return RumorState(
        knows=knows, inc_self=inc_self, lha=lha, gone_key=gone_key,
        subject=od.subject, rkey=od.rkey, birth=od.birth,
        sent_node=od.sent_node, sent_time=od.sent_time,
        confirmed=od.confirmed, overflow=od.overflow, step=t + 1)


def run(cfg: SwimConfig, state: RumorState, plan: FaultPlan, seed: int,
        periods: int) -> RumorState:
    """`periods` protocol periods from `state`: the reference's
    `rumor.run(cfg, state, plan, jax.random.key(seed), periods)`."""
    return run_periods(cfg, state, plan, seed, periods, step,
                       draw_period_rumor)


class RumorEngine(Engine):
    """(cfg, plan, state) on one device, stepping with `run`."""

    init_state = staticmethod(init_state)
    step = staticmethod(step)
    draw = staticmethod(draw_period_rumor)

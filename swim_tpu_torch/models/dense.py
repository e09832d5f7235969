"""Dense engine (port of `swim_tpu/models/dense.py`): the exact O(N^2)
SWIM simulation.

One protocol period for all N nodes over [N, N] tensors: view keys
`key[i, j]` (i's opinion of j) merge by an unsigned scatter-max, the
piggyback selection is a per-row top-B over (retransmit count,
subject), a message wave is a gather from the senders' rows and a
scatter into the receivers', and crash / partition / loss (and a
FaultProgram's link and gray lanes) are masks.  The reference's module
docstring holds the protocol semantics; this port reproduces its state
bit for bit under the same PeriodRandomness.

Plain PyTorch: the reference runs this engine outside any Pallas
kernel.  Layouts follow the reference; `key` is a u32 array in an
int32 carrier (ops/u32.py), so every order on it is unsigned.

Ties: `torch.topk` does not fix the order of equal values, and the
reference's top-k keeps the lower index first.  The piggyback sort key
folds the column index into the invalid entries, so every key is
unique and the order is the reference's; validity is read from the
unfolded rank.  The uniform pick `argmax(cumsum > idx)` is a
`searchsorted` on the cumsum (the first position past idx), which
needs no [N, k, N] mask.

Host syncs: none inside `step` for uniform targets.  Round-robin
targets read the Feistel cycle-walk's loop condition on the host
(ops/sampling.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models.common import Engine, Rows, repeat, run_periods
from swim_tpu_torch.ops import lattice, sampling, u32
from swim_tpu_torch.sim import faults
from swim_tpu_torch.sim.faults import FaultPlan
from swim_tpu_torch.utils.prng import PeriodRandomness, draw_period

I32 = torch.int32
I64 = torch.int64
NO_DEADLINE = 2**31 - 1
RANK_INF = 2**30


class DenseState(NamedTuple):
    """The reference's five fields; `key` is a u32 carrier."""

    key: torch.Tensor         # u32[N, N]  key[i, j] = i's opinion of j
    retransmit: torch.Tensor  # i32[N, N]  gossip send counts
    deadline: torch.Tensor    # i32[N, N]  suspicion expiry period
    lha: torch.Tensor         # i32[N]     Lifeguard local health score
    step: torch.Tensor        # i32        periods completed


U32_FIELDS = frozenset({"key"})


def init_state(cfg: SwimConfig, device=None) -> DenseState:
    dev = devmod.resolve(device)
    n = cfg.n_nodes
    i32 = dict(dtype=I32, device=dev)
    return DenseState(
        key=torch.zeros((n, n), **i32),          # alive_key(0) == 0
        retransmit=torch.full((n, n), cfg.retransmit_limit, **i32),
        deadline=torch.full((n, n), NO_DEADLINE, **i32),
        lha=torch.zeros((n,), **i32),
        step=torch.tensor(0, **i32),
    )


def _masked_pick(mask: torch.Tensor, u: torch.Tensor):
    """Uniform pick over each row's True positions (the reference's f32
    math): the (floor(u * c) + 1)-th set bit; (index i32[N], valid)."""
    c = mask.sum(dim=-1, dtype=I32)
    idx = (u * c.to(torch.float32)).to(I32)
    idx = torch.minimum(idx, (c - 1).clamp(min=0))
    cum = mask.to(I32).cumsum(-1, dtype=I32)
    pick = torch.searchsorted(cum, idx[:, None], right=True,
                              out_int32=True)[:, 0]
    return torch.where(c > 0, pick, 0), c > 0


def _piggyback(cfg: SwimConfig, retransmit: torch.Tensor):
    """Per-sender top-B: fewest retransmissions first, ties by subject
    id; (sel_idx i32[N, B], sel_valid bool[N, B]), B = min(B, N)."""
    n, b = cfg.n_nodes, min(cfg.max_piggyback, cfg.n_nodes)
    j_ids = torch.arange(n, dtype=I32, device=retransmit.device)
    valid = retransmit < cfg.retransmit_limit
    rank = torch.where(valid, retransmit * (n + 1) + j_ids, RANK_INF + j_ids)
    vals, sel_idx = torch.topk(rank, b, dim=-1, largest=False, sorted=True)
    return sel_idx.to(I32), vals < RANK_INF


def _apply_forced(sel_idx, sel_valid, skey, forced, fkey):
    """Lifeguard buddy: prepend the `forced` subject (-1 = none), whose
    key at the sender is `fkey`, where it is not already selected,
    dropping the last slot; `skey` holds the sender's keys of the
    selected subjects.  (msel, mval, payload) per message."""
    present = (sel_valid & (sel_idx == forced[:, None])).any(dim=-1)
    need = ((forced >= 0) & ~present)[:, None]
    f_idx = torch.cat([forced.clamp(min=0)[:, None], sel_idx[:, :-1]], dim=1)
    f_valid = torch.cat([torch.ones_like(sel_valid[:, :1]),
                         sel_valid[:, :-1]], dim=1)
    f_key = torch.cat([fkey[:, None], skey[:, :-1]], dim=1)
    return (torch.where(need, f_idx, sel_idx),
            torch.where(need, f_valid, sel_valid),
            torch.where(need, f_key, skey))


def _choose(cfg: SwimConfig, key: torch.Tensor, own: torch.Tensor,
            ids: torch.Tensor, joined: torch.Tensor, up_own: torch.Tensor,
            target_u: torch.Tensor, proxy_u: torch.Tensor, t):
    """Phase A, every random choice of the prober rows `own` (global
    ids) whose keys are `key` [m, N]: (target i32[m], prober bool[m],
    proxies i32[m, k], has_proxy bool[m])."""
    n = cfg.n_nodes
    cand = ((key >= 0) & (ids[None, :] != own[:, None])
            & joined[None, :])                        # not DEAD, not self
    if cfg.target_selection == "round_robin":
        m = own.shape[0]
        epoch = (t // (n - 1)).expand(m).contiguous()
        pos = (t % (n - 1)).expand(m).contiguous()
        target = sampling.round_robin_target(own, epoch, pos, n)
        prober = up_own & joined[target.to(I64)]
    else:
        target, has_cand = _masked_pick(cand, target_u)
        prober = up_own & has_cand
    cand2 = cand & (ids[None, :] != target[:, None])
    c2 = cand2.sum(dim=-1, dtype=I32)
    idx2 = (proxy_u * c2[:, None].to(torch.float32)).to(I32)
    idx2 = torch.minimum(idx2, (c2 - 1).clamp(min=0)[:, None])
    cum2 = cand2.to(I32).cumsum(-1, dtype=I32)
    proxies = torch.searchsorted(cum2, idx2, right=True, out_int32=True)
    proxies = torch.where((c2 > 0)[:, None], proxies, 0)      # i32[m, k]
    return target, prober, proxies, c2 > 0


def step(cfg: SwimConfig, state: DenseState, plan: FaultPlan,
         rnd: PeriodRandomness, *, tap=None, prof=None,
         rows: Rows | None = None) -> DenseState:
    """One protocol period for all N nodes (reference dense.py:104-344).
    The incoming state is left untouched.  `tap`, a dict, receives the
    period's EngineFrame fields (obs/engine.py; no overflow fields) as
    int32 device scalars; the selection statistics are those of the
    first wave's piggyback pass, which reads the start-of-period
    retransmit counts.  `prof`, an obs/prof.py PhaseProbe, marks the
    ends of select, merge, commit and (beside a tap) telemetry_tap; in
    prefix mode the step returns the captured live set of its phase.

    `rows` (common.Rows; None: all N) is the block of rows `state`
    holds, `plan` and `rnd` whole: a partitioned step
    (parallel/partition.py) runs this body on each shard's block.  The
    probers choose on their own rows, and one gather shares the
    choices; each wave's sender rows pick its piggyback and advance
    their counts, one gather shares the picks, and the receiver rows
    merge the messages addressed to them.  A message's sender is found
    from the whole target and proxy vectors, so no message is lost."""
    n, k = cfg.n_nodes, cfg.k_indirect
    rows = rows or Rows(n)
    plan, prog = faults.split_program(plan)
    t = state.step
    dev = state.key.device
    key, retransmit, deadline, lha = (state.key, state.retransmit,
                                      state.deadline, state.lha)
    ids = torch.arange(n, dtype=I32, device=dev)
    crashed = faults.crashed_mask(plan, t)
    joined = plan.join_step <= t
    up = ~crashed & joined
    delivered = faults.float_delivery(plan, prog, t, up)
    own, up_own = rows.take(ids), rows.take(up)

    # ---- Phase A: all random choices --------------------------------------
    target, prober, proxies, has_proxy = rows.gather(_choose(
        cfg, key, own, ids, joined, up_own, rows.take(rnd.target_u),
        rows.take(rnd.proxy_u), t))
    t64 = target.to(I64)

    if prof is not None and prof.cut("select", target):
        return prof.capture(target=target, proxies=proxies, prober=prober)

    buddy_on = cfg.lifeguard and cfg.buddy

    def buddy(cur_key, src, dst):
        """Forced subject per message: dst where src believes dst
        SUSPECT in the current view, else -1; and src's key of dst.
        The sender's rows read it; a shard's count of 1 + forced and
        of the key, 0 where it is not the sender, sum to the values."""
        if not buddy_on:
            return torch.full(src.shape, -1, dtype=I32, device=dev), \
                torch.zeros(src.shape, dtype=I32, device=dev)
        src64, dst64 = src.to(I64), dst.to(I64)
        mine = rows.mine(src64)
        cur = cur_key[torch.where(mine, src64 - rows.off, 0), dst64]
        forced = torch.where(lattice.is_suspect(cur), dst, -1)
        both = rows.psum(torch.stack([torch.where(mine, forced + 1, 0),
                                      torch.where(mine, cur, 0)]))
        return both[0] - 1, both[1]

    susp_periods = cfg.suspicion_periods
    first_valid = []        # the first wave's sel_valid [m, B], for the tap

    def wave(carry, src, dst, sent, u_loss, forced, reply=False):
        """One message wave over flat [M] message arrays; returns the
        new carry (key, retransmit, deadline) and the delivered mask."""
        key, retransmit, deadline = carry
        forced, fkey = forced
        src64, dst64 = src.to(I64), dst.to(I64)
        sel_idx, sel_valid = _piggyback(cfg, retransmit)  # wave-start state
        if tap is not None and not first_valid:
            first_valid.append(sel_valid)
        sel_idx, sel_valid, skey = rows.gather(
            (sel_idx, sel_valid, key.gather(1, sel_idx.to(I64))))
        msel, mval, payload = _apply_forced(sel_idx[src64], sel_valid[src64],
                                            skey[src64], forced, fkey)
        mval = mval & sent[:, None]
        msel64 = msel.to(I64)
        # counters advance for every sent message, delivered or not (an
        # integer sum: the same in any order), on the sender's rows
        s_row, s_val = rows.local(src64, mval)
        retransmit = retransmit.reshape(-1).scatter_add(
            0, (s_row[:, None] * n + msel64).reshape(-1),
            s_val.to(I32).reshape(-1)).reshape(rows.m, n)
        ok = sent & delivered(src64, dst64, u_loss, reply)
        # the receiver's rows: an unsigned scatter-max, the undelivered
        # payload 0 flipped to the signed minimum, the max's identity
        d_row, dval = rows.local(dst64, mval & ok[:, None])
        flat = (d_row[:, None] * n + msel64).reshape(-1)
        fkey = u32.flip(key)
        fnew = fkey.reshape(-1).scatter_reduce(
            0, flat, u32.flip(torch.where(dval, payload, 0)).reshape(-1),
            "amax").reshape(rows.m, n)
        new_key = u32.flip(fnew)
        changed = fnew > fkey
        retransmit = torch.where(changed, 0, retransmit)
        deadline = torch.where(
            changed, torch.where(lattice.is_suspect(new_key),
                                 t + susp_periods, NO_DEADLINE), deadline)
        return (new_key, retransmit, deadline), ok

    carry = (key, retransmit, deadline)
    none_nk = (torch.full((n * k,), -1, dtype=I32, device=dev),
               torch.zeros((n * k,), dtype=I32, device=dev))
    none_n = (none_nk[0][:n], none_nk[1][:n])
    # W1: pings i -> T(i); W2: acks T(i) -> i
    carry, w1_ok = wave(carry, ids, target, prober, rnd.loss_w1,
                        buddy(carry[0], ids, target))
    carry, acked = wave(carry, target, ids, w1_ok, rnd.loss_w2, none_n,
                        reply=True)
    # W3: ping-req i -> proxies, for probers with no direct ack
    need = prober & ~acked & has_proxy
    src3 = repeat(ids, k)
    dst3 = proxies.reshape(-1)
    carry, w3_ok = wave(carry, src3, dst3, repeat(need, k),
                        rnd.loss_w3.reshape(-1), none_nk)
    # W4: proxy pings p -> T(i); W5: target acks T(i) -> p; W6: relay p -> i
    tgt4 = repeat(target, k)
    carry, w4_ok = wave(carry, dst3, tgt4, w3_ok, rnd.loss_w4.reshape(-1),
                        buddy(carry[0], dst3, tgt4))
    carry, w5_ok = wave(carry, tgt4, dst3, w4_ok, rnd.loss_w5.reshape(-1),
                        none_nk, reply=True)
    carry, w6_ok = wave(carry, dst3, src3, w5_ok, rnd.loss_w6.reshape(-1),
                        none_nk, reply=True)
    key, retransmit, deadline = carry
    relayed = w6_ok.reshape(n, k).any(dim=-1)

    if prof is not None and prof.cut("merge", key, u32=True):
        return prof.capture(key=key, retransmit=retransmit,
                            deadline=deadline, acked=acked, relayed=relayed)

    # ---- End of period, on the rows held ----------------------------------
    loc = torch.arange(rows.m, dtype=I64, device=dev)
    own64 = own.to(I64)
    prober = rows.take(prober)
    target, t64 = rows.take(target), rows.take(t64)
    # 1. probe verdicts (health read at probe time, updated after)
    failed = prober & ~(rows.take(acked) | rows.take(relayed))
    if cfg.lifeguard:
        bump = torch.where(failed, 1, -1).to(I32)
        lha = torch.where(prober, (lha + bump).clamp(0, cfg.lha_max), lha)
        thin = rows.take(rnd.lha_u) < (1.0 / (1 + state.lha).to(
            torch.float32))
        failed = failed & thin
    cur_tk = key[loc, t64]
    mk_suspect = failed & (lattice.status_of(cur_tk) == 0)
    susp = lattice.suspect_key(lattice.incarnation_of(cur_tk))
    new_tk = torch.where(mk_suspect, u32.umax(cur_tk, susp), cur_tk)
    ch = u32.ugt(new_tk, cur_tk)
    key[loc, t64] = new_tk
    retransmit[loc, t64] = torch.where(ch, 0, retransmit[loc, t64])
    deadline[loc, t64] = torch.where(ch, t + susp_periods,
                                     deadline[loc, t64])

    # 2. refutation: a live node that sees itself suspected bumps its
    # incarnation
    self_k = key[loc, own64]
    refute = up_own & lattice.is_suspect(self_k)
    key[loc, own64] = torch.where(
        refute, lattice.alive_key(lattice.incarnation_of(self_k) + 1), self_k)
    retransmit[loc, own64] = torch.where(refute, 0, retransmit[loc, own64])
    deadline[loc, own64] = torch.where(refute, NO_DEADLINE,
                                       deadline[loc, own64])
    if cfg.lifeguard:
        lha = torch.where(refute, (lha + 1).clamp(0, cfg.lha_max), lha)

    # 3. suspicion expiry -> DEAD
    expire = lattice.is_suspect(key) & (deadline <= t) & up_own[:, None]
    key = torch.where(expire, lattice.dead_key(lattice.incarnation_of(key)),
                      key)
    retransmit = torch.where(expire, 0, retransmit)
    deadline = torch.where(expire, NO_DEADLINE, deadline)

    # inactive (crashed or not yet joined) nodes are frozen
    frozen = ~up_own[:, None]
    key = torch.where(frozen, state.key, key)
    retransmit = torch.where(frozen, state.retransmit, retransmit)
    deadline = torch.where(frozen, state.deadline, deadline)
    lha = torch.where(up_own, lha, state.lha)

    if prof is not None and prof.cut("commit", key, u32=True):
        return prof.capture(key=key, retransmit=retransmit,
                            deadline=deadline, lha=lha)

    if tap is not None:
        b = min(cfg.max_piggyback, n)
        row_bits = first_valid[0].sum(dim=-1, dtype=I32)         # [m]
        counts = rows.psum(torch.stack([
            row_bits.sum(dtype=I32), ((row_bits >= b) & up_own).sum(
                dtype=I32),
            (state.retransmit < cfg.retransmit_limit).sum(dtype=I32),
            failed.sum(dtype=I32)]))
        tap["sel_slots_selected"] = counts[0]
        tap["sel_rows_saturated"] = counts[1]
        tap["sel_slots_max"] = rows.pmax(row_bits.max())
        tap["win_occupancy"] = counts[2]
        tap["waves_delivered"] = torch.cat(
            [w1_ok, acked, w3_ok, w4_ok, w5_ok, w6_ok]).sum(dtype=I32)
        tap["probes_failed"] = counts[3]
        if prof is not None:
            prof.cut("telemetry_tap", tap["sel_slots_selected"])

    return DenseState(key=key, retransmit=retransmit, deadline=deadline,
                      lha=lha, step=t + 1)


def run(cfg: SwimConfig, state: DenseState, plan: FaultPlan, seed: int,
        periods: int) -> DenseState:
    """`periods` protocol periods from `state`: the reference's
    `dense.run(cfg, state, plan, jax.random.key(seed), periods)`."""
    return run_periods(cfg, state, plan, seed, periods, step, draw_period)


class DenseEngine(Engine):
    """(cfg, plan, state) on one device, stepping with `run`."""

    init_state = staticmethod(init_state)
    step = staticmethod(step)
    draw = staticmethod(draw_period)

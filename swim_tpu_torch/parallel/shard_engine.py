"""The exchange-sharded rumor engine (port of
`swim_tpu/parallel/shard_engine.py`).

The rumor engine's period restructured as a per-shard computation plus
compact message exchanges: the protocol only needs to move MESSAGES,
O(N*k*B) small integers a period, never the [N, R] heard-bit matrix.
Shard d owns node rows [d*N/D, (d+1)*N/D) of `knows`, `inc_self` and
`lha`; `gone_key`, the rumor table and the fault plan are replicated,
every shard computing the same updates from replicated inputs and the
collectives' results.  Each shard is one thread of `mesh.run_spmd`,
its rank the reference's `axis_index`.

Each wave: the senders build fixed-size message tuples (`_Msgs`: ids,
delivery, the piggybacked rumor ids, the buddy-forced one, the loss
draws the response chain carries, routing), one `stack_many`
rendezvous moves every shard's block to every shard (flattened in shard
order, the reference's all_gather), and each shard applies the messages
addressed to its rows and answers them locally.  Response waves are
compacted to `exchange_slack` times their expected per-shard load
(`ack_cap`, `rly_cap`) before the exchange; what does not fit is counted
in `overflow`, never silent.  `exchange_slack` = D (the default) is
lossless, and the engine is then bitwise `models/rumor.py`.

Suspicion expiry: each shard checks refutation for the sentinels it
owns, and one rendezvous combines the verdicts, every shard's dropped
messages (the reference's five overflow psums, summed once) and the
shards' compacted originations, concatenated in shard order (= global
id order, the single-device engine's priority).  The allocation then
runs replicated on every shard (`rumor._originate`).  With the live
knowers' psum of Phase 0 a period holds eight rendezvous.

The port reuses the rumor engine's phases and views on a shard's local
rows (`_retire`, `_candidates`, `_believes_dead`, `opinion_of`,
`_heard_max`, `_select_first_b`, `_deadlines`, `_confirm`,
`_originate`), writes a shard's heard-bits into an [S + 1, R] buffer
whose spare row takes the writes the reference drops, and compacts with
`scatter.first_true` (no host sync).  A response wave is built from the
compacted indices of the gathered requests, which gives the reference's
compacted tuple and fills.

The engine models neither FaultProgram lanes nor join churn, as in the
reference: `place` and a run's start refuse such plans (one host read
of `join_step`, never one a period).  It has no telemetry tap or phase
probe.  `start(cfg, plan, device=None)` places a fresh state and a plan
on the default mesh (every card, or 8 slots of one) or on 8 slots of a
named device, and builds its step.  Each shard computes on its own
device: the gathered messages reach it through the collectives, and
each period's randomness is cut to its rows and copied to its device
before the shards start.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import rumor
from swim_tpu_torch.models.common import repeat
from swim_tpu_torch.models.rumor import RumorRandomness, RumorState
from swim_tpu_torch.ops import lattice, sampling, scatter, u32
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.sim import faults
from swim_tpu_torch.sim.faults import FaultPlan, FaultProgram
from swim_tpu_torch.utils import threefry
from swim_tpu_torch.utils.tree import tree_map

I32 = torch.int32
I64 = torch.int64

# the node axis of each RumorState field (None = replicated)
STATE_SPECS = RumorState(
    knows=0, inc_self=0, lha=0, gone_key=None, subject=None, rkey=None,
    birth=None, sent_node=None, sent_time=None, confirmed=None,
    overflow=None, step=None)
PLAN_SPECS = FaultPlan(*(None,) * len(FaultPlan._fields))


class _Msgs(NamedTuple):
    """One wave's exchanged messages (all tensors share leading dim M)."""

    src: torch.Tensor      # i32[M] global sender id
    dst: torch.Tensor      # i32[M] global receiver id
    ok: torch.Tensor       # bool[M] delivered (faults already applied)
    sel: torch.Tensor      # i32[M, B] piggybacked rumor ids
    val: torch.Tensor      # bool[M, B]
    forced: torch.Tensor   # i32[M] buddy-forced rumor id (-1 none)
    carry: torch.Tensor    # f32[M, C] loss draws for the response chain
    meta: torch.Tensor     # i32[M] response routing (target / pinger id)


class _Geometry(NamedTuple):
    d: int          # shards
    n_loc: int      # rows a shard
    ack_cap: int    # W2 slots a shard
    rly_cap: int    # W4-W6 slots a shard
    cb_loc: int     # refute / suspect originations a shard


def _geometry(cfg: SwimConfig, mesh: pmesh.Mesh,
              exchange_slack: int | None) -> _Geometry:
    n, k, d = cfg.n_nodes, cfg.k_indirect, mesh.size
    if n % d:
        raise ValueError(f"n_nodes {n} must divide the mesh size {d}")
    n_loc = n // d
    slack = d if exchange_slack is None else exchange_slack
    return _Geometry(d, n_loc, min(n, slack * n_loc),
                     min(n * k, slack * n_loc * k),
                     max(1, min(n_loc, rumor._budget(cfg))))


def _flat(stacked: tuple) -> _Msgs:
    """[D, M, ...] blocks as [D*M, ...] rows in shard order (explicit row
    count: the carry can be zero wide)."""
    return _Msgs(*(x.reshape((x.shape[0] * x.shape[1],)
                              + tuple(x.shape[2:])) for x in stacked))


def _shard_step(cfg: SwimConfig, g: _Geometry, rank: int,
                coll: pmesh.Collectives, state: RumorState,
                plan: FaultPlan, rnd: RumorRandomness) -> RumorState:
    """Shard `rank`'s period (the reference's `shard_body`): its own
    blocks in, its own blocks of the next state out."""
    n, k, r_cap = cfg.n_nodes, cfg.k_indirect, cfg.rumor_slots
    n_loc = g.n_loc
    dev = state.knows.device
    off = rank * n_loc
    ids_l = off + torch.arange(n_loc, dtype=I32, device=dev)
    rr = torch.arange(r_cap, dtype=I32, device=dev)
    t = state.step
    base = rnd.base
    up_all = ~faults.crashed_mask(plan, t)                  # bool[N] repl
    up_l = up_all[off:off + n_loc]

    # ---- Phase 0: retirement (replicated; knower counts via psum) ------
    knowers = coll.psum(rank, rumor.live_knowers(state.knows, up_l))
    tb = rumor._retire(cfg, state, t, knowers, up_all.sum(dtype=I32))
    subject, rkey = tb.subject, state.rkey
    st = state._replace(subject=subject, gone_key=tb.gone_key)

    # ---- Phase A: targets & proxies (local) -----------------------------
    if cfg.target_selection == "round_robin":
        epoch = (t // (n - 1)).expand(n_loc).contiguous()
        pos = (t % (n - 1)).expand(n_loc).contiguous()
        target = sampling.round_robin_target(ids_l, epoch, pos, n)
        prober = up_l
    else:
        def draw_tgt(u):
            idx = (u * float(n - 1)).to(I32).clamp(max=n - 2)
            return idx + (idx >= ids_l).to(I32)

        target = draw_tgt(base.target_u)
        bad = rumor._believes_dead(st, target)
        for a in range(rumor.RESAMPLE_ATTEMPTS):
            nxt = draw_tgt(rnd.resample_u[:, a])
            target = torch.where(bad, nxt, target)
            bad = bad & rumor._believes_dead(st, target)
        prober = up_l & ~bad
    lo = torch.minimum(ids_l, target)
    hi = torch.maximum(ids_l, target)
    idx2 = (base.proxy_u * float(max(n - 2, 1))).to(I32).clamp(
        max=max(n - 3, 0))
    prox = idx2 + (idx2 >= lo[:, None]).to(I32)
    prox = (prox + (prox >= hi[:, None]).to(I32)).clamp(max=n - 1)
    has_proxy = n > 2
    fault_ok = faults.float_delivery(plan, None, t, up_all)

    def delivered(src, dst, u):
        return fault_ok(src.to(I64), dst.to(I64), u)

    # ---- piggyback selection (local rows; replicated candidates) -------
    b_pig = min(cfg.max_piggyback, r_cap)
    _, cand_idx, cand_valid = rumor._candidates(cfg, tb, rr)
    cand64 = cand_idx.to(I64)

    kbuf = torch.empty((n_loc + 1, r_cap), dtype=torch.bool, device=dev)
    kbuf[:n_loc] = state.knows
    kbuf[n_loc] = False
    knows = kbuf[:n_loc]

    def select_rows():
        """First-B eligible rumors of every local row: (ids, valid)."""
        kn = knows.index_select(1, cand64) & cand_valid[None, :]
        return rumor._select_first_b(kn, cand_idx, b_pig)

    buddy_on = cfg.lifeguard and cfg.buddy

    def buddy(rows, subj):
        """Rumor index of the local row's SUSPECT witness about subj, -1
        if none (rows None: every local row)."""
        if not buddy_on:
            return torch.full(subj.shape, -1, dtype=I32, device=dev)
        best, arg = rumor._heard_max(knows, subject, rkey, subj, rows=rows)
        return torch.where(lattice.is_suspect(best), arg, -1)

    def exchange(m: _Msgs) -> _Msgs:
        return _flat(coll.stack_many(rank, tuple(m)))

    kflat = kbuf.view(-1)
    spare = n_loc * r_cap                 # the spare row's first bit

    def apply(m: _Msgs) -> torch.Tensor:
        """Merge a gathered wave into this shard's rows (fills of the flat
        buffer at row * R + rumor): bool[M] mine."""
        mine = m.ok & (m.dst >= off) & (m.dst < off + n_loc)
        row = torch.where(mine, (m.dst - off).to(I64) * r_cap, spare)
        kflat.index_fill_(0, torch.where(m.val, row[:, None] + m.sel,
                                         spare).reshape(-1), True)
        fok = mine & (m.forced >= 0)
        kflat.index_fill_(0, torch.where(fok, row + m.forced, spare), True)
        return mine

    def respond(m: _Msgs, mine, cap: int, dst, meta, carry=None,
                forced: bool = False):
        """The response wave of the requests in `m` addressed to my rows,
        compacted in request order into `cap` slots: (msgs, dropped).
        `carry` (None: none) rides on to the next response."""
        if carry is None:
            carry = m.carry[:, :0]
        mlen = mine.shape[0]
        ci = scatter.first_true(mine, cap, mlen)
        got = ci < mlen
        cic = ci.clamp(max=mlen - 1).to(I64)
        src = torch.where(got, m.dst[cic], 0)
        row = (src - off).clamp(0, n_loc - 1).to(I64)
        dstc = torch.where(got, dst[cic], 0)
        sel_all, val_all = select_rows()
        out = _Msgs(
            src=src, dst=dstc,
            ok=got & delivered(src, dstc, m.carry[cic, 0]),
            sel=torch.where(got[:, None], sel_all[row], 0),
            val=got[:, None] & val_all[row],
            forced=(torch.where(got, buddy(row, dstc), -1) if forced
                    else torch.full((cap,), -1, dtype=I32, device=dev)),
            carry=torch.where(got[:, None], carry[cic], 0.0),
            meta=torch.where(got, meta[cic], 0))
        return out, (mine.sum(dtype=I32) - cap).clamp(min=0)

    def local_flags(m: _Msgs, mine) -> torch.Tensor:
        """bool[S]: my rows that received one of m's messages."""
        return scatter.set_drop(
            torch.zeros((n_loc,), dtype=torch.bool, device=dev),
            torch.where(mine, m.dst - off, n_loc), True)

    # ---- W1 PING i -> T(i): all local probers ---------------------------
    sel1, val1 = select_rows()
    ok1 = prober & delivered(ids_l, target, base.loss_w1)
    g1 = exchange(_Msgs(src=ids_l, dst=target, ok=ok1, sel=sel1,
                        val=val1 & prober[:, None],
                        forced=buddy(None, target),
                        carry=base.loss_w2[:, None], meta=ids_l))
    del sel1, val1
    mine1 = apply(g1)

    # ---- W2 ACK T(i) -> i: one per ping delivered to my rows ------------
    w2, drop2 = respond(g1, mine1, g.ack_cap, g1.src, g1.dst)
    del g1, mine1
    g2 = exchange(w2)
    del w2
    acked = local_flags(g2, apply(g2))
    del g2

    # ---- W3 PING-REQ i -> p (k fan-out from unacked probers) ------------
    need = prober & ~acked & has_proxy
    sent3 = repeat(need, k)
    sel3, val3 = select_rows()
    src3, dst3 = repeat(ids_l, k), prox.reshape(-1)
    g3 = exchange(_Msgs(
        src=src3, dst=dst3,
        ok=sent3 & delivered(src3, dst3, base.loss_w3.reshape(-1)),
        sel=sel3[:, None].expand(n_loc, k, b_pig).reshape(-1, b_pig),
        val=(val3[:, None].expand(n_loc, k, b_pig).reshape(-1, b_pig)
             & sent3[:, None]),
        forced=torch.full((n_loc * k,), -1, dtype=I32, device=dev),
        carry=torch.stack([base.loss_w4.reshape(-1),
                           base.loss_w5.reshape(-1),
                           base.loss_w6.reshape(-1)], dim=-1),
        meta=repeat(target, k)))
    del sel3, val3
    mine3 = apply(g3)

    # ---- W4 proxy PING p -> T(i) ----------------------------------------
    w4, drop4 = respond(g3, mine3, g.rly_cap, g3.meta, g3.src,
                        g3.carry[:, 1:], forced=True)
    del g3, mine3
    g4 = exchange(w4)
    del w4
    mine4 = apply(g4)

    # ---- W5 target ACK T(i) -> p ----------------------------------------
    w5, drop5 = respond(g4, mine4, g.rly_cap, g4.src, g4.meta,
                        g4.carry[:, 1:])
    del g4, mine4
    g5 = exchange(w5)
    del w5
    mine5 = apply(g5)

    # ---- W6 relay ACK p -> i --------------------------------------------
    w6, drop6 = respond(g5, mine5, g.rly_cap, g5.meta, g5.dst)
    del g5, mine5
    g6 = exchange(w6)
    del w6
    relayed = local_flags(g6, apply(g6))
    del g6

    # ---- Phase C: verdicts / refutation / expiry ------------------------
    failed = prober & ~(acked | relayed)
    lha = state.lha
    if cfg.lifeguard:
        bump = torch.where(failed, 1, -1).to(I32)
        lha = torch.where(prober, (lha + bump).clamp(0, cfg.lha_max), lha)
        thin = base.lha_u < (1.0 / (1 + state.lha).to(torch.float32))
        failed = failed & thin
    viewed_tk, _ = rumor.opinion_of(st._replace(knows=knows), target)
    v_status = lattice.status_of(viewed_tk)
    suspects = failed & ((v_status == 0) | (v_status == 1))
    susp_key = lattice.suspect_key(lattice.incarnation_of(viewed_tk))

    self_max, _ = rumor._heard_max(knows, subject, rkey, ids_l)
    self_best = u32.umax(self_max, lattice.alive_key(state.inc_self))
    refute = up_l & lattice.is_suspect(self_best)
    new_inc = torch.where(refute, lattice.incarnation_of(self_best) + 1,
                          state.inc_self)
    if cfg.lifeguard:
        lha = torch.where(refute, (lha + 1).clamp(0, cfg.lha_max), lha)

    # expiry: refutation checked by whichever shard owns each sentinel
    deadline_hit, higher = rumor._deadlines(cfg, state, plan, t, tb)
    snode = state.sent_node
    local_sent = (snode >= off) & (snode < off + n_loc)
    srow = (snode - off).clamp(0, n_loc - 1).to(I64)
    refuted_l = torch.stack(
        [(higher & knows[srow[:, s]]).any(dim=-1) & local_sent[:, s]
         for s in range(cfg.sentinels)], dim=-1)                  # [R, S]

    # ---- Phase D: local compaction, one gather, replicated allocation --
    def compact_local(valid, subj_a, key_a):
        ci = scatter.first_true(valid, g.cb_loc, n_loc)
        got = ci < n_loc
        cic = ci.clamp(max=n_loc - 1).to(I64)
        return ((got, torch.where(got, subj_a[cic], -1),
                 torch.where(got, key_a[cic], 0),
                 torch.where(got, ids_l[cic], 0)),
                (valid.sum(dtype=I32) - g.cb_loc).clamp(min=0))

    refutes, rdrop = compact_local(refute, ids_l, lattice.alive_key(new_inc))
    susps, sdrop = compact_local(suspects, target, susp_key)
    drops = drop2 + drop4 + drop5 + drop6 + rdrop + sdrop
    gathered = coll.stack_many(rank, (refuted_l, drops, *refutes, *susps))
    refuted = gathered[0].any(dim=0)
    rg, rsubj, rkey_c, rorig, sg, ssubj, skey_c, sorig = (
        x.reshape(-1) for x in gathered[2:])
    confirm, conf_node, dead_key_r = rumor._confirm(state, tb, deadline_hit,
                                                    refuted)
    gl = g.d * g.cb_loc
    od = rumor._originate(
        cfg, state, t, tb, state.overflow + gathered[1].sum(dtype=I32),
        c_subj=torch.cat([subject, rsubj, ssubj]),
        c_key=torch.cat([dead_key_r, rkey_c, skey_c]),
        c_orig=torch.cat([conf_node.clamp(min=0), rorig, sorig]),
        c_valid=torch.cat([confirm, rg, sg]),
        c_src=torch.cat([rr, torch.full((2 * gl,), -1, dtype=I32,
                                        device=dev)]),
        c_susp=torch.cat([torch.zeros((r_cap + gl,), dtype=torch.bool,
                                      device=dev),
                          torch.ones((gl,), dtype=torch.bool, device=dev)]))
    knows &= ~od.newly[None, :]
    mine_o = od.placed & (od.orig >= off) & (od.orig < off + n_loc)
    kflat.index_fill_(0, torch.where(mine_o, (od.orig - off).to(I64)
                                     * r_cap, spare) + od.slot.clamp(min=0),
                      True)

    return RumorState(
        knows=knows, inc_self=torch.where(up_l, new_inc, state.inc_self),
        lha=torch.where(up_l, lha, state.lha), gone_key=tb.gone_key,
        subject=od.subject, rkey=od.rkey, birth=od.birth,
        sent_node=od.sent_node, sent_time=od.sent_time,
        confirmed=od.confirmed, overflow=od.overflow, step=t + 1)


class ShardedRumorStep:
    """step(state, plan, rnd) on a placed state and plan (`place`) and a
    whole RumorRandomness (as `rumor.draw_period_rumor` draws it): the
    placed next state.  `exchange_slack` None is the mesh size D,
    lossless."""

    def __init__(self, cfg: SwimConfig, mesh: pmesh.Mesh,
                 exchange_slack: int | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.geometry = _geometry(cfg, mesh, exchange_slack)

    def __call__(self, state, plan, rnd: RumorRandomness):
        if isinstance(plan, FaultProgram):
            raise NotImplementedError(_PROGRAM_MSG)
        cfg, g = self.cfg, self.geometry

        rnds = [tree_map(lambda x: x.narrow(0, r * g.n_loc, g.n_loc)
                         .to(dev), rnd)
                for r, dev in enumerate(self.mesh.devices)]

        def body(rank, coll):
            return _shard_step(cfg, g, rank, coll, pmesh.block(state, rank),
                               pmesh.block(plan, rank), rnds[rank])

        return pmesh.gather_blocks(pmesh.run_spmd(self.mesh, body),
                                   STATE_SPECS)


def build_step(cfg: SwimConfig, mesh: pmesh.Mesh,
               exchange_slack: int | None = None) -> ShardedRumorStep:
    """step(state, plan, rnd) with explicit exchanges (ShardedRumorStep);
    the study runner takes it as its `step_fn`."""
    return ShardedRumorStep(cfg, mesh, exchange_slack)


def build_run(cfg: SwimConfig, mesh: pmesh.Mesh, periods: int,
              exchange_slack: int | None = None):
    """run(state, plan, root_key): `periods` sharded periods from a
    placed state, each period's randomness drawn as `rumor.run` draws it
    (`root_key` a threefry key or an int seed).  The plan is checked
    once, at the run's start."""
    step_fn = build_step(cfg, mesh, exchange_slack)

    def run(state, plan, root_key):
        _check_plan(pmesh.assemble(plan))
        if isinstance(root_key, int):
            root_key = threefry.key(root_key)
        t0 = int(pmesh.assemble(state.step))
        dev = state.knows.device
        for t in range(t0, t0 + periods):
            state = step_fn(state, plan,
                            rumor.draw_period_rumor(root_key, t, cfg, dev))
        return state

    return run


_PROGRAM_MSG = ("the sharded rumor exchange does not carry FaultProgram "
                "lane segments — use the sharded ring engine")


def _accept_plan(plan) -> FaultPlan:
    """A plain FaultPlan: zero-segment FaultPrograms unwrap (identical by
    the parity contract); real lane programs are refused (the sharded
    ring engine carries those)."""
    base, prog = faults.split_program(plan)
    if prog is not None:
        raise NotImplementedError(_PROGRAM_MSG)
    return base


def _reject_join_plans(plan: FaultPlan) -> None:
    """This engine does not model join churn: refuse a plan with a join
    schedule (one host read)."""
    if np.any(plan.join_step.cpu().numpy() > 0):
        raise NotImplementedError(
            "the sharded exchange engine does not model join churn yet — "
            "use the ring, rumor, or dense engine for join schedules")


def _check_plan(plan) -> FaultPlan:
    plan = _accept_plan(plan)
    _reject_join_plans(plan)
    return plan


def place(cfg: SwimConfig, mesh: pmesh.Mesh, state: RumorState, plan):
    """(placed state, placed plan): knows, inc_self and lha split on the
    node axis; gone_key, the rumor table, the scalars and the plan
    replicated.  Refuses FaultPrograms with segments and join plans."""
    _geometry(cfg, mesh, None)
    plan = _check_plan(plan)
    return (pmesh.place_tree(state, STATE_SPECS, mesh),
            pmesh.place_tree(plan, PLAN_SPECS, mesh))


def start(cfg: SwimConfig, plan, device=None):
    """(mesh, placed initial state, placed plan, sharded step): the
    engine's set-up, as the studies and the CLI run it, on
    `pmesh.start_mesh(device)` (every card, or 8 slots of one device)."""
    mesh = pmesh.start_mesh(device)
    state, plan = place(cfg, mesh, rumor.init_state(cfg, mesh.devices[0]),
                        plan)
    return mesh, state, plan, build_step(cfg, mesh)

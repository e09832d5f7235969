"""The sharded ring engine (port of `swim_tpu/parallel/ring_shard.py`).

The same `ring.step` body runs once per node shard, each shard a thread
of `mesh.run_spmd` holding S = N/D rows, with `ShardOps` supplying the
cross-shard data movement through the in-process collectives of
parallel/mesh.py.  Every method returns the values GlobalOps computes
on the whole node axis, restricted to this shard's rows (node-axis
results) or equal on every shard (reductions and gathers), so the
placed state is bitwise the single-device engine's:

  * rolls: a roll by d = k*S + r is rows [r, S) of shard me+k and rows
    [0, r) of shard me+k+1.  Every shift is a host function of the
    period (+-s_off, +-q_off[a], +-(s_off - q_off[a]), from
    `ring.rotor_offsets`), so the step is given the period's host
    shifts and k and r are host ints: a roll reads the posts of shards
    me+k and me+k+1 point to point (`Collectives.permute`, the
    reference's ppermute), only me+k when r = 0, and a post of its own
    device without a copy.  On the packed scalar wire
    (`ring_scalar_wire="packed"`) a wave's scalars travel as one u8
    bundle (ops/wavepack.py), bools at one bit a node, narrow codes at
    their wire width, and both neighbour blocks unpack before the r-row
    stitch;
  * the wave merge: per wave, the rolled selection block ORed in under
    the wave's mask.  On the "compact" ICI wire the first-B selection
    is packed once into slot indices [S, B] and each wave moves one
    packed block (plus one boundary block a period).  The wavemerge
    kernel ORs each exchanged block into the shard's own window rows
    (offset 0: the block is already rolled), one call a wave, the
    receiver-aligned forced-bit rows with the last; a wave-scope
    sender's forced bit goes into its selection block by a call with
    no wave before the block is exchanged;
  * global sums and maxima: integer sums (max) of the shards' partials;
  * scatters and gathers by global node id: each shard applies the
    updates addressed to its rows; a gather sums the owner's value (one
    owner per id);
  * the pull branch's random-peer reads: a ring pass, the query bundle
    visiting every shard once, each hop one read of shard me-1's post;
  * first-k compaction: local compaction, a gather of D small key
    blocks, a top-k.

`select_first_b`, `cold_update_select` and `merge_waves` run the CUDA
kernels on each shard's own blocks (u32[S, WW] rows, cold u32[RW, S]);
the plain versions with `plain=True`, and on CPU tensors.

Each shard computes on its own device: the exchanged blocks reach it
through the collectives, and each period's randomness is cut to its rows
and copied to its device before the shards start.  `mesh_copy_bytes`
counts what a mesh copies between devices for a period's exchanges: a
permute the blocks its shards read from another device, an all-gather
every other device's blocks into each device.

`place` splits a whole state and plan onto the mesh by the reference's
spec tables (`_state_specs`, `_plan_specs`, `_rnd_specs`),
`mapped_step` gives the sharded step(state, plan, rnd, shifts) on
placed trees (`shifts` the period's host offsets, as
`ring.rotor_offsets` and `ring.period_draws` give them; a step
without them raises), `build_run` a run of periods, and
`mesh.assemble` the whole state back; `start` places a fresh state
and a plan on the default mesh (`mesh.make_mesh()`: one shard per
card, or 8 slots of one card) or on 8 slots of a named device, and
builds its step.  A
`ShardedStep`'s `record`, when set to a list, receives every exchange
of shard 0: its op, the dtype and shape of every tensor it posts
(`payloads`, with the reference's `wire_dtype`: uint32 for the u32
values of `U32_LANES` in their int32 carriers; `dtype` and `shape` name
the main one), the number of such blocks the reference's layout moves
into one device for it (`blocks`: two for a roll by a device-side
distance, D for an all-gather, one otherwise), the offsets o of the
shards me+o whose posts a permute read (`srcs`), and the bytes the bill
charges for it under its labels (`terms`, the convention of
obs/ici.py).  Its `around`, when set, is a per-shard context manager
factory (mesh.run_spmd).  `ShardedStep.built` counts
the steps constructed in the process (analysis/audit.py's build seam).
"""
from __future__ import annotations

import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs.engine import frame_from_tap
from swim_tpu_torch.ops import (coldsel, scatter, selb, u32,
                                wavemerge, wavepack)
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.sim.faults import FaultPlan, FaultProgram
from swim_tpu_torch.utils import threefry

I32 = torch.int32
I64 = torch.int64

# exchange labels whose int32 payloads carry the reference's u32 values
# (ops/u32.py): a record names their wire dtype uint32
U32_LANES = frozenset({"roll_sel_waves", "roll_buddy_vals",
                       "roll_view_verdict"})


class ShardOps:
    """GlobalOps for shard `rank` of `n_shards`, over the collectives
    `coll` (see the module note)."""

    supports_random_gather = True   # the ring-pass exchanges

    def __init__(self, cfg: SwimConfig, n_shards: int, rank: int,
                 coll: pmesh.Collectives, device, plain: bool = False,
                 record: list | None = None, shifts: tuple = ()):
        self.n = cfg.n_nodes
        self.shifts = shifts
        self.d = n_shards
        self.s = self.n // n_shards
        self.rank = rank
        self.lo = rank * self.s
        self.coll = coll
        self.device = device
        self.plain = plain
        self.record = record
        self.wire = cfg.ring_ici_wire
        self.scalar_wire = cfg.ring_scalar_wire
        g = ring.geometry(cfg)
        self.ww = g.ww
        self.b_pig = min(cfg.max_piggyback, g.ww * ring.WORD)
        self._ids = self.lo + torch.arange(self.s, dtype=I32, device=device)
        self._rows = torch.arange(self.s, dtype=I64, device=device)

    def _log(self, op: str, payload, terms: dict, blocks: int = 1,
             srcs: tuple | None = None) -> None:
        """Record one exchange: `payload` is the tensor posted (or a
        tuple of them, the first the main one); `srcs` the offsets of
        the shards a permute read."""
        if self.record is None:
            return
        parts = payload if isinstance(payload, tuple) else (payload,)
        carrier = bool(terms) and all(k in U32_LANES for k in terms)
        desc = []
        for p in parts:
            dtype = str(p.dtype).removeprefix("torch.")
            desc.append({"dtype": dtype, "shape": tuple(p.shape),
                         "wire_dtype": "uint32" if carrier
                         and p.dtype == I32 else dtype})
        entry = {
            "op": op, "dtype": desc[0]["dtype"], "shape": desc[0]["shape"],
            "payloads": desc, "blocks": blocks,
            "bytes": sum(terms.values()), "terms": dict(terms)}
        if srcs is not None:
            entry["srcs"] = tuple(srcs)
        self.record.append(entry)

    # -- node identity ----------------------------------------------------
    def ids(self) -> torch.Tensor:
        return self._ids

    def zeros_nodes(self, dtype, cols: int | None = None) -> torch.Tensor:
        shape = (self.s,) if cols is None else (self.s, cols)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def full_nodes(self, val, dtype) -> torch.Tensor:
        return torch.full((self.s,), val, dtype=dtype, device=self.device)

    # -- reductions -------------------------------------------------------
    def gsum(self, partial: torch.Tensor) -> torch.Tensor:
        self._log("psum", partial, {"psum_scalar": 4 * partial.numel()})
        return self.coll.psum(self.rank, partial)

    def gmax(self, partial: torch.Tensor) -> torch.Tensor:
        return self.coll.pmax(self.rank, partial)

    # -- communication ----------------------------------------------------
    def offsets(self, rnd):
        """(s_off, q_off) of the period: the host shifts the step was
        given, so every roll's source shards are known on the host."""
        return self.shifts[0], self.shifts[1:]

    def _shift(self, d: int) -> tuple[int, int]:
        """(k, r) of a global shift d = k*S + r, d a host int (a device
        value would make every roll wait for the card)."""
        if not isinstance(d, int):
            raise TypeError(f"a sharded roll's shift must be a host int, "
                            f"not {type(d).__name__}")
        return divmod(d % self.n, self.s)

    def _read(self, x, offs: tuple) -> list:
        """The posts of shards me + o for o in `offs` (x posted by every
        shard: a tensor or a tuple of them), on this shard's device."""
        return self.coll.permute(
            self.rank, x, tuple((self.rank + o) % self.d for o in offs))

    def _roll_blocks(self, x, d: int, terms: dict) -> tuple:
        """(blocks, r) of a roll by d, recorded with the bill's `terms`:
        the posts of x of shards me+k and me+k+1 (me+k alone when
        r = 0)."""
        k, r = self._shift(d)
        srcs = (k,) if r == 0 else (k, k + 1)
        self._log("ppermute", x, terms, blocks=2, srcs=srcs)
        return self._read(x, srcs), r

    @staticmethod
    def _stitch(blocks, r: int) -> torch.Tensor:
        """Rows [r, r + S) of blocks[0] ++ blocks[1]."""
        if r == 0:
            return blocks[0].clone()
        return torch.cat([blocks[0][r:], blocks[1][:r]])

    def roll_from(self, x: torch.Tensor, d: int, label=None,
                  itemsize=None) -> torch.Tensor:
        """x at global node (i + d) mod n for my rows i.  A lone bool
        vector on the packed scalar wire ships as a one-part bundle (1
        bit a node); a carrier wider than the wire (`itemsize`) ships
        its low bytes."""
        if (self.scalar_wire == "packed" and x.dim() == 1
                and x.dtype == torch.bool):
            return self.roll_bundle((x,), d, labels=(label,))[0]
        if itemsize is not None and itemsize < x.element_size():
            return self._roll_packed((x,), d, (label,), (itemsize,))[0]
        blocks, r = self._roll_blocks(
            x, d, {label or "roll": 2 * x.numel() * x.element_size()})
        return self._stitch(blocks, r)

    def _roll_packed(self, parts, d, labels, itemsizes):
        payload = wavepack.pack_bundle(parts, itemsizes)
        terms: dict = {}
        for x, lb, sz in zip(parts, labels, itemsizes):
            key = lb or "roll"
            terms[key] = (terms.get(key, 0)
                          + 2 * wavepack.bundle_nbytes(x, sz))
        blocks, r = self._roll_blocks(payload, d, terms)
        unpacked = [wavepack.unpack_bundle(p, parts, itemsizes)
                    for p in blocks]
        return tuple(self._stitch(xs, r) for xs in zip(*unpacked))

    def roll_bundle(self, parts, d, labels=None, itemsizes=None):
        """roll_from over several same-offset node vectors: one u8
        payload on the packed scalar wire, one roll each on the wide."""
        if not parts:
            return ()
        labels = labels or (None,) * len(parts)
        itemsizes = itemsizes or (None,) * len(parts)
        if self.scalar_wire != "packed":
            return tuple(self.roll_from(x, d, label=lb, itemsize=sz)
                         for x, lb, sz in zip(parts, labels, itemsizes))
        return self._roll_packed(tuple(parts), d, tuple(labels),
                                 tuple(itemsizes))

    # -- node-axis scatter/gather by global node id -----------------------
    def _local(self, idx):
        """Global id -> local row; a row not held here -> S (drops)."""
        owned = (idx >= self.lo) & (idx < self.lo + self.s)
        return torch.where(owned, idx - self.lo, self.s), owned

    def scatter_max(self, dst, idx, val, unsigned: bool):
        li, _ = self._local(idx)
        return scatter.scatter_max(dst, li, val, unsigned=unsigned)

    def scatter_add(self, dst, idx, val: int):
        li, owned = self._local(idx)
        out = dst.clone()
        out.scatter_add_(0, torch.where(owned, li, 0).to(I64),
                         torch.where(owned, val, 0).to(dst.dtype))
        return out

    def scatter_or_word(self, win, rows, cols, bits):
        li, owned = self._local(rows)
        win.index_put_((torch.where(owned, li, 0).to(I64), cols.to(I64)),
                       torch.where(owned, bits, 0), accumulate=True)
        return win

    def gather(self, arr, idx):
        """arr[idx] for a node-axis arr and replicated ids: the owner's
        value, summed over the shards."""
        li, owned = self._local(idx)
        v = arr[li.clamp(0, self.s - 1).to(I64)]
        if v.dtype == torch.bool:
            part = torch.where(owned, v, False).to(I32)
        else:
            part = torch.where(owned, v, 0).to(v.dtype)
        self._log("psum", part, {"gather_psum": 4 * max(idx.numel(), 1)})
        out = self.coll.psum(self.rank, part)
        return out > 0 if v.dtype == torch.bool else out

    # -- the pull branch's ring-pass exchanges ----------------------------
    def _shift1(self, xs: tuple) -> tuple:
        """Every tensor of xs from shard me-1 (one ring hop)."""
        if self.d == 1:
            return xs
        self._log("ppermute", tuple(xs), {
            "ring_pass": sum(x.numel() * x.element_size() for x in xs)},
            srcs=(-1,))
        return self._read(tuple(xs), (-1,))[0]

    def gather_nodewise(self, arr, idx):
        """arr[idx] for a node-axis arr and node-axis global ids [S]:
        the query travels the ring, each shard answers what it owns."""
        q = idx.to(I64)
        acc = torch.zeros((self.s,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                          device=arr.device)
        for _ in range(self.d):
            owned = (q >= self.lo) & (q < self.lo + self.s)
            v = arr[(q - self.lo).clamp(0, self.s - 1)]
            ow = owned.reshape((-1,) + (1,) * (arr.dim() - 1))
            acc = torch.where(ow, v, acc)
            q, acc = self._shift1((q, acc))
        return acc

    def gather_rows(self, mat, idx):
        return self.gather_nodewise(mat, idx)

    def knows_nodewise(self, win, cold, slot_pos, rows, slot):
        """Heard-bit of global node ids `rows` [S] for ring slots `slot`
        [S]: the queried word travels the ring, the bit stays home."""
        ok, wcol, word_r, bit = slot_pos(slot)
        q, f, c, r = rows.to(I64), ok, wcol.to(I64), word_r.to(I64)
        acc = torch.zeros((self.s,), dtype=win.dtype, device=win.device)
        for _ in range(self.d):
            owned = (q >= self.lo) & (q < self.lo + self.s)
            lr = (q - self.lo).clamp(0, self.s - 1)
            word = torch.where(f, win[lr, c], cold[r, lr])
            acc = torch.where(owned, word, acc)
            q, f, c, r, acc = self._shift1((q, f, c, r, acc))
        return (slot >= 0) & u32.bit_of(acc, bit)

    def knows_self(self, win, cold, slot_pos, slot):
        """Heard-bit of each local row for ring slots `slot` [S]: no
        exchange."""
        ok, wcol, word_r, bit = slot_pos(slot)
        word = torch.where(ok, win[self._rows, wcol.to(I64)],
                           cold[word_r.to(I64), self._rows])
        return (slot >= 0) & u32.bit_of(word, bit)

    def knows_words(self, win, cold, slot_pos, rows, slot):
        """Heard-bit of replicated global ids `rows` for ring slots
        `slot`: the owner's bit, summed over the shards."""
        ok, wcol, word_r, bit = slot_pos(slot)
        lr, owned = self._local(rows)
        lrc = lr.clamp(0, self.s - 1).to(I64)
        word = torch.where(ok, win[lrc, wcol.to(I64)],
                           cold[word_r.to(I64), lrc])
        kn = (slot >= 0) & u32.bit_of(word, bit)
        part = torch.where(owned, kn, False).to(I32)
        self._log("psum", part, {"knows_psum": 4 * max(slot.numel(), 1)})
        return self.coll.psum(self.rank, part) > 0

    def knows_sentinels(self, win, cold, slot_pos, rows, slot):
        """The sentinel probes: the full-batch branch, as on one
        device."""
        return self.knows_words(win, cold, slot_pos, rows, slot)

    def first_true_nodes(self, valid, k):
        """Local compaction, a gather of the D candidate blocks keyed
        n - id, one top-k (descending keys = ascending ids)."""
        kl = min(k, self.s)
        lidx = scatter.first_true(valid, kl, self.s)
        gidx = torch.where(lidx < self.s, lidx + self.lo, self.n)
        gk = torch.where(gidx < self.n, self.n - gidx, 0).to(I32)
        self._log("all_gather", gk, {"candidates_all_gather":
                                     4 * self.d * kl}, blocks=self.d)
        merged = self.coll.stack(self.rank, gk).reshape(-1)
        kk2 = torch.topk(merged, min(k, self.d * kl)).values
        idx = torch.where(kk2 > 0, self.n - kk2, self.n).to(I32)
        if k > idx.shape[0]:
            idx = torch.cat([idx, torch.full((k - idx.shape[0],), self.n,
                                             dtype=I32, device=idx.device)])
        return idx

    # -- the wave merge ---------------------------------------------------
    def _merge(self, win, sel, oks, bcols=(), bvals=()):
        """`win` (updated in place) |= the already-rolled block `sel`
        under each mask of `oks` (offset 0), then the forced-bit rows:
        one wavemerge call on the shard's own rows."""
        dev = win.device
        bcol = (torch.stack(bcols) if bcols
                else torch.zeros((0, self.s), dtype=I32, device=dev))
        bval = (torch.stack(bvals) if bvals
                else torch.zeros((0, self.s), dtype=I32, device=dev))
        oks = (torch.stack(oks) if oks
               else torch.zeros((0, self.s), dtype=torch.bool, device=dev))
        offs = torch.zeros((oks.shape[0],), dtype=I32, device=dev)
        fn = (wavemerge.merge_waves_plain if self.plain
              else wavemerge.merge_waves)
        return fn(win, sel.contiguous(), oks, offs, bcol.contiguous(),
                  bval.contiguous())

    def merge_waves(self, win, sel, oks, offs, bcols=(), bvals=()):
        """The fused period-scope delivery, `win` updated in place: each
        wave's rolled selection ORed in under its mask, on the window or
        the compact ICI wire, then the receiver-aligned forced bits."""
        last = len(oks) - 1
        if self.wire == "compact":
            idx = wavepack.pack_slots(sel, self.b_pig)
            sz = wavepack.slot_dtype(self.ww).itemsize
            wire = wavepack.narrow_bytes(idx, sz)
            self._log("ppermute", wire,
                      {"sel_wire_boundary": wire.numel()}, srcs=(1,))
            (nxt,) = self._read(wire, (1,))
            both = torch.cat([wire, nxt])
        for w, (ok, d) in enumerate(zip(oks, offs)):
            if self.wire == "compact":
                k, r = self._shift(d)
                z = both[r:r + self.s]
                self._log("ppermute", z, {"roll_sel_waves": z.numel()},
                          srcs=(k,))
                (y,) = self._read(z, (k,))
                rolled = wavepack.unpack_slots(
                    wavepack.widen_bytes(y, idx.dtype), self.ww)
            else:
                rolled = self.roll_from(sel, d, label="roll_sel_waves")
            win = self._merge(win, rolled, [ok],
                              *((bcols, bvals) if w == last else ()))
        if last < 0 and bcols:
            win = self._merge(win, sel, [], bcols, bvals)
        return win

    def merge_wave(self, win, sel, ok, d, cv=None):
        """One wave in-line (the reference's wave-scope delivery): the
        sender's forced bit ORed into its selection row, that block
        rolled, ORed in under ok."""
        if cv is not None:
            sel = self._merge(sel.clone(), sel, [], [cv[0]], [cv[1]])
        return self._merge(
            win, self.roll_from(sel, d, label="roll_sel_waves"), [ok])

    # -- the kernel steps, per shard -------------------------------------
    def select_first_b(self, win_masked, b):
        if self.plain:
            return selb.select_first_b_plain(win_masked, b)
        return selb.select_first_b(win_masked, b)

    def cold_update_select(self, cold, flush_rows, flush_vals, q_rows):
        fn = (coldsel.cold_update_select_plain if self.plain
              else coldsel.cold_update_select)
        return fn(cold, flush_rows, flush_vals, q_rows)


# ---------------------------------------------------------------------------
# Spec tables and the public place / step / run API
# ---------------------------------------------------------------------------


def _state_specs(cfg: SwimConfig) -> ring.RingState:
    """The node axis of each RingState field (None = replicated)."""
    return ring.RingState(
        win=0, cold=1, inc_self=0, lha=0, gone_key=0,
        subject=None, rkey=None, birth0=None, sent_node=None,
        sent_time=None, confirmed=None, overflow=None,
        index_overflow=None, step=None)


def _plan_specs(program: bool = False):
    base = FaultPlan(crash_step=0, loss=None, partition_id=0,
                     partition_start=None, partition_end=None, join_step=0)
    if not program:
        return base
    # the node-axis lanes shard with the nodes; the segment table is
    # a handful of scalars a segment, replicated
    return FaultProgram(
        base=base, domain_id=0, seg_start=None, seg_end=None,
        seg_period=None, seg_on=None, seg_domain=None, seg_kind=None,
        seg_level=None)


def _rnd_specs(cfg: SwimConfig) -> ring.RingRandomness:
    if cfg.ring_probe == "pull":
        # the rotor legs are empty (0,) tensors under pull: replicated;
        # every pull uniform is per node
        return ring.RingRandomness(
            s_off=None, q_off=None, loss_w1=None, loss_w2=None,
            loss_w3=None, loss_w4=None, loss_w5=None, loss_w6=None,
            lha_u=None,
            pull=ring.PullRandomness(*(0,) * len(ring.PullRandomness._fields)))
    return ring.RingRandomness(
        s_off=None, q_off=None, loss_w1=0, loss_w2=0, loss_w3=0,
        loss_w4=0, loss_w5=0, loss_w6=0, lha_u=0, pull=None)


def _check(cfg: SwimConfig, mesh: pmesh.Mesh) -> int:
    d = mesh.size
    if cfg.n_nodes % d != 0:
        raise ValueError(
            f"n_nodes={cfg.n_nodes} must divide over {d} shards")
    return d


def place(cfg: SwimConfig, mesh: pmesh.Mesh, state: ring.RingState, plan):
    """(placed state, placed plan): each field split onto the mesh by
    the spec tables; `plan` a FaultPlan or a FaultProgram."""
    _check(cfg, mesh)
    st = pmesh.place_tree(state, _state_specs(cfg), mesh)
    pl = pmesh.place_tree(plan, _plan_specs(isinstance(plan, FaultProgram)),
                          mesh)
    return st, pl


def _slice_rnd(rnd, specs, lo: int, s: int, device):
    """Shard rows [lo, lo + s) of a period's randomness on `device`
    (replicated leaves whole)."""
    if rnd is None:
        return None
    if isinstance(rnd, tuple):
        return type(rnd)(*(_slice_rnd(x, sp, lo, s, device)
                           for x, sp in zip(rnd, specs)))
    return (rnd if specs is None else rnd.narrow(specs, lo, s)).to(device)


def mesh_copy_bytes(record: list, mesh: pmesh.Mesh) -> int:
    """Bytes `mesh`'s collectives copy between devices for the exchanges
    of `record` (shard 0's, as `ShardedStep.record` keeps them; every
    shard posts the same shapes and passes the same shift): each psum's
    posted bytes times `mesh.reduce_copies()`, each permute's (a roll, a
    ring hop, a compact wire block) times the blocks its shards read
    from another device (`mesh.permute_copies` of its `srcs`), each
    all-gather's times `mesh.stack_copies()`."""
    total = 0
    for e in record:
        posted = sum(getattr(torch, p["dtype"]).itemsize
                     * torch.Size(p["shape"]).numel() for p in e["payloads"])
        if e["op"] == "psum":
            copies = mesh.reduce_copies()
        elif "srcs" in e:
            copies = mesh.permute_copies(e["srcs"])
        else:
            copies = mesh.stack_copies()
        total += posted * copies
    return total


def host_shifts(cfg: SwimConfig, shifts) -> tuple:
    """`shifts` ([s_off, q_off[0..k)] of the period as host ints) as a
    tuple of ints; a ValueError when it is missing or of another
    length."""
    if shifts is None:
        raise ValueError(
            "the sharded ring step needs the period's host shifts "
            "(ring.rotor_offsets(cfg, step), as ring.period_draws yields "
            "them): step(state, plan, rnd, shifts)")
    shifts = tuple(int(x) for x in shifts)
    if len(shifts) != 1 + cfg.k_indirect:
        raise ValueError(f"{len(shifts)} host shifts for k_indirect="
                         f"{cfg.k_indirect}; want s_off and k q_off")
    return shifts


class ShardedStep:
    """The sharded step(state, plan, rnd, shifts) on a placed state and
    plan, a whole RingRandomness (as `ring.draw_period_ring` draws it)
    and the period's host shifts (`ring.rotor_offsets` of its step, as
    `ring.period_draws` yields them beside the randomness; a call
    without them raises ValueError): the placed next state, with
    cfg.telemetry its EngineFrame and with cfg.profiling the int32
    phase-marker vector (obs/prof.py) appended, `(state, frame?,
    markers?)`.  Both extras are reductions over the
    shards, equal on every shard.  `plain=True` runs the kernels' plain
    versions; `record`, a list, collects shard 0's exchanges; `around`
    (rank -> context manager) wraps each shard's body in its thread."""

    built = 0
    # the study runners pass a period's host shifts to a step_fn that
    # says it takes them (sim/runner.make_stepper)
    takes_shifts = True

    def __init__(self, cfg: SwimConfig, mesh: pmesh.Mesh,
                 plain: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.plain = plain
        self.d = _check(cfg, mesh)
        self.record: list | None = None
        self.around = None
        ShardedStep.built += 1

    def __call__(self, state, plan, rnd, shifts=None):
        cfg, d = self.cfg, self.d
        s = cfg.n_nodes // d
        rspecs = _rnd_specs(cfg)
        record = self.record
        shifts = host_shifts(cfg, shifts)

        rnds = [_slice_rnd(rnd, rspecs, r * s, s, dev)
                for r, dev in enumerate(self.mesh.devices)]

        def body(rank, coll):
            from swim_tpu_torch.obs.prof import PhaseProbe

            dev = self.mesh.devices[rank]
            ops = ShardOps(cfg, d, rank, coll, dev, plain=self.plain,
                           record=record if rank == 0 else None,
                           shifts=shifts)
            tap = {} if cfg.telemetry else None
            pr = PhaseProbe() if cfg.profiling else None
            st = ring.step(cfg, pmesh.block(state, rank),
                           pmesh.block(plan, rank), rnds[rank], ops=ops,
                           tap=tap, prof=pr)
            extras = []
            if cfg.telemetry:
                extras.append(frame_from_tap(tap, dev))
            if cfg.profiling:
                extras.append(pr.marker_vector())
            return st, extras

        out = pmesh.run_spmd(self.mesh, body, around=self.around)
        st = pmesh.gather_blocks([o[0] for o in out], _state_specs(cfg))
        extras = out[0][1]
        return (st, *extras) if extras else st


def mapped_step(cfg: SwimConfig, mesh: pmesh.Mesh,
                plain: bool = False) -> ShardedStep:
    """The sharded step on placed trees (see ShardedStep); the study
    runners take it as their `step_fn`."""
    return ShardedStep(cfg, mesh, plain)


def build_step(cfg: SwimConfig, mesh: pmesh.Mesh,
               plain: bool = False) -> ShardedStep:
    """step(state, plan, rnd) with explicit collectives: mapped_step."""
    return mapped_step(cfg, mesh, plain)


def start(cfg: SwimConfig, plan, device=None):
    """(mesh, placed initial state, placed plan, sharded step): the
    engine's set-up, as the studies, memwall and the CLI run it, on
    `pmesh.start_mesh(device)`."""
    mesh = pmesh.start_mesh(device)
    state, plan = place(cfg, mesh, ring.init_state(cfg, mesh.devices[0]),
                        plan)
    return mesh, state, plan, mapped_step(cfg, mesh)


def build_run(cfg: SwimConfig, mesh: pmesh.Mesh, periods: int,
              plain: bool = False):
    """run(state, plan, root_key): `periods` sharded periods from a
    placed state, the randomness of each drawn as `ring.run` draws it
    (`root_key` a threefry key, `threefry.key(seed)`).  With
    cfg.telemetry it returns (state, EngineFrame of [periods] series),
    with cfg.profiling the [periods, len(PHASES)] markers appended;
    otherwise the placed state."""
    sm = mapped_step(cfg, mesh, plain)
    extras = cfg.telemetry or cfg.profiling

    def run(state, plan, root_key):
        if isinstance(root_key, int):
            root_key = threefry.key(root_key)
        ys = []
        t0 = int(pmesh.assemble(state.step))
        for rnd, shifts in ring.period_draws(cfg, root_key, t0, periods,
                                             state.win.device):
            out = sm(state, plan, rnd, shifts)
            if extras:
                state = out[0]
                ys.append(out[1:])
            else:
                state = out
        if not extras:
            return state
        return (state, *(_stack_extra(col) for col in zip(*ys)))

    return run


def _stack_extra(col):
    if isinstance(col[0], tuple):
        return type(col[0])(*(torch.stack(f) for f in zip(*col)))
    return torch.stack(col)


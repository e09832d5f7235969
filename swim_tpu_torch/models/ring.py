"""Ring engine (port of `swim_tpu/models/ring.py`).

One protocol period for all N nodes, as the reference's `step` computes
it on either scalar wire, vanilla or with Lifeguard (local health,
buddy, dynamic suspicion): Phase 0 (judge the outgoing window words,
recycle the spreading ones, shift the window), the per-subject top-C
index, the first-B piggyback selection, the probes, Phase C
(refutation, sentinel expiry) and Phase D (originations, with an
optional batch of external ones, `ExtOriginations`: the serving hub's
channel).

Two probe patterns, as in the reference.  Rotor (the default): 2+4k
rolled message waves, then the deferred cold flush with the C+1 view
queries; with `ring_sel_scope="period"` the selection runs once and the
waves fuse into one window merge (up to 32 waves); with "wave", the
default, and beyond 32 waves, the selection (wave scope) and a one-wave
merge run before and for every wave.  A FaultProgram's per-node link
and gray lanes add to each wave's loss threshold.  The packed scalar
wire (`ring_scalar_wire="packed"`, fused period scope only) rolls each
wave's scalars narrowed and bundled, as the reference's single-device
GlobalOps does; its state equals the wide wire's.  Pull-uniform
(`ring_probe="pull"`, what the detection study runs): cold is flushed
in Phase 0, and every node pulls one probe lane from random peers by
row gathers (deviations P1-P4 of the reference).  The reference's
module docstring holds the protocol semantics and the deviations R1-R5;
this port reproduces its state bit for bit.

`live_knower_counts` is the study runner's census (per-slot counts of
live knowers), `resolved_words` the current heard-bits of every ring
word.

Three steps of the period are kernels: `select_first_b`
(ops/selb.py; once a period, or 2+4k times in wave scope on the rotor
path), `merge_waves` (ops/wavemerge.py; rotor only: once with all waves
and the 1+k buddy rows, or once per wave) and `cold_update_select`
(ops/coldsel.py; rotor only, once).
On CUDA tensors they launch the hand-written kernels; on CPU tensors
they run their plain versions.  `step(..., plain=True)` runs the plain
versions on any device: it is the reference `chip_smoke.py` holds the
kernels against on the card.

Layouts and dtypes follow the reference; u32 arrays are int32 carriers
(ops/u32.py).  `step` updates the incoming `state.cold` in place (the
cold-ring flush, as the reference's kernel aliases it); every other
field of the incoming state is left untouched.

Every cross-node movement goes through `GlobalOps`, under the
reference's seam names and roll labels, so that obs/ici.py can tally
the bytes a sharded layout would move and parallel/ring_shard.py can
run the same step on one node shard (its ShardOps).

Host syncs: none inside `step`.  `run` reads `state.step` once and
copies the whole run's rotor offsets to the device once;
`draw_period_ring` without `offsets` copies them per call.  The
reference's
sentinel-probe `lax.cond` (ring.py:1612-1631) is taken as its
full-batch branch, which is bitwise equal to the compacted one and
needs no data-dependent branch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from swim_tpu_torch import device as devmod
from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import rumor
from swim_tpu_torch.ops import (coldsel, lattice, sampling, scatter, selb,
                                u32, wavemerge, wavepack)
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
    fields are int32 carriers.  `cold` is word-major [RW, N]: its node
    axis is the last, as SHARD_AXES tells parallel/mesh.py."""

    SHARD_AXES = {"cold": 1}   # class attribute (not annotated: no field)

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


# ----------------------------------------------------------- randomness


PULL_SRC_ATTEMPTS = 3


class ExtOriginations(NamedTuple):
    """External rumor originations injected into Phase D (reference
    ring.py:219-247): fixed-size [E] int32 carriers, on the state's
    device.

      subject: i32[E]  member the claim is about (-1 = empty entry)
      key:     u32[E]  packed opinion key (the u32 bit pattern)
      origin:  i32[E]  the claim's originator (sentinel bookkeeping)
      hearer:  i32[E]  the node that received the datagram: it gets the
                       heard-bit

    They join the merge at the lowest priority (confirms > refutes >
    internal suspicions > external).  An entry whose rumor already
    exists dedups onto its slot and sets no heard-bit.  Valid entries
    name nodes in [0, N) (the serving hub checks them on the host; the
    step makes no host sync to check them)."""

    subject: torch.Tensor
    key: torch.Tensor
    origin: torch.Tensor
    hearer: torch.Tensor


def ext_none(capacity: int, device=None) -> ExtOriginations:
    """An all-empty injection batch of the given static capacity."""
    dev = devmod.resolve(device)
    zeros = dict(dtype=I32, device=dev)
    return ExtOriginations(subject=torch.full((capacity,), -1, **zeros),
                           key=torch.zeros((capacity,), **zeros),
                           origin=torch.zeros((capacity,), **zeros),
                           hearer=torch.zeros((capacity,), **zeros))


def pow_f32(base: torch.Tensor, expo: torch.Tensor) -> torch.Tensor:
    """base**expo for an f32 base and non-negative int32 expo, by 31
    rounds of square-and-multiply in a fixed order.  Each round is one
    correctly rounded f32 multiply per operand, kept as separate tensor
    ops (no fused multiply-add), so the result equals the reference's
    and `py_pow_f32`'s bit for bit."""
    result = torch.ones(expo.shape, dtype=torch.float32, device=expo.device)
    cur = base.to(torch.float32)
    for bit in range(31):
        result = torch.where(((expo >> bit) & 1) == 1, result * cur, result)
        cur = cur * cur
    return result


def py_pow_f32(base: float, expo: int) -> float:
    """Scalar numpy twin of pow_f32 (same operation order, f32 ops)."""
    result = np.float32(1.0)
    cur = np.float32(base)
    for bit in range(31):
        if (int(expo) >> bit) & 1:
            result = np.float32(result * cur)
        cur = np.float32(cur * cur)
    return float(result)


class PullRandomness(NamedTuple):
    """Per-period f32 uniforms of the pull-uniform probe."""

    m_u: torch.Tensor      # f32[N]     in-probe count draw
    src_u: torch.Tensor    # f32[N, A]  prober-id draws (first alive wins)
    d_fwd: torch.Tensor    # f32[N]     direct ping leg
    d_back: torch.Tensor   # f32[N]     direct ack leg
    px_u: torch.Tensor     # f32[N, k]  proxy-id draws
    px_fwd: torch.Tensor   # f32[N, k]  ping-req + proxy-ping (composed)
    px_back: torch.Tensor  # f32[N, k]  proxy-ack + relay (composed)
    ack_u: torch.Tensor    # f32[N]     ack-gossip contact draw
    ack_leg: torch.Tensor  # f32[N]     its composed ping+ack legs


class RingRandomness(NamedTuple):
    s_off: torch.Tensor    # i32 scalar: probe offset in [1, N)
    q_off: torch.Tensor    # i32[k]: proxy offsets in [1, N)
    loss_w1: torch.Tensor  # u32[N]    u16 draw (rotor; [0] under pull)
    loss_w2: torch.Tensor  # u32[N]    u16 draw
    loss_w3: torch.Tensor  # u32[N, k] u16 draw
    loss_w4: torch.Tensor  # u32[N, k] u16 draw
    loss_w5: torch.Tensor  # u32[N, k] u16 draw
    loss_w6: torch.Tensor  # u32[N, k] u16 draw
    lha_u: torch.Tensor    # u32[N]    u16 draw (Lifeguard thinning)
    pull: PullRandomness | None = None     # pull mode only


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
    from `rotor_offsets`) saves the host-to-device copy per period.
    Pull mode draws nine f32 uniforms instead of the u16 legs (which
    stay empty); the rotor offsets are computed all the same."""
    dev = devmod.resolve(device)
    n, k = cfg.n_nodes, cfg.k_indirect
    if offsets is None:
        offsets = torch.tensor(rotor_offsets(cfg, step), dtype=I32,
                               device=dev)
    kk = threefry.fold_in(key, step)
    if cfg.ring_probe == "pull":
        ks = threefry.split(kk, 9)
        zero = torch.zeros((0,), dtype=I32, device=dev)

        def uni(i, shape):
            return threefry.uniform(ks[i], shape, dev)

        return RingRandomness(
            s_off=offsets[0], q_off=offsets[1:],
            loss_w1=zero, loss_w2=zero, loss_w3=zero, loss_w4=zero,
            loss_w5=zero, loss_w6=zero, lha_u=zero,
            pull=PullRandomness(
                m_u=uni(0, (n,)), src_u=uni(1, (n, PULL_SRC_ATTEMPTS)),
                d_fwd=uni(2, (n,)), d_back=uni(3, (n,)),
                px_u=uni(4, (n, k)), px_fwd=uni(5, (n, k)),
                px_back=uni(6, (n, k)), ack_u=uni(7, (n,)),
                ack_leg=uni(8, (n,))))
    ks = threefry.split(kk, 4)

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


def _col_select_multi(mat: torch.Tensor, cols: list[torch.Tensor]):
    """[mat[i, c[i]] for c in cols]; an out-of-range c yields 0."""
    w = mat.shape[1]
    out = []
    for c in cols:
        v = mat.gather(1, c.clamp(0, w - 1).to(torch.int64)[:, None])[:, 0]
        out.append(torch.where((c >= 0) & (c < w), v, 0))
    return out


def _lane_counts(words: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """int32[OW*32]: per-lane active-knower counts of u32[OW, N] words
    (lane w*32 + b counts active nodes with bit b of word w set).  The
    words are read as little-endian bytes, so byte j's bit i is lane
    bit 8j + i; the expanded bits are one byte each."""
    ow, n = words.shape
    sh = torch.arange(8, dtype=torch.uint8, device=words.device)
    masked = torch.where(active[None, :], words, 0)
    octets = masked.contiguous().view(torch.uint8).reshape(ow, n, 4, 1)
    bits = (octets >> sh) & 1                                 # [OW, N, 4, 8]
    return bits.sum(dim=1, dtype=I32).reshape(ow * WORD)


def _sum32(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=I32)


def _window_overlay(g: RingGeometry, step) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(in_win bool[RW], wcol i32[RW]): which ring words are window-
    resident after `step` completed periods, and which win column holds
    each (the reference's single home of the win/cold overlay)."""
    first_gw = step * g.ow - g.ww          # win col 0 after the last step
    win_ring0 = torch.remainder(first_gw, g.rw)
    word_off = torch.remainder(
        torch.arange(g.rw, dtype=I32, device=win_ring0.device) - win_ring0,
        g.rw)
    return word_off < g.ww, word_off.clamp(0, g.ww - 1)


def live_knower_counts(cfg: SwimConfig, state: RingState, up: torch.Tensor,
                       pair_budget: int = 1 << 23) -> torch.Tensor:
    """int32[R]: per-ring-slot count of live (`up`) nodes holding the
    bit: the study runner's census.  Chunks of word rows (and of the
    node axis, where one row exceeds the budget) keep the expanded bits
    to `pair_budget` word-node pairs at a time (32 bytes each: 256 MiB at
    the default, plus the int32 copy of them `sum(dtype=int32)` makes,
    128 bytes a pair: analysis/audit.py's census_chunked row holds the
    peak to 168 bytes a pair); integer sums, equal in any chunk order.
    `state` may be one shard's block of rows (its `win`, `cold` and `up`
    rows): the counts are then that shard's part of the sum."""
    g = geometry(cfg)
    n = state.win.shape[0]
    cw = max(1, pair_budget // max(n, 1))

    def matrix_counts(words, nrows):            # [nrows, N] word-major
        out = []
        for r0 in range(0, nrows, cw):
            rc = min(cw, nrows - r0)
            if rc * n <= pair_budget:
                tot = _lane_counts(words[r0:r0 + rc], up)
            else:
                seg = max(1, pair_budget // rc)
                tot = None
                for c0 in range(0, n, seg):
                    part = _lane_counts(words[r0:r0 + rc, c0:c0 + seg],
                                        up[c0:c0 + seg])
                    tot = part if tot is None else tot + part
            out.append(tot.reshape(-1, WORD))
        return torch.cat(out)

    counts_cold = matrix_counts(state.cold, g.rw)
    counts_win = matrix_counts(state.win.T, g.ww)
    # window-resident words read their win column (cold's copy of a
    # window column is one generation stale by design)
    in_win, wcol = _window_overlay(g, state.step)
    counts = torch.where(in_win[:, None], counts_win[wcol.to(torch.int64)],
                         counts_cold)
    return counts.reshape(g.rw * WORD)


def resolved_words(cfg: SwimConfig, state: RingState) -> torch.Tensor:
    """u32[N, RW]: the current heard-bits of every ring word (window
    words from `win`, the rest from `cold`)."""
    g = geometry(cfg)
    in_win, wcol = _window_overlay(g, state.step)
    return torch.where(in_win[None, :], state.win[:, wcol.to(torch.int64)],
                       state.cold.T)


@functools.lru_cache(maxsize=16)
def _recip_table(n: int, device) -> torch.Tensor:
    """f32[N]: 1 / max(i, 1), divided on the host in numpy (correctly
    rounded) from the int64 ramp rounded once to f32, as the reference
    builds it; moved to `device` once per (n, device)."""
    ramp = np.arange(n, dtype=np.int64).astype(np.float32)
    return torch.from_numpy(
        np.float32(1.0) / np.maximum(ramp, np.float32(1.0))).to(device)


class GlobalOps:
    """Cross-node operations of the single-device engine: the seams of
    the reference's GlobalOps (ring.py:625-756), plus the three kernel
    steps (their plain versions with `plain`).  `step` routes through
    these the reference's node identity (`ids`, `zeros_nodes`,
    `full_nodes`), the period's rotor offsets (`offsets`: device
    values here, host ints in ShardOps), rolls (with its labels),
    global sums and maxima,
    scatters and gathers by node id, heard-bit lookups and first-k
    compactions; on one device each is the plain PyTorch op it names.
    obs/ici.py's CountingOps overrides them to tally the bytes of the
    sharded layout, and parallel/ring_shard.py's ShardOps computes the
    same values from one node shard with in-process collectives.  A
    roll's `itemsize` is the bytes per value of the reference's wire
    dtype where this port carries the values in a wider one (a u16 lane
    in int32).  Node-id vectors given as int64 index without a
    conversion."""

    def __init__(self, cfg: SwimConfig, device, plain: bool = False):
        self.n = cfg.n_nodes
        self.device = device
        self.plain = plain
        self._ids = torch.arange(self.n, dtype=I32, device=device)

    # -- node identity ----------------------------------------------------
    def ids(self) -> torch.Tensor:
        """int32 global ids of the node rows held here."""
        return self._ids

    def zeros_nodes(self, dtype, cols: int | None = None) -> torch.Tensor:
        shape = (self.n,) if cols is None else (self.n, cols)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def full_nodes(self, val, dtype) -> torch.Tensor:
        return torch.full((self.n,), val, dtype=dtype, device=self.device)

    # -- reductions -------------------------------------------------------
    def gsum(self, partial: torch.Tensor) -> torch.Tensor:
        """Global sum given this device's partial: the partial itself."""
        return partial

    def gmax(self, partial: torch.Tensor) -> torch.Tensor:
        """Global max given this device's partial (telemetry)."""
        return partial

    # -- communication ----------------------------------------------------
    def offsets(self, rnd: RingRandomness):
        """(s_off, q_off) of the period, the device values of `rnd`."""
        return rnd.s_off, rnd.q_off

    def _roll(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        idx = torch.remainder(self._ids.to(torch.int64) + d, self.n)
        return x[idx]

    def roll_from(self, x: torch.Tensor, d: torch.Tensor, label=None,
                  itemsize=None) -> torch.Tensor:
        """Value of x at node (i + d) mod n for every row i; `d` is a
        device scalar, so the index is computed on the device.  `label`
        names the roll in the byte tally."""
        return self._roll(x, d)

    def roll_bundle(self, parts, d, labels=None, itemsizes=None):
        """roll_from over several same-offset node vectors: the packed
        wire's fusion seam (one payload per wave when sharded); here
        each part just rolls."""
        return tuple(self._roll(x, d) for x in parts)

    # -- node-axis scatter/gather by global node id -----------------------
    def scatter_max(self, dst, idx, val, unsigned: bool):
        """dst[idx] <- max(dst[idx], val) (u32 order when `unsigned`);
        idx outside [0, n) drops."""
        return scatter.scatter_max(dst, idx, val, unsigned=unsigned)

    def scatter_add(self, dst, idx, val: int):
        valid = (idx >= 0) & (idx < dst.shape[0])
        out = dst.clone()
        out.scatter_add_(0, torch.where(valid, idx, 0).to(torch.int64),
                         torch.where(valid, val, 0).to(dst.dtype))
        return out

    def scatter_or_word(self, win, rows, cols, bits):
        """win[rows, cols] |= bits, in place, by an add (the caller's
        bits are disjoint from the word's and from each other, so no
        add carries).  A row wraps from below as JAX's scatter index
        does and drops outside [-n, n)."""
        n = win.shape[0]
        rows = torch.where(rows < 0, rows + n, rows)
        ok = (rows >= 0) & (rows < n)
        win.index_put_((torch.where(ok, rows, 0).to(torch.int64),
                        cols.to(torch.int64)),
                       torch.where(ok, bits, 0), accumulate=True)
        return win

    def gather(self, arr, idx):
        """arr[idx] for a node-axis arr; idx replicated, in [0, n)."""
        return arr[idx.to(torch.int64)]

    def gather_nodewise(self, arr, idx):
        """arr[idx] for a node-axis arr and node-axis global ids."""
        return arr[idx.to(torch.int64)]

    def gather_rows(self, mat, idx):
        """mat[idx] for a node-axis [N, C] matrix: the pull branch's
        selection-row exchange."""
        return mat[idx.to(torch.int64)]

    def knows_nodewise(self, win, cold, slot_pos, rows, slot):
        """Heard-bit for node-axis (rows, slot) query vectors."""
        return self.knows_words(win, cold, slot_pos, rows, slot)

    def knows_self(self, win, cold, slot_pos, slot):
        """Heard-bit of each row's own node for ring slots `slot`."""
        return self.knows_words(win, cold, slot_pos, self._ids, slot)

    def knows_words(self, win, cold, slot_pos, rows, slot):
        """Heard-bit of global node ids `rows` for ring slots `slot`."""
        ok, wcol, word_r, bit = slot_pos(slot)
        rows = rows.to(torch.int64)
        word = torch.where(ok, win[rows, wcol.to(torch.int64)],
                           cold[word_r.to(torch.int64), rows])
        return (slot >= 0) & u32.bit_of(word, bit)

    def knows_sentinels(self, win, cold, slot_pos, rows, slot):
        """The sentinel probes' heard-bits: the full-batch branch of the
        reference's `lax.cond` (ring.py:1612-1631), bitwise equal to its
        compacted branch and free of a data-dependent branch."""
        return self.knows_words(win, cold, slot_pos, rows, slot)

    def first_true_nodes(self, valid, k):
        """Ascending global ids of the first k True entries of a
        node-axis bool vector; missing entries fill with n."""
        return scatter.first_true(valid, k, self.n)

    # -- the three kernel steps ------------------------------------------
    def select_first_b(self, win_masked, b):
        if self.plain:
            return selb.select_first_b_plain(win_masked, b)
        return selb.select_first_b(win_masked, b)

    def cold_update_select(self, cold, flush_rows, flush_vals, q_rows):
        fn = (coldsel.cold_update_select_plain if self.plain
              else coldsel.cold_update_select)
        return fn(cold, flush_rows, flush_vals, q_rows)

    def _merge(self, win, sel, oks, offs, bcols, bvals):
        if bcols:
            bcol, bval = torch.stack(bcols), torch.stack(bvals)
        else:
            bcol = bval = torch.zeros((0, self.n), dtype=I32,
                                      device=self.device)
        fn = (wavemerge.merge_waves_plain if self.plain
              else wavemerge.merge_waves)
        return fn(win, sel, torch.stack(oks), torch.stack(offs), bcol, bval)

    def merge_waves(self, win, sel, oks, offs, bcols=(), bvals=()):
        """The fused period-scope delivery: `win` (updated in place) with
        the waves (oks[w], offs[w]) of `sel` and the receiver-aligned
        forced-bit rows ORed in."""
        return self._merge(win, sel, oks, offs, bcols, bvals)

    def merge_wave(self, win, sel, ok, d, cv=None):
        """One wave delivered in-line (wave scope, and period scope past
        MAX_WAVES): receiver i ORs sel row (i + d) mod n under ok, with
        the sender-side forced bit `cv` = (col, val) rolled along.  The
        reference rolls `sel | forced` as one [N, WW] block here; the
        kernel takes the forced bit as one compact row."""
        bcols = bvals = ()
        if cv is not None:
            bcols = [self._roll(cv[0], d)]
            bvals = [torch.where(ok, self._roll(cv[1], d), 0)]
        return self._merge(win, sel, [ok], [d], bcols, bvals)


# ---------------------------------------------------------------- step


def step(cfg: SwimConfig, state: RingState, plan: FaultPlan,
         rnd: RingRandomness, *, plain: bool = False, ops=None, ext=None,
         tap=None, prof=None) -> RingState:
    """One protocol period (reference ring.py:759-1841: the rotor branch
    in either selection scope, on either scalar wire, with or without
    Lifeguard, with a plain FaultPlan or a FaultProgram; or the pull
    branch).  Consumes `state.cold` (updated in place).  `tap`, a dict,
    receives the period's EngineFrame fields (obs/engine.py) as int32
    device scalars; the returned state is the same with or without it.
    `ops` replaces the GlobalOps(cfg, device, plain) the step builds
    (obs/ici.py passes its byte-counting subclass).  `ext`, an
    ExtOriginations batch, joins Phase D as its lowest-priority channel;
    with `ext=None` the step is unchanged.  `prof`, an obs/prof.py
    PhaseProbe, marks the ends of the reference's phases (select,
    ppermute and pack on the fused path, merge, commit, telemetry_tap
    beside a tap) in its order; in prefix mode the step returns the
    probe's captured live set at its phase instead of a state.  With
    `prof=None` the step is unchanged."""
    plan, prog = faults.split_program(plan)
    pull = cfg.ring_probe == "pull"
    if pull and prog is not None:
        # pull mode draws each contact at a composed probability and
        # never sees individual legs: per-node lanes have no sound
        # insertion point (the reference refuses this too)
        raise NotImplementedError(
            "FaultProgram link/gray segments are not supported by "
            "pull-uniform probing; use ring_probe='rotor'")
    dev = state.win.device
    if ops is None:
        ops = GlobalOps(cfg, dev, plain=plain)
    g = geometry(cfg)
    n, k = cfg.n_nodes, cfg.k_indirect
    r_tot, s_cap = g.rw * WORD, cfg.sentinels
    ob = g.ow * WORD
    t = state.step
    ids = ops.ids()
    rr = torch.arange(r_tot, dtype=I32, device=dev)
    lanes = torch.arange(ob, dtype=I32, device=dev)
    crashed = faults.crashed_mask(plan, t)
    joined = plan.join_step <= t
    active = ~crashed & joined
    part_on = faults.partition_active(plan, t)
    live_total = ops.gsum(_sum32(active))

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
    out_knowers = ops.gsum(_lane_counts(out_cols.T, active))   # i32[OB]
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
        | u32.ugt(ops.gather(gone_key, out_sub.clamp(min=0)), out_key))
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
    inv_knowers = ops.gsum(_lane_counts(fresh_rows, active))
    inv_tomb = inv_used & (inv_knowers >= live_total)
    gone_key = ops.scatter_max(
        gone_key, torch.where(inv_tomb, inv_sub, n), inv_key, unsigned=True)
    subject = scatter.set_drop(
        subject, torch.where(inv_used, fresh_slots, r_tot), -1)

    # ---- Phase 0c: move carried lanes old slot -> same lane of fresh word -
    mv_src = torch.where(carry, out_slots, r_tot).clamp(max=r_tot - 1)
    mv_dst = torch.where(carry, fresh_slots, r_tot)
    subject = scatter.set_drop(subject, mv_dst,
                               torch.where(carry, out_sub, -1))
    rkey = scatter.set_drop(rkey, mv_dst, out_key)
    birth0 = scatter.set_drop(birth0, mv_dst, birth0[mv_src])
    confirmed = scatter.set_drop(confirmed, mv_dst, confirmed[mv_src])
    snode = scatter.set_drop(snode, mv_dst, snode[mv_src])
    stime = scatter.set_drop(stime, mv_dst, stime[mv_src])
    subject = scatter.set_drop(
        subject, torch.where(carry | retire, out_slots, r_tot), -1)
    carry_mask = u32.pack_bits(carry.reshape(g.ow, WORD))      # u32[OW]

    # ---- Phase 0d: shift the window, carry bits --------------------------
    # Rotor defers the flush of the out cols into cold to the fused
    # flush + view-query kernel; pull reads cold through node-wise
    # lookups first, so it flushes here (the rows are distinct: OW < RW)
    flush_rows = torch.remainder(
        entry_gw0 + torch.arange(g.ow, dtype=I32, device=dev),
        g.rw).to(I32)                                          # i32[OW]
    if pull:
        cold.index_copy_(0, flush_rows.to(torch.int64), out_cols.T)
    else:
        flush_vals = out_cols.T.contiguous()                   # u32[OW, N]
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
        bk = ops.scatter_max(ops.zeros_nodes(I32),
                             torch.where(remaining, subject, n), rkey,
                             unsigned=True)
        bk_at_r = ops.gather(bk, subj_cl)
        hit = remaining & (rkey == bk_at_r) & (bk_at_r != 0)
        bs = ops.scatter_max(ops.full_nodes(-1, I32),
                             torch.where(hit, subject, n), rr,
                             unsigned=False)
        top_key.append(bk)
        top_slot.append(bs)
        remaining = remaining & ~(rr == ops.gather(bs, subj_cl))
    n_per_subj = ops.scatter_add(ops.zeros_nodes(I32), sub_or_n, 1)
    index_overflow = state.index_overflow + ops.gsum(
        _sum32(n_per_subj > g.c))
    sus_hit = used & lattice.is_suspect(rkey)
    sus_bk = ops.scatter_max(ops.zeros_nodes(I32),
                             torch.where(sus_hit, subject, n), rkey,
                             unsigned=True)
    sus_slot = ops.scatter_max(
        ops.full_nodes(-1, I32),
        torch.where(sus_hit & (rkey == ops.gather(sus_bk, subj_cl)),
                    subject, n), rr,
        unsigned=False)

    def slot_pos(slot):
        """(in_win, win_col, ring_word, bit) for ring slot array `slot`."""
        sl = slot.clamp(min=0)
        word_r = sl // WORD
        bit = sl % WORD
        off = torch.remainder(word_r - win_ring0, g.rw)
        return ((slot >= 0) & (off < g.ww), off.clamp(max=g.ww - 1),
                word_r, bit)

    # ---- Phases A+B: the probes -------------------------------------------
    pid = plan.partition_id
    loss_thr = torch.ceil(plan.loss.to(torch.float32) * 65536.0).to(I32)
    if prog is not None:
        # per-node u16 lanes at period t, in loss_thr's integer geometry:
        # a leg delivers iff u >= loss_thr + send lane (rolled from the
        # sender) + local recv lane; reply legs (W2/W5/W6) roll the
        # saturated send+reply lane (gray nodes lose their acks)
        send_thr, recv_thr, reply_thr = faults.link_lanes(prog, t)
        resp_thr = (send_thr + reply_thr).clamp(max=faults.LANE_MAX)
    b_pig = min(cfg.max_piggyback, g.ww * WORD)
    win_slots_lin = torch.remainder(
        win_ring0 * WORD + torch.arange(g.ww * WORD, dtype=I32, device=dev),
        r_tot).to(torch.int64)
    elig = used[win_slots_lin].reshape(g.ww, WORD)
    elig_mask = u32.pack_bits(elig)                            # u32[WW]
    if tap is not None:
        # the start-of-period occupancy, before any delivery ORs into
        # `win` in place; the first B of a row select min(occ, B) slots
        occ_bits = u32.popcount(win & elig_mask[None, :]).sum(
            dim=-1, dtype=I32)                                 # i32[N]
        tap_oks = []            # every wave's delivery mask
    # Piggyback-selection freshness (deviation R5).  Period scope: one
    # selection from the start-of-period window, reused by every wave,
    # and the 2+4k deliveries fuse into one merge (at most 32 waves).
    # Wave scope, and period scope beyond 32 waves: each wave is
    # delivered at once, by a merge of that one wave, and in wave scope
    # the selection re-runs on the live window before every wave.
    period_scope = cfg.ring_sel_scope == "period"
    fused = period_scope and 2 + 4 * k <= wavemerge.MAX_WAVES
    buddy_on = cfg.lifeguard and cfg.buddy
    if period_scope:
        sel_base = ops.select_first_b(win & elig_mask[None, :], b_pig)
    # the window senders consult for buddy knowledge: the live one in
    # wave scope, the start-of-period one in period scope (a copy where
    # in-line deliveries would change it under the later buddy waves)
    sel_src = win.clone() if buddy_on and period_scope and not fused else win
    lha = state.lha

    if prof is not None and prof.cut("select", win, ops=ops, u32=True):
        # end of "select": window shifted, top-C index built, first-B
        # selection done (period scope)
        parts = dict(win=win, elig_mask=elig_mask, gone_key=gone_key,
                     overflow=overflow, index_overflow=index_overflow,
                     sus_slot=sus_slot, sus_bk=sus_bk,
                     top_key=torch.stack(top_key),
                     top_slot=torch.stack(top_slot))
        if period_scope:
            parts["sel_base"] = sel_base
        return prof.capture(**parts)

    if not pull:
        s_off, q_off = ops.offsets(rnd)
        target = torch.remainder(ids + s_off, n)
        prober = active & ops.roll_from(joined, s_off,
                                        label="roll_probe_gate")
        waves = []              # fused: (ok, off, buddy cv | None)
        # Scalar wave wire.  "packed" narrows every per-wave scalar to its
        # information content (ok chains 1 bit a node, buddy columns and
        # bit codes a byte, slot + 1 codes in code_dtype(R)) and rolls a
        # wave's scalars as one roll_bundle; the values after the rolls
        # are the wide wire's.  Validation pins it to the fused
        # period-scope path.
        scalar_packed = cfg.ring_scalar_wire == "packed"
        slot_code = wavepack.code_dtype(r_tot)     # slot + 1, 0 = no slot
        col_code = wavepack.code_dtype(g.ww - 1)
        lane_code = wavepack.code_dtype(faults.LANE_MAX)   # u16 lanes

        def buddy_cv(d):
            """Per sender i, the forced window bit of the suspect rumor
            about subject (i + d) mod n, when sender i knows it and it is
            in the window.  Wide wire: (col i32, val u32; val 0 = inert).
            Packed wire: (col in col_code, u8 code = bit + 1; 0 = inert),
            which the receiver decodes as val = 1 << (code - 1)."""
            if not buddy_on:
                return None
            if scalar_packed:
                slot = ops.roll_from(
                    (sus_slot + 1).to(slot_code.carrier), d,
                    label="roll_buddy_slots",
                    itemsize=slot_code.itemsize).to(I32) - 1
            else:
                slot = ops.roll_from(sus_slot, d, label="roll_buddy_slots")
            in_win, wcol, _, bit = slot_pos(slot)
            (wword,) = _col_select_multi(sel_src if period_scope else win,
                                         [wcol])
            usebit = (slot >= 0) & u32.bit_of(wword, bit) & in_win
            if scalar_packed:
                return (wcol.to(col_code.carrier),
                        torch.where(usebit, bit + 1, 0).to(torch.uint8))
            one = torch.ones_like(bit, dtype=torch.int64)
            return wcol, torch.where(
                usebit, u32.from_u64(one << bit.to(torch.int64)), 0)

        def wave_ok(flag_at_sender, d, u, cv=None, reply=False):
            """(ok bool[N], cv') per receiver i: the message from (i + d)
            arrived.  Under a program, `reply` (ack legs) rolls the
            send+reply lane instead of the send lane (a u16 on the
            reference's wire).  The packed wire rolls the flag, the
            partition ids, the lane and the buddy cv as one bundle, so
            cv' comes back receiver-aligned; the wide wire rolls each
            apart and passes cv through sender-aligned."""
            lane = None
            if prog is not None:
                lane = resp_thr if reply else send_thr
            if scalar_packed:
                parts = [flag_at_sender, pid]
                labels = ["roll_ok_waves", "roll_pid_waves"]
                sizes = [None, None]
                if lane is not None:
                    parts.append(lane)
                    labels.append("roll_link_thr")
                    sizes.append(lane_code.itemsize)
                if cv is not None:
                    parts.extend(cv)
                    labels.extend(["roll_buddy_cols", "roll_buddy_vals"])
                    sizes.extend([col_code.itemsize, None])
                rolled = ops.roll_bundle(tuple(parts), d,
                                         labels=tuple(labels),
                                         itemsizes=tuple(sizes))
                flag_r, pid_r = rolled[0], rolled[1]
                if lane is not None:
                    lane_r = rolled[2]
                cvr = tuple(rolled[-2:]) if cv is not None else None
            else:
                flag_r = ops.roll_from(flag_at_sender, d,
                                       label="roll_ok_waves")
                pid_r = ops.roll_from(pid, d, label="roll_pid_waves")
                if lane is not None:
                    lane_r = ops.roll_from(lane, d, label="roll_link_thr",
                                           itemsize=lane_code.itemsize)
                cvr = cv
            thr = loss_thr if lane is None else loss_thr + lane_r + recv_thr
            ok = (flag_r & active & ~(part_on & (pid_r != pid))
                  & (u >= thr))
            return ok, cvr

        def staged(ok, d, cv):
            """A fused wave's forced bit as a receiver-aligned compact row
            (col i32, val u32) masked by the wave's delivery (roll(sel |
            forced) == roll(sel) | roll(forced)).  Wide wire: roll the
            sender-side (col, val) now.  Packed wire: (col, code) came
            receiver-aligned in the wave's bundle; decode the value."""
            if scalar_packed:
                col_r, code_r = cv
                code = code_r.to(torch.int64)
                val = torch.ones_like(code) << (code - 1).clamp(min=0)
                return (col_r.to(I32),
                        torch.where(ok & (code > 0), u32.from_u64(val), 0))
            col, val = cv
            return (ops.roll_from(col, d, label="roll_buddy_cols"),
                    torch.where(ok, ops.roll_from(val, d,
                                                  label="roll_buddy_vals"),
                                0))

        def deliver(ok, d, cv=None):
            """One wave: receiver i ORs sel row (i + d) mod n under ok."""
            nonlocal win
            if isinstance(d, torch.Tensor):
                d = d.to(I32)
            if tap is not None:
                tap_oks.append(ok)
            if fused:
                waves.append((ok, d, cv))
                return
            sel_w = (sel_base if period_scope else
                     ops.select_first_b(win & elig_mask[None, :], b_pig))
            win = ops.merge_wave(win, sel_w, ok, d, cv)

        # W1: ping i -> i+s (carries the buddy bit); W2: the ack back
        ok1, cv1 = wave_ok(prober & active, -s_off, rnd.loss_w1,
                           buddy_cv(s_off))
        deliver(ok1, -s_off, cv1)
        ok2, _ = wave_ok(ok1, s_off, rnd.loss_w2, reply=True)
        deliver(ok2, s_off)
        acked = ok2 & prober
        need = prober & ~acked
        relayed = ops.zeros_nodes(torch.bool)
        for a in range(k):
            q = q_off[a]
            d4 = s_off - q
            ok3, _ = wave_ok(need, -q, rnd.loss_w3[:, a])     # W3 ping-req
            deliver(ok3, -q)
            ok4, cv4 = wave_ok(ok3, -d4, rnd.loss_w4[:, a],   # W4 proxy ping
                               buddy_cv(d4))
            deliver(ok4, -d4, cv4)
            ok5, _ = wave_ok(ok4, d4, rnd.loss_w5[:, a],      # W5 target ack
                             reply=True)
            deliver(ok5, d4)
            ok6, _ = wave_ok(ok5, q, rnd.loss_w6[:, a],       # W6 relay ack
                             reply=True)
            deliver(ok6, q)
            relayed = relayed | (ok6 & need)
        if fused and prof is not None:
            # end of "ppermute": the whole ok chain is decided and the
            # window untouched; the fused path stages its payloads after
            # it, so "pack" comes next (obs/prof.py phases_for)
            oks_now = torch.stack([w[0] for w in waves])
            if prof.cut("ppermute", oks_now, ops=ops):
                return prof.capture(win=win)
        if fused:
            bcols, bvals = [], []
            for ok, d, cv in waves:
                if cv is not None:
                    bc, bv = staged(ok, d, cv)
                    bcols.append(bc)
                    bvals.append(bv)
            if prof is not None:
                # end of "pack": the buddy compact rows staged
                bval = torch.stack(bvals) if bvals else win
                if prof.cut("pack", bval, ops=ops, u32=True):
                    parts = dict(win=win,
                                 oks=torch.stack([w[0] for w in waves]))
                    if bvals:
                        parts["bcol"] = torch.stack(bcols)
                        parts["bval"] = bval
                    return prof.capture(**parts)
            win = ops.merge_waves(win, sel_base, [w[0] for w in waves],
                                  [w[1] for w in waves], bcols, bvals)
        if prof is not None and prof.cut("merge", win, ops=ops, u32=True):
            # end of "merge": every wave OR-delivered into the window
            return prof.capture(win=win, acked=acked, relayed=relayed)

        probe_ok = acked | relayed
        failed = prober & ~probe_ok
        if cfg.lifeguard:
            # probe-side health update, then thinning by the score the
            # probe started with:
            # bits * (1 + s) < 65536 == bits / 65536 < 1 / (1 + s)
            if cfg.lha_max > 256:
                raise ValueError("the integer thinning compare holds to "
                                 "lha_max = 256")
            bump = torch.where(failed, 1, -1).to(I32)
            lha = torch.where(prober, (lha + bump).clamp(0, cfg.lha_max), lha)
            failed = failed & (rnd.lha_u * (1 + state.lha) < 65536)
        # view_of(ids, target) + Phase C's self-suspicion word: C+1 queries
        if scalar_packed:
            q_slots = [ops.roll_from((top_slot[lvl] + 1).to(slot_code.carrier),
                                     s_off, label="roll_view_slots",
                                     itemsize=slot_code.itemsize).to(I32) - 1
                       for lvl in range(g.c)]
        else:
            q_slots = [ops.roll_from(top_slot[lvl], s_off,
                                     label="roll_view_slots")
                       for lvl in range(g.c)]
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
        # the C known-bits go back to the subject (1 bit each on the
        # packed wire), the key max folds there, one verdict rolls forward
        kn_back = (ops.roll_bundle(tuple(q_kn[:g.c]), -s_off,
                                   labels=("roll_view_known",) * g.c)
                   if g.c else ())
        tk_subj = u32.umax(lattice.alive_key(torch.zeros_like(gone_key)),
                           gone_key)
        for lvl in range(g.c):
            tk_subj = u32.umax(tk_subj,
                               torch.where(kn_back[lvl], top_key[lvl], 0))
        viewed_tk = ops.roll_from(tk_subj, s_off, label="roll_view_verdict")
        self_key = torch.where(q_kn[g.c], sus_bk, 0)
        susp_subject = target
        susp_orig = ids
    else:
        # Pull-uniform (deviations P1-P4 of the reference, ring.py:1355-
        # 1529): node j samples its own in-probe lane with the exact
        # no-probe probability P(m_j = 0) = (1 - 1/(M-1))^L_j; the prober
        # is the first live of A draws; gossip flows toward j by gathered
        # selection rows (direct ping, first delivering proxy, one
        # ack-direction contact); each two-hop path composes its two loss
        # legs into one draw against 1 - (1 - loss)^2.
        pr = rnd.pull
        sel_all = (sel_base if period_scope else
                   ops.select_first_b(win & elig_mask[None, :], b_pig))
        members = ops.gsum(_sum32(joined))
        lj = live_total - active.to(I32)
        # 1/(M-1) from the host-divided table, never a device divide
        di = (members - 1).clamp(1, n - 1).reshape(1).to(torch.int64)
        base = 1.0 - _recip_table(n, dev)[di]
        p0 = torch.where(members >= 2, pow_f32(base, lj.clamp(min=0)),
                         1.0)
        probed = (pr.m_u >= p0) & joined      # only members are probed
        # a Python scalar, not a device tensor: no copy (and sync) a
        # period; an f32 tensor times it multiplies in f32
        n_m1 = float(np.float32(n - 1))

        def draw_id(u):
            """A uniform other id: (u * f32(n-1)) truncated, self skipped."""
            idx = (u * n_m1).to(I32).clamp(max=n - 2)
            return idx + (idx >= ids).to(I32)

        src = draw_id(pr.src_u[:, 0])
        src_ok = ops.gather_nodewise(active, src)
        for a in range(1, PULL_SRC_ATTEMPTS):
            nxt = draw_id(pr.src_u[:, a])
            src = torch.where(src_ok, src, nxt)
            src_ok = src_ok | ops.gather_nodewise(active, nxt)
        probe_live = probed & src_ok
        src64 = src.to(torch.int64)

        loss_f = plan.loss.to(torch.float32)
        thr2 = 1.0 - (1.0 - loss_f) * (1.0 - loss_f)
        pid_src = ops.gather_nodewise(pid, src64)
        # direct ping src -> j and its ack
        d_fwd_ok = (probe_live & active & ~(part_on & (pid_src != pid))
                    & (pr.d_fwd >= loss_f))
        win |= torch.where(d_fwd_ok[:, None], ops.gather_rows(sel_all, src64),
                           0)
        acked_lane = d_fwd_ok & (pr.d_back >= loss_f)
        # indirect: k proxies, two-hop paths with composed legs
        need = probe_live & ~acked_lane
        relayed_lane = ops.zeros_nodes(torch.bool)
        px_deliver = ops.zeros_nodes(torch.bool)
        px_src = ops.zeros_nodes(I32)
        for b in range(k):
            p_b = draw_id(pr.px_u[:, b]).to(torch.int64)
            pid_pb = ops.gather_nodewise(pid, p_b)
            path_up = (need & ops.gather_nodewise(active, p_b)
                       & ~(part_on & (pid_src != pid_pb))
                       & ~(part_on & (pid_pb != pid)))
            w4_ok = path_up & active & (pr.px_fwd[:, b] >= thr2)
            first = w4_ok & ~px_deliver
            px_src = torch.where(first, p_b.to(I32), px_src)
            px_deliver = px_deliver | w4_ok
            relayed_lane = relayed_lane | (w4_ok & (pr.px_back[:, b] >= thr2))
        win |= torch.where(px_deliver[:, None],
                           ops.gather_rows(sel_all, px_src), 0)
        # ack-direction gossip: one contact from an independent draw,
        # delivered iff a ping+ack round trip would be
        aq = draw_id(pr.ack_u).to(torch.int64)
        ack_gossip_ok = (active & ops.gather_nodewise(active, aq)
                         & ~(part_on & (pid != ops.gather_nodewise(pid, aq)))
                         & (pr.ack_leg >= thr2))
        win |= torch.where(ack_gossip_ok[:, None],
                           ops.gather_rows(sel_all, aq), 0)
        if prof is not None and prof.cut("merge", win, ops=ops, u32=True):
            # end of "merge" (pull): direct, proxy and ack-pull gossip
            # gathered and OR-delivered
            return prof.capture(win=win, acked=acked_lane,
                                relayed=relayed_lane)
        failed = probe_live & ~(acked_lane | relayed_lane)
        if tap is not None:
            tap_oks = [d_fwd_ok, px_deliver, ack_gossip_ok]
        # src's view of j: the subject is the viewer's own row, so only
        # the heard-bit lookup crosses nodes
        viewed_tk = u32.umax(lattice.alive_key(torch.zeros_like(gone_key)),
                             gone_key)
        for lvl in range(g.c):
            kn = ops.knows_nodewise(win, cold, slot_pos, src64,
                                    top_slot[lvl])
            viewed_tk = u32.umax(viewed_tk,
                                 torch.where(kn, top_key[lvl], 0))
        self_key = torch.where(ops.knows_self(win, cold, slot_pos, sus_slot),
                               sus_bk, 0)
        susp_subject = ids
        susp_orig = src

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
    if cfg.lifeguard:
        lha = torch.where(refute, (lha + 1).clamp(0, cfg.lha_max), lha)

    if cfg.lifeguard and cfg.dynamic_suspicion:
        filled = (snode >= 0).sum(dim=-1)
        timeout = rumor.dynamic_timeout_table(cfg, dev)[
            filled.clamp(0, s_cap)][:, None]
    else:
        timeout = cfg.suspicion_periods
    snode_cl = snode.clamp(min=0).to(torch.int64)
    sent_alive = (snode >= 0) & (ops.gather(plan.crash_step, snode_cl) > t)
    deadline_hit = sent_alive & (t >= stime + timeout)
    is_susp_r = lattice.is_suspect(rkey)
    subj_r = subject.clamp(min=0).to(torch.int64)
    gone_at_r = ops.gather(gone_key, subj_r)
    higher_known = u32.ugt(gone_at_r, rkey)[:, None].expand(snode.shape)
    oslots, cands = [], []
    for lvl in range(g.c):
        oslot = ops.gather(top_slot[lvl], subj_r)
        okey = ops.gather(top_key[lvl], subj_r)
        cands.append((u32.ugt(okey, rkey) & (oslot >= 0))[:, None])
        oslots.append(oslot[:, None].expand(snode.shape))
    s_lanes = snode.shape[1]
    rows_b = torch.cat([snode_cl] * g.c, dim=1)                # [R, S*C]
    slots_b = torch.cat(oslots, dim=1)
    kn_b = ops.knows_sentinels(win, cold, slot_pos, rows_b, slots_b)
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
    # channels in priority order: confirms [0, R), refutes [R, R+N),
    # suspicions [R+N, R+2N), then the external batch [R+2N, R+2N+E)
    suspect = mk_suspect | re_suspect
    n_ext = 0 if ext is None else ext.subject.shape[0]
    m_cand = r_tot + 2 * n + n_ext
    total = (_sum32(confirm) + ops.gsum(_sum32(refute))
             + ops.gsum(_sum32(suspect)))
    kk1 = torch.topk(torch.where(confirm, r_tot - rr, 0), ob).values
    ci1 = torch.where(kk1 > 0, r_tot - kk1, m_cand)
    ci2 = ops.first_true_nodes(refute, ob)
    ci2 = torch.where(ci2 < n, r_tot + ci2, m_cand)
    ci3 = ops.first_true_nodes(suspect, ob)
    ci3 = torch.where(ci3 < n, r_tot + n + ci3, m_cand)
    chans = [ci1, ci2, ci3]
    if ext is not None:
        ext_valid = ext.subject >= 0
        total = total + _sum32(ext_valid)
        chans.append(torch.where(
            ext_valid,
            r_tot + 2 * n + torch.arange(n_ext, dtype=I32, device=dev),
            m_cand))
    cand = torch.cat(chans)
    mk_ = torch.topk(torch.where(cand < m_cand, m_cand - cand, 0), ob).values
    ci = torch.where(mk_ > 0, m_cand - mk_, m_cand)
    got = ci < m_cand
    is1 = ci < r_tot
    i1 = ci.clamp(0, r_tot - 1).to(torch.int64)
    is2 = got & ~is1 & (ci < r_tot + n)
    j2 = (ci - r_tot).clamp(0, n - 1)
    is3 = got & ~is1 & ~is2 & (ci < r_tot + 2 * n)
    j3 = (ci - r_tot - n).clamp(0, n - 1).to(torch.int64)
    sub3 = ops.gather(susp_subject, j3)
    key3 = ops.gather(susp_key, j3)
    org3 = ops.gather(susp_orig, j3)
    if ext is not None:
        is4 = got & ~is1 & ~is2 & ~is3
        j4 = (ci - r_tot - 2 * n).clamp(0, n_ext - 1).to(torch.int64)
        sub3 = torch.where(is3, sub3, ext.subject[j4])
        key3 = torch.where(is3, key3, ext.key[j4])
        org3 = torch.where(is3, org3, ext.origin[j4])
        hear3 = torch.where(is3, org3, ext.hearer[j4])
    subj_c = torch.where(
        got, torch.where(is1, subject[i1], torch.where(is2, j2, sub3)), -1)
    key_c = torch.where(
        got, torch.where(
            is1, dead_key_r[i1],
            torch.where(is2,
                        lattice.alive_key(ops.gather(new_inc, j2)),
                        key3)), 0)
    orig_c = torch.where(
        got, torch.where(is1, conf_node[i1].clamp(min=0),
                         torch.where(is2, j2, org3)), 0)
    if ext is not None:
        # the heard-bit goes to the datagram's receiver for external
        # entries, to the originator everywhere else
        hear_c = torch.where(
            got, torch.where(is1, conf_node[i1].clamp(min=0),
                             torch.where(is2, j2, hear3)), 0)
        susp_c = is3 | (is4 & lattice.is_suspect(key_c))
    else:
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
    subject = scatter.set_drop(subject, wslot, subj_c)
    rkey = scatter.set_drop(rkey, wslot, key_c)
    birth0 = scatter.set_drop(birth0, wslot, t)
    confirmed = scatter.set_drop(confirmed, wslot, False)
    snode = scatter.set_drop(snode, wslot, -1)
    stime = scatter.set_drop(stime, wslot, 0)

    # originators hear their rumor: add the one-hot into the fresh win
    # cols (add == or: freshly allocated lanes are bit-disjoint); only
    # an external hearer can lie outside [0, N)
    fw = (lane_c // WORD).clamp(0, g.ow - 1)
    fbit = (lane_c.clamp(0, ob - 1) % WORD).to(torch.int64)
    one = torch.ones_like(fbit)
    win = ops.scatter_or_word(
        win, torch.where(alloc_ok, hear_c, n), g.ww - g.ow + fw,
        torch.where(alloc_ok, u32.from_u64(one << fbit), 0))

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
    snode = scatter.set_drop(snode, wr, orig_c, col=ws)
    stime = scatter.set_drop(stime, wr, t, col=ws)

    conf_slot = torch.where(placed & (srcslot_c >= 0), srcslot_c, r_tot)
    confirmed = scatter.set_drop(confirmed, conf_slot, True)

    # inactive nodes are frozen
    inc_self = torch.where(active, inc_self, state.inc_self)
    if cfg.lifeguard:
        lha = torch.where(active, lha, state.lha)

    if prof is not None and prof.cut("commit", subject, ops=ops):
        # end of "commit": verdicts, query pass, Phase C+D, the state
        # assembled: the whole step but the tap
        return prof.capture(
            win=win, cold=cold, inc_self=inc_self, lha=lha,
            gone_key=gone_key, rkey=rkey, birth0=birth0, snode=snode,
            stime=stime, confirmed=confirmed, overflow=overflow,
            index_overflow=index_overflow)

    if tap is not None:
        row_bits = occ_bits.clamp(max=b_pig)
        tap["sel_slots_selected"] = ops.gsum(_sum32(row_bits))
        tap["sel_rows_saturated"] = ops.gsum(
            _sum32((row_bits >= b_pig) & active))
        tap["sel_slots_max"] = ops.gmax(row_bits.max())
        tap["win_occupancy"] = ops.gsum(_sum32(occ_bits))
        tap["waves_delivered"] = ops.gsum(_sum32(torch.stack(tap_oks)))
        tap["probes_failed"] = ops.gsum(_sum32(failed))
        tap["overflow"] = overflow
        tap["index_overflow"] = index_overflow
        if prof is not None:
            prof.cut("telemetry_tap", tap["sel_slots_selected"])

    return RingState(
        win=win, cold=cold, inc_self=inc_self, lha=lha, gone_key=gone_key,
        subject=subject, rkey=rkey, birth0=birth0,
        sent_node=snode, sent_time=stime, confirmed=confirmed,
        overflow=overflow, index_overflow=index_overflow, step=t + 1,
    )


def period_draws(cfg: SwimConfig, key: tuple[int, int], t0: int,
                 periods: int, device):
    """(RingRandomness, host shifts) of periods t0 .. t0+periods-1 in
    order: the shifts are the period's `rotor_offsets` as a tuple of
    ints (what the sharded step reads its rolls' source shards from),
    and the offsets of all the periods are copied to the device once."""
    host = [tuple(rotor_offsets(cfg, t0 + i)) for i in range(periods)]
    table = torch.tensor(host, dtype=I32, device=device)
    for i in range(periods):
        yield (draw_period_ring(key, t0 + i, cfg, device, offsets=table[i]),
               host[i])


def period_randomness(cfg: SwimConfig, key: tuple[int, int], t0: int,
                      periods: int, device):
    """RingRandomness of periods t0 .. t0+periods-1 in order, the rotor
    offsets of all of them copied to the device once."""
    for rnd, _ in period_draws(cfg, key, t0, periods, device):
        yield rnd


def run(cfg: SwimConfig, state: RingState, plan: FaultPlan, seed: int,
        periods: int, *, plain: bool = False) -> RingState:
    """`periods` protocol periods from `state`: the reference's
    `ring.run(cfg, state, plan, jax.random.key(seed), periods)`.  Reads
    state.step once and copies the run's rotor offsets once."""
    if periods <= 0:
        return state
    dev = state.win.device
    for rnd in period_randomness(cfg, threefry.key(seed), int(state.step),
                                 periods, dev):
        state = step(cfg, state, plan, rnd, plain=plain)
    return state


class RingEngine:
    """(cfg, plan, state) on one device, stepping with `run`."""

    def __init__(self, cfg: SwimConfig, plan: FaultPlan, seed: int = 0,
                 device=None):
        self.device = devmod.resolve(device)
        plan_dev = faults.base_of(plan).crash_step.device
        if plan_dev != self.device:
            raise ValueError(f"plan lives on {plan_dev}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.plan = plan
        self.seed = seed
        self.state = init_state(cfg, self.device)

    def run(self, periods: int) -> RingState:
        self.state = run(self.cfg, self.state, self.plan, self.seed, periods)
        return self.state

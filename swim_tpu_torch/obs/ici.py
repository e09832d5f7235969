"""Per-collective byte bill of the sharded ring layout (port of the byte
tally of `swim_tpu/obs/ici.py`).

`trace_ici_bytes(cfg, d)` runs one period of the ring step through
`CountingOps`, a GlobalOps that charges each cross-node seam the bytes
the reference's D-way sharded layout moves per device per period,
whatever the interconnect that carries them:

  * a labelled node-vector roll: two neighbour blocks of N/D rows at the
    reference's wire dtype (`roll_probe_gate`, `roll_ok_waves`,
    `roll_pid_waves`, `roll_link_thr` (the FaultProgram's u16 lane; absent
    under a plain FaultPlan), `roll_buddy_slots`, `roll_buddy_cols`,
    `roll_buddy_vals`, `roll_view_slots`, `roll_view_known`,
    `roll_view_verdict`); on the packed scalar wire a bool vector is 1 bit
    a node in u32 words, and narrow codes their byte width
    (ops/wavepack.py);
  * the wave merge: each wave's [N/D, WW] window block twice on the
    "window" ICI wire, or one block of B packed slot indices a row plus
    one shared boundary block on the "compact" wire (`roll_sel_waves`,
    `sel_wire_boundary`);
  * `psum_scalar` (global sums), `gather_psum` (gathers by node id),
    `knows_psum` (heard-bit lookups) at 4 bytes an element, and
    `candidates_all_gather` (first-k compaction, D blocks of min(k, N/D)).

The reference counts during `jax.eval_shape`, an abstract trace on no
device.  PyTorch has none, so the period runs for real on the `meta`
device, which carries shapes and dtypes and computes no values (every
op of the step's plain path runs there).  This is an accounting pass
beside a run, never a run of the arm.  Like the reference's trace, it
charges both branches of the sentinel probes' `lax.cond`.

The bill is static per (cfg, d, plan's segment count): shapes and the
collective set are constants of the configuration.  It states bytes
only: the reference's time model divides them by a TPU link rate,
which this port does not carry (ROADMAP.md Queue 1: sharding).
"""
from __future__ import annotations

import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.models import ring
from swim_tpu_torch.ops import wavepack
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import threefry
from swim_tpu_torch.utils.tree import tree_map

META = torch.device("meta")
# rumor rows the reference's compacted sentinel branch probes
# (swim_tpu/models/ring.py _SENTINEL_QUERY_CAP)
SENTINEL_QUERY_CAP = 512


class CountingOps(ring.GlobalOps):
    """GlobalOps on the plain kernel versions that adds every seam's
    bytes to `tally` (key -> bytes per device per period)."""

    def __init__(self, cfg: SwimConfig, d: int, device=META):
        super().__init__(cfg, device, plain=True)
        self.cfg = cfg
        self.d = d
        self.tally: dict[str, int] = {}

    def add(self, key: str, nbytes: int) -> None:
        self.tally[key] = self.tally.get(key, 0) + int(nbytes)

    def _roll_part_bytes(self, x: torch.Tensor, itemsize=None) -> int:
        """Bytes one neighbour-block transfer of x costs a device: N/D
        rows at the wire dtype, except a bool node vector on the packed
        scalar wire, which ships 1 bit a node in u32 words."""
        s = x.shape[0] // self.d
        if (self.cfg.ring_scalar_wire == "packed" and x.ndim == 1
                and x.dtype == torch.bool):
            return 4 * wavepack.packed_words(s)
        return (s * (x.numel() // x.shape[0])
                * (itemsize or x.element_size()))

    @staticmethod
    def _roll_key(x: torch.Tensor, label) -> str:
        if label is not None:
            return label
        return (f"roll[{'x'.join(map(str, x.shape))},"
                f"{str(x.dtype).removeprefix('torch.')}]")

    def roll_from(self, x, d, label=None, itemsize=None):
        self.add(self._roll_key(x, label),
                 2 * self._roll_part_bytes(x, itemsize))
        return super().roll_from(x, d)

    def roll_bundle(self, parts, d, labels=None, itemsizes=None):
        # the sharded packed wire fuses the parts into one payload whose
        # bytes are the parts' packed bytes summed: tallied per part
        labels = labels or [None] * len(parts)
        itemsizes = itemsizes or [None] * len(parts)
        for x, lb, sz in zip(parts, labels, itemsizes):
            self.add(self._roll_key(x, lb), 2 * self._roll_part_bytes(x, sz))
        return super().roll_bundle(parts, d)

    def merge_waves(self, win, sel, oks, offs, bcols=(), bvals=()):
        n, ww = sel.shape
        if self.cfg.ring_ici_wire == "compact":
            row = (min(self.cfg.max_piggyback, ww * wavepack.WORD)
                   * wavepack.packed_itemsize(ww))
            self.add("sel_wire_boundary", n * row // self.d)
            self.add("roll_sel_waves", len(oks) * n * row // self.d)
        else:
            self.add("roll_sel_waves",
                     len(oks) * 2 * sel.numel() * sel.element_size()
                     // self.d)
        return super().merge_waves(win, sel, oks, offs, bcols, bvals)

    def merge_wave(self, win, sel, ok, d, cv=None):
        # the reference rolls `sel | forced` as one labelled block
        self.add("roll_sel_waves", 2 * self._roll_part_bytes(sel))
        return super().merge_wave(win, sel, ok, d, cv)

    def gsum(self, partial):
        self.add("psum_scalar", 4 * partial.numel())
        return super().gsum(partial)

    def gather(self, arr, idx):
        self.add("gather_psum", 4 * max(idx.numel(), 1))
        return super().gather(arr, idx)

    def knows_words(self, win, cold, slot_pos, rows, slot):
        self.add("knows_psum", 4 * max(slot.numel(), 1))
        return super().knows_words(win, cold, slot_pos, rows, slot)

    def knows_sentinels(self, win, cold, slot_pos, rows, slot):
        # the reference's trace holds both branches of its lax.cond, the
        # compacted one on min(SENTINEL_QUERY_CAP, R) rumor rows
        r_tot = rows.shape[0]
        cap = min(SENTINEL_QUERY_CAP, r_tot)
        if cap < r_tot:
            self.add("knows_psum", 4 * cap * rows.shape[1])
        return super().knows_sentinels(win, cold, slot_pos, rows, slot)

    def first_true_nodes(self, valid, k):
        kl = min(k, self.n // self.d)
        self.add("candidates_all_gather", 4 * self.d * kl)
        return super().first_true_nodes(valid, k)


def trace_ici_bytes(cfg: SwimConfig, d: int, plan=None,
                    ext_capacity: int | None = None) -> dict:
    """Bytes per device per period the D-way sharded layout of the ring
    step moves for `cfg`, keyed by collective: {"per_chip_bytes_per_period":
    total, "breakdown": {key: bytes}, largest first}.  `plan` defaults to
    `faults.none` (the baseline bill); a FaultProgram adds its u16 link
    lane, the `roll_link_thr` term (sim/scenario.py embeds it in verdict
    artifacts).  `ext_capacity` prices the serving hub's row mirror: the
    period runs with `ring.ext_none(ext_capacity)`, and the one placed
    batch a period (four 4-byte lanes a slot, replicated to every device)
    adds the `ext_mirror_rows` term.  One period runs on the meta
    device."""
    ops = CountingOps(cfg, d)
    if plan is None:
        plan = faults.none(cfg.n_nodes, META)
    else:
        plan = tree_map(lambda x: x.to(META), plan)
    rnd = ring.draw_period_ring(threefry.key(0), 0, cfg, META)
    ext = None if ext_capacity is None else ring.ext_none(ext_capacity,
                                                          META)
    ring.step(cfg, ring.init_state(cfg, META), plan, rnd, ops=ops, ext=ext)
    if ext_capacity is not None:
        ops.add("ext_mirror_rows", 4 * 4 * ext_capacity)
    total = sum(ops.tally.values())
    return {"per_chip_bytes_per_period": total,
            "breakdown": dict(sorted(ops.tally.items(),
                                     key=lambda kv: -kv[1]))}

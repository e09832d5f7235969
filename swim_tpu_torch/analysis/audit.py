"""Contract auditor (port of `swim_tpu/analysis/audit.py`): the laws the
performance claims rest on, in one machine-checked table.

The reference checks its contracts statically, against the jaxprs, the
compiled HLO and XLA's alias tables of its JAX programs.  Eager PyTorch
has none of these: the port runs what it runs, one op at a time.  So
each contract is restated for what the port really executes, and every
checked row runs something that can fail (tests/test_torch_audit.py
fires each by name):

* **wire_contracts** — one sharded period (parallel/ring_shard.py, D
  shard slots) of each of the four `WIRE_ARMS` records shard 0's
  exchanges (`ShardedStep.record`); `exchange_records` turns them into
  the reference's record form (`op` an HLO collective name, `payloads`
  with HLO dtype names), and the reference's predicates apply as they
  are: at least one collective-permute, on packed arms a u8 payload and
  no [S]-shaped s32/pred lane, no all-gather above
  `ALLGATHER_MAX_ELEMS`, and compact+packed moving fewer ppermute bytes
  than window+wide.
* **ici_tally_completeness** — the same records give each family's
  moved bytes from their payloads' dtype and shape times the blocks the
  reference's layout moves for the exchange (two for a roll by a
  device-side distance, D for an all-gather, whose output is counted;
  input bytes otherwise), never from the labels the bill gives them;
  `tally_unattributed` holds them against `obs/ici.trace_ici_bytes(cfg,
  d)`, with zero unattributed.  Each arm also holds the bytes the mesh
  copied between devices in the period (`Mesh.copied_bytes`) against
  the same records (`ring_shard.mesh_copy_bytes`: the posted bytes of
  each stack and psum times the blocks the mesh copies for one), and
  prints the fetch factor: the copied bytes over the bytes the
  reference's layout moves into the D shards (0 on a one-device mesh;
  (D-1)/2 for a roll over D cards, where the reference moves two
  blocks).  `serve_ext_mirror` prices the serving hub's row mirror as
  the reference does.
* **hot_path_hygiene** — every `ringshard/<arm>` period and the
  `study/dense|rumor|ring` period bodies (the draws included) run under
  a TorchDispatchMode (`HygieneWatch`) that names each float64 value
  `f64:<aten op>` and each host-reading op (`SYNC_OPS`) `sync:<aten
  op>`.  A dispatch mode is thread-local, and the sharded step runs its
  shards in threads of their own, so the mode is entered inside every
  shard's body (`ShardedStep.around`).  The CUDA kernels launch through
  ctypes (`_kernels.lib`) and bypass the dispatcher, so the mode never
  sees them; on the card every step and study period also runs under
  `torch.cuda.set_sync_debug_mode("error")`, which raises on any
  synchronizing CUDA call, the kernels' included.  The draws stay out
  of that check: their threefry keys are made on the host and copied
  over, as every runner does before a period's step.
* **retrace_budget**, as a build budget — across the fault-program
  value sweep (`_program_sweep`) each arm counts what it builds: the
  port's `functools.lru_cache` misses (`ring._recip_table`,
  `rumor.dynamic_timeout_table`), each kernel's library loads in
  `_kernels.lib` (a load follows a build or finds one; one seam a
  kernel) and the `ShardedStep`s constructed (`mapped_step`).  Each seam's caches are emptied when an
  arm starts, so every arm counts its own builds; a seam built more than
  once in an arm fails, and `retraces_extra` counts the excess.
* **barrier_survival**, as a bounded working set — the reference's
  optimization_barrier chains exist so that XLA's scheduler cannot
  stage every chunk (or every gather) at once.  Eager PyTorch runs ops
  in program order and frees a temporary when its last reference dies,
  so the same laws read:
    - `census_chunked`: `ring.live_knower_counts` at
      `pair_budget=4*retrace_n` runs in at least two chunks, none above
      the budget's word-node pairs (counted at the `_lane_counts` seam);
      on the card its peak allocation above the state stays within
      `CENSUS_BYTES_PER_PAIR` bytes a budget pair plus
      `CENSUS_SLACK_BYTES`;
    - `pull_gather_step`: the pull step's [N, WW] selection-row gathers
      (`GlobalOps.gather_rows`: direct, proxy, ack-pull) are serialized —
      when each is issued, no earlier one is still alive, so at most one
      gather result is live at a time (weak references at the seam).
  The reference's `sharded_gspmd_64m` reads its GSPMD lowering's AOT
  row; the port has no such lowering (each shard runs the
  single-device census on its own rows), so that row is
  `not_applicable`.
* **donation_coverage** has no eager counterpart: there is no compiled
  alias table, and a callee cannot free its caller's references to the
  state it was given.  Its arms are `not_applicable`.

`not_applicable` is neither pass nor fail: the totals count it apart
(`not_applicable`), a total with nothing measured is null (never 0),
`check_report` ignores it, and only the (contract, arm) pairs of
`NOT_APPLICABLE` may carry it.  `WAIVERS` is empty: the reference's one
waiver is about its GSPMD lowering; the machinery stays.  The report
keeps the reference's schema (each contract block adds its `eager_form`)
and holds no wall time, so two runs of one tree write identical bytes.
The reference's HLO scanner and jaxpr walkers have no counterpart here.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ---------------------------------------------------------------------------
# The contract table.  Names are load-bearing: tests assert failures fire
# by name, the registry lint cross-checks gauges against this table, and
# waivers reference (contract, arm) pairs.
# ---------------------------------------------------------------------------

CONTRACTS = {
    "retrace_budget":
        "one compile per (engine, static-config) arm across a fault-program "
        "value sweep — S is the only trace axis",
    "donation_coverage":
        "every donate_argnums leaf is aliased in the compiled executable: "
        "alias bytes == donated bytes, exactly, for every study runner",
    "wire_contracts":
        "packed arms ship u8 collective-permute payloads and no [S]-shaped "
        "s32/pred lanes; no replication-scale all-gather; compact wire moves "
        "strictly fewer ppermute bytes than the window wire",
    "ici_tally_completeness":
        "every traced collective byte is attributed to a named obs/ici.py "
        "tally term — unattributed bytes fail",
    "barrier_survival":
        "the census-chunk and pull-gather optimization_barrier chains are "
        "present as ordering edges in the traced program, and the sharded "
        "GSPMD lowering keeps the census chain alive (64M AOT row)",
    "hot_path_hygiene":
        "no f64 values and no host callbacks inside traced engine steps "
        "and study bodies",
}

# What each contract means for the port's eager programs (see the module
# note); the report carries it beside the reference's description.
EAGER_FORMS = {
    "retrace_budget":
        "at most one build per seam (lru_cache miss, kernel library load, "
        "ShardedStep construction) per (engine, static-config) arm across "
        "a fault-program value sweep",
    "donation_coverage":
        "no eager counterpart: no compiled alias table exists, and a "
        "callee cannot free its caller's references",
    "wire_contracts":
        "the reference's predicates over shard 0's recorded exchanges of "
        "one sharded period",
    "ici_tally_completeness":
        "bytes moved per family, from the recorded payloads' dtype and "
        "shape times the blocks the layout moves, all attributed to "
        "obs/ici.py bill terms",
    "barrier_survival":
        "bounded working sets in program order: the census runs in "
        "budget-sized chunks (and, on the card, peaks within them); the "
        "pull step's row gathers are live one at a time",
    "hot_path_hygiene":
        "no float64 value and no host-reading op under a TorchDispatchMode "
        "entered in every shard's thread (and, on the card, no "
        "synchronizing CUDA call under set_sync_debug_mode('error'))",
}

# Expected-fail entries: a failing check whose (contract, arm) appears here
# is reported as "waived" instead of failing the audit.  Each entry names
# the tracking pointer so the waiver is a debt, not a hole.  The port owes
# none.
WAIVERS: tuple = ()

# The only rows that may be not_applicable, each with its reason.
_DONATION_NA = ("eager PyTorch compiles no executable, so there is no "
                "alias table to hold against the donated bytes, and a "
                "callee cannot free its caller's references to the state")
NOT_APPLICABLE = {
    **{("donation_coverage", arm): _DONATION_NA
       for arm in ("dense", "rumor", "ring", "ring_stream_chunk", "batch")},
    ("barrier_survival", "sharded_gspmd_64m"):
        "the reference reads its GSPMD lowering's 64M AOT row; the port "
        "has no GSPMD lowering: each shard runs the single-device census "
        "on its own rows (census_chunked covers it)",
}

# ---------------------------------------------------------------------------
# ICI tally vocabulary: which obs/ici.py breakdown terms attribute which
# collective family.  The completeness contract verifies no breakdown key
# lies outside this vocabulary and no moved byte outside the terms'
# budget.
# ---------------------------------------------------------------------------

ICI_TERM_FAMILIES = {
    "ppermute": (
        "roll_probe_gate", "roll_ok_waves", "roll_pid_waves",
        "roll_link_thr", "roll_buddy_slots", "roll_buddy_cols",
        "roll_buddy_vals", "roll_view_slots", "roll_view_known",
        "roll_view_verdict", "roll_sel_waves", "sel_wire_boundary",
    ),
    "psum": ("psum_scalar", "gather_psum", "knows_psum"),
    "all_gather": ("candidates_all_gather",),
    # Host->device placed updates (not collectives, priced at a fixed
    # rate in obs/ici.py): the serving hub's batched row mirror — one
    # coalesced ExtOriginations placement per device step
    # (swim_tpu_torch/serve/hub.py).
    "placed": ("ext_mirror_rows",),
}

ICI_TERMS = tuple(sorted(
    t for fam in ICI_TERM_FAMILIES.values() for t in fam))

DTYPE_BYTES = {
    "pred": 1, "u8": 1, "s8": 1,
    "u16": 2, "s16": 2, "f16": 2, "bf16": 2,
    "u32": 4, "s32": 4, "f32": 4,
    "u64": 8, "s64": 8, "f64": 8,
}

# torch dtype name -> HLO element type name
HLO_DTYPES = {
    "bool": "pred", "uint8": "u8", "int8": "s8", "uint16": "u16",
    "int16": "s16", "float16": "f16", "bfloat16": "bf16", "uint32": "u32",
    "int32": "s32", "float32": "f32", "uint64": "u64", "int64": "s64",
    "float64": "f64",
}

# the sharded engine's exchange op -> (HLO op, tally family)
EXCHANGE_OPS = {
    "ppermute": ("collective-permute", "ppermute"),
    "psum": ("all-reduce", "psum"),
    "all_gather": ("all-gather", "all_gather"),
}


def _payload(p: dict) -> dict:
    """One recorded tensor as ``{"dtype", "elems", "bytes"}``, its dtype
    the HLO name of its wire dtype."""
    dtype = HLO_DTYPES[p["wire_dtype"]]
    elems = 1
    for dim in p["shape"]:
        elems *= int(dim)
    return {"dtype": dtype, "elems": elems,
            "bytes": elems * DTYPE_BYTES[dtype]}


def exchange_records(record: list[dict]) -> list[dict]:
    """The reference's record form of shard 0's exchanges
    (`ShardedStep.record`): one ``{"op", "payloads", "payload_bytes"}``
    an exchange, `op` the HLO collective name, `payloads` every posted
    tensor as ``{"dtype", "elems", "bytes"}`` with the HLO name of its
    wire dtype (the u32 values of int32 carriers are u32; an all-gather
    lists its gathered output too, as its HLO line would),
    `payload_bytes` the largest."""
    out = []
    for e in record:
        payloads = [_payload(p) for p in e["payloads"]]
        op = EXCHANGE_OPS[e["op"]][0]
        if op == "all-gather":
            payloads += [dict(p, elems=p["elems"] * e["blocks"],
                              bytes=p["bytes"] * e["blocks"])
                         for p in payloads]
        out.append({"op": op, "payloads": payloads,
                    "payload_bytes": max((p["bytes"] for p in payloads),
                                         default=0)})
    return out


def family_bytes(record: list[dict]) -> dict[str, int]:
    """Bytes one device receives per collective family in shard 0's
    recorded exchanges (`ShardedStep.record`): the posted tensors' bytes
    (dtype and shape) times the blocks the layout moves — the
    reference's rule: input bytes, twice for a roll by a device-side
    distance, and an all-gather's output (D blocks)."""
    out: dict[str, int] = {}
    for e in record:
        fam = EXCHANGE_OPS[e["op"]][1]
        moved = e["blocks"] * sum(_payload(p)["bytes"]
                                  for p in e["payloads"])
        out[fam] = out.get(fam, 0) + moved
    return out


def max_payload_elems(records: list[dict], op: str) -> int:
    """Largest element count on any `op` record (1 if none)."""
    worst = 1
    for r in records:
        if r["op"] != op:
            continue
        for p in r["payloads"]:
            worst = max(worst, p["elems"])
    return worst


def cperm_payloads(records: list[dict]) -> list[dict]:
    """Flat payload list across all collective-permute records."""
    return [p for r in records if r["op"] == "collective-permute"
            for p in r["payloads"]]


def tally_unattributed(family_bytes: dict[str, int],
                       breakdown: dict[str, int]) -> dict[str, int]:
    """Per-family bytes the trace moves but no named tally term claims.

    Returns ``{family: max(0, traced - attributed)}`` plus an
    ``"unknown_term:<key>"`` entry for any breakdown key outside
    ICI_TERM_FAMILIES (vocabulary drift fails too) and the pass-through
    of any ``while_unbounded`` traced bytes.
    """
    out: dict[str, int] = {}
    known = set(ICI_TERMS)
    for key in breakdown:
        if key not in known:
            out[f"unknown_term:{key}"] = int(breakdown[key])
    for family, traced in sorted(family_bytes.items()):
        if family == "while_unbounded":
            out[family] = int(traced)
            continue
        terms = ICI_TERM_FAMILIES.get(family, ())
        attributed = sum(int(breakdown.get(t, 0)) for t in terms)
        out[family] = max(0, int(traced) - attributed)
    return out


def wire_problems(records: list[dict], packed: bool,
                  shard_rows: int) -> list[str]:
    """The reference's wire predicates over one arm's records ([] =
    clean)."""
    problems = []
    if not any(r["op"] == "collective-permute" for r in records):
        problems.append("no collective-permute wave rolls")
    if packed:
        if not any(p["dtype"] == "u8" for p in cperm_payloads(records)):
            problems.append("no u8 cperm payload on the packed wire")
        wide_lanes = sorted({
            f"{p['dtype']}[{p['elems']}]"
            for p in cperm_payloads(records)
            if p["dtype"] in ("s32", "pred") and p["elems"] == shard_rows})
        if wide_lanes:
            problems.append(
                f"[S]-shaped scalar lanes on the packed wire: {wide_lanes}")
    ag_worst = max_payload_elems(records, "all-gather")
    if ag_worst > ALLGATHER_MAX_ELEMS:
        problems.append(
            f"all-gather payload {ag_worst} elems > bookkeeping "
            f"ceiling {ALLGATHER_MAX_ELEMS}")
    return problems


# ---------------------------------------------------------------------------
# Hygiene: a TorchDispatchMode that names float64 values and host reads.
# ---------------------------------------------------------------------------

# aten ops that read a device value to the host (a sync on the card)
SYNC_OPS = ("_local_scalar_dense", "is_nonzero", "nonzero", "equal")


class HygieneWatch(TorchDispatchMode):
    """Adds `f64:<op>` for every op with a float64 input or output and
    `sync:<op>` for every op of SYNC_OPS to `found`; counts the ops it
    saw in `ops`.  Thread-local, like every dispatch mode: enter it in
    the thread whose ops it should see."""

    def __init__(self, found: set | None = None):
        super().__init__()
        self.found = set() if found is None else found
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        name = func.overloadpacket.__name__
        if name in SYNC_OPS:
            self.found.add(f"sync:{name}")
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                self.found.add(f"f64:{name}")
                break
        return out


class ShardWatch:
    """`around` for a ShardedStep: a HygieneWatch entered in every
    shard's thread, all adding to one `found`; `ops[rank]` counts what
    each shard's watch saw."""

    def __init__(self):
        self.found: set = set()
        self.ops: dict[int, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, rank: int):
        found: set = set()
        watch = HygieneWatch(found)
        try:
            with watch:
                yield
        finally:
            with self._lock:
                self.found |= found
                self.ops[rank] = self.ops.get(rank, 0) + watch.ops


@contextlib.contextmanager
def sync_check(device: torch.device):
    """On a CUDA device, PyTorch's sync debug mode set to raise for the
    block (a process-wide setting, so the shard threads are under it
    too); nothing elsewhere."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def hygiene_violations(fn) -> list[str]:
    """Sorted violations of `fn()` run under a HygieneWatch in this
    thread."""
    with HygieneWatch() as watch:
        fn()
    return sorted(watch.found)


# ---------------------------------------------------------------------------
# The build budget: seams counted per arm.
# ---------------------------------------------------------------------------

def _build_seams():
    """name -> (reset, count) of every build seam."""
    from swim_tpu_torch import _kernels
    from swim_tpu_torch.models import ring, rumor
    from swim_tpu_torch.parallel import ring_shard

    def lru(fn):
        return (fn.cache_clear, lambda: fn.cache_info().misses)

    def kernel(name):
        return (lambda: _kernels._loaded.pop(name, None),
                lambda: _kernels.loads.get(name, 0))

    return {
        "lru:ring._recip_table": lru(ring._recip_table),
        "lru:rumor.dynamic_timeout_table": lru(rumor.dynamic_timeout_table),
        **{f"kernel:{name}": kernel(name) for name in _kernels.SIGNATURES},
        "ShardedStep": (lambda: None,
                        lambda: ring_shard.ShardedStep.built),
    }


def count_builds(run_value, values) -> dict[str, int]:
    """Builds per seam while `run_value(v)` runs for every v of
    `values`, each seam's cache emptied first (nonzero seams only)."""
    seams = _build_seams()
    before = {}
    for name, (reset, count) in seams.items():
        reset()
        before[name] = count()
    for v in values:
        run_value(v)
    got = {name: count() - before[name]
           for name, (_, count) in seams.items()}
    return {k: v for k, v in sorted(got.items()) if v}


def build_row(builds: dict[str, int], n_values: int,
              what: str = "program values") -> tuple[bool, int, str]:
    """(ok, extra builds, detail) of one arm's build counts."""
    extra = sum(max(0, c - 1) for c in builds.values())
    worst = max(builds.values(), default=0)
    return (worst <= 1, extra,
            f"{sum(builds.values())} build(s) over {n_values} {what}, "
            f"at most {worst} per seam: {builds}")


# ---------------------------------------------------------------------------
# Bounded working sets (the eager barrier_survival).
# ---------------------------------------------------------------------------

CENSUS_FLOOR_CHUNKS = 2
# Peak allocation of the census above the state, per word-node pair of
# the budget: the expanded bits (1 byte a bit, 32 a pair), the int32 copy
# of them PyTorch's sum(dtype=int32) makes of a uint8 input (128 a
# pair), and the masked chunk and its bytes (8 a pair).
CENSUS_BYTES_PER_PAIR = 32 + 128 + 8
# the per-word counts, the overlay vectors and the allocator's 512-byte
# rounding of each
CENSUS_SLACK_BYTES = 64 << 10


def census_chunks(cfg, state, up, pair_budget: int) -> list[int]:
    """Word-node pairs of each chunk `ring.live_knower_counts` expands at
    `pair_budget`, in order (counted at its `_lane_counts` seam)."""
    from swim_tpu_torch.models import ring

    chunks: list[int] = []
    inner = ring._lane_counts

    def counted(words, active):
        chunks.append(int(words.numel()))
        return inner(words, active)

    ring._lane_counts = counted
    try:
        ring.live_knower_counts(cfg, state, up, pair_budget=pair_budget)
    finally:
        ring._lane_counts = inner
    return chunks


def census_row(chunks: list[int], budget: int,
               peak: int | None = None) -> tuple[bool, str]:
    """(ok, detail) of the census working set: at least
    CENSUS_FLOOR_CHUNKS chunks, none above `budget` pairs, and a peak
    (bytes above the state, when measured) within the budget's bytes."""
    worst = max(chunks, default=0)
    ok = len(chunks) >= CENSUS_FLOOR_CHUNKS and worst <= budget
    detail = (f"{len(chunks)} census chunk(s), largest {worst} word-node "
              f"pairs (budget {budget}, floor {CENSUS_FLOOR_CHUNKS} "
              "chunks)")
    if peak is not None:
        limit = CENSUS_BYTES_PER_PAIR * budget + CENSUS_SLACK_BYTES
        ok = ok and peak <= limit
        detail += f"; peak {peak} bytes above the state (limit {limit})"
    return ok, detail


class RowGatherWatch:
    """Wraps a GlobalOps' `gather_rows` and keeps weak references to its
    results: `issued` gathers, `max_live` the most results alive at
    once (counting the one just issued)."""

    def __init__(self, ops):
        self.issued = 0
        self.max_live = 0
        self._live: list = []
        inner = ops.gather_rows

        def gather_rows(mat, idx):
            alive = sum(1 for r in self._live if r() is not None)
            out = inner(mat, idx)
            self.issued += 1
            self.max_live = max(self.max_live, alive + 1)
            self._live.append(weakref.ref(out))
            return out

        ops.gather_rows = gather_rows


def gather_row(watch: RowGatherWatch) -> tuple[bool, str]:
    ok = watch.issued >= 2 and watch.max_live <= 1
    return ok, (f"{watch.issued} [N, WW] row gather(s) in the pull-probe "
                f"step, at most {watch.max_live} alive at once (floor 2 "
                "gathers, ceiling 1 alive)")


# ---------------------------------------------------------------------------
# Audit arms.  Geometry mirrors the reference's SMALL_GEOM, which its
# sharded parity tests pin.
# ---------------------------------------------------------------------------

SMALL_GEOM = dict(suspicion_mult=1.0, k_indirect=1, max_piggyback=2,
                  ring_window_periods=2, ring_view_c=2)

WIRE_ARMS = (
    ("window+wide", {}),
    ("window+packed", {"ring_sel_scope": "period",
                       "ring_scalar_wire": "packed"}),
    ("compact+wide", {"ring_sel_scope": "period",
                      "ring_ici_wire": "compact"}),
    ("compact+packed", {"ring_sel_scope": "period",
                        "ring_ici_wire": "compact",
                        "ring_scalar_wire": "packed"}),
)

# Bookkeeping ceiling for all-gather payloads (elements): OB*D candidate
# keys — far below one shard's node rows.  Same constant the historical
# test pin used.
ALLGATHER_MAX_ELEMS = 2048


def _program_sweep(n: int, device, capacity: int = 4):
    """Three FaultProgram VALUES at one capacity — the build sweep."""
    from swim_tpu_torch.sim import faults

    base = faults.as_program(faults.none(n, device), capacity=capacity)
    gray = faults.with_segment(base, 0, start=1, end=6, kind="gray",
                               level=0.5)
    lossy = faults.with_segment(
        faults.as_program(faults.none(n, device), capacity=capacity),
        0, start=2, end=5, kind="link_loss", level=0.3)
    return (base, gray, lossy)


def sharded_wire_arms(mesh, wire_n: int, add) -> dict:
    """The 2x2 sharded wire matrix (WIRE_ARMS) at `wire_n` nodes on
    `mesh`, any mix of devices: one period of each arm, its rows passed
    to `add(contract, arm, ok, detail)` (wire_contracts,
    ici_tally_completeness with the bytes the mesh copied between
    devices against `ring_shard.mesh_copy_bytes` and the fetch factor,
    hot_path_hygiene).  The sync check covers an all-card mesh; one with
    CPU shards copies to the host by design.  Returns {"families": {arm:
    the bytes of each collective family}, "unattributed": bytes,
    "copies": {arm: {"copied", "model", "fetch_factor"}}}."""
    from swim_tpu_torch import SwimConfig
    from swim_tpu_torch.models import ring
    from swim_tpu_torch.obs import ici
    from swim_tpu_torch.parallel import ring_shard
    from swim_tpu_torch.sim import faults
    from swim_tpu_torch.utils import threefry

    d = mesh.size
    dev = mesh.devices[0]
    shard_sync = (dev if all(x.type == "cuda" for x in mesh.devices)
                  else torch.device("cpu"))
    key = threefry.key(0)
    shard_rows = wire_n // d
    out = {"families": {}, "unattributed": 0, "copies": {}}
    for arm_name, overrides in WIRE_ARMS:
        cfg_w = SwimConfig(n_nodes=wire_n, **SMALL_GEOM, **overrides)
        plan_w = faults.with_crashes(faults.none(wire_n, dev), [5], [2])
        st_w, pl_w = ring_shard.place(cfg_w, mesh,
                                      ring.init_state(cfg_w, dev), plan_w)
        rnd_w = ring.draw_period_ring(key, 0, cfg_w, dev)
        step = ring_shard.mapped_step(cfg_w, mesh)
        step.record = []
        watch = ShardWatch()
        step.around = watch
        mesh.copied_bytes = 0
        with sync_check(shard_sync):
            step(st_w, pl_w, rnd_w, ring.rotor_offsets(cfg_w, 0))
        copied = mesh.copied_bytes
        records = exchange_records(step.record)

        problems = wire_problems(records, cfg_w.ring_scalar_wire == "packed",
                                 shard_rows)
        n_cperm = sum(r["op"] == "collective-permute" for r in records)
        add("wire_contracts", arm_name, not problems,
            "; ".join(problems) if problems
            else f"{n_cperm} cperm exchange(s), all-gather max "
                 f"{max_payload_elems(records, 'all-gather')} elems")

        fam = family_bytes(step.record)
        out["families"][arm_name] = fam
        tally = ici.trace_ici_bytes(cfg_w, d)
        loose = {k: v for k, v in tally_unattributed(
            fam, tally["breakdown"]).items() if v}
        out["unattributed"] += sum(loose.values())
        model = ring_shard.mesh_copy_bytes(step.record, mesh)
        factor = copied / (d * sum(fam.values()))
        out["copies"][arm_name] = {"copied": copied, "model": model,
                                   "fetch_factor": factor}
        copies = (f"copied={copied} of model {model}, fetch factor "
                  f"{factor:.4f}")
        add("ici_tally_completeness", arm_name,
            not loose and copied == model,
            (f"unattributed={loose}" if loose
             else f"traced={ {k: int(v) for k, v in sorted(fam.items())} } "
                  "fully attributed") + "; " + copies)

        violations = sorted(watch.found)
        seen = sorted(watch.ops) == list(range(d)) and all(
            watch.ops.values())
        if not seen:
            violations.append(f"unwatched shards: {sorted(watch.ops)}")
        add("hot_path_hygiene", f"ringshard/{arm_name}", not violations,
            "; ".join(violations) if violations else "clean")
    return out


def run_audit(wire_n: int = 512, retrace_n: int = 256, d: int = 8,
              periods: int = 4, device=None) -> dict:
    """Run every contract arm and return the (byte-stable) report dict.
    On the card unless `device` names another (device.py); the sharded
    arms run on `d` shard slots of that one device
    (`parallel/mesh.make_mesh`; `sharded_wire_arms` runs them on any
    mesh)."""
    from swim_tpu_torch import SwimConfig
    from swim_tpu_torch import device as devmod
    from swim_tpu_torch.models import dense, ring, rumor
    from swim_tpu_torch.obs import ici
    from swim_tpu_torch.parallel import mesh as pmesh, ring_shard
    from swim_tpu_torch.serve.hub import EXT_CAPACITY as serve_cap
    from swim_tpu_torch.sim import faults, runner
    from swim_tpu_torch.utils import prng, threefry

    dev = devmod.resolve(device)
    mesh = pmesh.make_mesh(devices=[dev] * d)
    key = threefry.key(0)

    checks: dict[str, list[dict]] = {name: [] for name in CONTRACTS}
    totals = {"retraces_extra": 0, "unattributed_collective_bytes": 0,
              "undonated_bytes": None, "barrier_chains_missing": 0}

    def add(contract: str, arm: str, ok, detail: str) -> None:
        checks[contract].append(
            {"arm": arm, "ok": None if ok is None else bool(ok),
             "detail": str(detail)})

    # -- build budget: one build per seam per arm across a value sweep --
    progs = _program_sweep(retrace_n, dev)
    cfg_r = SwimConfig(n_nodes=retrace_n, **SMALL_GEOM)
    build_arms = (
        ("dense", lambda p: runner.run_study(
            cfg_r, dense.init_state(cfg_r, dev), p, key, periods)),
        ("rumor", lambda p: runner.run_study_rumor(
            cfg_r, rumor.init_state(cfg_r, dev), p, key, periods)),
        ("ring", lambda p: runner.run_study_ring(
            cfg_r, ring.init_state(cfg_r, dev), p, key, periods)),
    )
    for name, run_value in build_arms:
        ok, extra, detail = build_row(count_builds(run_value, progs),
                                      len(progs))
        totals["retraces_extra"] += extra
        add("retrace_budget", name, ok, detail)

    # streaming chunk: two plan values through one chunk body
    def chunk_value(crash_at):
        plan_v = faults.with_crashes(faults.none(retrace_n, dev), [5],
                                     [crash_at])
        runner._run_study_ring_chunk(
            cfg_r, ring.init_state(cfg_r, dev),
            runner.compact_track_init(plan_v, periods), plan_v, key,
            periods, runner.make_stepper(cfg_r, plan_v, ring.step))

    ok, extra, detail = build_row(count_builds(chunk_value, (2, 3)), 2,
                                  "plan values")
    totals["retraces_extra"] += extra
    add("retrace_budget", "ring_stream_chunk", ok, detail)

    # sharded step: one ShardedStep across program values
    cfg_s = SwimConfig(n_nodes=retrace_n, ring_sel_scope="period",
                       ring_ici_wire="compact", ring_scalar_wire="packed",
                       **SMALL_GEOM)
    rnd_s = ring.draw_period_ring(key, 0, cfg_s, dev)
    held: dict = {}

    def sharded_value(prog):
        if "step" not in held:
            held["step"] = ring_shard.mapped_step(cfg_s, mesh)
        st_p, pl_p = ring_shard.place(cfg_s, mesh,
                                      ring.init_state(cfg_s, dev), prog)
        held["step"](st_p, pl_p, rnd_s, ring.rotor_offsets(cfg_s, 0))

    ok, extra, detail = build_row(count_builds(sharded_value, progs[:2]),
                                  2)
    totals["retraces_extra"] += extra
    add("retrace_budget", "ringshard", ok, detail)

    # -- donation coverage: no eager counterpart --
    for arm in ("dense", "rumor", "ring", "ring_stream_chunk", "batch"):
        add("donation_coverage", arm, None,
            NOT_APPLICABLE[("donation_coverage", arm)])

    # -- wire, tally, hygiene over the 2x2 sharded wire matrix --
    wire = sharded_wire_arms(mesh, wire_n, add)
    family_bytes_by_arm = wire["families"]
    totals["unattributed_collective_bytes"] += wire["unattributed"]
    ppermute_bytes_by_arm = {arm: int(fam.get("ppermute", 0))
                             for arm, fam in family_bytes_by_arm.items()}

    # the serving hub's mirror bytes: inside the vocabulary, 16 bytes a
    # reserved slot, and the window+wide arm's bytes all attributed
    cfg_e = SwimConfig(n_nodes=wire_n, **SMALL_GEOM)
    tally_e = ici.trace_ici_bytes(cfg_e, d, ext_capacity=serve_cap)
    mirror_b = int(tally_e["breakdown"].get("ext_mirror_rows", 0))
    loose_e = {k: v for k, v in tally_unattributed(
        family_bytes_by_arm["window+wide"],
        tally_e["breakdown"]).items() if v}
    totals["unattributed_collective_bytes"] += sum(loose_e.values())
    add("ici_tally_completeness", "serve_ext_mirror",
        mirror_b == 16 * serve_cap and not loose_e,
        f"ext_mirror_rows={mirror_b} (capacity {serve_cap}), "
        + (f"unattributed={loose_e}" if loose_e else "fully attributed"))

    compact_b = ppermute_bytes_by_arm["compact+packed"]
    wide_b = ppermute_bytes_by_arm["window+wide"]
    add("wire_contracts", "compact_vs_window", 0 < compact_b < wide_b,
        f"ppermute bytes/period/chip: compact+packed={compact_b} "
        f"window+wide={wide_b}")

    # -- hygiene over the study period bodies, the draws included --
    prog_h = progs[0]
    base_h = faults.base_of(prog_h)

    def study_body(init, period_fn, draw, step_fn):
        """Violations of `periods` study periods from a fresh state: the
        draws under the watch, the periods under the watch and (on the
        card) the sync check.  The set-up, and on the card the draws
        (their threefry keys are made on the host and copied over, as
        every period of every runner does before its step), stay out of
        the sync check."""
        state = init(cfg_r, dev)
        track = runner._new_track(retrace_n, dev)
        stepper = runner.make_stepper(cfg_r, prog_h, step_fn)
        found: set = set()
        with HygieneWatch(found):
            rnds = [draw(t) for t in range(periods)]
        with HygieneWatch(found), sync_check(dev):
            for rnd in rnds:
                state, track, _, _ = period_fn(cfg_r, state, track, base_h,
                                               rnd, stepper)
        return sorted(found)

    hygiene_arms = (
        ("dense", lambda: study_body(
            dense.init_state, runner.dense_study_period,
            lambda t: prng.draw_period(key, t, cfg_r, dev), dense.step)),
        ("rumor", lambda: study_body(
            rumor.init_state, runner.rumor_study_period,
            lambda t: rumor.draw_period_rumor(key, t, cfg_r, dev),
            rumor.step)),
        ("ring", lambda: study_body(
            ring.init_state, runner.ring_study_period,
            lambda t: ring.draw_period_ring(key, t, cfg_r, dev), ring.step)),
    )
    for name, body in hygiene_arms:
        violations = body()
        add("hot_path_hygiene", f"study/{name}", not violations,
            "; ".join(violations) if violations else "clean")

    # -- bounded working sets --
    budget = 4 * retrace_n
    state_c = ring.init_state(cfg_r, dev)
    up = torch.ones((retrace_n,), dtype=torch.bool, device=dev)
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    chunks = census_chunks(cfg_r, state_c, up, budget)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base_mem
    ok_c, detail_c = census_row(chunks, budget, peak)
    totals["barrier_chains_missing"] += int(not ok_c)
    add("barrier_survival", "census_chunked", ok_c, detail_c)

    cfg_pull = SwimConfig(n_nodes=retrace_n, ring_probe="pull",
                          **SMALL_GEOM)
    ops_p = ring.GlobalOps(cfg_pull, dev)
    gathers = RowGatherWatch(ops_p)
    ring.step(cfg_pull, ring.init_state(cfg_pull, dev),
              faults.none(retrace_n, dev),
              ring.draw_period_ring(key, 0, cfg_pull, dev), ops=ops_p)
    ok_p, detail_p = gather_row(gathers)
    totals["barrier_chains_missing"] += int(not ok_p)
    add("barrier_survival", "pull_gather_step", ok_p, detail_p)

    add("barrier_survival", "sharded_gspmd_64m", None,
        NOT_APPLICABLE[("barrier_survival", "sharded_gspmd_64m")])

    return assemble_report(checks, totals, platform=dev.type, devices=d,
                           wire_n=wire_n, retrace_n=retrace_n,
                           periods=periods)


def assemble_report(checks: dict[str, list[dict]], totals: dict,
                    **header) -> dict:
    """The report of the rows `checks` (contract -> rows of {"arm", "ok",
    "detail"}, `ok` None for a not_applicable row): statuses, waivers,
    per-contract worst status and the totals."""
    waived_keys = {(w["contract"], w["arm"]): w for w in WAIVERS}
    contracts_out = {}
    n_checks = n_failed = n_waived = n_na = 0
    for contract in sorted(CONTRACTS):
        arm_rows = []
        worst = None
        for row in checks.get(contract, []):
            if row["ok"] is None:
                if (contract, row["arm"]) not in NOT_APPLICABLE:
                    raise ValueError(
                        f"{contract}/{row['arm']} is not measured and not "
                        "in NOT_APPLICABLE")
                n_na += 1
                arm_rows.append(dict(row, status="not_applicable"))
                continue
            n_checks += 1
            status = "pass"
            if not row["ok"]:
                waiver = waived_keys.get((contract, row["arm"]))
                if waiver is not None:
                    status = "waived"
                    n_waived += 1
                    row = dict(row, waived_by=waiver["pointer"])
                else:
                    status = "fail"
                    n_failed += 1
            arm_rows.append(dict(row, status=status))
            if status == "fail":
                worst = "fail"
            elif status == "waived" and worst != "fail":
                worst = "waived"
            elif worst is None:
                worst = "pass"
        contracts_out[contract] = {
            "description": CONTRACTS[contract],
            "eager_form": EAGER_FORMS[contract],
            "status": worst or "not_applicable",
            "checks": arm_rows,
        }
    totals = dict(totals, checks_total=n_checks, failures=n_failed,
                  waived=n_waived, not_applicable=n_na)
    return {"schema": 1, **header, "contracts": contracts_out,
            "waivers": list(WAIVERS), "totals": totals}


# ---------------------------------------------------------------------------
# Report plumbing: checking, byte-stable writing, gauges.
# ---------------------------------------------------------------------------

def check_report(report: dict) -> tuple[bool, list[str]]:
    """(ok, failures) — failures list unwaived failing checks by name."""
    failures = []
    for contract in sorted(report["contracts"]):
        for row in report["contracts"][contract]["checks"]:
            if row["status"] == "fail":
                failures.append(
                    f"{contract}/{row['arm']}: {row['detail']}")
    return (not failures), failures


def write_report(report: dict, path: str) -> None:
    """Atomic, byte-stable write: sorted keys, no timestamps, trailing
    newline — reruns of the same tree produce the identical file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = json.dumps(report, indent=2, sort_keys=True) + "\n"
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".audit_")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


AUDIT_GAUGES = {
    "swim_audit_checks_total":
        "contract checks evaluated in the last audit run",
    "swim_audit_failures_total":
        "unwaived failing contract checks (CI-red)",
    "swim_audit_waived_total":
        "failing checks covered by an expected-fail waiver",
    "swim_audit_retraces_extra_total":
        "retraces beyond the one-compile-per-arm budget",
    "swim_audit_unattributed_collective_bytes":
        "traced collective bytes not attributed to a named obs/ici.py "
        "tally term",
    "swim_audit_undonated_bytes":
        "donated-argument bytes not aliased in the compiled executable",
    "swim_audit_barrier_chains_missing":
        "barrier arms whose ordering chain fell below the contract floor",
}


def gauge_values(report: dict) -> dict[str, int | float]:
    """Metric name -> value for obs/expo.py (one per AUDIT_GAUGES key)."""
    totals = report["totals"]
    return {
        "swim_audit_checks_total": totals["checks_total"],
        "swim_audit_failures_total": totals["failures"],
        "swim_audit_waived_total": totals["waived"],
        "swim_audit_retraces_extra_total": totals["retraces_extra"],
        "swim_audit_unattributed_collective_bytes":
            totals["unattributed_collective_bytes"],
        "swim_audit_undonated_bytes": totals["undonated_bytes"],
        "swim_audit_barrier_chains_missing":
            totals["barrier_chains_missing"],
    }

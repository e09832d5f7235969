#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc of the three kernels (one process per source, in
     parallel) into swim_tpu_torch/_build/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     bitwise, at the 1,000,000-node slice's shapes and at edge cases;
     kernel and plain times (CUDA events, median of 21 samples of 10
     launches after warm-up) beside the bytes the function must move and
     the least time the card could take (for coldsel also the bound that
     counts cold in 32-byte sectors); and the time of a PyTorch copy of
     the window, the rate this card reaches on one read and one write;
  4. golden: the port on the card reproduces the three engine digests
     of golden.py (period scope, wave scope, Lifeguard with buddy) and
     the study digest (a pull-mode streaming detection study), which
     both packages give on the CPU;
  5. parity: 1,000,000 nodes with 0.1% of them crashing, a few periods
     with the kernels and with the plain versions, both on the card, all
     14 state fields equal, for each of the three paths: period scope,
     wave scope (the default SwimConfig) and Lifeguard in period scope;
  6. throughput: for each path RingEngine(...).run(periods) after
     warm-up, periods/sec (host-bound readings with a wide spread between
     calls) and each kernel's launches per period; launch counts are
     zeroed just before each run and read just after; on the period-scope
     run crashed nodes are declared dead, and on every run no live node
     is;
  7. main_inputs: one more period of each engine with the kernels'
     wrappers replaced by ones that keep clones of their arguments; each
     kernel against its plain version on those inputs, bitwise, its time
     on them (`ms_main`), the bytes they need (`bytes_main`: each input
     byte once, of wavemerge's sel only the rows some delivering wave
     reads, of coldsel's cold one 32-byte sector per distinct (row,
     8-column group) queried) and the least time for those bytes
     (`bound_ms_main`); for wavemerge the ok density of each wave.
     coldsel's inputs come from two periods: the quiet one of the
     period-scope run, and a busy one late in a run whose plan crashes
     5% of the nodes in its first periods.  The wave-scope capture times
     the one-wave merge (V=1) against its plain version, and the
     Lifeguard capture shows the merge receiving VB = 1 + k forced rows;
  8. pull and program parity: 1,000,000 nodes for 20 periods with the
     kernels and with the plain versions, all 14 fields equal, launch
     counts zeroed before and read after the kernels' run: pull-uniform
     probing (the default wave scope, 0.1% crashes; selb 1, coldsel 0,
     wavemerge 0 a period) and the rotor probe under a FaultProgram
     (gray 0.3 on domain 1, a flapping link loss on domain 2, send loss
     on every node; 14 / 1 / 14);
  9. study: `experiments.detection_study` at 1,000,000 nodes, 0.1%
     crashes, 60 periods (pull-uniform, as the study defaults), by the
     full-track runner, by the streaming runner in chunks of 20, and
     by the streaming runner checkpointing every 20 periods, stopped
     in-process after period 40 and resumed from its directory: equal
     summaries, and the streaming runs' CompactTrack and series
     bitwise equal; one more study period with PyTorch's sync check
     set to raise (no host sync inside a period); study periods/sec
     and the census's share of the wall time (CUDA events around
     `live_knower_counts`); then one
     `lifeguard_ablation` arm pair at 1,000,000 nodes, 20 periods;
 10. engines: the dense and rumor engines (plain PyTorch: they launch
     none of the three kernels, and their launch counts are read to
     show it).  The three engine digests of golden.py on the card; the
     card against the CPU from the same state and draws, every field
     after each of 5 periods, dense at 2,048 nodes and rumor at 100,000
     (1% crashes, loss 0.1), and rumor with Lifeguard, buddy and dynamic
     suspicion at 100,000 for 4 periods (its row-chunked reductions over
     several chunks); the studies at full width through their
     entry points with the default engine: `detection_study()` (dense,
     1,000 nodes), a `DenseEngine` at DENSE_MAX = 8,192 nodes for 10
     periods, `fp_sweep()` (rumor, 100,000 nodes),
     `suspicion_sweep(n=1_000_000, mults=(2.0, 5.0), periods=20)` and
     `lifeguard_ablation(n=1_000_000, periods=10)` (Lifeguard with
     buddy); for each, run twice, periods/sec and wall ms from the bare
     run, device busy ms from a second run under torch.profiler (which
     must give the same result), and peak memory, and on the runs
     without loss that crashed subjects were suspected and no live node
     declared dead;
     one study period of each engine with PyTorch's sync check set to
     raise;
 11. telemetry: the engines' taps, the study runners' frames, the flight
     recorder and batched studies.  `recorded_ring_run` at 1,000,000
     nodes in the default wave scope, 0.1% crashing, 20 periods, with
     the kernels and with the plain versions: all 14 state fields and
     all 8 frame fields equal, selb 14, wavemerge 14 and coldsel 1
     launches a period, and the state equal to a tap-off `ring.run`;
     periods/sec with the tap and without it in alternating pairs, and
     the device busy ms of each under torch.profiler.  The 1M pull
     detection study with `telemetry=True` and a flight-recorder dump,
     by the full-track runner and by the streaming runner in chunks of
     20: digests and summaries equal, the dumps byte-equal and holding
     every period's frame, the detection summary reproduced by
     `analyze` from the dump alone, its error findings printed, and one
     more telemetry study period with the sync check set to raise; the
     pull study's tap cost in alternating pairs.  `detection_study(
     telemetry=True)` with a dump on the dense engine (1,000 nodes) and
     on the rumor engine (100,000 nodes): the summary equal to the
     tap-off study's, the digest and health summary printed, the
     detection summary reproduced from the dump.  The dense and rumor
     taps: card frames equal to the CPU's in phase 10's card-against-CPU
     runs (every period), a telemetry study period of each under the
     sync check, and each tap's cost
     (wall and busy ms a period, on and off) at dense 8,192 and rumor
     1,000,000 nodes.  `experiments._run_study_batch` on the ring engine
     at 1,000,000 nodes, P = 3 programs, 20 periods, telemetry on, and
     on the rumor engine at 100,000 nodes, P = 2, 10 periods: every lane
     bitwise equal to its serial run on the card (state, track, series,
     frames), launches P times the serial ones, and the peak memory.

 12. scenario: the scenario library and the search (sim/scenario.py,
     sim/search.py).  `rack_outage`, `flap`, `flap_boundary` and
     `gray_10pct` (ring, packed scalar wire, Lifeguard with buddy, 256
     nodes, 40-48 periods), `baseline_config3` (rumor, 100,000 nodes, 4
     arms x 100 periods) and `lean_fidelity` (the ring pull study, 4,096
     nodes, 24 periods) through `scenario.run` on the card, serial and
     with `batch=True`: equal verdict bytes (out_dir normalised), and for
     the four ring specs and `lean_fidelity` equal to the port's verdict
     on the CPU; each spec's verdict, checks, walls, the bill of its
     packed arms, and its launches per ring period (a packed ring arm
     with a program: selb 1, wavemerge 1, coldsel 1; the pull study selb
     1; rumor none), zeroed before and read after each run;
     `replay_storm` (a 16-node SimCluster of real nodes) passes with
     verdict bytes equal to golden.GOLDEN_DIGEST_REPLAY_STORM, launching
     no kernel.  `gray_10pct`'s
     program and Lifeguard arm rescaled to 1,000,000 nodes (`blocks:10`,
     about 100,000 gray nodes) for 20 periods: the packed wire with the
     kernels, with the plain versions and the wide wire all give equal
     state in every field, launches 1 / 1 / 1 a period; periods/sec
     packed and wide in 3 alternating pairs; the 8-way bill of both
     wires.  `search.search()` at its defaults (4 generations x 16
     lanes, then `refine_boundary`) once: the report's sha256 equal to
     golden.GOLDEN_DIGEST_SEARCH (both packages' report on the CPU),
     wall, wall per generation, the boundary; it runs in a child process
     beside phases 17-19, so its wall is contended (see below).
 13. serve: the serving hub (serve/hub.py) and its load harness
     (serve/load.py) on the card.  (a) golden.GOLDEN_DIGEST_SERVE on the
     card; (b) golden.drive_serve (8 sessions, gossip with SUSPECT, DEAD
     and ALIVE claims, a period past the 64-slot batch, ACKs, an
     eviction) at 100,000 nodes for 20 periods on the card and on the
     CPU, state digests equal after every period, selb 1, wavemerge 1
     and coldsel 1 launch a period (zeroed before, read after); (c) the
     same at 1,000,000 nodes for 3 periods against a loop of
     `ring.step(..., plain=True, ext=...)` on the card over the hub's
     own recorded step inputs; (d) the kernels on one 1M hub period's
     captured inputs (WW = 6, V = 6, Q = 3), bitwise against their
     plain versions, with `ms_main`, `bytes_main`, `bound_ms_main`;
     (h) one untraced 1M hub period, with gossip queued, under
     PyTorch's sync check set to raise; the 1M hub period's wall, busy
     ms under the profiler, idle share and launches (20 periods, the
     golden script's gossip each period); (e) `run_load()` at its
     defaults (1M nodes, 1,000 sessions, 3 periods, 2,000 echoes) on the
     udppump frontend: `ok_parity`, both arms admit every session, the
     admission rate, echo p50/p99/p99.9, `step_seconds`; (f)
     `run_trace()` at its defaults: traced and untraced digests equal,
     the tail's attribution and coverage printed (the reference's 90%
     coverage contract is reported, not asserted: on the card the three
     periods span under a third of the echo window), with the echo
     percentiles inside and outside the traced periods; (g)
     `trace_overhead()` at its defaults.
 14. bridge: the lockstep bridge over the ring engine on the card
     (bridge/engine_server.py).  g++ of native/bridge_client.cpp; (1)
     golden.GOLDEN_DIGEST_BRIDGE (the scripted raw-socket session at
     2,048 nodes in the bridge geometry, k = 1: frames and state after
     every period) on the card, selb 6, wavemerge 6 and coldsel 1
     launches a period; (2) the same script at 65,536 nodes with the
     default SwimConfig for 10 periods (20 until phase 20 came), card
     against CPU after every period (frames, state, findings), launches
     14 / 14 / 1 a period;
     (3) the reference's conformance scenarios with the compiled C++
     core: one core joining 65,536 engine nodes (victim killed at 8 s,
     a forged suspicion refuted into tensor state, no false deaths) and
     two cores at 16,384 nodes (A leaves, B learns A's death through
     tensor state); (4) the bridge period at 1,000,000 nodes with the
     default SwimConfig and one session acking its pings: the wall a
     period as the session and as the server see it, busy ms under
     torch.profiler, the idle share, launches and device-to-host copies
     a period (one: the table, tombstones and the joined rows), and the
     synchronizing calls PyTorch's sync check reports.
 15. instruments: the phase profiler, the memory wall and the CLI
     (obs/prof.py, obs/memwall.py, cli.py).  `profiled_ring_run` at
     1,000,000 nodes, 0.1% crashing, period scope, 5 periods, with the
     kernels and with the plain versions: markers equal, the state
     equal to `ring.run`'s in all 14 fields, selb, wavemerge and coldsel
     once a period (zeroed before, read after), and one more profiled
     period under PyTorch's sync check set to raise;
     golden.GOLDEN_DIGEST_MARKERS on the card; `profile_ring` at 1M in
     period scope and in the default wave scope with a device trace:
     per-phase ms, step ms, its wall coverage, the roofline band, the
     top kernels; the same attribution by device time, each prefix and
     the step traced with torch.profiler: per-phase device ms and the
     device-time coverage, which must lie in 95-105% (at least 100% by
     construction, the excess is what the clamp of negative prefix
     differences dropped); then 2
     traced periods of each scope whose trace holds each kernel as
     often as its wrapper launched it, under its phase; marker mode on
     against off, wall ms a period in 3 alternating pairs (printed, not
     asserted); `study_memory_analysis`
     at 1M (streaming): the measured peak against the card's memory;
     the CLI in subprocesses on the card: `simulate --nodes 1000000
     --engine ring --sel-scope period --periods 10`, `profile --nodes
     1000000 --check --json --out auto` and `bridge --metrics-port 0`,
     whose scrape carries that artifact's swim_prof_* gauges; each
     exits 0.
 16. ringshard: the sharded ring engine (parallel/ring_shard.py) with
     D = 8 shards on the one card, 1,000,000 nodes (S = 125,000 rows a
     shard), 0.1% crashing.  For the default SwimConfig (wave scope,
     the window ICI wire: SwimConfig pins the compact wire to period
     scope), period scope on the compact wire and period scope on the
     packed scalar wire, 3 periods on one device, sharded with the
     kernels and sharded with the plain versions: all 14 fields equal,
     launches (zeroed before, read after) 8 times the single-device
     selb and coldsel and wavemerge once a wave on each shard (each
     exchanged block ORed in at offset 0); golden.GOLDEN_DIGESTS by the
     sharded engine (in a child process beside phases 17-19, see
     below); selb, coldsel and wavemerge on every per-shard input of
     one more wave-scope period (112, 8 and 112 calls) and of a period at
     8 x 125,001 nodes (S % 4 != 0), bitwise against their plain
     versions, with `ms_main` on shard 0's inputs; one sharded period
     under PyTorch's sync check set to raise; the 1M pull detection
     study on `ringshard` streaming in chunks of 3 for 9 periods, again
     checkpointing every 3, stopped in-process after 6 and resumed:
     summaries equal, track, series and state bitwise, the summary the
     `ring` engine's; memwall's measured peak of the 1M pull study (12
     periods) sharded and on one device, the sharded within 5% of the
     other; the wall and busy ms a period, idle share and kernels a
     period of the sharded wave-scope period beside the single-device
     one in the same call.
 17. shard: the exchange-sharded rumor engine (parallel/shard_engine.py)
     with D = 8 shards on the one card, 1,000,000 nodes (R = 4,096), 0.1%
     crashing, loss 0.1.  First, before the children start: the peak
     memory of a 1M study period whose census sums the shards' counts
     against one that assembles the state; 5 periods at 1M after
     warm-up, sharded and on one device, each with only its own state
     on the card: wall, busy, idle share, kernels a period, peak
     memory.  Then 3 periods against `rumor.step` on one device,
     all 12 fields equal every period, and one more sharded period under
     PyTorch's sync check set to raise; `exchange_slack=1` without loss:
     period 0's overflow exceeds the lossless engine's by exactly the
     acks over their W2 slots, and after 3 periods every field is in
     its range; golden.ENGINE_DIGESTS["rumor"] and ["rumor_lifeguard"]
     by the sharded engine; `fp_sweep(n=100_000, periods=20)` on
     `shard` equal to `rumor` but for the engine's name, with wall ms a
     study period of each.  The port's kernels launch 0 times in the
     phase (`launches_shard`).

 18. audit_oracles: `swim-tpu-torch audit --check --json` (cli.main) in
     a subprocess on the card at its defaults (wire 512, retrace 256
     nodes, 8 shard slots): exit 0, every row `pass` but the
     `not_applicable` rows analysis/audit.py names (donation_coverage,
     barrier_survival/sharded_gspmd_64m), no unattributed byte, no
     extra build; each contract's status, the census's chunks and peak,
     the wall time; `render_audit` of the report, one sample line per
     gauge.  Then the port's engines on the card with the kernels
     against the port's scalar oracles, every period compared as the
     reference's tests compare: the ring crash lifecycle (32 nodes, 26
     periods) in wave and in period scope and under pull, the dense
     stock demo with crashes, the rumor crash-and-loss lifecycle.  The
     kernels' launches of each part are zeroed before and read after
     (`launches_audit`: in the audit's process; `launches_oracle`: each
     ring path's launches a period times its periods).

 19. multidevice: both sharded engines with each shard's blocks on its
     own device.  On the mesh card, CPU, card, CPU (D = 4, every
     exchange a copy between the devices; the CPU shards run the
     kernels' plain versions): ringshard at 1,000,000 nodes in period
     and in wave scope, 2 periods each, every field equal to ring.run
     on the card, selb and coldsel launched on the two card shards
     (twice one card's) and wavemerge on them once a wave, the card
     shards' kernel calls of one more period against their plain
     versions; `shard` at
     100,000 nodes (R = 4,096, loss 0.1, 3 periods) equal to rumor.run;
     the 1M pull study (4 periods in chunks of 2) checkpointed on the
     card's 8 slots, stopped after its first chunk and resumed on the
     mixed mesh, its summary, track and series equal to the one-card
     study's; the audit's sharded wire arms
     (analysis/audit.sharded_wire_arms, 512 nodes) on the mix, every
     row passing.  For each: launches, the bytes copied between the
     devices a period (equal to ring_shard.mesh_copy_bytes of the
     recorded exchanges: a roll, ring hop or compact wire block copies
     the source posts its shards read from another device) beside
     obs/ici.py's bill for D = 4 and the fetch factor, of every
     exchange, of the rolls and of the pull ring passes, the seconds.
     Where PyTorch sees two or more cards,
     after the children are joined: the same parity on `make_mesh()`
     at 1M (the rolls' fetch factor at most 1: two blocks a shard
     read, where the reference moves two), the wall a period beside
     one card, each card's peak
     (memwall), the audit's wire arms with the sync check and one
     period under the sync check; on one card the line `"part":
     "all_cards", "run": false`.  `launches_multidevice` sums the
     launches of the mixed mesh's runs.

 20. partition: the dense, ring and rumor engines partitioned over the
     same mixed mesh (parallel/partition.py), each against one card,
     every field bitwise: dense at DENSE_MAX = 8,192 nodes (1%
     crashes, telemetry on, every period's EngineFrame equal) and rumor
     at 100,000 nodes (R = 4,096, loss 0.1, telemetry on) under a join
     schedule and a FaultProgram with two segments, 3 periods of the
     one-card step and of the partitioned step; the ring through the
     studies' router: `make_mesh()` giving the mixed mesh,
     `_run_study_batch` of two FaultProgram lanes at 100,000 nodes
     (rotor, wave scope, 3 periods), each lane equal to its one-card
     serial study, selb and coldsel launched on the two card shards
     (twice one card's) and wavemerge on them once a wave, the card
     shards' kernel calls of one more period against their plain
     versions.  For each: the seconds, the
     bytes copied between the devices a period (`Mesh.copied_bytes`),
     the rendezvous a period (`Mesh.rendezvous`) and the card shards'
     launches (`launches_partition`: the ring's).  Where PyTorch sees
     two or more cards: the 1M rumor detection study
     (`experiments._run_study`) over `make_mesh()`, its state, track and
     series bitwise the one-card study's, each card's peak; on
     one card the line `"part": "all_cards", "run": false`.

Phase 12's search and phase 16's sharded golden digests are host-paced
checks, so each runs in a child process (`Background`) from just after
phase 17's timing, the last measurement of time on one card, to the end
of phase 20's one-card parts.  Every line printed while a child runs,
and each child's own lines (printed when it is joined), carry
`"contended": true`: their walls shared the host and the card.  Then
the `kernels` summary line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Any failure raises: the exit code
is then nonzero and the last line is not printed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from swim_tpu_torch import SwimConfig, _kernels, coldsel_bench, golden
from swim_tpu_torch import native
from swim_tpu_torch.bridge import EngineBridgeServer
from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.core import codec
from swim_tpu_torch.measure import (PartTimer, bound, capture_inputs,
                                    card_line, coldsel_profile, gpu_ms)
from swim_tpu_torch import convert
from swim_tpu_torch.models import (dense, oracle, ring, ring_oracle, rumor,
                                   rumor_oracle)
from swim_tpu_torch.obs import analyze, ici, memwall, prof
from swim_tpu_torch.serve import hub as serve_hub
from swim_tpu_torch.serve import load as serve_load
from swim_tpu_torch.obs import engine as obs_engine
from swim_tpu_torch.ops import coldsel, lattice, selb, u32, wavemerge
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import partition, ring_shard, shard_engine
from swim_tpu_torch.sim import (experiments, faults, runner, scenario,
                                search)
from swim_tpu_torch.types import MsgKind, Status
from swim_tpu_torch.utils import prng, threefry
from swim_tpu_torch.utils.tree import tree_map

N = 1_000_000
PARITY_PERIODS = 3
WARMUP_PERIODS = 3
CRASH_FRACTION = 0.001
# path -> (SwimConfig keywords, timed periods, crashes spread over)
PATHS = {
    "period": (dict(ring_sel_scope="period"), 60, 40),
    "wave": ({}, 30, 30),
    "lifeguard": (dict(ring_sel_scope="period", lifeguard=True), 30, 30),
}
SLICE_PERIODS = 20      # pull and program parity
STUDY_PERIODS = 60
STUDY_CHUNK = 20
CKPT_DIR = Path(__file__).resolve().parent / "_study_ckpt"


# the `Background` children running now: every line printed while one
# runs is marked `"contended": true` (its walls shared the host and card)
CHILDREN: list = []


def emit(**kw):
    if CHILDREN:
        kw["contended"] = True
    print(json.dumps(kw), flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((u32.to_u64(a) - u32.to_u64(b)).abs().max())


def require_equal(what: str, a: torch.Tensor, b: torch.Tensor) -> int:
    err = max_abs_err(a, b)
    if err != 0 or not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


def rand_u32(gen, shape):
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         device="cuda", dtype=torch.int32)


# ------------------------------------------------------------- kernels


def check_selb(gen, n, ww, b):
    win = rand_u32(gen, (n, ww))
    win[torch.rand((n, ww), generator=gen, device="cuda") < 0.3] = 0
    win[0] = 0
    win[min(1, n - 1)] = -1
    got = selb.select_first_b(win, b)
    want = selb.select_first_b_plain(win, b)
    return win, require_equal(f"selb n={n} ww={ww} b={b}", got, want)


def check_coldsel(gen, rw, n, ow, q, flush=None, quiet=False):
    """`quiet`: q_rows shaped like the main path's, mostly row 0 and -1
    with a few runs of columns on other rows."""
    cold = rand_u32(gen, (rw, n))
    fr = (torch.tensor(flush, dtype=torch.int32, device="cuda")
          if flush is not None else
          torch.randint(0, rw, (ow,), generator=gen, device="cuda",
                        dtype=torch.int32))
    fv = rand_u32(gen, (fr.shape[0], n))
    qr = torch.randint(-2, rw + 2, (q, n), generator=gen, device="cuda",
                       dtype=torch.int32)
    if quiet:
        u = torch.rand((q, n), generator=gen, device="cuda")
        run = (torch.arange(n, device="cuda") // 3 % rw).to(torch.int32)
        qr = torch.where(u < 0.9, 0, torch.where(u < 0.95, -1,
                                                 torch.where(u < 0.98, run,
                                                             qr)))
        qr = qr.to(torch.int32)
    c_k, s_k = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
    c_p, s_p = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
    what = f"coldsel rw={rw} n={n} ow={fr.shape[0]} q={q}"
    return ((cold, fr, fv, qr),
            max(require_equal(what + " cold", c_k, c_p),
                require_equal(what + " sel", s_k, s_p)))


def check_wavemerge(gen, n, ww, v, vb, offs=None, density=0.4):
    win = rand_u32(gen, (n, ww))
    sel = rand_u32(gen, (n, ww))
    oks = (torch.rand((v, n), generator=gen, device="cuda")
           < torch.tensor(density, device="cuda").reshape(-1, 1))
    if offs is None:
        offs = torch.randint(-2 * n, 2 * n, (v,), generator=gen,
                             device="cuda", dtype=torch.int32)
    else:
        offs = torch.tensor(offs, dtype=torch.int32, device="cuda")
    bcol = torch.randint(-1, ww + 2, (vb, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    bit = torch.randint(0, 32, (vb, n), generator=gen, device="cuda",
                        dtype=torch.int32)
    bval = torch.where(torch.rand((vb, n), generator=gen, device="cuda")
                       < 0.3, torch.ones_like(bit) << bit, 0)
    got = wavemerge.merge_waves(win.clone(), sel, oks, offs, bcol, bval)
    want = wavemerge.merge_waves_plain(win.clone(), sel, oks, offs, bcol,
                                       bval)
    return ((win, sel, oks, offs, bcol, bval),
            require_equal(f"wavemerge n={n} ww={ww} v={v} vb={vb}", got,
                          want))


def kernel_phase(cfg) -> dict:
    g = ring.geometry(cfg)
    ww, rw, ow, q = g.ww, g.rw, g.ow, g.c + 1
    v = 2 + 4 * cfg.k_indirect
    b = cfg.max_piggyback
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    rows = {}

    # edge cases: ragged N, budgets 0/1/32/beyond, bit-31 words, odd and
    # wide rows (WW=400 takes more than 48 KB of shared memory)
    edge = []
    for n_e, ww_e, b_e in ((1000, 12, 6), (257, 12, 0), (257, 12, 1),
                           (1000, 3, 32), (1000, 12, 500), (33, 1, 6),
                           (1000, 5, 6), (1000, 16, 31), (1000, 16, 33),
                           (300, 400, 500)):
        edge.append(check_selb(gen, n_e, ww_e, b_e)[1])
    win, err = check_selb(gen, N, ww, b)
    t_k = gpu_ms(lambda: selb.select_first_b(win, b))
    t_p = gpu_ms(lambda: selb.select_first_b_plain(win, b), samples=5,
                 inner=2)
    nbytes = 2 * N * ww * 4
    bms, by = bound(nbytes, N * ww * 8)
    rows["selb"] = dict(max_abs_err=max(err, *edge), ms=t_k, plain_ms=t_p,
                        bytes=nbytes, bound_ms=bms, bound_by=by,
                        shape=[N, ww], b=b)
    emit(phase="kernel", name="selb", edge_cases=len(edge), **rows["selb"])
    # what this card reaches on the same bytes: one read and one write of
    # the window, by PyTorch's copy
    dst = torch.empty_like(win)
    t_c = gpu_ms(lambda: dst.copy_(win))
    emit(phase="calibration", what="copy of the [N, WW] window",
         bytes=nbytes, ms=t_c, tb_per_s=nbytes / t_c / 1e9)

    edge = []
    # edge cases: duplicate and out-of-range flush rows, more queries
    # than one group of four, N % 4 != 0 (the 4-byte path), a flushed row
    # 0 under main-path-shaped queries
    for rw_e, n_e, ow_e, q_e, fl, quiet in (
            (16, 1000, 2, 4, None, False), (16, 300, 3, 3, [4, 4, -1], False),
            (8, 33, 2, 1, [7, 20], False), (16, 1000, 2, 9, [3, 3], False),
            (128, 4096, 2, 4, [0, 5], True), (128, 4099, 2, 4, None, True),
            (16, 1001, 5, 6, [0, 15, 0, 16, 2], True)):
        edge.append(check_coldsel(gen, rw_e, n_e, ow_e, q_e, fl, quiet)[1])
    (cold, fr, fv, qr), err = check_coldsel(gen, rw, N, ow, q)
    t_k = gpu_ms(lambda: coldsel.cold_update_select(cold, fr, fv, qr))
    t_p = gpu_ms(lambda: coldsel.cold_update_select_plain(cold, fr, fv, qr),
                 samples=5, inner=2)
    nbytes = (2 * ow + 3 * q) * N * 4
    bms, by = bound(nbytes, N * (ow + q * (ow + 4)))
    prof = coldsel_profile(cold, fr, fv, qr)
    rows["coldsel"] = dict(max_abs_err=max(err, *edge), ms=t_k, plain_ms=t_p,
                           bytes=nbytes, bound_ms=bms, bound_by=by,
                           bytes_sector=prof["bytes_sector"],
                           bound_ms_sector=prof["bound_ms_sector"],
                           shape=[rw, N], ow=ow, q=q)
    emit(phase="kernel", name="coldsel", edge_cases=len(edge),
         **rows["coldsel"])

    # edge cases: offsets 0 / N-1 / negative / beyond N, wraps inside a
    # tile (85 receivers at WW=12), VB rows, WW=3 (the 4-byte path), the
    # main path's shape of oks (two dense waves, twelve sparse), and the
    # one-wave merges of the in-line delivery (V=1, VB=0 and 1), and the
    # sharded ring's sender-side forced bit (V=0, VB=1)
    sparse = [0.99] * 2 + [0.002] * 12
    edge = []
    for n_e, ww_e, vb_e, offs, dens in (
            (1000, 12, 0, [0, 999, -1, -1000, 1999, 1, 500], 0.4),
            (1000, 12, 2, None, 0.4), (257, 12, 2, [0, 256, -257], 0.4),
            (1, 12, 1, [0, 5], 0.4), (1000, 3, 2, None, 0.4),
            (1001, 12, 1, [0, 1, -1, -85, 830, 2001, -2999, 84], 0.4),
            (50_000, 12, 0, None, sparse), (1000, 12, 0, [-7], 0.9),
            (1000, 12, 1, [993], 0.9), (1000, 12, 1, [], 0.4)):
        nv = 14 if offs is None else len(offs)
        edge.append(check_wavemerge(gen, n_e, ww_e, nv, vb_e, offs,
                                    dens)[1])
    _, err2 = check_wavemerge(gen, N, ww, v, 2)
    (win, sel, oks, offs, bcol, bval), err = check_wavemerge(gen, N, ww, v, 0)
    t_k = gpu_ms(lambda: wavemerge.merge_waves(win, sel, oks, offs, bcol,
                                               bval))
    t_p = gpu_ms(lambda: wavemerge.merge_waves_plain(win, sel, oks, offs,
                                                     bcol, bval),
                 samples=5, inner=2)
    nbytes = 3 * N * ww * 4 + v * N
    bms, by = bound(nbytes, N * ww * 3 * v)
    rows["wavemerge"] = dict(max_abs_err=max(err, err2, *edge), ms=t_k,
                             plain_ms=t_p, bytes=nbytes, bound_ms=bms,
                             bound_by=by, shape=[N, ww], v=v, vb=0)
    emit(phase="kernel", name="wavemerge", edge_cases=len(edge) + 1,
         **rows["wavemerge"])
    return rows


# --------------------------------------------------------- main path


def crash_plan(cfg, periods: int, fraction: float = CRASH_FRACTION):
    return faults.with_random_crashes(
        faults.none(cfg.n_nodes, "cuda"), threefry.key(1), fraction, 0,
        periods)


def path_cfg(path: str) -> SwimConfig:
    return SwimConfig(n_nodes=N, **PATHS[path][0])


def expected_launches(cfg) -> dict:
    """Kernel launches per period: one of each when the waves fuse; else
    a selection (wave scope only) and a one-wave merge per wave."""
    waves = 2 + 4 * cfg.k_indirect
    fused = cfg.ring_sel_scope == "period" and waves <= wavemerge.MAX_WAVES
    return {"selb": 1 if cfg.ring_sel_scope == "period" else waves,
            "coldsel": 1, "wavemerge": 1 if fused else waves}


def shard_merge_launches(cfg) -> int:
    """wavemerge calls a period on each card shard of the sharded ring:
    one a wave (the exchanged block ORed in at offset 0), and in wave
    scope under Lifeguard's buddy one more for each wave whose sender
    forces a bit (W1 and the k W4s); none under pull."""
    if cfg.ring_probe == "pull":
        return 0
    waves = 2 + 4 * cfg.k_indirect
    fused = cfg.ring_sel_scope == "period" and waves <= wavemerge.MAX_WAVES
    buddy = cfg.lifeguard and cfg.buddy and not fused
    return waves + (1 + cfg.k_indirect if buddy else 0)


def golden_phase() -> None:
    for name, want in golden.GOLDEN_DIGESTS.items():
        got = golden.digest(golden.golden_run("cuda", name))
        if got != want:
            raise AssertionError(f"golden digest '{name}' on the card {got} "
                                 f"!= {want}")
        emit(phase="golden", config=name, digest=got,
             n_nodes=golden.GOLDEN_N, periods=golden.GOLDEN_PERIODS)
    res = golden.golden_study("cuda")
    got = golden.study_digest(res.state, res.track, res.series)
    if got != golden.GOLDEN_DIGEST_STUDY:
        raise AssertionError(f"golden study digest on the card {got} != "
                             f"{golden.GOLDEN_DIGEST_STUDY}")
    emit(phase="golden", config="study", digest=got,
         n_nodes=golden.GOLDEN_N, periods=golden.GOLDEN_PERIODS,
         crashed=int(res.track.subjects.numel()))


def parity_phase(path: str) -> None:
    cfg = path_cfg(path)
    plan = crash_plan(cfg, PARITY_PERIODS)
    t0 = time.perf_counter()
    k = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, PARITY_PERIODS)
    p = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, PARITY_PERIODS,
                 plain=True)
    torch.cuda.synchronize()
    for f in ring.RingState._fields:
        if not torch.equal(getattr(k, f), getattr(p, f)):
            raise AssertionError(f"{path} path: field {f} differs between "
                                 "the kernels and the plain versions")
    emit(phase="parity", path=path, n_nodes=cfg.n_nodes,
         periods=PARITY_PERIODS, fields_equal=len(ring.RingState._fields),
         seconds=time.perf_counter() - t0)


def throughput_phase(path: str, card: str) -> tuple[dict, dict]:
    """(launches in the timed run, the next period's captured inputs)."""
    cfg = path_cfg(path)
    timed, crash_over = PATHS[path][1:]
    plan = crash_plan(cfg, crash_over)
    engine = ring.RingEngine(cfg, plan, seed=0)
    engine.run(WARMUP_PERIODS)
    torch.cuda.synchronize()
    selb.launches = coldsel.launches = wavemerge.launches = 0
    t0 = time.perf_counter()
    st = engine.run(timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"selb": selb.launches, "coldsel": coldsel.launches,
                "wavemerge": wavemerge.launches}
    per_period = expected_launches(cfg)
    for name, cnt in launches.items():
        if cnt != timed * per_period[name]:
            raise AssertionError(
                f"{path} path, {name}: {cnt} launches in {timed} periods, "
                f"expected {per_period[name]} a period")
    # the run's output: finite shapes, crashed nodes detected, no live
    # node declared dead (no loss in this plan, so no false suspicion)
    periods_done = WARMUP_PERIODS + timed
    if int(st.step) != periods_done:
        raise AssertionError(f"step {int(st.step)} != {periods_done}")
    g = ring.geometry(cfg)
    if tuple(st.win.shape) != (cfg.n_nodes, g.ww) or \
            tuple(st.cold.shape) != (g.rw, cfg.n_nodes):
        raise AssertionError("state shapes changed")
    crashed = plan.crash_step <= periods_done
    dead_subj = torch.zeros(cfg.n_nodes, dtype=torch.bool, device="cuda")
    dead_subj |= st.gone_key < 0
    live_rows = (st.subject >= 0) & (st.rkey < 0)
    dead_subj[st.subject[live_rows].long()] = True
    false_dead = int((dead_subj & ~crashed).sum())
    n_dead = int(dead_subj.sum())
    # a suspicion takes suspicion_periods to confirm: only the
    # period-scope run is long enough for that
    if false_dead or (path == "period" and n_dead == 0):
        raise AssertionError(f"{path} path detection: {n_dead} declared "
                             f"dead, {false_dead} of them alive")
    if cfg.lifeguard and int(st.lha.max()) == 0:
        raise AssertionError("Lifeguard run: no health score left 0")
    emit(phase="throughput", path=path, n_nodes=cfg.n_nodes, periods=timed,
         seconds=wall, periods_per_sec=timed / wall, card=card,
         crashed=int(crashed.sum()), declared_dead=n_dead, false_dead=0,
         lha_max=int(st.lha.max()), launches=launches,
         launches_per_period=per_period)
    captured = capture_inputs(engine)
    for name, cnt in captured["calls"].items():
        if cnt != per_period[name]:
            raise AssertionError(f"{path} path, {name}: {cnt} calls in the "
                                 "captured period")
    return launches, captured


def selb_main(captured: dict, rows: dict) -> None:
    win, b = captured["selb"]
    err = require_equal("selb on the main path's input",
                        selb.select_first_b(win, b),
                        selb.select_first_b_plain(win, b))
    nbytes = 2 * win.numel() * 4
    bms, _ = bound(nbytes, win.numel() * 8)
    rows["selb"].update(max_abs_err=max(rows["selb"]["max_abs_err"], err),
                        ms_main=gpu_ms(lambda: selb.select_first_b(win, b)),
                        bytes_main=nbytes, bound_ms_main=bms)
    emit(phase="main_inputs", name="selb", shape=list(win.shape), b=b,
         **{k: rows["selb"][k] for k in ("ms_main", "bytes_main",
                                          "bound_ms_main")})


def wavemerge_on(captured: dict, what: str) -> dict:
    """The merge kernel on one captured call: bitwise against the plain
    version, its time, the bytes the call needs and their bound."""
    win, sel, oks, offs, bcol, bval = captured["wavemerge"]
    err = require_equal(
        f"wavemerge on {what}",
        wavemerge.merge_waves(win.clone(), sel, oks, offs, bcol, bval),
        wavemerge.merge_waves_plain(win.clone(), sel, oks, offs, bcol, bval))
    n, ww = win.shape
    # sel row j is read when some wave w delivers to receiver j - offs[w]
    needed = torch.zeros(n, dtype=torch.bool, device=win.device)
    for w in range(oks.shape[0]):
        needed |= torch.roll(oks[w], int(offs[w]))
    deliveries = int(oks.sum())
    nbytes = (2 * n * ww * 4 + oks.numel() + offs.numel() * 4
              + int(needed.sum()) * ww * 4 + bcol.numel() * 8)
    bms, _ = bound(nbytes, n * ww + 2 * deliveries * ww)
    out = win.clone()
    return dict(
        max_abs_err=err, shape=[n, ww], v=oks.shape[0], vb=bcol.shape[0],
        forced_bits=int((bval != 0).sum()),
        ms_main=gpu_ms(lambda: wavemerge.merge_waves(out, sel, oks, offs,
                                                     bcol, bval)),
        bytes_main=nbytes, bound_ms_main=bms,
        ok_density=oks.float().mean(dim=1).tolist())


def coldsel_on(args, what: str) -> dict:
    cold, fr, fv, qr = args
    c_k, s_k = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
    c_p, s_p = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
    err = max(require_equal(f"coldsel on {what}: cold", c_k, c_p),
              require_equal(f"coldsel on {what}: sel", s_k, s_p))
    prof = coldsel_profile(cold, fr, fv, qr)
    return dict(
        max_abs_err=err,
        ms_main=gpu_ms(lambda: coldsel.cold_update_select(cold, fr, fv, qr)),
        bytes_main=prof["bytes_sector"],
        bound_ms_main=prof["bound_ms_sector"],
        out_of_range=prof["out_of_range"], row0=prof["row0"],
        rows_per_32_columns=prof["rows_per_32_columns"])


def main_inputs_phase(captured: dict, rows: dict) -> None:
    """`captured`: path -> the period captured after its throughput run."""
    selb_main(captured["period"], rows)

    r = wavemerge_on(captured["period"], "the period-scope path's inputs")
    rows["wavemerge"].update(
        max_abs_err=max(rows["wavemerge"]["max_abs_err"], r["max_abs_err"]),
        **{k: r[k] for k in ("ms_main", "bytes_main", "bound_ms_main",
                             "ok_density")})
    emit(phase="main_inputs", name="wavemerge", path="period", **r)

    # wave scope: the first wave's one-wave merge, kernel against the plain
    # rolled OR (what the in-line delivery would cost in PyTorch ops)
    r = wavemerge_on(captured["wave"], "a wave-scope wave's inputs")
    if r["v"] != 1:
        raise AssertionError(f"wave scope merged {r['v']} waves at once")
    win, sel, oks, offs, bcol, bval = captured["wave"]["wavemerge"]
    out = win.clone()
    r["plain_ms_main"] = gpu_ms(
        lambda: wavemerge.merge_waves_plain(out, sel, oks, offs, bcol, bval),
        samples=5, inner=2)
    rows["wavemerge"]["max_abs_err"] = max(rows["wavemerge"]["max_abs_err"],
                                           r["max_abs_err"])
    rows["wavemerge"]["wave_scope"] = {
        k: r[k] for k in ("ms_main", "plain_ms_main", "bound_ms_main")}
    emit(phase="main_inputs", name="wavemerge", path="wave", **r)

    # Lifeguard: the fused merge takes the 1 + k buddy rows
    r = wavemerge_on(captured["lifeguard"], "the Lifeguard path's inputs")
    k = path_cfg("lifeguard").k_indirect
    if r["vb"] != 1 + k:
        raise AssertionError(f"Lifeguard merge got VB={r['vb']}, expected "
                             f"{1 + k}")
    rows["wavemerge"]["max_abs_err"] = max(rows["wavemerge"]["max_abs_err"],
                                           r["max_abs_err"])
    rows["wavemerge"]["lifeguard"] = {
        k_: r[k_] for k_ in ("vb", "ms_main", "bound_ms_main")}
    emit(phase="main_inputs", name="wavemerge", path="lifeguard", **r)

    quiet = coldsel_on(captured["period"]["coldsel"], "the quiet period")
    # a late period of a run whose plan crashes 5% of the nodes in its
    # first periods: as many rumours as the ring's window carries
    busy_args, used = coldsel_bench.captured_input(
        path_cfg("period"), **coldsel_bench.BUSY)
    busy = coldsel_on(busy_args, "the busy period")
    rows["coldsel"].update(
        max_abs_err=max(rows["coldsel"]["max_abs_err"],
                        quiet["max_abs_err"], busy["max_abs_err"]),
        **{k: quiet[k] for k in ("ms_main", "bytes_main", "bound_ms_main")},
        busy={k: busy[k] for k in ("ms_main", "bytes_main",
                                   "bound_ms_main")})
    emit(phase="main_inputs", name="coldsel", input="quiet", **quiet)
    emit(phase="main_inputs", name="coldsel", input="busy",
         crash_fraction=coldsel_bench.BUSY["fraction"],
         period=coldsel_bench.BUSY["periods"],
         slots_used=used, **busy)


# ------------------------------------------------------ slice 4 paths


def reset_launches() -> None:
    selb.launches = coldsel.launches = wavemerge.launches = 0


def read_launches() -> dict:
    return {"selb": selb.launches, "coldsel": coldsel.launches,
            "wavemerge": wavemerge.launches}


def program_plan(n: int):
    """Three segments over domains np.arange(n) % 4: gray 0.3 on domain
    1, link loss 0.2 flapping (3 of every 6 periods) on domain 2, send
    loss 0.05 on every node; 0.1% of the nodes crash."""
    prog = faults.as_program(crash_plan(SwimConfig(n_nodes=n),
                                        SLICE_PERIODS),
                             np.arange(n) % 4, capacity=3)
    prog = faults.with_segment(prog, 0, start=0, end=SLICE_PERIODS,
                               kind="gray", level=0.3, domain=1)
    prog = faults.with_segment(prog, 1, start=2, end=SLICE_PERIODS,
                               kind="link_loss", level=0.2, domain=2,
                               period=6, on=3)
    return faults.with_segment(prog, 2, start=0, end=SLICE_PERIODS,
                               kind="send_loss", level=0.05)


def slice_parity_phase(name: str, cfg, plan, want: dict) -> dict:
    """SLICE_PERIODS periods with the kernels (launches counted) and
    with the plain versions; every field equal; launches per period as
    `want` says."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    k = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, SLICE_PERIODS)
    torch.cuda.synchronize()
    launches = read_launches()
    p = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, SLICE_PERIODS,
                 plain=True)
    for f in ring.RingState._fields:
        if not torch.equal(getattr(k, f), getattr(p, f)):
            raise AssertionError(f"{name} path: field {f} differs between "
                                 "the kernels and the plain versions")
    per_period = {kn: c / SLICE_PERIODS for kn, c in launches.items()}
    if per_period != want:
        raise AssertionError(f"{name} path launches a period {per_period}, "
                             f"expected {want}")
    emit(phase="parity", path=name, n_nodes=cfg.n_nodes,
         periods=SLICE_PERIODS, fields_equal=len(ring.RingState._fields),
         launches=launches, launches_per_period=per_period,
         suspects=int((k.rkey & 1).sum()), inc_max=int(k.inc_self.max()),
         seconds=time.perf_counter() - t0)
    return launches


def no_sync_period(res, cfg, _state, plan, key) -> None:
    """One more study period after `res` (step, census, milestones) with
    PyTorch's sync check set to raise: the period queues its work
    without waiting for the card.  The randomness is drawn before."""
    rnd = ring.draw_period_ring(key, int(res.state.step), cfg)
    base = faults.base_of(plan)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.study_period(cfg, res.state, res.track, base, rnd,
                            runner.make_stepper(cfg, plan, ring.step))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


class Interrupted(Exception):
    """The deliberate in-process stop of the checkpointed study."""


def study_phase(card: str) -> None:
    kw = dict(n=N, crash_fraction=CRASH_FRACTION, periods=STUDY_PERIODS,
              seed=0, engine="ring")
    kept = {}
    real_stream = runner.run_study_ring_stream
    real_step = ring.step

    def keep_stream(*a, **k):
        res = real_stream(*a, **k)
        kept["stream"] = res
        kept["args"] = a
        return res

    calls = [0]

    def stopping_step(*a, **k):
        calls[0] += 1
        if calls[0] > 2 * STUDY_CHUNK:
            raise Interrupted
        return real_step(*a, **k)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        runner.run_study_ring_stream = keep_stream
        full = experiments.detection_study(stream=False, **kw)
        with PartTimer({"census": (ring, "live_knower_counts")}) as parts:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            chunked = experiments.detection_study(
                stream=True, chunk=STUDY_CHUNK, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        census_ms = parts.ms(STUDY_PERIODS)["census"]["device_ms"]
        ref = kept.pop("stream")
        ring.step = stopping_step
        try:
            experiments.detection_study(checkpoint_dir=str(CKPT_DIR),
                                        checkpoint_every=STUDY_CHUNK, **kw)
            raise AssertionError("the checkpointed study was not stopped")
        except Interrupted:
            pass
        ring.step = real_step
        snaps = sorted(p.name for p in CKPT_DIR.iterdir())
        resumed = experiments.detection_study(
            checkpoint_dir=str(CKPT_DIR), checkpoint_every=STUDY_CHUNK, **kw)
        again = kept.pop("stream")
    finally:
        runner.run_study_ring_stream = real_stream
        ring.step = real_step
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if calls[0] != 2 * STUDY_CHUNK + 1:
        raise AssertionError(f"stopped after {calls[0] - 1} periods")
    if launches != {"selb": STUDY_PERIODS, "coldsel": 0, "wavemerge": 0}:
        raise AssertionError(f"study launches {launches}: expected one "
                             "selb a period and nothing else")
    drop = {"stream"}
    for name, d in (("chunked", chunked), ("resumed", resumed)):
        if {k: v for k, v in d.items() if k not in drop} != \
                {k: v for k, v in full.items() if k not in drop}:
            raise AssertionError(f"{name} study summary differs from the "
                                 f"full-track one: {d} != {full}")
    for part in ("track", "series"):
        a, b = getattr(ref, part), getattr(again, part)
        for f in a._fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"resumed study: {part}.{f} differs")
    if full["crashed"] == 0 or full.get("suspect_detected", 0) == 0:
        raise AssertionError(f"the study detected nothing: {full}")
    no_sync_period(ref, *kept["args"][:4])
    law = analyze.detection_law(ref.track.crash_step.cpu().numpy(),
                                ref.track.first_suspect.cpu().numpy(), N,
                                "pull")
    emit(phase="study", study="detection", n_nodes=N,
         periods=STUDY_PERIODS, ring_probe=full["ring_probe"],
         host_syncs_in_a_period=0,
         runners=["full", f"stream chunk={STUDY_CHUNK}",
                  f"stream resumed at {2 * STUDY_CHUNK}"],
         snapshots=snaps, summaries_equal=True, launches=launches,
         track_series_bitwise=True,
         **{k: full.get(k) for k in ("crashed", "suspect_detected",
                                     "suspect_latency_mean",
                                     "dead_view_detected",
                                     "false_dead_views_final", "overflow")},
         mean_vs_law=law.get("mean_vs_law"),
         expected_mean=law["expected_mean"],
         study_periods_per_sec=STUDY_PERIODS / wall,
         census_ms_per_period=census_ms,
         census_share_of_wall=census_ms * STUDY_PERIODS / 1e3 / wall,
         card=card)
    t0 = time.perf_counter()
    ab = experiments.lifeguard_ablation(n=N, crash_fraction=CRASH_FRACTION,
                                        periods=20, seed=0, engine="ring")
    for arm in ab["arms"].values():
        if arm["crashed"] == 0:
            raise AssertionError(f"Lifeguard ablation arm crashed none: "
                                 f"{ab}")
    emit(phase="study", study="lifeguard_ablation", n_nodes=N, periods=20,
         loss=ab["loss"], arms=ab["arms"],
         seconds=time.perf_counter() - t0, card=card)


# --------------------------------------------------- slice 5: engines

# case -> (engine, nodes, config options, periods); at 100,000 nodes the
# rumor engine's row-chunked reductions span two ROW_CHUNKs, and
# Lifeguard's buddy witness over the N * k messages of wave 4 five
ENGINE_PARITY = {"dense": ("dense", 2048, {}, 5),
                 "rumor": ("rumor", 100_000, {}, 5),
                 "rumor_lifeguard": ("rumor", 100_000, {"lifeguard": True},
                                     4)}
ENGINES = {"dense": (dense, dense.DenseState, prng.draw_period),
           "rumor": (rumor, rumor.RumorState, rumor.draw_period_rumor)}


def engine_golden_phase() -> None:
    for name, want in golden.ENGINE_DIGESTS.items():
        got = golden.digest(golden.engine_run("cuda", name))
        if got != want:
            raise AssertionError(f"engine digest '{name}' on the card {got} "
                                 f"!= {want}")
        emit(phase="engines", part="golden", config=name, digest=got,
             n_nodes=golden.ENGINE_N[name], periods=golden.GOLDEN_PERIODS)


def _to_cpu(nt):
    return type(nt)(*(_to_cpu(x) if isinstance(x, tuple) else x.cpu()
                      for x in nt))


def _leaves(nt) -> list:
    return [y for x in nt for y in (_leaves(x) if isinstance(x, tuple)
                                    else [x])]


def engine_parity_phase(case: str) -> None:
    """The engine on the card and on the CPU from the same state and the
    same draws (drawn on the card, copied over), both with the telemetry
    tap, and on the card also without it: every field of the three
    states equal, and the card's frame equal to the CPU's, after every
    period."""
    name, n, opts, p = ENGINE_PARITY[case]
    mod, cls, draw = ENGINES[name]
    cfg = SwimConfig(n_nodes=n, **opts)

    def plan(dev):
        return faults.with_loss(faults.with_random_crashes(
            faults.none(n, dev), threefry.key(1), 0.01, 0, p), 0.1)

    plan_c, plan_h = plan("cuda"), plan("cpu")
    st_c, st_h = mod.init_state(cfg, "cuda"), mod.init_state(cfg, "cpu")
    key = threefry.key(0)
    t0 = time.perf_counter()
    frames = []
    for t in range(p):
        rnd = draw(key, t, cfg, "cuda")
        tap_c, tap_h = {}, {}
        untapped = mod.step(cfg, st_c, plan_c, rnd)
        st_c = mod.step(cfg, st_c, plan_c, rnd, tap=tap_c)
        st_h = mod.step(cfg, st_h, plan_h, _to_cpu(rnd), tap=tap_h)
        for f in cls._fields:
            if not torch.equal(getattr(st_c, f), getattr(untapped, f)):
                raise AssertionError(f"{name} engine, period {t}: field {f} "
                                     "differs with the tap on the card")
            if not torch.equal(getattr(st_c, f).cpu(), getattr(st_h, f)):
                raise AssertionError(f"{name} engine, period {t}: field {f} "
                                     "differs between the card and the CPU")
        frame = [int(x) for x in obs_engine.frame_from_tap(tap_c, "cuda")]
        if frame != [int(x) for x in obs_engine.frame_from_tap(tap_h, "cpu")]:
            raise AssertionError(f"{name} engine, period {t}: the frame "
                                 "differs between the card and the CPU")
        frames.append(frame)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(
            _leaves(draw(key, p, cfg, "cuda")),
            _leaves(draw(key, p, cfg, "cpu")))):
        raise AssertionError(f"{name} draws differ between card and CPU")
    emit(phase="engines", part="card_vs_cpu", case=case, engine=name,
         n_nodes=n, periods=p, options=opts, fields_equal=len(cls._fields),
         frame_fields_equal=len(obs_engine.EngineFrame._fields),
         last_frame=dict(zip(obs_engine.EngineFrame._fields, frames[-1])),
         seconds=time.perf_counter() - t0)


def busy_ms(prof) -> tuple[float, int]:
    """(device ms, count) of the device activities (kernels, copies,
    fills) a profile saw, read from its raw events: `key_averages`
    takes minutes over the million events of a sweep."""
    cuda_type = torch.autograd.DeviceType.CUDA
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda_type]
    return sum(ns) / 1e6, len(ns)


def timed_study(label: str, periods: int, fn, card: str) -> dict:
    """Run `fn` twice: first bare, for the wall time and periods/sec,
    then under torch.profiler (CUDA activity only) for the device busy
    time, which is set against the bare wall (the profiler adds host time
    to every launch: `wall_ms_profiled`).  Both runs must give the same
    result.  Launch counts are zeroed before the first run and read after
    the second; peak memory from a reset of PyTorch's peak counter (it
    includes what earlier phases still hold: `allocated_before`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    launches = read_launches()
    if json.dumps(out, sort_keys=True, default=str) != \
            json.dumps(again, sort_keys=True, default=str):
        raise AssertionError(f"{label}: the profiled run gave another "
                             f"result: {out} != {again}")
    busy, kernels = busy_ms(prof)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        raise AssertionError(f"{label}: peak memory {peak} >= {total}")
    if any(launches.values()):
        raise AssertionError(f"{label}: launched the ring kernels "
                             f"{launches}")
    row = dict(phase="engines", part="study", run=label, periods=periods,
               periods_per_sec=periods / wall, wall_ms=wall * 1e3,
               device_busy_ms=busy, idle_share=1.0 - busy / (wall * 1e3),
               wall_ms_profiled=wall_prof * 1e3,
               kernels_per_period=kernels / periods,
               max_memory_allocated=peak, allocated_before=before,
               card_memory=total, launches=launches, card=card)
    return out, row


def dense_8192_run():
    """DENSE_MAX nodes, 1% crashing in periods 0-5, no loss, 10 periods."""
    cfg = SwimConfig(n_nodes=experiments.DENSE_MAX)
    plan = crash_plan(cfg, 5, 0.01)
    eng = dense.DenseEngine(cfg, plan, seed=0)
    st = eng.run(10)
    crashed = plan.crash_step <= 9
    live = ~crashed
    key = st.key
    seen = ((lattice.is_suspect(key) | lattice.is_dead(key))
            & live[:, None]).any(dim=0)
    false_dead = ((key < 0) & live[:, None] & live[None, :]).sum()
    return dict(crashed=int(crashed.sum()),
                suspected=int((seen & crashed).sum()),
                false_dead_views=int(false_dead), step=int(st.step))


def engine_no_sync_period(name: str, n: int, telemetry: bool = False
                          ) -> None:
    """Two study periods of the engine, then one more with PyTorch's sync
    check set to raise (the draws made before); with the tap when
    `telemetry`."""
    mod, _, draw = ENGINES[name]
    cfg = SwimConfig(n_nodes=n, telemetry=telemetry)
    plan = crash_plan(cfg, 3, 0.01)
    key = threefry.key(0)
    if name == "dense":
        res = runner.run_study(cfg, dense.init_state(cfg, "cuda"), plan, key,
                               2)
        period = runner.dense_study_period
    else:
        res = runner.run_study_rumor(cfg, rumor.init_state(cfg, "cuda"), plan,
                                     key, 2)
        period = runner.rumor_study_period
    rnd = draw(key, 2, cfg, "cuda")
    base = faults.base_of(plan)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        period(cfg, res.state, res.track, base, rnd,
               runner.make_stepper(cfg, plan, mod.step))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit(phase="telemetry" if telemetry else "engines", part="no_sync",
         engine=name, n_nodes=n, telemetry=telemetry,
         host_syncs_in_a_period=0)


def engines_phase(card: str) -> dict:
    """Phase 10; returns the ring kernels' launches on the dense and the
    rumor runs (both 0)."""
    engine_golden_phase()
    for case in ENGINE_PARITY:
        engine_parity_phase(case)
    launches = {"dense": {}, "rumor": {}}

    def add(engine, row):
        for kn, c in row["launches"].items():
            launches[engine][kn] = launches[engine].get(kn, 0) + c

    det, row = timed_study("detection_study()", 100,
                           experiments.detection_study, card)
    if det["engine"] != "dense" or det["n"] != 1000:
        raise AssertionError(f"detection_study() ran {det['engine']}")
    if det["crashed"] == 0 or det["suspect_detected"] == 0 \
            or det["false_dead_views_peak"] != 0:
        raise AssertionError(f"detection_study() without loss: {det}")
    row.update(n_nodes=1000, engine="dense",
               **{k: det[k] for k in ("crashed", "suspect_detected",
                                      "suspect_latency_mean",
                                      "dead_view_detected",
                                      "false_dead_views_peak")})
    add("dense", row)
    emit(**row)

    d8, row = timed_study("DenseEngine(8192).run(10)", 10, dense_8192_run,
                          card)
    if d8["suspected"] == 0 or d8["false_dead_views"] != 0:
        raise AssertionError(f"dense 8192 without loss: {d8}")
    row.update(n_nodes=experiments.DENSE_MAX, engine="dense", **d8)
    add("dense", row)
    emit(**row)

    fp, row = timed_study("fp_sweep()", 400, experiments.fp_sweep, card)
    if fp["engine"] != "rumor" or len(fp["points"]) != 4 or \
            fp["points"][-1]["suspect_views_peak"] == 0:
        raise AssertionError(f"fp_sweep(): {fp}")
    row.update(n_nodes=fp["n"], engine=fp["engine"], points=fp["points"])
    add("rumor", row)
    emit(**row)

    ss, row = timed_study(
        "suspicion_sweep(n=1_000_000, mults=(2.0, 5.0), periods=20)", 40,
        lambda: experiments.suspicion_sweep(n=N, mults=(2.0, 5.0),
                                            periods=20), card)
    if ss["engine"] != "rumor" or any(pt["crashed"] == 0
                                      for pt in ss["points"]):
        raise AssertionError(f"suspicion_sweep: {ss}")
    row.update(n_nodes=N, engine=ss["engine"], points=ss["points"])
    add("rumor", row)
    emit(**row)

    lg, row = timed_study(
        "lifeguard_ablation(n=1_000_000, periods=10)", 20,
        lambda: experiments.lifeguard_ablation(n=N, periods=10), card)
    if lg["engine"] != "rumor" or any(a["crashed"] == 0
                                      for a in lg["arms"].values()):
        raise AssertionError(f"lifeguard_ablation: {lg}")
    row.update(n_nodes=N, engine=lg["engine"], arms=lg["arms"])
    add("rumor", row)
    emit(**row)

    engine_no_sync_period("dense", 1000)
    engine_no_sync_period("rumor", 100_000)
    return launches


# ------------------------------------------------- slice 6: telemetry

TAP_PERIODS = 20        # recorded_ring_run, the batches, the tap costs
TAP_PAIRS = 3           # alternating tap-off / tap-on timed runs
BATCH_RUMOR_N = 100_000  # the rumor batch at config 3's size
TELEMETRY_DIR = Path(__file__).resolve().parent / "_telemetry"


def tap_cost(label: str, periods: int, run_off, run_on, card: str) -> dict:
    """Wall ms a period of `run_off()` and `run_on()` (each does
    `periods` periods from the same start) in TAP_PAIRS alternating
    pairs, then the device busy ms a period of one more run of each under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    walls = {"off": [], "on": []}
    for _ in range(TAP_PAIRS):
        for which, fn in (("off", run_off), ("on", run_on)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) * 1e3 / periods)
    busy = {}
    for which, fn in (("off", run_off), ("on", run_on)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ms, kernels = busy_ms(prof)
        busy[which] = dict(busy_ms=ms / periods,
                           kernels_per_period=kernels / periods)
    row = dict(phase="telemetry", part="tap_cost", run=label,
               periods=periods, wall_ms_off=walls["off"],
               wall_ms_on=walls["on"],
               periods_per_sec_off=[1e3 / w for w in walls["off"]],
               periods_per_sec_on=[1e3 / w for w in walls["on"]],
               busy_ms_off=busy["off"]["busy_ms"],
               busy_ms_on=busy["on"]["busy_ms"],
               kernels_off=busy["off"]["kernels_per_period"],
               kernels_on=busy["on"]["kernels_per_period"], card=card)
    emit(**row)
    return row


def require_same(what: str, a, b) -> int:
    """Every leaf of two NamedTuple trees of tensors equal; the count."""
    pairs = []
    tree_map(lambda x, y: pairs.append(torch.equal(x, y)), a, b)
    if not pairs or not all(pairs):
        raise AssertionError(f"{what}: leaf {pairs.index(False)} differs")
    return len(pairs)


def recorded_run_phase(card: str) -> dict:
    """recorded_ring_run at 1M in wave scope: kernels against plain
    versions, launches, the tap-off run's state, the tap's cost."""
    cfg = path_cfg("wave")
    plan = crash_plan(cfg, TAP_PERIODS)
    key = threefry.key(0)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    rec = obs_engine.recorded_ring_run(cfg, ring.init_state(cfg, "cuda"),
                                       plan, key, TAP_PERIODS)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: TAP_PERIODS * v for k, v in expected_launches(cfg).items()}
    if launches != want:
        raise AssertionError(f"recorded_ring_run launches {launches}, "
                             f"expected {want}")
    plain = obs_engine.recorded_ring_run(cfg, ring.init_state(cfg, "cuda"),
                                         plan, key, TAP_PERIODS, plain=True)
    fields = require_same("recorded_ring_run, kernels against plain", rec,
                          plain)
    off = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, TAP_PERIODS)
    require_same("recorded_ring_run against a tap-off ring.run", rec.state,
                 off)
    fr = rec.frames
    if int(fr.waves_delivered.min()) == 0 or \
            int(fr.sel_slots_selected.max()) == 0:
        raise AssertionError(f"recorded_ring_run frames are empty: {fr}")
    emit(phase="telemetry", part="recorded_ring_run", path="wave",
         n_nodes=N, periods=TAP_PERIODS, leaves_equal=fields,
         launches=launches,
         launches_per_period={k: v / TAP_PERIODS for k, v in
                              launches.items()},
         frames_sum={f: int(getattr(fr, f).sum()) for f in fr._fields},
         frames_last={f: int(getattr(fr, f)[-1]) for f in fr._fields},
         seconds=time.perf_counter() - t0, card=card)
    init = ring.init_state(cfg, "cuda")

    def fresh():
        return init._replace(cold=init.cold.clone())

    tap_cost("ring wave recorded_ring_run", TAP_PERIODS,
             lambda: ring.run(cfg, fresh(), plan, 0, TAP_PERIODS),
             lambda: obs_engine.recorded_ring_run(cfg, fresh(), plan, key,
                                                  TAP_PERIODS), card)
    return launches


def telemetry_study_phase(card: str) -> None:
    """The 1M pull detection study with telemetry and a dump, by both
    runners (byte-equal dumps that hold every period's frame); the dump
    analysed; a telemetry study period without a host sync; the tap's
    cost on 20 study periods."""
    kw = dict(n=N, crash_fraction=CRASH_FRACTION, periods=STUDY_PERIODS,
              seed=0, engine="ring", telemetry=True)
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    TELEMETRY_DIR.mkdir()
    t0 = time.perf_counter()
    try:
        dumps = {w: str(TELEMETRY_DIR / f"{w}.jsonl")
                 for w in ("full", "stream")}
        full = experiments.detection_study(stream=False,
                                           flight_record=dumps["full"], **kw)
        chunked = experiments.detection_study(
            stream=True, chunk=STUDY_CHUNK, flight_record=dumps["stream"],
            **kw)
        reports = {w: analyze.analyze(p) for w, p in dumps.items()}
        same_dump = (Path(dumps["full"]).read_bytes()
                     == Path(dumps["stream"]).read_bytes())
    finally:
        shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    drop = {"stream", "flight_record"}
    if {k: v for k, v in full.items() if k not in drop} != \
            {k: v for k, v in chunked.items() if k not in drop}:
        raise AssertionError(f"telemetry study summaries differ: {full} != "
                             f"{chunked}")
    if not same_dump or reports["full"] != reports["stream"]:
        raise AssertionError("the two runners' dumps differ")
    if reports["full"]["periods"] != STUDY_PERIODS:
        raise AssertionError(f"the dump holds {reports['full']['periods']} "
                             f"frames, not {STUDY_PERIODS}")
    det = reports["full"]["detection"]
    if det["crashed"] == 0 or any(full[k] != v for k, v in det.items()):
        raise AssertionError(f"the dump's detection summary {det} is not "
                             f"the study's")
    errors = analyze.error_findings(reports["full"])
    scfg = SwimConfig(n_nodes=N, ring_probe="pull")
    tcfg = SwimConfig(n_nodes=N, ring_probe="pull", telemetry=True)
    plan = experiments._crash_plan(N, 0, CRASH_FRACTION, STUDY_PERIODS,
                                   "cuda")
    key = threefry.key(0)
    init = ring.init_state(scfg, "cuda")

    def study(c):
        st = init._replace(cold=init.cold.clone())
        return runner.run_study_ring_stream(c, st, plan, key, TAP_PERIODS)

    no_sync_period(study(tcfg), tcfg, None, plan, key)
    emit(phase="telemetry", part="study", study="detection", n_nodes=N,
         periods=STUDY_PERIODS, ring_probe=full["ring_probe"],
         runners=["full", f"stream chunk={STUDY_CHUNK}"],
         summaries_equal=True, dumps_identical=True,
         frames_in_dump=reports["full"]["periods"],
         dump_reproduces_detection=True, host_syncs_in_a_period=0,
         telemetry=full["telemetry"], health=full["health"],
         error_findings=errors, report_health=reports["full"]["health"],
         seconds=wall, card=card)
    print(analyze.render_report(reports["full"], title="telemetry study"),
          flush=True)
    tap_cost("ring pull study (streaming)", TAP_PERIODS,
             lambda: study(scfg), lambda: study(tcfg), card)


def engine_study_phase(name: str, n: int, card: str) -> None:
    """`detection_study(n, telemetry=True)` on its default engine with a
    dump: the study's summary equals the tap-off study's, and the dump
    alone reproduces its detection summary."""
    TELEMETRY_DIR.mkdir(exist_ok=True)
    path = str(TELEMETRY_DIR / f"{name}.jsonl")
    t0 = time.perf_counter()
    try:
        on = experiments.detection_study(n=n, telemetry=True,
                                         flight_record=path)
        report = analyze.analyze(path)
    finally:
        shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    wall = time.perf_counter() - t0
    off = experiments.detection_study(n=n)
    if on["engine"] != name:
        raise AssertionError(f"detection_study(n={n}) ran {on['engine']}")
    added = {"telemetry", "health", "flight_record"}
    if {k: v for k, v in on.items() if k not in added} != off:
        raise AssertionError(f"{name} study with telemetry {on} differs "
                             f"from the study without it {off}")
    if on["telemetry"]["waves_delivered_sum"] == 0:
        raise AssertionError(f"{name} study frames are empty: {on}")
    det = report["detection"]
    if det["crashed"] == 0 or any(on[k] != v for k, v in det.items()):
        raise AssertionError(f"the {name} dump's detection summary {det} "
                             f"is not the study's")
    emit(phase="telemetry", part="engine_study", study="detection",
         engine=name, n_nodes=n, periods=on["periods"],
         summary_equals_tap_off=True, dump_reproduces_detection=True,
         frames_in_dump=report["periods"], telemetry=on["telemetry"],
         health=on["health"], error_findings=analyze.error_findings(report),
         seconds=wall, card=card)


def engine_loop(name: str, cfg, plan, periods: int, tap: bool):
    """`periods` periods of the dense or rumor engine from a fresh state,
    with the tap when `tap` (frames stacked at the end)."""
    mod, _, draw = ENGINES[name]
    st = mod.init_state(cfg, "cuda")
    key = threefry.key(0)
    frames = []
    for t in range(periods):
        taps = {} if tap else None
        st = mod.step(cfg, st, plan, draw(key, t, cfg, "cuda"), tap=taps)
        if tap:
            frames.append(obs_engine.frame_from_tap(taps, "cuda"))
    return st, (obs_engine.stack_frames(frames) if tap else None)


def engine_tap_phase(name: str, n: int, periods: int, card: str) -> None:
    """The dense or rumor engine with and without its tap: equal states,
    frames that saw deliveries, and the tap's cost."""
    cfg = SwimConfig(n_nodes=n)
    tcfg = SwimConfig(n_nodes=n, telemetry=True)
    plan = crash_plan(cfg, 5, 0.01)
    st, frames = engine_loop(name, tcfg, plan, periods, True)
    off, _ = engine_loop(name, cfg, plan, periods, False)
    require_same(f"{name} tap state", st, off)
    if int(frames.waves_delivered.min()) == 0:
        raise AssertionError(f"{name} tap: no deliveries {frames}")
    del st, off
    tap_cost(f"{name} {n}", periods,
             lambda: engine_loop(name, cfg, plan, periods, False),
             lambda: engine_loop(name, tcfg, plan, periods, True), card)


def batch_phase(name: str, engine: str, n: int, periods: int, progs,
                card: str) -> dict:
    """`_run_study_batch` with telemetry on: every lane against its
    serial run on the card, launches P times the serial ones, peak
    memory."""
    cfg = SwimConfig(n_nodes=n, telemetry=True)
    keys = [threefry.key(20 + p) for p in range(len(progs))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    batched = experiments._run_study_batch(cfg, progs, keys, periods, engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    serial_launches = {}
    leaves = 0
    for p, prog in enumerate(progs):
        reset_launches()
        serial = experiments._run_study(cfg, prog, keys[p], periods, engine,
                                        torch.device("cuda"))
        for k, v in read_launches().items():
            serial_launches[k] = serial_launches.get(k, 0) + v
        leaves = require_same(f"{name} batch lane {p}",
                              runner.lane_result(batched, p), serial)
    if launches != serial_launches:
        raise AssertionError(f"{name} batch launches {launches}, serial "
                             f"lanes {serial_launches}")
    series = batched.series
    emit(phase="telemetry", part="batch", run=name, engine=engine,
         n_nodes=n, lanes=len(progs), periods=periods,
         segments=[int(p.seg_kind.shape[0]) for p in progs],
         leaves_equal_per_lane=leaves, launches=launches,
         launches_serial=serial_launches,
         suspect_views_peak=[int(x) for x in series.suspect_views.max(1)
                             .values],
         waves_delivered_sum=[int(x) for x in
                              batched.telemetry.waves_delivered.sum(1)],
         wall_ms=wall * 1e3, max_memory_allocated=peak,
         allocated_before=before, card=card)
    return launches


def telemetry_phase(card: str) -> dict:
    """Phase 11; returns the ring kernels' launches in the recorded run
    and in the ring batch."""
    t0 = time.perf_counter()
    launches = {"telemetry": recorded_run_phase(card)}
    telemetry_study_phase(card)
    engine_study_phase("dense", 1000, card)
    engine_study_phase("rumor", BATCH_RUMOR_N, card)
    engine_no_sync_period("dense", 1000, telemetry=True)
    engine_no_sync_period("rumor", BATCH_RUMOR_N, telemetry=True)
    engine_tap_phase("dense", experiments.DENSE_MAX, 10, card)
    engine_tap_phase("rumor", N, 10, card)
    prog = program_plan(N)
    gray = prog._replace(seg_level=prog.seg_level.clone())
    gray.seg_level[0] = faults.level_to_threshold(0.6)
    empty = faults.as_program(crash_plan(SwimConfig(n_nodes=N),
                                         SLICE_PERIODS))
    launches["batch"] = batch_phase("ring 1M", "ring", N, TAP_PERIODS,
                                    [prog, gray, empty], card)
    n_r = BATCH_RUMOR_N
    launches["batch_rumor"] = batch_phase(
        "rumor 100k", "rumor", n_r, 10,
        [program_plan(n_r), faults.as_program(crash_plan(
            SwimConfig(n_nodes=n_r), 10))], card)
    emit(phase="telemetry", part="done", seconds=time.perf_counter() - t0,
         card=card)
    return launches


# ------------------------------------------------ slice 7: scenarios


SCENARIO_DIR = Path(__file__).resolve().parent / "_scenarios"
LIB_RING = ("rack_outage", "flap", "flap_boundary", "gray_10pct")
LIB_CPU = LIB_RING + ("lean_fidelity",)  # card verdict == the port's CPU's
PACKED_PERIODS = 20
PACKED_PAIRS = 3


def verdict_text(path: str, out_dir: Path) -> str:
    with open(path) as fh:
        return fh.read().replace(str(out_dir), "OUT")


def run_scenario(sc, mode: str, device: str, batch: bool):
    """One scenario run into its own directory: (verdict, normalised
    verdict text, wall seconds, kernel launches)."""
    out = SCENARIO_DIR / f"{sc.name}_{mode}"
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    verdict, path = scenario.run(sc, out_dir=str(out), batch=batch,
                                 device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return verdict, verdict_text(path, out), wall, read_launches()


def library_phase(card: str) -> dict:
    """The library at its own sizes, serial and batched on the card (and
    on the CPU for the 256-node ring specs and lean_fidelity): equal
    verdict bytes; a packed ring arm with a program launches selb,
    wavemerge and coldsel once a period; replay_storm raises.  Returns
    the kernels' launches over the ring specs' serial card runs."""
    total = {"selb": 0, "coldsel": 0, "wavemerge": 0}
    for name in LIB_RING + ("baseline_config3", "lean_fidelity"):
        sc = scenario.get(name)
        verdict, text, wall, launches = run_scenario(sc, "card", "cuda",
                                                     False)
        _, text_b, wall_b, launches_b = run_scenario(sc, "batch", "cuda",
                                                     True)
        if text_b != text:
            raise AssertionError(f"{name}: batched verdict differs from "
                                 "the serial one on the card")
        if launches_b != launches:
            raise AssertionError(f"{name}: batched launches {launches_b}, "
                                 f"serial {launches}")
        row = dict(phase="scenario", part="library", name=name,
                   n_nodes=sc.n, periods=sc.periods,
                   arms=list(verdict["arms"]), verdict=verdict["verdict"],
                   checks=[[c["check"], c.get("arm"), c["ok"]]
                           for c in verdict["checks"]],
                   wall_s=wall, wall_s_batch=wall_b, launches=launches)
        if name in LIB_CPU:
            _, text_c, wall_c, _ = run_scenario(sc, "cpu", "cpu", False)
            if text_c != text:
                raise AssertionError(f"{name}: the card's verdict differs "
                                     "from the CPU's")
            row["wall_s_cpu"] = wall_c
        ring_periods = sc.periods * len(verdict["arms"])
        if name in LIB_RING:
            want = {k: ring_periods for k in total}
            bill = {a: v["ici"] for a, v in verdict["arms"].items()
                    if "ici" in v}
            row["ici"] = bill
            for k, v in launches.items():
                total[k] += v
        elif name == "lean_fidelity":
            want = {"selb": sc.periods, "coldsel": 0, "wavemerge": 0}
        else:
            want = {k: 0 for k in total}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        row["launches_per_ring_period"] = {
            k: v / ring_periods for k, v in launches.items()}
        row["card"] = card
        emit(**row)
    # the real-node arm (host Python: a SimCluster of core/node.py nodes)
    sc = scenario.get("replay_storm")
    verdict, text, wall, launches = run_scenario(sc, "card", "cuda", False)
    digest = hashlib.sha256(text.encode()).hexdigest()
    if verdict["verdict"] != "pass" or \
            digest != golden.GOLDEN_DIGEST_REPLAY_STORM:
        raise AssertionError(f"replay_storm: verdict {verdict['verdict']}, "
                             f"digest {digest}")
    real = verdict["arms"]["real"]
    emit(phase="scenario", part="library", name=sc.name, n_nodes=sc.n,
         verdict=verdict["verdict"],
         checks=[[c["check"], c.get("arm"), c["ok"]]
                 for c in verdict["checks"]],
         network=real["network"], digest=digest, wall_s=wall,
         launches=launches, card=card)
    return total


def packed_phase(card: str) -> dict:
    """gray_10pct's program and Lifeguard arm at 1,000,000 nodes: the
    packed wire with the kernels, with the plain versions and the wide
    wire with the kernels give equal state; periods/sec packed and wide
    in alternating runs; the bill's bytes on both wires."""
    sc = dataclasses.replace(scenario.get("gray_10pct"), n=N,
                             periods=PACKED_PERIODS)
    _, cfg, prog = scenario._arm_prepare(sc, {}, "cuda")
    wide = cfg.replace(ring_scalar_wire="wide")
    t0 = time.perf_counter()

    def run(c, plain=False):
        return ring.run(c, ring.init_state(c, "cuda"), prog, sc.seed,
                        PACKED_PERIODS, plain=plain)

    torch.cuda.synchronize()
    reset_launches()
    k = run(cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    fields = require_same("packed 1M: kernels vs plain", k, run(cfg, True))
    require_same("packed 1M: packed vs wide wire", k, run(wide))
    if launches != {x: PACKED_PERIODS for x in launches}:
        raise AssertionError(f"packed 1M launches {launches}")
    gray = int((faults.link_lanes(prog, 10)[2] > 0).sum())
    pps = {"packed": [], "wide": []}
    for _ in range(PACKED_PAIRS):
        for name, c in (("packed", cfg), ("wide", wide)):
            st = ring.init_state(c, "cuda")
            torch.cuda.synchronize()
            a = time.perf_counter()
            ring.run(c, st, prog, sc.seed, PACKED_PERIODS)
            torch.cuda.synchronize()
            pps[name].append(PACKED_PERIODS / (time.perf_counter() - a))
    bills = {name: ici.trace_ici_bytes(c, d=8, plan=prog)
             for name, c in (("packed", cfg), ("wide", wide))}
    emit(phase="scenario", part="packed_1m", n_nodes=N,
         periods=PACKED_PERIODS, gray_nodes=gray, fields_equal=fields,
         launches=launches, suspects=int((k.rkey & 1).sum()),
         lha_max=int(k.lha.max()), periods_per_sec=pps, bill_d8=bills,
         seconds=time.perf_counter() - t0, card=card)
    return launches


def search_phase(card: str) -> None:
    """search.search() at its defaults, once: the report's sha256 equal
    to golden.GOLDEN_DIGEST_SEARCH (both packages' report on the CPU);
    wall, wall per generation, the boundary."""
    path = SCENARIO_DIR / "search.json"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = search.search(out=str(path))
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    sha = hashlib.sha256(path.read_bytes()).hexdigest()
    if sha != golden.GOLDEN_DIGEST_SEARCH:
        raise AssertionError(f"search: report sha256 {sha} != "
                             f"golden.GOLDEN_DIGEST_SEARCH")
    gens = rep["explore"]["generations"] + len(rep["boundary"]["history"])
    b = rep["boundary"]
    emit(phase="scenario", part="search", sha256=sha, generations=gens,
         pop=rep["explore"]["pop"], lanes=gens * rep["explore"]["pop"],
         wall_s=walls, wall_s_per_generation=[w / gens for w in walls],
         archive=len(rep["explore"]["archive"]),
         violations=len(rep["explore"]["violations"]),
         boundary={k: b.get(k) for k in ("found", "clean_level",
                                          "violation_level", "width")},
         card=card)


def scenario_phase(card: str) -> dict:
    """Phase 12 but its search (`search_phase`, a `Background` job);
    returns the kernels' launches in the library's ring specs and in the
    1M packed run."""
    t0 = time.perf_counter()
    SCENARIO_DIR.mkdir(exist_ok=True)
    launches = {"scenario": library_phase(card),
                "packed": packed_phase(card)}
    emit(phase="scenario", part="done", seconds=time.perf_counter() - t0,
         card=card)
    return launches


# ------------------------------------------------------- phase 13: serve

SERVE_PARITY_N = 100_000
SERVE_PARITY_PERIODS = 20
SERVE_PLAIN_PERIODS = 3
SERVE_TIMED_PERIODS = 20


def serve_launches(what: str, launches: dict, periods: int) -> None:
    per = {k: v / periods for k, v in launches.items()}
    if per != {"selb": 1.0, "coldsel": 1.0, "wavemerge": 1.0}:
        raise AssertionError(f"serve {what}: launches a period {per}, "
                             "expected selb 1, coldsel 1, wavemerge 1")


def serve_digests(card: list, want: list, what: str) -> None:
    for t, (a, b) in enumerate(zip(card, want)):
        if a != b:
            raise AssertionError(f"serve {what}: state digests differ "
                                 f"after period {t}")
    if len(card) != len(want):
        raise AssertionError(f"serve {what}: {len(card)} != {len(want)} "
                             "periods")


def serve_parity_phase() -> dict:
    """(a) the golden digest, (b) card against CPU at 100,000 nodes with
    launches counted, (c) card against the CPU hub (the plain versions)
    at 1M."""
    got = golden.golden_serve("cuda")
    if got[-1] != golden.GOLDEN_DIGEST_SERVE:
        raise AssertionError(f"golden serve digest on the card {got[-1]} "
                             f"!= {golden.GOLDEN_DIGEST_SERVE}")
    emit(phase="serve", part="golden", digest=got[-1],
         n_nodes=golden.SERVE_N, periods=golden.SERVE_PERIODS)

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    card = golden.golden_serve("cuda", n=SERVE_PARITY_N,
                               periods=SERVE_PARITY_PERIODS)
    launches = read_launches()
    serve_launches("card against CPU", launches, SERVE_PARITY_PERIODS)
    cpu = golden.golden_serve("cpu", n=SERVE_PARITY_N,
                              periods=SERVE_PARITY_PERIODS)
    serve_digests(card, cpu, "card against CPU")
    emit(phase="serve", part="card_vs_cpu", n_nodes=SERVE_PARITY_N,
         periods=SERVE_PARITY_PERIODS, digests_equal=len(card),
         launches=launches, seconds=time.perf_counter() - t0)

    # 1M: the card hub against the CPU hub (the plain versions) on the
    # same scripted sessions and datagrams
    t0 = time.perf_counter()
    card = golden.golden_serve("cuda", n=N, periods=SERVE_PLAIN_PERIODS)
    cpu = golden.golden_serve("cpu", n=N, periods=SERVE_PLAIN_PERIODS)
    serve_digests(card, cpu, "card against the CPU's plain versions at 1M")
    emit(phase="serve", part="plain_1m", n_nodes=N,
         periods=SERVE_PLAIN_PERIODS, digests_equal=len(card),
         seconds=time.perf_counter() - t0)
    return launches


class _HubRunner:
    """`capture_inputs` steps an engine with `run(1)`: a hub period."""

    def __init__(self, hub):
        self.hub = hub

    def run(self, periods: int) -> None:
        self.hub.step_periods(periods)


def serve_hub_1m():
    """A 1M hub with the golden script's sessions, after 3 periods of
    its datagrams, with period 3's (the spill period's) queued."""
    cfg = SwimConfig(n_nodes=N, **serve_load.SERVE_ANCHOR)
    hub = serve_hub.ServeHub(cfg, **golden.serve_hub_kwargs())
    golden.drive_serve(hub, 3, lambda _: None)
    rows = sorted(r["row"] for r in hub.report()["sessions"])
    for src, dst, payload in golden.serve_datagrams(N, 3, rows):
        hub._on_session_datagram(None, src, dst, payload)
    return hub, rows


def serve_kernels_phase(rows: dict, card: str) -> dict:
    """(d) the kernels on one hub period's inputs, (h) one untraced hub
    period under the sync check, and the hub period's wall, busy ms and
    launches at 1M."""
    from torch.profiler import ProfilerActivity, profile

    hub, sessions = serve_hub_1m()
    try:
        captured = capture_inputs(_HubRunner(hub))
        for name, cnt in captured["calls"].items():
            if cnt != 1:
                raise AssertionError(f"serve: {name} called {cnt} times in "
                                     "one hub period")
        win, b = captured["selb"]
        err = require_equal("selb on the serve path's input",
                            selb.select_first_b(win, b),
                            selb.select_first_b_plain(win, b))
        nbytes = 2 * win.numel() * 4
        out = {"selb": dict(
            max_abs_err=err, shape=list(win.shape), b=b,
            ms_main=gpu_ms(lambda: selb.select_first_b(win, b)),
            bytes_main=nbytes, bound_ms_main=bound(nbytes,
                                                   win.numel() * 8)[0])}
        out["wavemerge"] = wavemerge_on(captured, "the serve path's inputs")
        out["coldsel"] = coldsel_on(captured["coldsel"], "the serve period")
        out["coldsel"]["q"] = int(captured["coldsel"][3].shape[0])
        for name, r in out.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            r["max_abs_err"])
            rows[name]["serve"] = {k: r[k] for k in (
                "ms_main", "bytes_main", "bound_ms_main")}
            emit(phase="serve", part="main_inputs", name=name, **r)

        # no host sync in an untraced period (gossip queued: the batch
        # and the offsets go over in the staged copy)
        for src, dst, payload in golden.serve_datagrams(N, 4, sessions):
            hub._on_session_datagram(None, src, dst, payload)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hub.step_periods(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        emit(phase="serve", part="no_sync", n_nodes=N, period=hub.t - 1)

        # the hub period at 1M: bare wall, then busy ms under the
        # profiler; each period queues the golden script's gossip
        def periods(k):
            for _ in range(k):
                for src, dst, payload in golden.serve_datagrams(
                        N, hub.t, sessions):
                    hub._on_session_datagram(None, src, dst, payload)
                hub.step_periods(1)
            torch.cuda.synchronize()

        periods(2)
        reset_launches()
        t0 = time.perf_counter()
        periods(SERVE_TIMED_PERIODS)
        wall = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED_PERIODS
        launches = read_launches()
        serve_launches("timed 1M periods", launches, SERVE_TIMED_PERIODS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            periods(SERVE_TIMED_PERIODS)
        busy, acts = busy_ms(prof)
        busy /= SERVE_TIMED_PERIODS
        row = dict(phase="serve", part="hub_period", n_nodes=N,
                   periods=SERVE_TIMED_PERIODS, wall_ms=wall, busy_ms=busy,
                   idle_share=1.0 - busy / wall,
                   device_activities_per_period=acts / SERVE_TIMED_PERIODS,
                   launches=launches, mirror=hub.report()["mirror_updates"],
                   card=card)
        emit(**row)
        return row
    finally:
        hub.close()


def serve_load_phase(card: str) -> None:
    """(e) run_load, (f) run_trace, (g) trace_overhead at their
    defaults, on the udppump frontend.  run_trace must keep the traced
    state bitwise equal to the untraced one and attribute its echo tail
    to named phases (`ok_parity`)."""
    t0 = time.perf_counter()
    res = serve_load.run_load(frontend="udppump")
    if not res["ok_parity"] or res["frontend"] != "udppump":
        raise AssertionError(f"run_load: ok_parity {res['ok_parity']}, "
                             f"frontend {res['frontend']}")
    for arm in ("clean", "storm"):
        if res[arm]["admission"]["sessions"] != res["sessions"]:
            raise AssertionError(f"run_load {arm} arm admitted "
                                 f"{res[arm]['admission']}")
    clean = res["clean"]
    emit(phase="serve", part="load", n_nodes=res["nodes"],
         sessions=res["sessions"], periods=res["periods"],
         frontend=res["frontend"],
         admission_sessions_per_sec=res["admission_sessions_per_sec"],
         rtt_ms={k: clean["rtt_ms"][k] for k in ("p50", "p99", "p999",
                                                  "samples")},
         storm_rtt_ms={k: res["storm"]["rtt_ms"][k]
                       for k in ("p50", "p99", "p999")},
         step_seconds=clean["step_seconds"],
         storm_step_seconds=res["storm"]["step_seconds"],
         wall_ms_per_period=clean["step_seconds"] * 1e3 / res["periods"],
         acks_sent=clean["acks_sent"], digest=clean["digest"],
         ok_parity=True, seconds=time.perf_counter() - t0, card=card)

    t0 = time.perf_counter()
    tr = serve_load.run_trace(frontend="udppump")
    att = tr["attribution"]
    if set(att["p99_attribution_ms"]) != set(analyze.SERVE_PHASES) | {
            "unattributed"} or att["periods"] != tr["periods"]:
        raise AssertionError(f"run_trace: malformed attribution {att}")
    row = dict(phase="serve", part="trace", n_nodes=tr["nodes"],
               sessions=tr["sessions"], periods=tr["periods"],
               digests_match=tr["digests_match"],
               coverage_pct=tr["coverage_pct"],
               attributed=bool(att.get("attributed")),
               contract_pct=att["contract_pct"], tail=att["tail"],
               echo=att["echo"],
               p99_attribution_ms=att["p99_attribution_ms"],
               phase_mean_ms={k: v["mean_ms"] for k, v in
                              tr["phase_summary"]["phases"].items()},
               period_ms=tr["phase_summary"]["period_ms"],
               step_seconds_untraced=tr["step_seconds_untraced"],
               step_seconds_traced=tr["step_seconds_traced"],
               seconds=time.perf_counter() - t0, card=card)
    emit(**row)
    if not tr["ok_parity"]:
        raise AssertionError(
            f"run_trace: digests_match {tr['digests_match']}, "
            f"{tr['coverage_pct']}% of the tail attributed (contract "
            f"{att['contract_pct']}%)")

    t0 = time.perf_counter()
    ov = serve_load.trace_overhead()
    if not ov["ok_parity"]:
        raise AssertionError("trace_overhead: traced and untraced "
                             "digests differ")
    emit(phase="serve", part="trace_overhead",
         **{k: ov[k] for k in ("nodes", "sessions", "periods", "reps",
                               "pps_off", "pps_on", "overhead_pct",
                               "within_contract", "serve_unattributed_ms")},
         seconds=time.perf_counter() - t0, card=card)


def serve_phase(rows: dict, card: str) -> dict:
    """Phase 13; returns the kernels' launches in the 100,000-node
    card-against-CPU run."""
    t0 = time.perf_counter()
    launches = serve_parity_phase()
    serve_kernels_phase(rows, card)
    serve_load_phase(card)
    emit(phase="serve", part="done", seconds=time.perf_counter() - t0,
         card=card)
    return launches


# ------------------------------------------------------ phase 14: bridge

BRIDGE_PARITY_N = 65_536
BRIDGE_PARITY_PERIODS = 10     # 20 until phase 20 came
BRIDGE_TIMED_PERIODS = 20
BRIDGE_SYNC_PERIODS = 2


def bridge_launches(what: str, launches: dict, periods: int, cfg) -> None:
    per = {k: v / periods for k, v in launches.items()}
    want = {k: float(v) for k, v in expected_launches(cfg).items()}
    if per != want:
        raise AssertionError(f"bridge {what}: launches a period {per}, "
                             f"expected {want}")


def bridge_parity_phase() -> dict:
    """(1) golden.GOLDEN_DIGEST_BRIDGE on the card, (2) the scripted
    session at 65,536 nodes with the default SwimConfig, card against
    CPU after every period; launches a period counted on both card runs.
    Returns the launches of the 65,536-node run and of the golden one."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    got, server = golden.golden_bridge("cuda")
    golden_launches = read_launches()
    if got[-1] != golden.GOLDEN_DIGEST_BRIDGE:
        raise AssertionError(f"golden bridge digest on the card {got[-1]} "
                             f"!= {golden.GOLDEN_DIGEST_BRIDGE}")
    if server.t != golden.BRIDGE_PERIODS:
        raise AssertionError(f"golden bridge ran {server.t} periods")
    bridge_launches("golden", golden_launches, server.t,
                    SwimConfig(**golden.bridge_config()))
    emit(phase="bridge", part="golden", digest=got[-1],
         n_nodes=golden.BRIDGE_N, periods=server.t,
         launches=golden_launches, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    cfg = SwimConfig(n_nodes=BRIDGE_PARITY_N)
    torch.cuda.synchronize()
    reset_launches()
    card, server = golden.golden_bridge(
        "cuda", n=BRIDGE_PARITY_N, periods=BRIDGE_PARITY_PERIODS, cfg_kw={})
    launches = read_launches()
    bridge_launches("card against CPU", launches, server.t, cfg)
    cpu, cpu_server = golden.golden_bridge(
        "cpu", n=BRIDGE_PARITY_N, periods=BRIDGE_PARITY_PERIODS, cfg_kw={})
    for t, (a, b) in enumerate(zip(card, cpu)):
        if a != b:
            raise AssertionError("bridge card against CPU: frames or state "
                                 f"differ after period {t}")
    if len(card) != BRIDGE_PARITY_PERIODS or len(cpu) != len(card):
        raise AssertionError(f"bridge card against CPU: {len(card)} / "
                             f"{len(cpu)} periods")
    findings = [f.to_dict() for f in server.findings]
    if findings != [f.to_dict() for f in cpu_server.findings]:
        raise AssertionError("bridge card against CPU: findings differ")
    emit(phase="bridge", part="card_vs_cpu", n_nodes=BRIDGE_PARITY_N,
         periods=len(card), digests_equal=len(card), launches=launches,
         findings=findings, seconds=time.perf_counter() - t0)
    return launches, golden_launches


def _u32_keys(server, member: int) -> list[int]:
    """The table keys about `member` and its tombstone, as u32."""
    return server.table_keys(member) + [
        int(server.state.gone_key[member]) & u32.MASK32]


def _members(stdout: str) -> tuple[dict, int | None]:
    members, self_inc = {}, None
    for line in stdout.splitlines():
        parts = line.split()
        if parts and parts[0] == "member":
            members[int(parts[1])] = (int(parts[2]), int(parts[3]))
        elif parts and parts[0] == "self":
            self_inc = int(parts[2])
    return members, self_inc


def cpp_core_64k(client: str, card: str) -> None:
    """The reference's TestCppCore64k with the port's compiled core:
    65,536 nodes (bridge geometry, seed 6) on the card, victim 512 killed
    by the core at 8.0, 60 virtual seconds, suspect(X) forged on the wire
    once the engine is past period 20."""
    n = 65_536
    x, victim = n - 1, 512
    cfg = SwimConfig(**golden.bridge_config(n))
    server = EngineBridgeServer(cfg, external_id=x, seed=6)
    server.start()
    host, port = server.address
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [client, str(host), str(port), str(x), "7", "60.0", "0.5",
         str(victim), "8.0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        while server.t < 20 and proc.poll() is None:
            if time.time() > deadline:
                raise AssertionError("cpp 64k: stalled before period 20")
            time.sleep(0.05)
        server.deliver_forged(3, [codec.WireUpdate(
            x, Status.SUSPECT, 0, ("sim", x), 3)])
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
        server.close()
        server.join(timeout=60)
    wall = time.perf_counter() - t0
    launches = read_launches()
    if proc.returncode != 0:
        raise AssertionError(f"cpp 64k: client exit {proc.returncode}: "
                             f"{err[-2000:]}")
    members, self_inc = _members(out)
    false_dead = [m for m, (st, _) in members.items()
                  if m != victim and st == int(Status.DEAD)]
    inc_x = int(server.state.inc_self[x])
    keys = _u32_keys(server, x)
    refuted = [k for k in keys if k >= 2 and not k >> 31 and not k & 1]
    checks = {"members_ge_64": len(members) >= 64,
              "victim_dead": members.get(victim, (None,))[0]
              == int(Status.DEAD),
              "no_false_deaths": not false_dead,
              "core_refuted": self_inc is not None and self_inc >= 1,
              "engine_inc_self_zero": inc_x == 0,
              "refutation_in_tensor_state": bool(refuted),
              "x_not_crash_gated": not server._x_crashed,
              "no_dead_view_of_x": not any(k >> 31 for k in keys)}
    if not all(checks.values()):
        raise AssertionError(f"cpp 64k: {checks} members {len(members)} "
                             f"false_dead {false_dead[:10]} keys "
                             f"{[hex(k) for k in keys]}")
    bridge_launches("cpp 64k", launches, server.t, cfg)
    emit(phase="bridge", part="cpp_core_64k", n_nodes=n, periods=server.t,
         members=len(members), self_inc=self_inc, checks=checks,
         launches=launches, wall_s=wall,
         wall_ms_per_period=wall * 1e3 / server.t, card=card)


def cpp_two_cores(client: str, card: str) -> None:
    """The reference's two-C-cores scenario: A (id 128) and B (N-1) join
    one 16,384-node engine on the card; A leaves at 10 s, and B learns
    A's death through tensor state by 46 s."""
    import threading

    n = 16_384
    xa, xb = 128, n - 1
    cfg = SwimConfig(**golden.bridge_config(n))
    server = EngineBridgeServer(cfg, external_ids=[xa, xb], seed=11)
    server.start()
    host, port = server.address
    boxes: dict = {"a": {}, "b": {}}

    def run_client(args, box):
        box["proc"] = p = subprocess.Popen(
            [client, str(host), str(port)] + args,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        box["out"], box["err"] = p.communicate(timeout=300)
        box["rc"] = p.returncode

    t0 = time.perf_counter()
    ta = threading.Thread(target=run_client, daemon=True,
                          args=([str(xa), "7", "10.0", "0.5"], boxes["a"]))
    tb = threading.Thread(target=run_client, daemon=True,
                          args=([str(xb), "9", "46.0", "0.5"], boxes["b"]))
    ta.start()
    time.sleep(0.5)      # A's row is alive when B samples its snapshot
    tb.start()
    try:
        ta.join(timeout=300)
        tb.join(timeout=300)
        if ta.is_alive() or tb.is_alive():
            raise AssertionError("cpp two cores: a client stalled")
    finally:
        for box in boxes.values():
            p = box.get("proc")
            if p is not None and p.poll() is None:
                p.kill()
        server.close()
        server.join(timeout=60)
    wall = time.perf_counter() - t0
    for name, box in boxes.items():
        if box.get("rc") != 0:
            raise AssertionError(
                f"cpp two cores: client {name} exit {box.get('rc')}: "
                f"{box.get('err', '')[-2000:]}")
    b_members, _ = _members(boxes["b"]["out"])
    false_dead = [m for m, (st, _) in b_members.items()
                  if m != xa and st == int(Status.DEAD)]
    checks = {"b_members_ge_64": len(b_members) >= 64,
              "b_knows_a": xa in b_members,
              "b_sees_a_dead": b_members.get(xa, (None,))[0]
              == int(Status.DEAD),
              "no_false_deaths": not false_dead,
              "a_crash_gated": server._ext_crashed[xa],
              "b_not_crash_gated": not server._ext_crashed[xb],
              "a_dead_in_tensor_state": any(
                  k >> 31 for k in _u32_keys(server, xa)),
              "no_dead_view_of_b": not any(
                  k >> 31 for k in _u32_keys(server, xb))}
    if not all(checks.values()):
        raise AssertionError(f"cpp two cores: {checks}")
    emit(phase="bridge", part="cpp_two_cores", n_nodes=n, periods=server.t,
         b_members=len(b_members), checks=checks, wall_s=wall, card=card)


def step_session(sock, me: int) -> None:
    """One raw-socket STEP of one period: drain the flush and ack every
    mirrored ping like a live core."""
    bp.write_frame(sock, bp.Frame(bp.STEP, t=1.0))
    while (f := bp.read_frame(sock)).op != bp.TIME:
        msg = codec.decode(f.payload)
        if msg.kind == MsgKind.PING:
            bp.write_frame(sock, bp.Frame(bp.SEND, a=me, b=f.a,
                                          payload=codec.encode(codec.Message(
                                              kind=MsgKind.ACK, sender=me,
                                              probe_seq=msg.probe_seq,
                                              on_behalf=msg.on_behalf))))


def bridge_period_1m(card: str) -> dict:
    """The bridge period at 1,000,000 nodes with the default SwimConfig
    and one raw-socket session acking its pings: the wall a period as the
    session sees it (STEP to TIME) and as the server sees it
    (`_run_period`), busy ms under torch.profiler, the idle share,
    launches and device-to-host copies a period, and the synchronizing
    calls PyTorch's sync check reports a period."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    cfg = SwimConfig(n_nodes=N)
    x = N - 1
    server = EngineBridgeServer(cfg, external_id=x, seed=0)
    served: list[float] = []
    run_period = server._run_period

    def timed_period() -> None:
        t0 = time.perf_counter()
        run_period()
        served.append(time.perf_counter() - t0)

    server._run_period = timed_period
    server.start()
    sock = socket.create_connection(server.address)
    try:
        bp.write_frame(sock, bp.Frame(bp.HELLO, a=x))
        if bp.read_frame(sock).op != bp.WELCOME:
            raise AssertionError("bridge 1m: no WELCOME")

        def steps(k: int) -> list[float]:
            walls = []
            for _ in range(k):
                t0 = time.perf_counter()
                step_session(sock, x)
                walls.append(time.perf_counter() - t0)
            return walls

        steps(3)
        served.clear()
        reset_launches()
        copies0 = server.d2h_copies
        walls = steps(BRIDGE_TIMED_PERIODS)
        launches = read_launches()
        copies = server.d2h_copies - copies0
        bridge_launches("1m", launches, BRIDGE_TIMED_PERIODS, cfg)
        session_ms = sum(walls) * 1e3 / len(walls)
        server_ms = sum(served) * 1e3 / len(served)
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(BRIDGE_TIMED_PERIODS)
        busy, acts = busy_ms(prof)
        kernels = sum(read_launches().values())
        if acts < kernels:
            raise AssertionError(f"bridge 1m: the profiler saw {acts} device "
                                 f"activities for {kernels} kernel launches")
        busy /= BRIDGE_TIMED_PERIODS
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                steps(BRIDGE_SYNC_PERIODS)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        synced = [w for w in caught if "synchroniz" in str(w.message)]
        syncs = len(synced)
        sites = sorted({f"{Path(w.filename).name}:{w.lineno}"
                        for w in synced})
        bp.write_frame(sock, bp.Frame(bp.BYE))
    finally:
        sock.close()
        server.close()
        server.join(timeout=60)
    row = dict(phase="bridge", part="period_1m", n_nodes=N,
               periods=BRIDGE_TIMED_PERIODS, wall_ms_session=session_ms,
               wall_ms_server=server_ms, busy_ms=busy,
               idle_share=1.0 - busy / session_ms,
               idle_share_server=1.0 - busy / server_ms,
               device_activities_per_period=acts / BRIDGE_TIMED_PERIODS,
               launches=launches,
               d2h_copies_per_period=copies / BRIDGE_TIMED_PERIODS,
               sync_warnings_per_period=syncs / BRIDGE_SYNC_PERIODS,
               sync_sites=sites, card=card)
    if copies != BRIDGE_TIMED_PERIODS:
        raise AssertionError(f"bridge 1m: {copies} device-to-host copies "
                             f"in {BRIDGE_TIMED_PERIODS} periods")
    emit(**row)
    return row


def bridge_phase(card: str) -> dict:
    """Phase 14; returns the kernels' launches in the 65,536-node card
    run (default SwimConfig) and in the golden run (bridge geometry)."""
    t0 = time.perf_counter()
    client = native.bridge_client_bin()
    if client is None:
        raise AssertionError("bridge: g++ could not build bridge_client")
    emit(phase="bridge", part="build", client=client,
         seconds=time.perf_counter() - t0)
    launches, golden_launches = bridge_parity_phase()
    cpp_core_64k(client, card)
    cpp_two_cores(client, card)
    bridge_period_1m(card)
    emit(phase="bridge", part="done", seconds=time.perf_counter() - t0,
         card=card)
    return {"bridge": launches, "bridge_golden": golden_launches}


# ------------------------------------------------------ instruments


PROF_PERIODS = 5
OVERHEAD_PERIODS = 10
OVERHEAD_PAIRS = 3
REPO = Path(__file__).resolve().parent


def profiled_parity(cfg, card: str) -> dict:
    """profiled_ring_run at 1M with the kernels (launches counted) and
    with the plain versions: markers equal, state equal to ring.run's in
    all 14 fields; then one profiled period under the sync check."""
    plan = crash_plan(cfg, PROF_PERIODS)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    k = prof.profiled_ring_run(cfg, ring.init_state(cfg, "cuda"), plan, 0,
                               PROF_PERIODS)
    torch.cuda.synchronize()
    launches = read_launches()
    p = prof.profiled_ring_run(cfg, ring.init_state(cfg, "cuda"), plan, 0,
                               PROF_PERIODS, plain=True)
    want = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0,
                    PROF_PERIODS)
    if not torch.equal(k.markers, p.markers):
        raise AssertionError("instruments: markers differ between the "
                             "kernels and the plain versions")
    for f in ring.RingState._fields:
        for what, st in (("kernels", k.state), ("plain", p.state)):
            if not torch.equal(getattr(st, f), getattr(want, f)):
                raise AssertionError(f"instruments: profiled run ({what}) "
                                     f"field {f} differs from ring.run")
    per_period = {kn: c / PROF_PERIODS for kn, c in launches.items()}
    if per_period != {"selb": 1.0, "coldsel": 1.0, "wavemerge": 1.0}:
        raise AssertionError(f"instruments: launches a period {per_period}")
    rnd = ring.draw_period_ring(threefry.key(0), PROF_PERIODS, cfg, "cuda")
    st = k.state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pr = prof.PhaseProbe()
        ring.step(cfg, st, plan, rnd, prof=pr)
        pr.marker_vector()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emit(phase="instruments", part="profiled_run", n_nodes=cfg.n_nodes,
         periods=PROF_PERIODS, markers_equal=True,
         fields_equal=len(ring.RingState._fields), launches=launches,
         launches_per_period=per_period,
         last_markers=k.markers[-1].tolist(), no_sync_period=True,
         seconds=time.perf_counter() - t0, card=card)
    return launches


TRACE_PERIODS = 2
# interleaved rounds of every prefix and the step for profile_ring's wall
# attribution (printed, not checked: the host-paced step and its last
# prefix drift up to 17% apart, at 20 rounds and at 60)
PROFILE_REPS = 60
# calls of every prefix and of the step under one trace each, for the
# device-time attribution that the coverage check reads
DEVICE_REPS = 5
KERNEL_PHASES = {"selb_kernel": "select", "wavemerge_kernel": "merge",
                 "coldsel_kernel": "commit"}


def traced_launches(cfg, name: str) -> dict:
    """TRACE_PERIODS ring periods at 1M under utils/profiling.py `trace`,
    launch counts zeroed before and read after: each kernel appears in
    the device trace as often as its wrapper launched it, and
    classify_op gives it its phase."""
    import tempfile

    from swim_tpu_torch.utils import profiling

    plan = crash_plan(cfg, TRACE_PERIODS)
    state = ring.init_state(cfg, "cuda")
    with tempfile.TemporaryDirectory() as tdir:
        torch.cuda.synchronize()
        reset_launches()
        with profiling.trace(tdir):
            ring.run(cfg, state, plan, 0, TRACE_PERIODS)
            torch.cuda.synchronize()
        launches = read_launches()
        every = prof.top_ops_from_trace(tdir, top_k=10_000)["ops"]
    found = {}
    for kname, phase in KERNEL_PHASES.items():
        hits = [o for o in every if kname in o["op"]]
        calls = sum(o["calls"] for o in hits)
        want = launches[kname.removesuffix("_kernel")]
        if not want or calls != want or \
                any(o["phase_guess"] != phase for o in hits):
            raise AssertionError(
                f"instruments: {name} trace holds {kname} {calls} times "
                f"as {[o['phase_guess'] for o in hits]}, its wrapper "
                f"launched it {want} times ({phase} expected)")
        found[kname] = {"phase": phase, "calls": calls, "launches": want,
                        "self_us": sum(o["self_us"] for o in hits)}
    return found


def device_attribution(cfg) -> dict:
    """profile_ring's phase attribution by device time: the prefixes and
    the full step of profile_ring's settled 1M period (its plan, settle
    and seed), each called DEVICE_REPS times under one torch.profiler
    trace, every call with its own copy of `cold` made before the
    trace.  A phase takes the device ms of its prefix less the prefix
    before (clamped at 0), telemetry_tap the rest of the full step.
    Device time does not wait for the host, so the prefixes order as
    their kernels do; coverage is 100% plus what the clamp dropped."""
    from torch.profiler import ProfilerActivity, profile

    from swim_tpu_torch.obs.engine import frame_from_tap

    settle, reps = 2, DEVICE_REPS
    plan = faults.with_random_crashes(faults.none(cfg.n_nodes, "cuda"),
                                      threefry.key(1), CRASH_FRACTION, 0,
                                      settle)
    state = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, settle)
    rnds = [ring.draw_period_ring(threefry.key(0), 1_000 + i, cfg, "cuda")
            for i in range(reps)]
    active = prof.phases_for(cfg)

    def prefix(phase):
        return lambda st, rnd: ring.step(cfg, st, plan, rnd, tap={},
                                         prof=prof.PhaseProbe(until=phase))

    def full(st, rnd):
        tap: dict = {}
        st = ring.step(cfg, st, plan, rnd, tap=tap)
        return st, frame_from_tap(tap, st.win.device)

    fns = {p: prefix(p) for p in active if p != "telemetry_tap"}
    fns["full"] = full
    dev_ms = {}
    for name, fn in fns.items():
        fn(state._replace(cold=state.cold.clone()), rnds[0])    # warm-up
        colds = [state.cold.clone() for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            for cold, rnd in zip(colds, rnds):
                fn(state._replace(cold=cold), rnd)
            torch.cuda.synchronize()
        dev_ms[name] = busy_ms(pr)[0] / reps
        del colds
    phases, prev = {}, 0.0
    for phase in active:
        if phase == "telemetry_tap":
            phases[phase] = max(dev_ms["full"] - prev, 0.0)
        else:
            phases[phase] = max(dev_ms[phase] - prev, 0.0)
            prev = dev_ms[phase]
    return {"step_device_ms": dev_ms["full"], "prefix_device_ms": dev_ms,
            "phases": phases, "coverage_pct":
            sum(phases.values()) / dev_ms["full"] * 100.0}


def profile_report(cfg, name: str, card: str) -> dict:
    """profile_ring at 1M with a device trace: per-phase ms, step ms,
    its wall coverage, the roofline band and the top kernels; the same
    attribution by device time (`device_attribution`), whose coverage
    must lie in 95-105%; then a traced run whose kernel events match
    the wrappers' launch counts.

    Both coverages are at least 100% by construction (each prefix
    difference is clamped at 0 and the telemetry term takes the rest of
    the full step); what they read above 100% is what the clamp dropped,
    where a prefix ran longer than a longer one.  The wall coverage of
    the host-paced step is printed: prefix walls spread by up to 15%
    between rounds.  Device times order as the prefixes' kernels do, so
    above 105% the attribution is wrong: that fails."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tdir:
        rep = prof.profile_ring(cfg, reps=PROFILE_REPS, trace_dir=tdir,
                                top_k=8)
    dev = device_attribution(cfg)
    if not 95.0 <= dev["coverage_pct"] <= 105.0:
        raise AssertionError(f"instruments: {name} device-time coverage "
                             f"{dev['coverage_pct']}% outside 95-105%")
    found = traced_launches(cfg, name)
    emit(phase="instruments", part="profile", config=name,
         n_nodes=cfg.n_nodes, step_ms=rep["step_ms"], pps=rep["pps"],
         coverage_pct=rep["coverage_pct"],
         device_coverage_pct=dev["coverage_pct"],
         step_device_ms=dev["step_device_ms"],
         device_phases=dev["phases"],
         prefix_device_ms=dev["prefix_device_ms"],
         phases={r["phase"]: r["ms"] for r in rep["phases"]},
         roofline=rep["roofline"], kernels_in_trace=found,
         trace_periods=TRACE_PERIODS,
         top_ops=[(o["op"][:80], o["self_us"], o["calls"], o["phase_guess"])
                  for o in rep["top_ops"]["ops"]],
         seconds=time.perf_counter() - t0, card=card)
    print(prof.render_report(rep), flush=True)
    return rep


def marker_overhead(cfg, card: str) -> dict:
    """Wall ms per 1M period with the marker-mode probe and without it,
    in alternating pairs (the reference's <= 5% contract, printed)."""
    plan = crash_plan(cfg, OVERHEAD_PERIODS)
    state = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, 2)
    rnds = [ring.draw_period_ring(threefry.key(0), 2 + i, cfg, "cuda")
            for i in range(OVERHEAD_PERIODS)]

    def arm(on: bool) -> float:
        st = state._replace(cold=state.cold.clone())
        rows = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for rnd in rnds:
            pr = prof.PhaseProbe() if on else None
            st = ring.step(cfg, st, plan, rnd, prof=pr)
            if on:      # kept, as profiled_ring_run keeps them
                rows.append(pr.marker_vector())
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / len(rnds)

    arm(True)
    arm(False)
    off, on = [], []
    for _ in range(OVERHEAD_PAIRS):
        off.append(arm(False))
        on.append(arm(True))
    row = dict(phase="instruments", part="marker_overhead",
               n_nodes=cfg.n_nodes, periods=OVERHEAD_PERIODS,
               off_ms=off, on_ms=on, off_median=float(np.median(off)),
               on_median=float(np.median(on)),
               overhead_pct=float((np.median(on) / np.median(off) - 1)
                                  * 100), card=card)
    emit(**row)
    return row


def memwall_report(card: str) -> dict:
    t0 = time.perf_counter()
    rep = memwall.study_memory_analysis(N, device="cuda")
    if not rep["measured"] or rep["total_bytes"] < rep["state_bytes"]:
        raise AssertionError(f"instruments: memwall report {rep}")
    emit(phase="instruments", part="memwall", **rep,
         seconds=time.perf_counter() - t0, card=card)
    return rep


def run_cli(args: list, timeout: float = 300.0) -> tuple[str, str]:
    proc = subprocess.run([sys.executable, "-m", "swim_tpu_torch.cli",
                           *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"cli {args}: exit {proc.returncode}\n"
                             f"{proc.stderr[-2000:]}")
    return proc.stdout, proc.stderr


def cli_phase(card: str) -> None:
    """The CLI in subprocesses on the card: simulate, profile (writing
    the artifact the bridge serves) and bridge with a /metrics scrape
    carrying the swim_prof_* gauges; each exits 0."""
    import urllib.request

    t0 = time.perf_counter()
    out, _ = run_cli(["simulate", "--nodes", str(N), "--engine", "ring",
                      "--sel-scope", "period", "--periods", "10"])
    sim = json.loads(out.strip().splitlines()[-1])
    if sim["nodes"] != N or sim["periods"] != 10:
        raise AssertionError(f"cli simulate: {sim}")
    out, err = run_cli(["profile", "--nodes", str(N), "--check", "--json",
                        "--out", "auto"])
    rep = json.loads(out)
    artifact = err.strip().splitlines()[-1].removeprefix("# wrote ")
    if prof.load_artifact(artifact) != rep:
        raise AssertionError("cli profile: artifact differs from output")
    proc = subprocess.Popen(
        [sys.executable, "-m", "swim_tpu_torch.cli", "bridge", "--internal",
         "4", "--metrics-port", "0", "--timeout", "120"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        host, port = info["metrics"]
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        # one client that hangs up ends the server's service loop
        socket.create_connection(tuple(info["listening"])).close()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    prof_lines = [ln for ln in body.splitlines()
                  if ln.startswith("swim_prof_")]
    if rc != 0 or not prof_lines or \
            f'nodes="{N}"' not in prof_lines[0]:
        raise AssertionError(f"cli bridge: exit {rc}, prof gauges "
                             f"{prof_lines[:2]}")
    emit(phase="instruments", part="cli", simulate=sim,
         profile={k: rep[k] for k in ("step_ms", "pps", "coverage_pct")},
         artifact=artifact, bridge_exit=rc, prof_gauge_lines=len(prof_lines),
         seconds=time.perf_counter() - t0, card=card)


def instruments_phase(card: str) -> dict:
    """Phase 15; returns the kernels' launches in the profiled 1M run."""
    t0 = time.perf_counter()
    cfg = path_cfg("period")
    launches = profiled_parity(cfg, card)
    got = golden.markers_digest(golden.golden_markers("cuda"))
    if got != golden.GOLDEN_DIGEST_MARKERS:
        raise AssertionError("instruments: GOLDEN_DIGEST_MARKERS not "
                             f"reproduced on the card ({got})")
    emit(phase="instruments", part="golden_markers", digest=got,
         expected=golden.GOLDEN_DIGEST_MARKERS)
    profile_report(cfg, "period", card)
    profile_report(SwimConfig(n_nodes=N), "wave", card)
    marker_overhead(cfg, card)
    memwall_report(card)
    cli_phase(card)
    emit(phase="instruments", part="done", seconds=time.perf_counter() - t0,
         card=card)
    return launches


# --------------------------------------------------- phase 16: ringshard

SHARDS = pmesh.DEFAULT_SHARDS
SHARD_PERIODS = 3
# config name -> SwimConfig keywords beyond n_nodes; the compact ICI
# wire packs the one selection of a period, so SwimConfig pins it to
# period scope and the default wave scope runs on the window wire
SHARD_CONFIGS = {
    "wave": {},
    "period_compact": dict(ring_sel_scope="period", ring_ici_wire="compact"),
    "period_packed": dict(ring_sel_scope="period", ring_scalar_wire="packed"),
}
SHARD_ODD_N = SHARDS * 125_001          # S % 4 == 1
SHARD_STUDY_PERIODS = 9
SHARD_STUDY_CHUNK = 3
SHARD_TIMED_PERIODS = 5
SHARD_CKPT_DIR = Path(__file__).resolve().parent / "_shard_ckpt"
SHARD_MEMWALL_RATIO = 1.05      # sharded study peak over one device's


def shard_mesh():
    return pmesh.make_mesh(devices=["cuda"] * SHARDS)


def shard_place(cfg, plan):
    return ring_shard.start(cfg, plan, "cuda")[1:3]


def shard_run(cfg, plan, periods: int, plain: bool = False, seed: int = 0):
    """The placed state after `periods` sharded periods from init."""
    mesh, st, pl, _ = ring_shard.start(cfg, plan, "cuda")
    return ring_shard.build_run(cfg, mesh, periods, plain=plain)(
        st, pl, threefry.key(seed))


def shard_parity(name: str) -> tuple[dict, object]:
    """SHARD_PERIODS periods at N on one device, sharded with the kernels
    and sharded with the plain versions: all 14 fields equal; the
    sharded launches D times the single-device selb and coldsel and
    wavemerge once a wave on each shard.  Returns (launches, the
    kernels' placed state)."""
    t0 = time.perf_counter()
    cfg = SwimConfig(n_nodes=N, **SHARD_CONFIGS[name])
    plan = crash_plan(cfg, SHARD_PERIODS)
    torch.cuda.synchronize()
    reset_launches()
    single = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0,
                      SHARD_PERIODS)
    torch.cuda.synchronize()
    one = read_launches()
    reset_launches()
    placed = shard_run(cfg, plan, SHARD_PERIODS)
    torch.cuda.synchronize()
    launches = read_launches()
    k = pmesh.assemble(placed)
    p = pmesh.assemble(shard_run(cfg, plan, SHARD_PERIODS, plain=True))
    require_same(f"ringshard {name}: sharded against one device", k, single)
    require_same(f"ringshard {name}: kernels against plain versions", k, p)
    want = {"selb": SHARDS * one["selb"], "coldsel": SHARDS * one["coldsel"],
            "wavemerge": SHARDS * SHARD_PERIODS * shard_merge_launches(cfg)}
    if launches != want or one["wavemerge"] == 0:
        raise AssertionError(f"ringshard {name}: launches {launches}, one "
                             f"device {one}, expected {want}")
    emit(phase="ringshard", part="parity", config=name, n_nodes=N,
         shards=SHARDS, periods=SHARD_PERIODS,
         fields_equal=len(ring.RingState._fields), launches=launches,
         launches_one_device=one, suspects=int((k.rkey & 1).sum()),
         seconds=time.perf_counter() - t0)
    return launches, placed


def shard_golden() -> None:
    """golden.GOLDEN_DIGESTS by the sharded engine at D = 8."""
    t0 = time.perf_counter()
    for name, want in golden.GOLDEN_DIGESTS.items():
        cfg = golden.golden_config(name)[0]
        got = golden.digest(pmesh.assemble(shard_run(
            cfg, golden.golden_plan(name, "cuda"), golden.GOLDEN_PERIODS,
            seed=golden.GOLDEN_SEED)))
        if got != want:
            raise AssertionError(f"ringshard golden '{name}' {got} != "
                                 f"{want}")
    emit(phase="ringshard", part="golden", shards=SHARDS,
         digests=list(golden.GOLDEN_DIGESTS),
         seconds=time.perf_counter() - t0)


def capture_shard_period(cfg, placed, plan, t: int, mesh=None) -> dict:
    """One sharded period from `placed` (period t, on `mesh`, by default
    the 8 slots of the card) with the three kernels' wrappers keeping
    clones of the arguments of every call."""
    got = {"selb": [], "coldsel": [], "wavemerge": []}
    real = (selb.select_first_b, coldsel.cold_update_select,
            wavemerge.merge_waves)
    lock = threading.Lock()

    def keep(name, fn):
        def wrapped(*args):
            with lock:
                got[name].append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
            return fn(*args)
        return wrapped

    selb.select_first_b = keep("selb", real[0])
    coldsel.cold_update_select = keep("coldsel", real[1])
    wavemerge.merge_waves = keep("wavemerge", real[2])
    try:
        rnd = ring.draw_period_ring(threefry.key(0), t, cfg, "cuda")
        ring_shard.mapped_step(cfg, mesh or shard_mesh())(
            placed, plan, rnd, ring.rotor_offsets(cfg, t))
    finally:
        (selb.select_first_b, coldsel.cold_update_select,
         wavemerge.merge_waves) = real
    torch.cuda.synchronize()
    return got


def check_captured(what: str, got: dict) -> int:
    """Each captured call's kernel against its plain version."""
    err = 0
    for (win, b) in got["selb"]:
        err = max(err, require_equal(
            f"{what} selb S={win.shape[0]}", selb.select_first_b(win, b),
            selb.select_first_b_plain(win, b)))
    for (cold, fr, fv, qr) in got["coldsel"]:
        c_k, s_k = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
        c_p, s_p = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
        err = max(err, require_equal(f"{what} coldsel cold", c_k, c_p),
                  require_equal(f"{what} coldsel sel", s_k, s_p))
    for (win, sel, oks, offs, bcol, bval) in got["wavemerge"]:
        err = max(err, require_equal(
            f"{what} wavemerge S={win.shape[0]} v={oks.shape[0]} "
            f"vb={bcol.shape[0]}",
            wavemerge.merge_waves(win.clone(), sel, oks, offs, bcol, bval),
            wavemerge.merge_waves_plain(win.clone(), sel, oks, offs, bcol,
                                        bval)))
    return err


def shard_kernels(placed, rows: dict) -> None:
    """selb, coldsel and wavemerge on the per-shard inputs of one more
    wave-scope period at N (and of a period at SHARD_ODD_N, S % 4 != 0),
    bitwise against their plain versions; the per-shard
    `ms_main_ringshard`."""
    t0 = time.perf_counter()
    cfg = SwimConfig(n_nodes=N, **SHARD_CONFIGS["wave"])
    plan = shard_place(cfg, crash_plan(cfg, SHARD_PERIODS))[1]
    got = capture_shard_period(cfg, placed, plan, SHARD_PERIODS)
    waves = 2 + 4 * cfg.k_indirect
    if (len(got["selb"]) != SHARDS * waves
            or len(got["coldsel"]) != SHARDS
            or len(got["wavemerge"]) != SHARDS * shard_merge_launches(cfg)):
        raise AssertionError(
            f"ringshard: captured {len(got['selb'])} selb, "
            f"{len(got['coldsel'])} coldsel and {len(got['wavemerge'])} "
            "wavemerge calls")
    err = check_captured("ringshard", got)
    odd_cfg = SwimConfig(n_nodes=SHARD_ODD_N, ring_sel_scope="period")
    odd_plan = crash_plan(odd_cfg, SHARD_PERIODS)
    odd_state = shard_run(odd_cfg, odd_plan, 2)
    odd_plan = shard_place(odd_cfg, odd_plan)[1]
    odd = capture_shard_period(odd_cfg, odd_state, odd_plan, 2)
    if odd["coldsel"][0][0].shape[1] % 4 == 0:
        raise AssertionError("ringshard: the odd shard size is a multiple "
                             "of 4")
    err = max(err, check_captured("ringshard odd S", odd))
    win, b = got["selb"][0]
    cold, fr, fv, qr = got["coldsel"][0]
    m_win, m_sel, oks, offs, bcol, bval = got["wavemerge"][0]
    s = win.shape[0]
    for name, t_k, t_p, nbytes, nops in (
            ("selb", gpu_ms(lambda: selb.select_first_b(win, b)),
             gpu_ms(lambda: selb.select_first_b_plain(win, b), samples=5,
                    inner=2),
             2 * win.numel() * 4, win.numel() * 8),
            ("coldsel",
             gpu_ms(lambda: coldsel.cold_update_select(cold, fr, fv, qr)),
             gpu_ms(lambda: coldsel.cold_update_select_plain(
                 cold, fr, fv, qr), samples=5, inner=2),
             (2 * fr.shape[0] + 3 * qr.shape[0]) * s * 4,
             s * (fr.shape[0] + qr.shape[0] * (fr.shape[0] + 4))),
            ("wavemerge",
             gpu_ms(lambda: wavemerge.merge_waves(m_win, m_sel, oks, offs,
                                                  bcol, bval)),
             gpu_ms(lambda: wavemerge.merge_waves_plain(
                 m_win, m_sel, oks, offs, bcol, bval), samples=5, inner=2),
             3 * m_win.numel() * 4 + oks.numel(),
             m_win.numel() * 3 * oks.shape[0])):
        bms, by = bound(nbytes, nops)
        rows[name]["ringshard"] = dict(
            ms_main=t_k, plain_ms_main=t_p, bytes_main=nbytes,
            bound_ms_main=bms, bound_by=by, shard_rows=s)
    emit(phase="ringshard", part="kernels", max_abs_err=err,
         selb_calls=len(got["selb"]), coldsel_calls=len(got["coldsel"]),
         wavemerge_calls=len(got["wavemerge"]),
         odd_shard_rows=odd["coldsel"][0][0].shape[1],
         selb=rows["selb"]["ringshard"], coldsel=rows["coldsel"]["ringshard"],
         wavemerge=rows["wavemerge"]["ringshard"],
         seconds=time.perf_counter() - t0)


def shard_no_sync_period() -> None:
    """One sharded period (the default SwimConfig: wave scope) at N with
    PyTorch's sync check set to raise; the randomness drawn before."""
    cfg = SwimConfig(n_nodes=N, **SHARD_CONFIGS["wave"])
    st, pl = shard_place(cfg, crash_plan(cfg, SHARD_PERIODS))
    step = ring_shard.mapped_step(cfg, shard_mesh())
    st = step(st, pl, ring.draw_period_ring(threefry.key(0), 0, cfg, "cuda"),
              ring.rotor_offsets(cfg, 0))
    rnd = ring.draw_period_ring(threefry.key(0), 1, cfg, "cuda")
    shifts = ring.rotor_offsets(cfg, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(st, pl, rnd, shifts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit(phase="ringshard", part="no_sync_period", host_syncs_in_a_period=0)


def shard_study(card: str) -> None:
    """The 1M pull detection study (the study default) on `ringshard`,
    streaming in chunks of SHARD_STUDY_CHUNK; again checkpointing every
    chunk, stopped in-process after two chunks and resumed from its
    directory: equal summaries, CompactTrack and series bitwise; the
    summary equal to the `ring` engine's."""
    t0 = time.perf_counter()
    kw = dict(n=N, crash_fraction=CRASH_FRACTION,
              periods=SHARD_STUDY_PERIODS, seed=0, device="cuda")
    kept = {}
    real_stream = runner.run_study_ring_stream
    real_call = ring_shard.ShardedStep.__call__
    calls = [0]

    def keep_stream(*a, **k):
        res = real_stream(*a, **k)
        kept["stream"] = res
        return res

    def stopping_call(self, *a):
        calls[0] += 1
        if calls[0] > 2 * SHARD_STUDY_CHUNK:
            raise Interrupted
        return real_call(self, *a)

    shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    try:
        runner.run_study_ring_stream = keep_stream
        one = experiments.detection_study(stream=True,
                                          chunk=SHARD_STUDY_CHUNK,
                                          engine="ring", **kw)
        kept.pop("stream")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        straight = experiments.detection_study(
            stream=True, chunk=SHARD_STUDY_CHUNK, engine="ringshard", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        ref = kept.pop("stream")
        ring_shard.ShardedStep.__call__ = stopping_call
        try:
            experiments.detection_study(
                checkpoint_dir=str(SHARD_CKPT_DIR),
                checkpoint_every=SHARD_STUDY_CHUNK, engine="ringshard", **kw)
            raise AssertionError("the checkpointed study was not stopped")
        except Interrupted:
            pass
        ring_shard.ShardedStep.__call__ = real_call
        snaps = sorted(p.name for p in SHARD_CKPT_DIR.iterdir())
        resumed = experiments.detection_study(
            checkpoint_dir=str(SHARD_CKPT_DIR),
            checkpoint_every=SHARD_STUDY_CHUNK, engine="ringshard", **kw)
        again = kept.pop("stream")
    finally:
        runner.run_study_ring_stream = real_stream
        ring_shard.ShardedStep.__call__ = real_call
        shutil.rmtree(SHARD_CKPT_DIR, ignore_errors=True)
    if resumed != straight:
        raise AssertionError(f"ringshard resumed study {resumed} != "
                             f"{straight}")
    for part in ("track", "series"):
        a, b = getattr(ref, part), getattr(again, part)
        for f in a._fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"ringshard resumed study: {part}.{f} "
                                     "differs")
    require_same("ringshard resumed study state", pmesh.assemble(ref.state),
               pmesh.assemble(again.state))
    if {k: v for k, v in one.items() if k != "engine"} != \
            {k: v for k, v in straight.items() if k != "engine"}:
        raise AssertionError(f"ringshard study {straight} != ring {one}")
    emit(phase="ringshard", part="study", n_nodes=N, shards=SHARDS,
         periods=SHARD_STUDY_PERIODS, ring_probe=straight["ring_probe"],
         chunk=SHARD_STUDY_CHUNK, snapshots=snaps,
         resumed_at=2 * SHARD_STUDY_CHUNK, summaries_equal=True,
         track_series_state_bitwise=True, equal_to_ring=True,
         **{k: straight.get(k) for k in ("crashed", "suspect_detected",
                                         "suspect_latency_mean",
                                         "false_dead_views_final")},
         study_periods_per_sec=SHARD_STUDY_PERIODS / wall,
         seconds=time.perf_counter() - t0, card=card)


def shard_memwall(card: str) -> None:
    """memwall's streaming-study accounting at N (pull, 12 periods) on
    `ringshard` and on one device in the same call: both measured, each
    peak at least its state and inside the card's memory, the sharded
    peak within SHARD_MEMWALL_RATIO of one device's (the shards hold
    the state once, and no exchange stacks every shard's block)."""
    t0 = time.perf_counter()
    reps = {e: memwall.study_memory_analysis(N, engine=e, device="cuda")
            for e in ("ring", "ringshard")}
    for e, rep in reps.items():
        if (not rep["measured"] or not rep["fits_budget"]
                or rep["total_bytes"] < rep["state_bytes"]):
            raise AssertionError(f"ringshard: memwall {e} report {rep}")
    sh = reps["ringshard"]
    if sh["shards"] != SHARDS or sh["shard_state_bytes"] * SHARDS != \
            sh["state_bytes"]:
        raise AssertionError(f"ringshard: memwall shards {sh}")
    ratio = sh["total_bytes"] / reps["ring"]["total_bytes"]
    if ratio > SHARD_MEMWALL_RATIO:
        raise AssertionError(f"ringshard: memwall peak {ratio:.4f} of one "
                             f"device's, over {SHARD_MEMWALL_RATIO}")
    keys = ("state_bytes", "argument_bytes", "output_bytes", "temp_bytes",
            "total_bytes", "budget_fraction")
    emit(phase="ringshard", part="memwall", n_nodes=N, shards=SHARDS,
         periods=sh["periods"], ring_probe=sh["ring_probe"],
         shard_state_bytes=sh["shard_state_bytes"],
         ringshard={k: sh[k] for k in keys},
         one_device={k: reps["ring"][k] for k in keys},
         peak_ratio=ratio,
         seconds=time.perf_counter() - t0, card=card)


def shard_timing(card: str) -> None:
    """Wall and busy ms a period, idle share and kernels a period of the
    default SwimConfig at N: one device and D shards in
    the same call, SHARD_TIMED_PERIODS periods each after a warm-up,
    bare for the wall and again under torch.profiler for the busy ms."""
    from torch.profiler import ProfilerActivity, profile
    cfg = SwimConfig(n_nodes=N, **SHARD_CONFIGS["wave"])
    plan = crash_plan(cfg, 2 * SHARD_TIMED_PERIODS)
    single = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, 1)
    placed = shard_run(cfg, plan, 1)
    placed_plan = shard_place(cfg, plan)[1]
    sharded = ring_shard.build_run(cfg, shard_mesh(), SHARD_TIMED_PERIODS)
    arms = {
        "one_device": lambda: ring.run(cfg, single._replace(
            cold=single.cold.clone()), plan, 0, SHARD_TIMED_PERIODS),
        "ringshard": lambda: sharded(placed._replace(cold=pmesh.Sharded(
            [b.clone() for b in placed.cold.blocks], placed.cold.axis)),
            placed_plan, threefry.key(0)),
    }
    out = {}
    for name, fn in arms.items():
        fn()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / SHARD_TIMED_PERIODS
        launches = read_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            fn()
            torch.cuda.synchronize()
        busy, count = busy_ms(pr)
        busy /= SHARD_TIMED_PERIODS
        out[name] = dict(wall_ms=wall, busy_ms=busy,
                         idle_share=1.0 - busy / wall,
                         kernels_per_period=count / SHARD_TIMED_PERIODS,
                         launches_per_period={
                             k: v / SHARD_TIMED_PERIODS
                             for k, v in launches.items()})
    emit(phase="ringshard", part="timing", n_nodes=N, shards=SHARDS,
         periods=SHARD_TIMED_PERIODS, config="wave", **out,
         card=card)


def ringshard_phase(rows: dict, card: str) -> dict:
    """Phase 16 but its golden digests (`shard_golden`, a `Background`
    job); returns the kernels' launches in the wave-scope sharded parity
    run."""
    t0 = time.perf_counter()
    launches = {}
    placed = None
    for name in SHARD_CONFIGS:
        launches[name], st = shard_parity(name)
        if name == "wave":
            placed = st
    shard_kernels(placed, rows)
    del placed
    shard_no_sync_period()
    shard_study(card)
    shard_memwall(card)
    shard_timing(card)
    emit(phase="ringshard", part="done", seconds=time.perf_counter() - t0,
         card=card)
    return launches["wave"]


# ------------------------------------------------------- phase 17: shard

SHARD_LOSS = 0.1
SHARD_FP_N = 100_000
SHARD_FP_PERIODS = 20


def shard_cfg_plan(loss: float):
    """The default SwimConfig at N, 0.1% crashing in the first
    PARITY_PERIODS periods, under `loss`."""
    cfg = SwimConfig(n_nodes=N)
    return cfg, faults.with_loss(crash_plan(cfg, PARITY_PERIODS), loss)


def placed_equal(what: str, placed, whole) -> int:
    """Every field of a placed RumorState, block by block, equal to the
    matching rows of a single-device state (no assembled copy)."""
    for f in rumor.RumorState._fields:
        leaf, want = getattr(placed, f), getattr(whole, f)
        s = want.shape[0] // len(leaf.blocks) if leaf.axis == 0 else 0
        for i, b in enumerate(leaf.blocks):
            w = want if leaf.axis is None else want[i * s:(i + 1) * s]
            if not torch.equal(b, w):
                raise AssertionError(f"{what}: {f} differs on shard {i}")
    return len(rumor.RumorState._fields)


def shard_rumor_parity() -> None:
    """PARITY_PERIODS periods at N on D shards against rumor.step on one
    device: all 12 fields equal every period; then one more sharded
    period under PyTorch's sync check set to raise."""
    t0 = time.perf_counter()
    cfg, plan = shard_cfg_plan(SHARD_LOSS)
    _, st, pl, step = shard_engine.start(cfg, plan, "cuda")
    single = rumor.init_state(cfg, "cuda")
    key = threefry.key(0)
    for t in range(PARITY_PERIODS):
        rnd = rumor.draw_period_rumor(key, t, cfg, "cuda")
        st = step(st, pl, rnd)
        single = rumor.step(cfg, single, plan, rnd)
        fields = placed_equal(f"shard period {t}", st, single)
    used = single.subject >= 0
    stats = dict(rumors=int(used.sum()),
                 suspects=int((used & lattice.is_suspect(single.rkey)).sum()),
                 overflow=int(single.overflow))
    del single
    rnd = rumor.draw_period_rumor(key, PARITY_PERIODS, cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(st, pl, rnd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit(phase="shard", part="parity", n_nodes=N, shards=SHARDS,
         periods=PARITY_PERIODS, loss=SHARD_LOSS, fields_equal=fields,
         no_sync_period=True, **stats, seconds=time.perf_counter() - t0)


def w2_excess(plan, rnd, n_loc: int) -> int:
    """The acks of period 0 that exchange_slack=1 cannot carry: the pings
    delivered to each shard's rows beyond its n_loc W2 slots (uniform
    targets; at period 0 no node believes another dead)."""
    ids = torch.arange(N, dtype=torch.int32, device="cuda")
    idx = (rnd.base.target_u * float(N - 1)).to(torch.int32).clamp(max=N - 2)
    tgt = idx + (idx >= ids).to(torch.int32)
    up = plan.crash_step > 0
    ok = up & up[tgt.long()] & (rnd.base.loss_w1 >= plan.loss)
    per = torch.bincount((tgt[ok] // n_loc).long(), minlength=SHARDS)
    return int((per - n_loc).clamp(min=0).sum())


def shard_overflow() -> None:
    """exchange_slack=1 at N without loss (at loss 0.1 the acks stay
    under their slots): period 0 from the same state as the lossless
    engine, whose overflow it exceeds by exactly the acks its W2 blocks
    cannot hold; then PARITY_PERIODS - 1 more periods, every field in
    its range."""
    t0 = time.perf_counter()
    cfg, plan = shard_cfg_plan(0.0)
    mesh, st0, pl, lossless = shard_engine.start(cfg, plan, "cuda")
    tight = shard_engine.build_step(cfg, mesh, exchange_slack=1)
    key = threefry.key(0)
    rnd = rumor.draw_period_rumor(key, 0, cfg, "cuda")
    base = int(lossless(st0, pl, rnd).overflow.blocks[0])
    st = tight(st0, pl, rnd)
    del st0
    dropped = int(st.overflow.blocks[0]) - base
    want = w2_excess(plan, rnd, N // SHARDS)
    if want == 0 or dropped != want:
        raise AssertionError(f"shard slack 1: overflow grew by {dropped}, "
                             f"{want} acks over their slots")
    for t in range(1, PARITY_PERIODS):
        st = tight(st, pl, rumor.draw_period_rumor(key, t, cfg, "cuda"))
    w = pmesh.assemble(st._replace(knows=None))
    t = PARITY_PERIODS
    used = w.subject >= 0
    bad = {
        "subject": bool(((w.subject < -1) | (w.subject >= N)).any()),
        "sent_node": bool(((w.sent_node < -1) | (w.sent_node >= N)).any()),
        "birth": bool((used & ((w.birth < 0) | (w.birth >= t))).any()),
        "sent_time": bool(((w.sent_node >= 0) & ((w.sent_time < 0)
                                                 | (w.sent_time >= t)))
                          .any()),
        "lha": bool(((w.lha < 0) | (w.lha > cfg.lha_max)).any()),
        "inc_self": bool(u32.ugt(w.inc_self, t).any()),
        "rkey": bool((used & (lattice.incarnation_of(w.rkey) > t)).any()),
        "step": int(w.step) != t, "overflow": int(w.overflow) <= base}
    if any(bad.values()):
        raise AssertionError(f"shard slack 1: fields out of range {bad}")
    emit(phase="shard", part="overflow", n_nodes=N, shards=SHARDS,
         exchange_slack=1, loss=0.0, periods=t, w2_acks_dropped=dropped,
         overflow_lossless_period0=base, overflow=int(w.overflow),
         fields_in_range=len(bad), seconds=time.perf_counter() - t0)


def shard_rumor_golden() -> None:
    t0 = time.perf_counter()
    for name in ("rumor", "rumor_lifeguard"):
        got = golden.digest(golden.engine_run("cuda", name, sharded=True))
        if got != golden.ENGINE_DIGESTS[name]:
            raise AssertionError(f"shard golden '{name}' {got} != "
                                 f"{golden.ENGINE_DIGESTS[name]}")
    emit(phase="shard", part="golden", shards=SHARDS,
         digests=["rumor", "rumor_lifeguard"],
         seconds=time.perf_counter() - t0)


def shard_fp_study(card: str) -> None:
    """fp_sweep at SHARD_FP_N nodes on `shard` and on `rumor`: equal but
    for the engine's name; wall ms per study period of each."""
    kw = dict(n=SHARD_FP_N, periods=SHARD_FP_PERIODS, device="cuda")
    out, wall = {}, {}
    for engine in ("rumor", "shard"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[engine] = experiments.fp_sweep(engine=engine, **kw)
        torch.cuda.synchronize()
        wall[engine] = time.perf_counter() - t0
    if out["shard"].pop("engine") != "shard" or out["shard"] != \
            {k: v for k, v in out["rumor"].items() if k != "engine"}:
        raise AssertionError(f"shard fp_sweep {out['shard']} != rumor "
                             f"{out['rumor']}")
    periods = SHARD_FP_PERIODS * len(out["rumor"]["points"])
    emit(phase="shard", part="study", study="fp_sweep", n_nodes=SHARD_FP_N,
         study_periods=periods, equal_to_rumor=True,
         wall_ms_per_study_period={e: w * 1e3 / periods
                                   for e, w in wall.items()},
         points=out["rumor"]["points"], card=card)


def shard_census_peaks() -> dict:
    """The peak memory of one 1M sharded study period whose census sums
    each shard's knower counts (runner's) and of the same period whose
    census reads the assembled state, from one warm placed state."""
    cfg, plan = shard_cfg_plan(SHARD_LOSS)
    _, st, pl, step = shard_engine.start(cfg, plan, "cuda")
    key = threefry.key(0)
    res = runner.run_study_rumor(cfg, st, pl, key, 1, step)
    base = faults.base_of(plan)
    rnd = rumor.draw_period_rumor(key, 1, cfg, "cuda")
    steppers = {
        "per_shard": runner.make_stepper(cfg, pl, rumor.step, step),
        "assembled": lambda s, r: (pmesh.assemble(step(s, pl, r)), None)}
    peaks, rows = {}, {}
    for name, stepper in steppers.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, _, row, _ = runner.rumor_study_period(cfg, res.state, res.track,
                                                 base, rnd, stepper)
        torch.cuda.synchronize()
        rows[name] = [int(x) for x in row]
        peaks[name] = torch.cuda.max_memory_allocated() - before
    if rows["per_shard"] != rows["assembled"]:
        raise AssertionError(f"shard census rows differ {rows}")
    return peaks


def shard_rumor_timing(card: str) -> dict:
    """SHARD_TIMED_PERIODS periods at N after one warm-up period: the
    sharded engine and rumor.run on one device, each with only its own
    state on the card: wall, device busy (torch.profiler), idle share,
    kernels a period, peak memory; the port's kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    cfg, plan = shard_cfg_plan(SHARD_LOSS)
    key = threefry.key(0)

    def one_device():
        st = rumor.run(cfg, rumor.init_state(cfg, "cuda"), plan, 0, 1)
        return lambda: rumor.run(cfg, st, plan, 0, SHARD_TIMED_PERIODS)

    def sharded():
        mesh, st, pl, _ = shard_engine.start(cfg, plan, "cuda")
        st = shard_engine.build_run(cfg, mesh, 1)(st, pl, key)
        run = shard_engine.build_run(cfg, mesh, SHARD_TIMED_PERIODS)
        return lambda: run(st, pl, key)

    out = {}
    for name, make in (("one_device", one_device), ("shard", sharded)):
        fn = make()
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / SHARD_TIMED_PERIODS
        peak = torch.cuda.max_memory_allocated()
        launches = read_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            fn()
            torch.cuda.synchronize()
        busy, count = busy_ms(pr)
        busy /= SHARD_TIMED_PERIODS
        out[name] = dict(wall_ms=wall, busy_ms=busy,
                         idle_share=1.0 - busy / wall,
                         kernels_per_period=count / SHARD_TIMED_PERIODS,
                         peak_bytes=peak, allocated_before=before,
                         launches=launches,
                         top_ops=top_device_ops(pr, SHARD_TIMED_PERIODS))
        del fn
    return out


def top_device_ops(pr, periods: int, k: int = 8) -> list:
    """The k device activities of a profile with the most time: (name,
    ms a period, calls a period)."""
    ms, calls = {}, {}
    cuda_type = torch.autograd.DeviceType.CUDA
    for e in pr.profiler.kineto_results.events():
        if e.device_type() == cuda_type:
            name = e.name()[:60]
            ms[name] = ms.get(name, 0.0) + e.duration_ns() / 1e6
            calls[name] = calls.get(name, 0) + 1
    top = sorted(ms, key=ms.get, reverse=True)[:k]
    return [(nm, ms[nm] / periods, calls[nm] / periods) for nm in top]


def shard_phase(card: str, start_children: Callable[[], None]) -> dict:
    """Phase 17: the exchange-sharded rumor engine at N on D shards;
    returns the port's kernel launches over the phase (none).  Its
    timing runs first: it is the script's last measurement of the
    card's and the host's time, so `start_children()` (the `Background`
    checks) is called just after it."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    peaks = shard_census_peaks()
    timing = shard_rumor_timing(card)
    launched = {k: v for arm in timing.values()
                for k, v in arm["launches"].items() if v}
    if launched:
        raise AssertionError(f"shard timing: the port's kernels launched "
                             f"{launched}")
    emit(phase="shard", part="timing", n_nodes=N, shards=SHARDS,
         periods=SHARD_TIMED_PERIODS, loss=SHARD_LOSS, **timing,
         census_peak_bytes=peaks, card=card)
    start_children()
    torch.cuda.synchronize()
    reset_launches()
    shard_rumor_parity()
    shard_overflow()
    shard_rumor_golden()
    shard_fp_study(card)
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"shard: the port's kernels launched "
                             f"{launches}")
    emit(phase="shard", part="done", launches=launches,
         seconds=time.perf_counter() - t0, card=card)
    return launches


# ------------------------------------------- checks run in child processes

BACKGROUND_TIMEOUT_S = 900


class Background:
    """One check of this script (`call`, a call of a function here) run
    in a child process while the script goes on: two host-paced checks
    (the search's report digest, the sharded golden digests) overlap
    phases 17-19 this way, after the last timing.  The child's JSON
    lines are printed when it is joined, each marked `"contended":
    true` (it ran beside this process), and a child that fails fails
    the script.  It counts no launch of this process."""

    def __init__(self, name: str, call: str):
        import tempfile

        self.name = name
        self.out = tempfile.TemporaryFile()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as c; c.{call}"],
            cwd=REPO, stdout=self.out, stderr=subprocess.STDOUT)
        CHILDREN.append(self)

    def join(self) -> None:
        rc = self.proc.wait(timeout=BACKGROUND_TIMEOUT_S)
        self.out.seek(0)
        text = self.out.read().decode(errors="replace")
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        for ln in lines:
            print(json.dumps(dict(json.loads(ln), contended=True)),
                  flush=True)
        if rc != 0 or not lines:
            raise AssertionError(f"{self.name}: child exit {rc}\n"
                                 f"{text[-4000:]}")
        emit(phase="background", part=self.name,
             seconds=time.perf_counter() - self.t0)
        CHILDREN.remove(self)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        if self in CHILDREN:
            CHILDREN.remove(self)


# -------------------------------------------------- phase 19: multidevice

# D = 4 shards alternating between the card and the CPU: every exchange
# crosses a device boundary
MIXED_DEVICES = ["cuda", "cpu", "cuda", "cpu"]
MULTI_PERIODS = 2
MULTI_WAVE_N = N
MULTI_RUMOR_N = 100_000
MULTI_RUMOR_R = 4096
MULTI_RUMOR_PERIODS = 3
MULTI_STUDY_N = N
MULTI_STUDY_PERIODS = 4
MULTI_STUDY_CHUNK = 2
MULTI_TIMED_PERIODS = 5
MULTI_AUDIT_N = 512     # the audit's wire_n
MULTI_CKPT_DIR = Path(__file__).resolve().parent / "_multi_ckpt"


def card_shards(mesh) -> int:
    return sum(d.type == "cuda" for d in mesh.devices)


def mesh_ring_run(cfg, plan, mesh, periods: int, seed: int = 0):
    """`periods` sharded periods on `mesh` from init, drawn as ring.run
    draws them: (placed state, shard 0's exchange record, the bytes the
    mesh copied between devices, the kernels' launches), launches and
    bytes zeroed just before the run and read just after."""
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cuda"), plan)
    step = ring_shard.mapped_step(cfg, mesh)
    step.record = []
    torch.cuda.synchronize()
    reset_launches()
    mesh.copied_bytes = 0
    for rnd, shifts in ring.period_draws(cfg, threefry.key(seed), 0, periods,
                                         "cuda"):
        st = step(st, pl, rnd, shifts)
    torch.cuda.synchronize()
    return st, pl, step.record, mesh.copied_bytes, read_launches()


def copy_row(cfg, mesh, record: list, copied: int, periods: int) -> dict:
    """The bytes copied between devices a period against the mesh's
    model of the recorded exchanges (they must be equal: each permute
    copies the posts its shards read from another device), the bill of
    obs/ici.py for D shards, and the fetch factor (copied over the bytes
    the reference's layout moves into the D shards): of every exchange,
    of the rolls (and the compact wire's blocks) and of the pull ring
    passes (None where the record has none).  On a mesh of distinct
    cards the rolls' factor must be at most 1."""
    from swim_tpu_torch.analysis import audit

    model = ring_shard.mesh_copy_bytes(record, mesh)
    if copied != model:
        raise AssertionError(f"multidevice: copied {copied} bytes, the "
                             f"mesh's model of the exchanges {model}")
    ref = mesh.size * sum(audit.family_bytes(record).values())
    perms = [e for e in record if e["op"] == "ppermute"]

    def factor(entries):
        moved = mesh.size * sum(audit.family_bytes(entries).values())
        return (ring_shard.mesh_copy_bytes(entries, mesh) / moved
                if moved else None)

    rolls = factor([e for e in perms if "ring_pass" not in e["terms"]])
    passes = factor([e for e in perms if "ring_pass" in e["terms"]])
    if (len(mesh.distinct) == mesh.size and rolls is not None
            and rolls > 1.0):
        raise AssertionError(f"multidevice: the rolls' fetch factor "
                             f"{rolls} over {mesh.size} cards exceeds 1")
    bill = ici.trace_ici_bytes(cfg, mesh.size)["per_chip_bytes_per_period"]
    return dict(copied_bytes_per_period=copied / periods,
                model_bytes_per_period=model / periods,
                reference_bytes_per_period=ref / periods,
                bill_per_chip_per_period=bill,
                bill_all_shards_per_period=bill * mesh.size,
                fetch_factor=copied / ref, fetch_factor_rolls=rolls,
                fetch_factor_ring_passes=passes)


def multi_ring_part(name: str, kw: dict, n: int) -> dict:
    """ringshard on the mixed mesh at `n` nodes for MULTI_PERIODS
    periods against ring.run on the card, every field bitwise; the three
    kernels launched on the card shards only; the captured inputs of
    their card calls in one more period against the plain versions."""
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh(devices=MIXED_DEVICES)
    cfg = SwimConfig(n_nodes=n, **kw)
    plan = crash_plan(cfg, MULTI_PERIODS)
    torch.cuda.synchronize()
    reset_launches()
    single = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0,
                      MULTI_PERIODS)
    torch.cuda.synchronize()
    one = read_launches()
    placed, pl, record, copied, launches = mesh_ring_run(
        cfg, plan, mesh, MULTI_PERIODS)
    run_s = time.perf_counter() - t0
    fields = require_same(f"multidevice {name}: mixed mesh against one "
                          "card", pmesh.assemble(placed), single)
    c = card_shards(mesh)
    want = {"selb": c * one["selb"], "coldsel": c * one["coldsel"],
            "wavemerge": c * MULTI_PERIODS * shard_merge_launches(cfg)}
    if launches != want or one["selb"] == 0:
        raise AssertionError(f"multidevice {name}: launches {launches}, "
                             f"one card {one}, expected {want}")
    got = capture_shard_period(cfg, placed, pl, MULTI_PERIODS, mesh)
    got = {k: [a for a in v if a[0].is_cuda] for k, v in got.items()}
    err = check_captured(f"multidevice {name}", got)
    row = dict(phase="multidevice", part="ringshard", config=name,
               n_nodes=n, shards=mesh.size, devices=MIXED_DEVICES,
               periods=MULTI_PERIODS, fields_equal=fields,
               launches=launches, launches_one_card=one,
               kernels_checked={k: len(v) for k, v in got.items()},
               max_abs_err=err,
               **copy_row(cfg, mesh, record, copied, MULTI_PERIODS),
               run_seconds=run_s, seconds=time.perf_counter() - t0)
    emit(**row)
    return launches


def multi_rumor_part() -> None:
    """The exchange-sharded rumor engine on the mixed mesh against
    rumor.run on the card: every field bitwise; no kernel of the port."""
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh(devices=MIXED_DEVICES)
    cfg = SwimConfig(n_nodes=MULTI_RUMOR_N, rumor_capacity=MULTI_RUMOR_R)
    plan = faults.with_loss(crash_plan(cfg, MULTI_RUMOR_PERIODS), SHARD_LOSS)
    single = rumor.run(cfg, rumor.init_state(cfg, "cuda"), plan, 0,
                       MULTI_RUMOR_PERIODS)
    st, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cuda"),
                                plan)
    torch.cuda.synchronize()
    reset_launches()
    mesh.copied_bytes = 0
    placed = shard_engine.build_run(cfg, mesh, MULTI_RUMOR_PERIODS)(
        st, pl, 0)
    torch.cuda.synchronize()
    launches = read_launches()
    copied = mesh.copied_bytes
    fields = require_same("multidevice shard: mixed mesh against one card",
                          pmesh.assemble(placed), single)
    if any(launches.values()):
        raise AssertionError(f"multidevice shard: launches {launches}")
    emit(phase="multidevice", part="shard", n_nodes=MULTI_RUMOR_N,
         rumor_slots=cfg.rumor_slots, loss=SHARD_LOSS, shards=mesh.size,
         devices=MIXED_DEVICES, periods=MULTI_RUMOR_PERIODS,
         fields_equal=fields, launches=launches,
         copied_bytes_per_period=copied / MULTI_RUMOR_PERIODS,
         rumors=int((single.subject >= 0).sum()),
         seconds=time.perf_counter() - t0)


class _StopAfterSnapshot(runner.StudyCheckpointer):
    """Stops the study right after its first snapshot lands."""

    def save(self, *a, **kw):
        super().save(*a, **kw)
        raise Interrupted


def multi_study_part() -> dict:
    """The streaming pull study (the study default) of ringshard:
    checkpointed on the 8 slots of the card and stopped after its first
    chunk, resumed on the mixed mesh; summary, track and series equal
    the one-card ring study's."""
    t0 = time.perf_counter()
    n, periods = MULTI_STUDY_N, MULTI_STUDY_PERIODS
    cfg = SwimConfig(n_nodes=n, ring_probe="pull")
    plan = experiments._crash_plan(n, 0, CRASH_FRACTION, periods, "cuda")
    key = threefry.key(0)
    one = runner.run_study_ring_stream(cfg, ring.init_state(cfg, "cuda"),
                                       plan, key, periods,
                                       chunk=MULTI_STUDY_CHUNK)
    shutil.rmtree(MULTI_CKPT_DIR, ignore_errors=True)
    try:
        card8 = shard_mesh()
        st, pl = ring_shard.place(cfg, card8, ring.init_state(cfg, "cuda"),
                                  plan)
        try:
            runner.run_study_ring_stream(
                cfg, st, pl, key, periods, ring_shard.mapped_step(cfg, card8),
                ckpt=_StopAfterSnapshot(str(MULTI_CKPT_DIR),
                                        every=MULTI_STUDY_CHUNK))
            raise AssertionError("multidevice: the checkpointed study was "
                                 "not stopped")
        except Interrupted:
            pass
        snaps = sorted(p.name for p in MULTI_CKPT_DIR.iterdir())
        mesh = pmesh.make_mesh(devices=MIXED_DEVICES)
        st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cuda"),
                                  plan)
        step = ring_shard.mapped_step(cfg, mesh)
        step.record = []
        torch.cuda.synchronize()
        reset_launches()
        mesh.copied_bytes = 0
        res = runner.run_study_ring_stream(
            cfg, st, pl, key, periods, step,
            ckpt=runner.StudyCheckpointer(str(MULTI_CKPT_DIR),
                                          every=MULTI_STUDY_CHUNK))
        torch.cuda.synchronize()
        launches = read_launches()
        copied = mesh.copied_bytes
    finally:
        shutil.rmtree(MULTI_CKPT_DIR, ignore_errors=True)
    a = runner.detection_summary(one, plan, periods)
    b = runner.detection_summary(res, plan, periods)
    if a != b:
        raise AssertionError(f"multidevice study: resumed {b} != one card "
                             f"{a}")
    for part in ("track", "series"):
        x, y = getattr(one, part), getattr(res, part)
        for f in x._fields:
            if not torch.equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"multidevice study: {part}.{f} "
                                     "differs")
    resumed = periods - MULTI_STUDY_CHUNK
    copies = copy_row(cfg, mesh, step.record, copied, resumed)
    want = {"selb": card_shards(mesh) * resumed, "coldsel": 0,
            "wavemerge": 0}
    if launches != want:
        raise AssertionError(f"multidevice study: launches {launches}, "
                             f"expected {want}")
    emit(phase="multidevice", part="study", n_nodes=n, periods=periods,
         chunk=MULTI_STUDY_CHUNK, ring_probe="pull", snapshots=snaps,
         saved_on="8 slots of the card", resumed_on=MIXED_DEVICES,
         summaries_equal=True, track_series_bitwise=True,
         launches=launches, **copies,
         crashed=b.get("crashed"), seconds=time.perf_counter() - t0)
    return launches


def audit_wire_rows(mesh) -> dict:
    """`analysis/audit.sharded_wire_arms` at MULTI_AUDIT_N nodes on
    `mesh`: every row must pass and every arm copy its model's bytes
    (more than none where the mesh has two devices); returns the bytes
    copied, their model and the fetch factor of each arm."""
    from swim_tpu_torch.analysis import audit

    rows = []
    out = audit.sharded_wire_arms(mesh, MULTI_AUDIT_N,
                                  lambda *row: rows.append(row))
    bad = [row for row in rows if not row[2]]
    if bad or out["unattributed"]:
        raise AssertionError(f"multidevice audit on {mesh}: failing rows "
                             f"{bad}, unattributed {out['unattributed']}")
    for arm, c in out["copies"].items():
        if c["copied"] != c["model"] or (len(mesh.distinct) > 1
                                         and not c["copied"]):
            raise AssertionError(f"multidevice audit {arm}: {c}")
    return out["copies"]


def multi_audit_part() -> dict:
    """The audit's sharded wire arms on the mixed mesh (`audit_wire_rows`;
    the sync check covers all-card meshes only); returns the kernels'
    launches on its card shards."""
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh(devices=MIXED_DEVICES)
    torch.cuda.synchronize()
    reset_launches()
    copies = audit_wire_rows(mesh)
    torch.cuda.synchronize()
    launches = read_launches()
    if not (launches["selb"] and launches["coldsel"]):
        raise AssertionError(f"multidevice audit: card-shard launches "
                             f"{launches}")
    emit(phase="multidevice", part="audit", n_nodes=MULTI_AUDIT_N,
         shards=mesh.size, copies=copies, launches=launches,
         seconds=time.perf_counter() - t0)
    return launches


def all_cards_part(card: str) -> None:
    """make_mesh() over every card, where there are two or more: wave
    scope at N against one card, bitwise; wall a period beside one card;
    each card's peak in the sharded study (memwall); one sharded period
    under PyTorch's sync check."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit(phase="multidevice", part="all_cards", run=False, cards=cards)
        return
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh()
    cfg = SwimConfig(n_nodes=N)
    plan = crash_plan(cfg, MULTI_PERIODS)
    single = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0,
                      MULTI_PERIODS)
    placed, pl, record, copied, launches = mesh_ring_run(
        cfg, plan, mesh, MULTI_PERIODS)
    fields = require_same("multidevice all cards: against one card",
                          pmesh.assemble(placed), single)
    copies = copy_row(cfg, mesh, record, copied, MULTI_PERIODS)
    run = ring_shard.build_run(cfg, mesh, MULTI_TIMED_PERIODS)
    walls = {}
    for name, fn in (
            ("one_card", lambda: ring.run(cfg, single, plan, 0,
                                          MULTI_TIMED_PERIODS)),
            ("all_cards", lambda: run(placed, pl, threefry.key(0)))):
        fn()
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        t1 = time.perf_counter()
        fn()
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
        walls[name] = (time.perf_counter() - t1) * 1e3 / MULTI_TIMED_PERIODS
    audit_copies = audit_wire_rows(mesh)
    rep = memwall.study_memory_analysis(N, engine="ringshard")
    rnd = ring.draw_period_ring(threefry.key(0), MULTI_PERIODS, cfg, "cuda")
    shifts = ring.rotor_offsets(cfg, MULTI_PERIODS)
    step = ring_shard.mapped_step(cfg, mesh)
    for d in mesh.distinct:
        torch.cuda.synchronize(d)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(placed, pl, rnd, shifts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emit(phase="multidevice", part="all_cards", run=True, cards=cards,
         n_nodes=N, shards=mesh.size, fields_equal=fields,
         launches=launches, **copies, wall_ms_per_period=walls,
         device_peaks=rep["device_peaks"],
         fullest_device=rep["fullest_device"], host_syncs_in_a_period=0,
         audit=audit_copies,
         seconds=time.perf_counter() - t0, card=card)


def multidevice_phase(card: str) -> dict:
    """Phase 19 but its all-card part (`all_cards_part`, run once the
    children have been joined); returns the kernels' launches on the
    card shards of the mixed mesh's runs (ringshard in both scopes, the
    resumed study, the audit's wire arms)."""
    t0 = time.perf_counter()
    launches = {"selb": 0, "coldsel": 0, "wavemerge": 0}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    add(multi_ring_part("period", dict(ring_sel_scope="period"), N))
    add(multi_ring_part("wave", {}, MULTI_WAVE_N))
    multi_rumor_part()
    add(multi_study_part())
    add(multi_audit_part())
    emit(phase="multidevice", part="done", launches=launches,
         seconds=time.perf_counter() - t0, card=card)
    return launches


# ---------------------------------------------------- phase 20: partition

# the dense, ring and rumor engines partitioned over the mixed mesh
# (parallel/partition.py), each against one card
PART_PERIODS = 3
PART_DENSE_N = experiments.DENSE_MAX
PART_DENSE_CRASHES = 0.01
PART_RUMOR_N = 100_000
PART_RUMOR_R = 4096
PART_RING_N = 100_000
PART_ALL_PERIODS = 4


@contextlib.contextmanager
def default_mesh(mesh):
    """`pmesh.make_mesh()` gives `mesh` inside the block: the studies'
    router sees its devices as the machine's."""
    real = pmesh.make_mesh
    pmesh.make_mesh = lambda *a, **kw: mesh
    try:
        yield mesh
    finally:
        pmesh.make_mesh = real


def zero_counts(mesh) -> None:
    torch.cuda.synchronize()
    reset_launches()
    mesh.copied_bytes = mesh.rendezvous = 0


def mesh_counts(mesh, periods: int) -> dict:
    return dict(copied_bytes_per_period=mesh.copied_bytes / periods,
                rendezvous_per_period=mesh.rendezvous / periods)


def part_rows_engine(name: str, cfg, plan) -> dict:
    """`name` ("dense" or "rumor", cfg.telemetry on) for PART_PERIODS
    periods on one card and partitioned on the mixed mesh, from init
    with the same draws: every field and every period's EngineFrame
    equal; no kernel of the port launched."""
    t0 = time.perf_counter()
    model, draw = {"dense": (dense, prng.draw_period),
                   "rumor": (rumor, rumor.draw_period_rumor)}[name]
    mesh = pmesh.make_mesh(devices=MIXED_DEVICES)
    rnds = [draw(threefry.key(0), t, cfg, "cuda")
            for t in range(PART_PERIODS)]
    one, one_frames = model.init_state(cfg, "cuda"), []
    for rnd in rnds:
        tap = {}
        one = model.step(cfg, one, plan, rnd, tap=tap)
        one_frames.append(obs_engine.frame_from_tap(tap, "cuda"))
    st, pl = partition.place(cfg, mesh, name, model.init_state(cfg, "cuda"),
                             plan)
    step = partition.build_step(cfg, mesh, name)
    zero_counts(mesh)
    t1 = time.perf_counter()
    frames = []
    for rnd in rnds:
        st, frame = step(st, pl, rnd)
        frames.append(frame)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = read_launches()
    counts = mesh_counts(mesh, PART_PERIODS)
    fields = require_same(f"partition {name}: mixed mesh against one card",
                          pmesh.assemble(st), one)
    for t, (a, b) in enumerate(zip(frames, one_frames)):
        require_same(f"partition {name}: frame of period {t}", a, b)
    if any(launches.values()):
        raise AssertionError(f"partition {name}: launches {launches}")
    return dict(phase="partition", part=name, n_nodes=cfg.n_nodes,
                shards=mesh.size, devices=MIXED_DEVICES,
                periods=PART_PERIODS, fields_equal=fields,
                frames_equal=len(frames), launches=launches,
                card_shard_launches={"selb": 0, "coldsel": 0,
                                     "wavemerge": 0}, **counts,
                run_seconds=run_s, seconds=time.perf_counter() - t0)


def part_dense() -> None:
    """Dense at DENSE_MAX (the study's default geometry), 1% crashes."""
    cfg = SwimConfig(n_nodes=PART_DENSE_N, telemetry=True)
    emit(**part_rows_engine("dense", cfg, crash_plan(
        cfg, PART_PERIODS, PART_DENSE_CRASHES)),
        crash_fraction=PART_DENSE_CRASHES)


def part_rumor() -> None:
    """Rumor at 100,000 nodes, R = 4,096, loss 0.1, with a join
    schedule (200 nodes joining at periods 1 and 2) and a FaultProgram
    with segments: neither of which the `shard` engine takes."""
    n = PART_RUMOR_N
    cfg = SwimConfig(n_nodes=n, rumor_capacity=PART_RUMOR_R, telemetry=True)
    plan = faults.with_loss(crash_plan(cfg, PART_PERIODS), SHARD_LOSS)
    late = np.arange(n - 200, n)
    plan = faults.with_joins(plan, late, np.where(late % 2 == 0, 1, 2))
    prog = faults.as_program(plan, np.arange(n) % 4, capacity=2)
    prog = faults.with_segment(prog, 0, start=0, end=PART_PERIODS,
                               kind="gray", level=0.3, domain=1)
    prog = faults.with_segment(prog, 1, start=1, end=PART_PERIODS,
                               kind="link_loss", level=0.2, domain=2)
    emit(**part_rows_engine("rumor", cfg, prog), rumor_slots=cfg.rumor_slots,
         loss=SHARD_LOSS, joins=int(late.size), segments=2)


def part_ring() -> dict:
    """The ring through the studies' router: `_run_study_batch` with two
    FaultProgram lanes at 100,000 nodes (the rotor probe, wave scope),
    `make_mesh()` giving the mixed mesh; each lane equal to its one-card
    serial study; selb and coldsel on the two card shards, twice one
    card's, and wavemerge on them once a wave; the card shards' kernel
    calls of one more period against their plain versions.  Returns the
    batch's launches."""
    t0 = time.perf_counter()
    n = PART_RING_N
    cfg = SwimConfig(n_nodes=n)
    mesh = pmesh.make_mesh(devices=MIXED_DEVICES)
    lossy = faults.as_program(faults.with_loss(
        crash_plan(cfg, PART_PERIODS), SHARD_LOSS), np.arange(n) % 4,
        capacity=1)
    progs = [program_plan(n), faults.with_segment(
        lossy, 0, start=1, end=PART_PERIODS, kind="gray", level=0.3,
        domain=3)]
    keys = [threefry.key(0), threefry.key(1)]
    torch.cuda.synchronize()
    reset_launches()
    one = [experiments._run_study(cfg, prog, key, PART_PERIODS, "ring",
                                  device="cuda")
           for prog, key in zip(progs, keys)]
    torch.cuda.synchronize()
    one_launches = read_launches()
    zero_counts(mesh)
    t1 = time.perf_counter()
    with default_mesh(mesh):
        batch = experiments._run_study_batch(cfg, progs, keys, PART_PERIODS,
                                             "ring")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = read_launches()
    periods = PART_PERIODS * len(progs)
    counts = mesh_counts(mesh, periods)
    fields = sum(require_same(f"partition ring: lane {p} against its "
                              "one-card study", runner.lane_result(batch, p),
                              one[p]) for p in range(len(progs)))
    c = card_shards(mesh)
    want = {"selb": c * one_launches["selb"],
            "coldsel": c * one_launches["coldsel"],
            "wavemerge": c * periods * shard_merge_launches(cfg)}
    if launches != want or not one_launches["coldsel"]:
        raise AssertionError(f"partition ring: launches {launches}, one "
                             f"card {one_launches}, expected {want}")
    placed, pl = ring_shard.place(cfg, mesh, one[1].state, progs[1])
    got = capture_shard_period(cfg, placed, pl, PART_PERIODS, mesh)
    got = {k: [a for a in v if a[0].is_cuda] for k, v in got.items()}
    if not all(got.values()):
        raise AssertionError(f"partition ring: captured card calls "
                             f"{ {k: len(v) for k, v in got.items()} }")
    err = check_captured("partition ring", got)
    emit(phase="partition", part="ring", n_nodes=n, shards=mesh.size,
         devices=MIXED_DEVICES, lanes=len(progs), periods=PART_PERIODS,
         routed_by="experiments._run_study_batch", fields_equal=fields,
         launches=launches, launches_one_card=one_launches,
         card_shard_launches=launches,
         kernels_checked={k: len(v) for k, v in got.items()},
         max_abs_err=err,
         **counts, run_seconds=run_s, seconds=time.perf_counter() - t0)
    return launches


def partition_phase(card: str) -> dict:
    """Phase 20 but its all-card part (`partition_all_cards`); returns
    the kernels' launches on the card shards of its runs."""
    t0 = time.perf_counter()
    part_dense()
    part_rumor()
    launches = part_ring()
    emit(phase="partition", part="done", launches=launches,
         seconds=time.perf_counter() - t0, card=card)
    return launches


def partition_all_cards(card: str) -> None:
    """The 1M rumor detection study through make_mesh(), where PyTorch
    sees two or more cards, against the one-card study: state, track
    and series bitwise; each card's peak."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit(phase="partition", part="all_cards", run=False, cards=cards)
        return
    t0 = time.perf_counter()
    cfg = SwimConfig(n_nodes=N)
    # detection_study's plan at its default 1% crashes
    plan = experiments._crash_plan(N, 0, 0.01, PART_ALL_PERIODS, "cuda:0")
    key = threefry.key(0)
    one = experiments._run_study(cfg, plan, key, PART_ALL_PERIODS, "rumor",
                                 device="cuda:0")
    for i in range(cards):
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    got = experiments._run_study(cfg, plan, key, PART_ALL_PERIODS, "rumor")
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(cards)]
    fields = sum(require_same(f"partition all cards: {part} against one "
                              "card", getattr(got, part), getattr(one, part))
                 for part in ("state", "track", "series"))
    emit(phase="partition", part="all_cards", run=True, cards=cards,
         n_nodes=N, periods=PART_ALL_PERIODS, fields_equal=fields,
         device_peaks=peaks, seconds=time.perf_counter() - t0, card=card)


# ------------------------------------------------ phase 18: audit_oracles

AUDIT_CODE = (
    "import json, sys\n"
    "from swim_tpu_torch import cli\n"
    "from swim_tpu_torch.ops import coldsel, selb, wavemerge\n"
    "rc = cli.main(['audit', '--check', '--json'])\n"
    "print(json.dumps({'selb': selb.launches, 'coldsel': coldsel.launches,\n"
    "                  'wavemerge': wavemerge.launches}), file=sys.stderr)\n"
    "sys.exit(rc)\n")


def audit_run(card: str) -> dict:
    """`swim-tpu-torch audit --check --json` (cli.main) in a subprocess
    on the card: exit 0, every row pass or one of audit.NOT_APPLICABLE's,
    nothing unattributed, no extra build; its exposition has one sample
    line per gauge.  Returns the kernels' launches in the subprocess."""
    from swim_tpu_torch.analysis import audit
    from swim_tpu_torch.obs import expo

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", AUDIT_CODE], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"audit: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    err = proc.stderr.strip().splitlines()
    launches = json.loads(err[-1])
    audit_s = [ln for ln in err if ln.startswith("# audit: ")]
    statuses, na = {}, set()
    for contract, block in report["contracts"].items():
        statuses[contract] = block["status"]
        for row in block["checks"]:
            if row["status"] == "not_applicable":
                na.add((contract, row["arm"]))
            elif row["status"] != "pass":
                raise AssertionError(f"audit: {contract}/{row['arm']} "
                                     f"{row['status']}: {row['detail']}")
    totals = report["totals"]
    if report["platform"] != "cuda" or na != set(audit.NOT_APPLICABLE) \
            or totals["unattributed_collective_bytes"] != 0 \
            or totals["retraces_extra"] != 0 or totals["failures"] != 0 \
            or totals["barrier_chains_missing"] != 0:
        raise AssertionError(f"audit: platform {report['platform']}, "
                             f"not_applicable {sorted(na)}, totals {totals}")
    text = expo.render_audit(report)
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    names = [ln.split("{")[0] for ln in samples]
    if sorted(names) != sorted(audit.AUDIT_GAUGES):
        raise AssertionError(f"audit exposition: sample lines {names}")
    rows = {f"{c}/{r['arm']}": r["detail"]
            for c, b in report["contracts"].items() for r in b["checks"]
            if c in ("barrier_survival", "retrace_budget")}
    emit(phase="audit_oracles", part="audit", wire_n=report["wire_n"],
         retrace_n=report["retrace_n"], shards=report["devices"],
         statuses=statuses, totals=totals, details=rows,
         launches=launches, audit_line=audit_s[-1] if audit_s else None,
         seconds=wall, card=card)
    emit(phase="audit_oracles", part="exposition", text=text,
         sample_lines=len(samples))
    return launches


def oracle_run(name: str, engine, cfg, plan, periods: int, seed: int,
               oracle_cls, draw, to_oracle, compare) -> None:
    """`periods` periods of the port's engine on the card against its
    scalar oracle fed the same draws; `compare(oracle, state as numpy)`
    names the fields that differ."""
    orc = oracle_cls(cfg, plan)
    est = engine.init_state(cfg, "cuda")
    key = threefry.key(seed)
    for t in range(periods):
        rnd = draw(key, t, cfg, "cuda")
        orc.step(to_oracle(rnd))
        est = engine.step(cfg, est, plan, rnd)
        bad = compare(orc, convert.state_to_numpy(est))
        if bad:
            raise AssertionError(f"oracle {name}: {bad} differ at period "
                                 f"{t}")


def _equal_fields(fields):
    def compare(orc, got):
        return [f for f in fields
                if not np.array_equal(np.asarray(getattr(orc.state, f)),
                                      got[f])]
    return compare


ORACLE_CASES = {
    # name: (engine, cfg keywords, crashes, crash periods, loss, periods,
    #        seed); the reference's tests/test_ring.py,
    #        test_dense_vs_oracle.py and test_rumor_vs_scalar.py cases
    "ring_wave": ("ring", dict(n_nodes=32), [5], [2], 0.0, 26, 7),
    "ring_period": ("ring", dict(n_nodes=32, ring_sel_scope="period"), [5],
                    [2], 0.0, 26, 7),
    "ring_pull": ("ring", dict(n_nodes=32, ring_probe="pull"), [5], [2],
                  0.0, 26, 1),
    "dense_stock_demo": ("dense", dict(n_nodes=32, suspicion_mult=2.0),
                         [3, 17], [0, 4], 0.0, 20, 1),
    "rumor_crash_loss": ("rumor", dict(n_nodes=32, rumor_capacity=64), [5],
                         [1], 0.15, 22, 7),
}


def oracles_on_card(card: str) -> dict:
    """The port's engines on the card with the kernels against the port's
    scalar oracles, every period; returns the kernels' launches, which
    must be each rotor path's per period times its periods (pull: one
    selb a period; dense and rumor none)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    want = {"selb": 0, "coldsel": 0, "wavemerge": 0}
    for name, (eng, kw, crashes, at, loss, periods, seed) in \
            ORACLE_CASES.items():
        cfg = SwimConfig(**kw)
        plan = faults.with_crashes(faults.none(cfg.n_nodes, "cuda"),
                                   crashes, at)
        if loss:
            plan = faults.with_loss(plan, loss)
        if eng == "ring":
            oracle_run(name, ring, cfg, plan, periods, seed,
                       ring_oracle.RingOracle, ring.draw_period_ring,
                       ring_oracle.to_numpy, ring_oracle.mismatches)
            per = ({"selb": 1, "coldsel": 0, "wavemerge": 0}
                   if cfg.ring_probe == "pull" else expected_launches(cfg))
            for kn, c in per.items():
                want[kn] += c * periods
        elif eng == "dense":
            oracle_run(name, dense, cfg, plan, periods, seed, oracle.Oracle,
                       prng.draw_period, lambda r: r, _equal_fields(
                           ("key", "retransmit", "deadline", "lha")))
        else:
            oracle_run(name, rumor, cfg, plan, periods, seed,
                       rumor_oracle.RumorOracle, rumor.draw_period_rumor,
                       lambda r: r, _equal_fields(
                           ("knows", "inc_self", "lha", "gone_key",
                            "subject", "rkey", "birth", "sent_node",
                            "sent_time", "confirmed", "overflow", "step")))
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != want:
        raise AssertionError(f"oracles: launches {launches}, expected "
                             f"{want}")
    emit(phase="audit_oracles", part="oracles", cases=list(ORACLE_CASES),
         periods_equal=sum(c[5] for c in ORACLE_CASES.values()),
         launches=launches, seconds=time.perf_counter() - t0, card=card)
    return launches


def audit_oracles_phase(card: str) -> dict:
    """Phase 18: the contract audit and the scalar oracles on the card;
    returns the kernels' launches of each."""
    t0 = time.perf_counter()
    launches = {"audit": audit_run(card), "oracle": oracles_on_card(card)}
    emit(phase="audit_oracles", part="done", launches=launches,
         seconds=time.perf_counter() - t0, card=card)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: PyTorch sees no CUDA device")
    card = card_line()
    emit(phase="card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = _kernels.build()
    emit(phase="build", seconds=build_s, dir=str(_kernels.BUILD_DIR))

    rows = kernel_phase(path_cfg("period"))
    golden_phase()
    launches, captured = {}, {}
    for path in PATHS:
        parity_phase(path)
    for path in PATHS:
        launches[path], captured[path] = throughput_phase(path, card)
    main_inputs_phase(captured, rows)
    launches["pull"] = slice_parity_phase(
        "pull", SwimConfig(n_nodes=N, ring_probe="pull"),
        crash_plan(SwimConfig(n_nodes=N), SLICE_PERIODS),
        {"selb": 1.0, "coldsel": 0.0, "wavemerge": 0.0})
    launches["program"] = slice_parity_phase(
        "program", SwimConfig(n_nodes=N), program_plan(N),
        {k: float(v) for k, v in expected_launches(path_cfg("wave")).items()})
    study_phase(card)
    launches.update(engines_phase(card))
    launches.update(telemetry_phase(card))
    launches.update(scenario_phase(card))
    launches["serve"] = serve_phase(rows, card)
    launches.update(bridge_phase(card))
    launches["instruments"] = instruments_phase(card)
    launches["ringshard"] = ringshard_phase(rows, card)
    background = []
    try:
        launches["shard"] = shard_phase(card, lambda: background.extend([
            Background("search", "search_phase(c.card_line())"),
            Background("ringshard_golden", "shard_golden()")]))
        launches.update(audit_oracles_phase(card))
        launches["multidevice"] = multidevice_phase(card)
        launches["partition"] = partition_phase(card)
        for job in background:
            job.join()
    finally:
        for job in background:
            job.stop()
    all_cards_part(card)
    partition_all_cards(card)

    replaces = {"selb": "swim_tpu/ops/selb.py:110",
                "coldsel": "swim_tpu/ops/coldsel.py:114",
                "wavemerge": "swim_tpu/ops/wavemerge.py:136"}
    extra = ("ms_main", "bytes_main", "bound_ms_main", "ok_density",
             "bound_ms_sector", "busy", "wave_scope", "lifeguard", "serve",
             "ringshard")
    kernels = []
    for name in ("selb", "coldsel", "wavemerge"):
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"swim_tpu_torch/csrc/{name}.cu",
            replaces=replaces[name], launches=launches["period"][name],
            launches_wave=launches["wave"][name],
            launches_lifeguard=launches["lifeguard"][name],
            launches_pull=launches["pull"][name],
            launches_program=launches["program"][name],
            launches_dense=launches["dense"].get(name, 0),
            launches_rumor=launches["rumor"].get(name, 0),
            launches_telemetry=launches["telemetry"][name],
            launches_batch=launches["batch"][name],
            launches_scenario=launches["scenario"][name],
            launches_packed_1m=launches["packed"][name],
            launches_serve=launches["serve"][name],
            launches_bridge=launches["bridge"][name],
            launches_bridge_golden=launches["bridge_golden"][name],
            launches_instruments=launches["instruments"][name],
            launches_ringshard=launches["ringshard"][name],
            launches_shard=launches["shard"][name],
            launches_audit=launches["audit"][name],
            launches_oracle=launches["oracle"][name],
            launches_multidevice=launches["multidevice"][name],
            launches_partition=launches["partition"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, **{k: r[k] for k in extra if k in r}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

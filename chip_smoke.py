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
     `suspicion_sweep(n=1_000_000, mults=(2.0, 5.0), periods=30)` and
     `lifeguard_ablation(n=1_000_000, periods=20)` (Lifeguard with
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
     lanes, then `refine_boundary`) twice: equal report bytes, wall,
     wall per generation, the boundary.
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
     default SwimConfig for 20 periods, card against CPU after every
     period (frames, state, findings), launches 14 / 14 / 1 a period;
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

Then the `kernels` summary line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.  Any failure raises: the exit code
is then nonzero and the last line is not printed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from swim_tpu_torch import SwimConfig, _kernels, coldsel_bench, golden
from swim_tpu_torch import native
from swim_tpu_torch.bridge import EngineBridgeServer
from swim_tpu_torch.bridge import protocol as bp
from swim_tpu_torch.core import codec
from swim_tpu_torch.measure import (PartTimer, bound, capture_inputs,
                                    card_line, coldsel_profile, gpu_ms)
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.obs import analyze, ici
from swim_tpu_torch.serve import hub as serve_hub
from swim_tpu_torch.serve import load as serve_load
from swim_tpu_torch.obs import engine as obs_engine
from swim_tpu_torch.ops import coldsel, lattice, selb, u32, wavemerge
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


def emit(**kw):
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
    # one-wave merges of the in-line delivery (V=1, VB=0 and 1)
    sparse = [0.99] * 2 + [0.002] * 12
    edge = []
    for n_e, ww_e, vb_e, offs, dens in (
            (1000, 12, 0, [0, 999, -1, -1000, 1999, 1, 500], 0.4),
            (1000, 12, 2, None, 0.4), (257, 12, 2, [0, 256, -257], 0.4),
            (1, 12, 1, [0, 5], 0.4), (1000, 3, 2, None, 0.4),
            (1001, 12, 1, [0, 1, -1, -85, 830, 2001, -2999, 84], 0.4),
            (50_000, 12, 0, None, sparse), (1000, 12, 0, [-7], 0.9),
            (1000, 12, 1, [993], 0.9)):
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
        "suspicion_sweep(n=1_000_000, mults=(2.0, 5.0), periods=30)", 60,
        lambda: experiments.suspicion_sweep(n=N, mults=(2.0, 5.0),
                                            periods=30), card)
    if ss["engine"] != "rumor" or any(pt["crashed"] == 0
                                      for pt in ss["points"]):
        raise AssertionError(f"suspicion_sweep: {ss}")
    row.update(n_nodes=N, engine=ss["engine"], points=ss["points"])
    add("rumor", row)
    emit(**row)

    lg, row = timed_study(
        "lifeguard_ablation(n=1_000_000, periods=20)", 40,
        lambda: experiments.lifeguard_ablation(n=N, periods=20), card)
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
    """search.search() at its defaults, twice: equal report bytes; wall,
    wall per generation, the boundary."""
    walls, texts = [], []
    for i in range(2):
        path = SCENARIO_DIR / f"search_{i}.json"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = search.search(out=str(path))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        texts.append(path.read_bytes())
    if texts[0] != texts[1]:
        raise AssertionError("search: two runs wrote different reports")
    gens = rep["explore"]["generations"] + len(rep["boundary"]["history"])
    b = rep["boundary"]
    emit(phase="scenario", part="search", generations=gens,
         pop=rep["explore"]["pop"], lanes=gens * rep["explore"]["pop"],
         wall_s=walls, wall_s_per_generation=[w / gens for w in walls],
         archive=len(rep["explore"]["archive"]),
         violations=len(rep["explore"]["violations"]),
         boundary={k: b.get(k) for k in ("found", "clean_level",
                                          "violation_level", "width")},
         card=card)


def scenario_phase(card: str) -> dict:
    """Phase 12; returns the kernels' launches in the library's ring
    specs and in the 1M packed run."""
    t0 = time.perf_counter()
    SCENARIO_DIR.mkdir(exist_ok=True)
    launches = {"scenario": library_phase(card),
                "packed": packed_phase(card)}
    search_phase(card)
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
BRIDGE_PARITY_PERIODS = 20
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

    replaces = {"selb": "swim_tpu/ops/selb.py:110",
                "coldsel": "swim_tpu/ops/coldsel.py:114",
                "wavemerge": "swim_tpu/ops/wavemerge.py:136"}
    extra = ("ms_main", "bytes_main", "bound_ms_main", "ok_density",
             "bound_ms_sector", "busy", "wave_scope", "lifeguard", "serve")
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

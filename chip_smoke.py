#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc of the three kernels (one process per source, in
     parallel) into swim_tpu_torch/_build/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     bitwise, at the 1,000,000-node slice's shapes and at edge cases;
     kernel and plain times (CUDA events, median of 21 samples of 10
     launches after warm-up) beside the bytes the function must move and
     the least time the card could take; and the time of a PyTorch copy
     of the window, the rate this card reaches on one read and one write;
  4. golden: the port on the card reproduces golden.GOLDEN_DIGEST, the
     digest both packages give on the CPU;
  5. parity: SwimConfig(n_nodes=1_000_000, ring_sel_scope="period") with
     0.1% of nodes crashing, a few periods with the kernels and with the
     plain versions, both on the card: all 14 state fields equal;
  6. throughput: RingEngine(...).run(100) after warm-up, periods/sec;
     launch counts are zeroed just before this run and read just after;
     crashed nodes are declared dead and no live node is;
  7. main_inputs: one more period of that engine with
     selb.select_first_b and wavemerge.merge_waves wrapped to keep
     clones of their arguments; each kernel against its plain version
     on those inputs, bitwise, its time on them (`ms_main`), the bytes
     they need (`bytes_main`: each input byte once, and of sel only the
     rows some delivering wave reads) and the least time for those
     bytes (`bound_ms_main`); for wavemerge the ok density of each wave.

Then the `kernels` summary line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`.  Any failure raises: the exit code
is then nonzero and the last line is not printed.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from swim_tpu_torch import SwimConfig, _kernels, golden
from swim_tpu_torch.models import ring
from swim_tpu_torch.ops import coldsel, selb, u32, wavemerge
from swim_tpu_torch.sim import faults

N = 1_000_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12       # the guide's float32 rate outside the tensor
#                             cores; it lists no int32 rate
PARITY_PERIODS = 3
WARMUP_PERIODS = 3
TIMED_PERIODS = 100
CRASH_FRACTION = 0.001


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_ms(fn, samples: int = 21, inner: int = 10) -> float:
    """Median device ms of one call of `fn` (CUDA events around `inner`
    calls; a device sleep first lets the host queue them ahead)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


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


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


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


def check_coldsel(gen, rw, n, ow, q, flush=None):
    cold = rand_u32(gen, (rw, n))
    fr = (torch.tensor(flush, dtype=torch.int32, device="cuda")
          if flush is not None else
          torch.randint(0, rw, (ow,), generator=gen, device="cuda",
                        dtype=torch.int32))
    fv = rand_u32(gen, (fr.shape[0], n))
    qr = torch.randint(-2, rw + 2, (q, n), generator=gen, device="cuda",
                       dtype=torch.int32)
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
    for rw_e, n_e, ow_e, q_e, fl in ((16, 1000, 2, 4, None),
                                     (16, 300, 3, 3, [4, 4, -1]),
                                     (8, 33, 2, 1, [7, 20])):
        edge.append(check_coldsel(gen, rw_e, n_e, ow_e, q_e, fl)[1])
    (cold, fr, fv, qr), err = check_coldsel(gen, rw, N, ow, q)
    t_k = gpu_ms(lambda: coldsel.cold_update_select(cold, fr, fv, qr))
    t_p = gpu_ms(lambda: coldsel.cold_update_select_plain(cold, fr, fv, qr),
                 samples=5, inner=2)
    nbytes = (2 * ow + 3 * q) * N * 4
    bms, by = bound(nbytes, N * (ow + q * (ow + 4)))
    rows["coldsel"] = dict(max_abs_err=max(err, *edge), ms=t_k, plain_ms=t_p,
                           bytes=nbytes, bound_ms=bms, bound_by=by,
                           shape=[rw, N], ow=ow, q=q)
    emit(phase="kernel", name="coldsel", edge_cases=len(edge),
         **rows["coldsel"])

    # edge cases: offsets 0 / N-1 / negative / beyond N, wraps inside a
    # tile (85 receivers at WW=12), VB rows, WW=3 (the 4-byte path), and
    # the main path's shape of oks (two dense waves, twelve sparse)
    sparse = [0.99] * 2 + [0.002] * 12
    edge = []
    for n_e, ww_e, vb_e, offs, dens in (
            (1000, 12, 0, [0, 999, -1, -1000, 1999, 1, 500], 0.4),
            (1000, 12, 2, None, 0.4), (257, 12, 2, [0, 256, -257], 0.4),
            (1, 12, 1, [0, 5], 0.4), (1000, 3, 2, None, 0.4),
            (1001, 12, 1, [0, 1, -1, -85, 830, 2001, -2999, 84], 0.4),
            (50_000, 12, 0, None, sparse)):
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


def crash_plan(cfg, periods: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return faults.with_random_crashes(
        faults.none(cfg.n_nodes, "cuda"), gen, CRASH_FRACTION, 0, periods)


def parity_phase(cfg) -> None:
    plan = crash_plan(cfg, PARITY_PERIODS)
    t0 = time.perf_counter()
    k = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, PARITY_PERIODS)
    p = ring.run(cfg, ring.init_state(cfg, "cuda"), plan, 0, PARITY_PERIODS,
                 plain=True)
    torch.cuda.synchronize()
    for f in ring.RingState._fields:
        if not torch.equal(getattr(k, f), getattr(p, f)):
            raise AssertionError(f"main path: field {f} differs between "
                                 "the kernels and the plain versions")
    emit(phase="parity", n_nodes=cfg.n_nodes, periods=PARITY_PERIODS,
         fields_equal=len(ring.RingState._fields),
         seconds=time.perf_counter() - t0)


def capture_main_inputs(engine) -> dict:
    """One period of `engine` with the two kernels' wrappers replaced by
    ones that keep clones of their arguments (win before the in-place
    merge).  GlobalOps looks both up at call time, so the swap reaches
    the main path."""
    got = {}
    real_selb, real_merge = selb.select_first_b, wavemerge.merge_waves

    def capture_selb(win_masked, b):
        got["selb"] = (win_masked.clone(), b)
        return real_selb(win_masked, b)

    def capture_merge(*args):
        got["wavemerge"] = tuple(t.clone() for t in args)
        return real_merge(*args)

    selb.select_first_b, wavemerge.merge_waves = capture_selb, capture_merge
    try:
        engine.run(1)
    finally:
        selb.select_first_b, wavemerge.merge_waves = real_selb, real_merge
    torch.cuda.synchronize()
    return got


def main_inputs_phase(captured: dict, rows: dict) -> None:
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

    win, sel, oks, offs, bcol, bval = captured["wavemerge"]
    err = require_equal(
        "wavemerge on the main path's inputs",
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
    rows["wavemerge"].update(
        max_abs_err=max(rows["wavemerge"]["max_abs_err"], err),
        ms_main=gpu_ms(lambda: wavemerge.merge_waves(out, sel, oks, offs,
                                                     bcol, bval)),
        bytes_main=nbytes, bound_ms_main=bms,
        ok_density=oks.float().mean(dim=1).tolist())
    emit(phase="main_inputs", name="wavemerge", shape=[n, ww],
         v=oks.shape[0], vb=bcol.shape[0],
         **{k: rows["wavemerge"][k] for k in (
             "ms_main", "bytes_main", "bound_ms_main", "ok_density")})


def throughput_phase(cfg, card: str) -> tuple[dict, dict]:
    plan = crash_plan(cfg, TIMED_PERIODS)
    engine = ring.RingEngine(cfg, plan, seed=0)
    engine.run(WARMUP_PERIODS)
    torch.cuda.synchronize()
    selb.launches = coldsel.launches = wavemerge.launches = 0
    t0 = time.perf_counter()
    st = engine.run(TIMED_PERIODS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"selb": selb.launches, "coldsel": coldsel.launches,
                "wavemerge": wavemerge.launches}
    for name, cnt in launches.items():
        if cnt < TIMED_PERIODS:
            raise AssertionError(f"{name}: {cnt} launches in "
                                 f"{TIMED_PERIODS} periods")
    # the run's output: finite shapes, crashed nodes detected, no live
    # node declared dead (no loss in this plan, so no false suspicion)
    periods_done = WARMUP_PERIODS + TIMED_PERIODS
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
    if false_dead or n_dead == 0:
        raise AssertionError(f"detection: {n_dead} declared dead, "
                             f"{false_dead} of them alive")
    pps = TIMED_PERIODS / wall
    emit(phase="throughput", n_nodes=cfg.n_nodes, periods=TIMED_PERIODS,
         seconds=wall, periods_per_sec=pps, card=card,
         crashed=int(crashed.sum()), declared_dead=n_dead, false_dead=0,
         launches=launches)
    return launches, capture_main_inputs(engine)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: PyTorch sees no CUDA device")
    card = card_line()
    emit(phase="card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = _kernels.build()
    emit(phase="build", seconds=build_s, dir=str(_kernels.BUILD_DIR))

    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period")
    rows = kernel_phase(cfg)

    st = golden.golden_run("cuda")
    got = golden.digest(st)
    if got != golden.GOLDEN_DIGEST:
        raise AssertionError(f"golden digest on the card {got} != "
                             f"{golden.GOLDEN_DIGEST}")
    emit(phase="golden", digest=got, n_nodes=golden.GOLDEN_N,
         periods=golden.GOLDEN_PERIODS)

    parity_phase(cfg)
    launches, captured = throughput_phase(cfg, card)
    main_inputs_phase(captured, rows)

    replaces = {"selb": "swim_tpu/ops/selb.py:110",
                "coldsel": "swim_tpu/ops/coldsel.py:114",
                "wavemerge": "swim_tpu/ops/wavemerge.py:136"}
    kernels = []
    for name in ("selb", "coldsel", "wavemerge"):
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"swim_tpu_torch/csrc/{name}.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None,
            **{k: r[k] for k in ("ms_main", "bytes_main", "bound_ms_main",
                                 "ok_density") if k in r}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

"""Timing and byte-counting helpers shared by the card scripts
(chip_smoke.py, period_profile.py, coldsel_bench.py, published.py).

Everything here needs the CUDA card; nothing runs at import.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.ops import coldsel, selb, wavemerge
from swim_tpu_torch.parallel.mesh import DEFAULT_SHARDS

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12       # the float32 rate outside the tensor cores;
#                             the data sheet lists no int32 rate
SECTOR = 32                 # bytes the card moves per device-memory access


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
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


def busy_ms(prof) -> tuple[float, int]:
    """(device ms, count) of the device activities (kernels, copies,
    fills) a torch.profiler profile saw, read from its raw events:
    `key_averages` takes minutes over the million events of a study."""
    cuda_type = torch.autograd.DeviceType.CUDA
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda_type]
    return sum(ns) / 1e6, len(ns)


def busy_ms_by_gap(prof, gap_s: float, device_type=None) -> list:
    """[(device ms, count)] of each run of device activities that a
    torch.profiler profile saw, in order: the activities sorted by
    start and split wherever the device idled longer than `gap_s`.
    Calls separated by such idle gaps come out one run each; their
    start times alone could not place them, since the profiler maps the
    device's clock to the host's with an error of milliseconds.
    `device_type` defaults to CUDA."""
    dtype = torch.autograd.DeviceType.CUDA if device_type is None \
        else device_type
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == dtype)
    runs, last = [], None
    for start, end in spans:
        if last is None or start - last > gap_s * 1e9:
            runs.append([0, 0])
        runs[-1][0] += end - start
        runs[-1][1] += 1
        last = end if last is None else max(last, end)
    return [(ns / 1e6, n) for ns, n in runs]


def reset_launches() -> None:
    """Zero the three kernels' launch counts."""
    selb.launches = coldsel.launches = wavemerge.launches = 0


def read_launches() -> dict:
    return {"selb": selb.launches, "coldsel": coldsel.launches,
            "wavemerge": wavemerge.launches}


def launches_a_period(cfg: SwimConfig, engine: str = "ring",
                      shards: int = DEFAULT_SHARDS) -> dict:
    """The kernels' launches one period of `cfg` calls for: on one
    device a selection a wave in wave scope (one in period scope or
    under pull), one cold flush (none under pull), a one-wave merge a
    wave unless the waves fuse; the sharded ring launches these on each
    of its shards, a merge a wave (and in wave scope under Lifeguard's
    buddy one more for each wave whose sender forces a bit)."""
    waves = 2 + 4 * cfg.k_indirect
    pull = cfg.ring_probe == "pull"
    period = cfg.ring_sel_scope == "period"
    fused = period and waves <= wavemerge.MAX_WAVES
    one = {"selb": 1 if period or pull else waves,
           "coldsel": 0 if pull else 1,
           "wavemerge": 0 if pull else (1 if fused else waves)}
    if engine != "ringshard":
        return one
    merges = 0
    if not pull:
        buddy = cfg.lifeguard and cfg.buddy and not fused
        merges = waves + (1 + cfg.k_indirect if buddy else 0)
    return {"selb": shards * one["selb"], "coldsel": shards * one["coldsel"],
            "wavemerge": shards * merges}


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


class PartTimer:
    """Wraps module-level callables so that every call inside a `with`
    block is bracketed by CUDA events; `ms()` sums them per part."""

    def __init__(self, parts: dict):
        self.parts = parts          # name -> (owner, attribute)
        self.spans = {name: [] for name in parts}
        self.saved = {}

    def _wrap(self, name, fn):
        def timed(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            self.spans[name].append(ev)
            return out
        return timed

    def __enter__(self):
        for name, (owner, attr) in self.parts.items():
            self.saved[name] = getattr(owner, attr)
            setattr(owner, attr, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.parts.items():
            setattr(owner, attr, self.saved[name])

    def ms(self, periods: int) -> dict:
        torch.cuda.synchronize()
        return {name: dict(device_ms=sum(a.elapsed_time(b) for a, b in ev)
                           / periods, calls=len(ev) / periods)
                for name, ev in self.spans.items()}


def capture_inputs(engine) -> dict:
    """One period of `engine` with the three kernels' wrappers replaced
    by ones that keep clones of their arguments as they were before the
    call (win and cold are updated in place).  The engine looks the
    wrappers up at call time, so the swap reaches its period.  A kernel
    called several times in the period keeps its first call's arguments
    (in wave scope: the first wave's, the direct ping) and a count of the
    calls."""
    got = {"calls": {"selb": 0, "coldsel": 0, "wavemerge": 0}}
    real = (selb.select_first_b, coldsel.cold_update_select,
            wavemerge.merge_waves)

    def keep(name, fn):
        def wrapped(*args):
            if name not in got:
                got[name] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            got["calls"][name] += 1
            return fn(*args)
        return wrapped

    selb.select_first_b = keep("selb", real[0])
    coldsel.cold_update_select = keep("coldsel", real[1])
    wavemerge.merge_waves = keep("wavemerge", real[2])
    try:
        engine.run(1)
    finally:
        (selb.select_first_b, coldsel.cold_update_select,
         wavemerge.merge_waves) = real
    torch.cuda.synchronize()
    return got


def coldsel_profile(cold, flush_rows, flush_vals, q_rows) -> dict:
    """What a coldsel input asks of the card.

    `bytes`: each input byte read once (of cold, each distinct queried
    word) and each output byte written once, as if words could be
    fetched alone.  `bytes_sector`: the same, but of
    cold one 32-byte sector per distinct (row, 8-column group) that some
    query names (in range and not flushed: a flushed row is answered from
    flush_vals) - the least this card can move for the function.  Also
    the shares of q_rows out of range and equal to row 0, and the mean
    count of distinct in-range rows per query and 32-column group (the
    sectors one warp-wide access needs)."""
    rw, n = cold.shape
    ow, q = flush_rows.shape[0], q_rows.shape[0]
    valid = (q_rows >= 0) & (q_rows < rw)
    fr_ok = (flush_rows >= 0) & (flush_rows < rw)
    flushed = torch.zeros(rw + 1, dtype=torch.bool, device=cold.device)
    flushed[torch.where(fr_ok, flush_rows, rw).long()] = True
    flushed[rw] = False
    from_cold = valid & ~flushed[q_rows.clamp(0, rw - 1).long()]
    groups = (n + 7) // 8
    cols = torch.arange(n, device=cold.device) // 8
    keys = (q_rows.long() * groups + cols[None, :])[from_cold]
    sectors = int(torch.unique(keys).numel())
    rows_written = int(flushed.sum())
    stream = (ow * 4 + ow * n * 4 + q * n * 4          # read
              + rows_written * n * 4 + q * n * 4)      # written
    n32 = n // 32 * 32
    grp = torch.where(valid, q_rows, -1)[:, :n32].reshape(q, -1, 32)
    srt = grp.sort(dim=-1).values
    distinct = (1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
                - (srt[..., 0] == -1).long())
    words = torch.unique((q_rows.long() * n
                          + torch.arange(n, device=cold.device)[None, :]
                          )[from_cold])
    nbytes = stream + int(words.numel()) * 4
    nops = n * (ow + q * (ow + 4))
    return dict(
        bytes=nbytes, bound_ms=bound(nbytes, nops)[0],
        bytes_sector=stream + sectors * SECTOR,
        bound_ms_sector=bound(stream + sectors * SECTOR, nops)[0],
        out_of_range=float((~valid).float().mean()),
        row0=float((q_rows == 0).float().mean()),
        rows_per_32_columns=float(distinct.float().mean()))

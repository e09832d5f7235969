"""Memory-wall accounting of the study pipeline (port of
`swim_tpu/obs/memwall.py`).

The reference reads XLA's buffer assignment of the study step, compiled
ahead of time against shapes alone, against the memory budget of its own
accelerator.  Eager PyTorch compiles no program ahead of time, so the
port measures instead: on the card, `study_memory_analysis` runs the
same program once at N (the streaming chunk
`runner._run_study_ring_chunk`, or the full-track `run_study_ring`) and
reads the device's peak allocation (`torch.cuda.max_memory_allocated`,
reset just before), against the card's own memory
(`torch.cuda.get_device_properties(dev).total_memory`).  On the CPU or
the meta device it reports only the trees' bytes (state, carry and
arguments, counted on the meta device, so nothing is allocated at size
N), with `measured: false`.

`engine="ringshard"` accounts the sharded engine's streaming study
(parallel/ring_shard.py on `pmesh.start_mesh(device)`: every card when
no device is named, else 8 slots of the named one): the report adds
the shard and device counts and one shard's state bytes
(`shard_state_bytes`: its node-axis blocks plus its own copy of the
replicated tables), and on the card each card's measured peak
(`device_peaks`) and the fullest card (`fullest_device`), whose peak is
the report's total: an all-gather-form roll puts D blocks on every
card.  The reference's
deviceless compile for a TPU mesh has no counterpart here.  Exposed as
`swim-tpu-torch study detection --mem-report [--device cpu]`; obs/expo.py
`render_memwall` renders a report as swim_mem_* gauges.
"""
from __future__ import annotations

import torch

META = torch.device("meta")

# Prometheus gauge registry for the exposition side (obs/expo.py
# render_memwall): the reference's names, help texts for this port.
MEM_GAUGES = {
    "swim_mem_argument_bytes": "device bytes of the study step's arguments "
                               "(engine state + plan + milestone carry)",
    "swim_mem_output_bytes": "device bytes of what the study step returns",
    "swim_mem_temp_bytes": "peak device bytes the study step allocates "
                           "above its arguments",
    "swim_mem_alias_bytes": "bytes aliased by donation (0: the port "
                            "donates nothing; the step updates cold in "
                            "place)",
    "swim_mem_total_bytes": "measured peak device bytes of the study "
                            "step, its arguments included",
    "swim_mem_state_bytes": "engine-state bytes alone",
    "swim_mem_hbm_budget_bytes": "the device's memory, the budget the "
                                 "verdict is measured against",
    "swim_mem_fits_budget": "1 when the measured peak fits the device's "
                            "memory, else 0",
}


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors; a placed tensor counts every block."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "blocks"):
        return sum(_tree_bytes(b) for b in tree.blocks)
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(x) for x in tree)
    return 0


def _study_inputs(cfg, n: int, periods: int, crash_fraction: float,
                  variant: str, device, engine: str = "ring"):
    """(state, plan, track or None, crashes, step_fn or None) of the
    study at `n` on `device` (device.py; META counts bytes only):
    crashes drawn as detection_study draws them, the streaming runner's
    CompactTrack over them; for "ringshard" the state and plan placed by
    `ring_shard.start(cfg, plan, device)` (no device: every card) and
    its sharded step."""
    from swim_tpu_torch import device as devmod
    from swim_tpu_torch.models import ring
    from swim_tpu_torch.sim import faults, runner
    from swim_tpu_torch.utils import threefry

    dev = devmod.resolve(device)
    if dev.type == "meta":
        plan = faults.none(n, dev)
        crashes = max(1, round(n * crash_fraction))
        track = (runner.CompactTrack(*(torch.empty((crashes,),
                                                   dtype=torch.int32,
                                                   device=dev)
                                       for _ in range(5)))
                 if variant == "stream" else None)
    else:
        plan = faults.with_random_crashes(
            faults.none(n, dev), threefry.key(1), crash_fraction, 2,
            max(3, periods // 2))
        track = (runner.compact_track_init(plan, periods)
                 if variant == "stream" else None)
        crashes = (int(track.subjects.shape[0]) if track is not None
                   else int((plan.crash_step < periods).sum()))
    if engine == "ringshard":
        from swim_tpu_torch.parallel import ring_shard

        _, state, plan, step_fn = ring_shard.start(cfg, plan, device)
        return state, plan, track, crashes, step_fn
    return ring.init_state(cfg, dev), plan, track, crashes, None


def study_memory_analysis(n: int, periods: int = 12,
                          crash_fraction: float = 1e-5, *,
                          variant: str = "stream", engine: str = "ring",
                          device=None, probe: str = "pull",
                          budget_bytes: int | None = None,
                          **cfg_kw) -> dict:
    """Memory accounting of one detection-study program at `n` nodes on
    `device` (the card unless the caller names another).

    `variant` picks the program: "stream" is the O(crashes) chunked
    study step (runner._run_study_ring_chunk), "stacked" the full-track
    run_study_ring.  On the card the program runs once for `periods`
    periods and the report gives the measured peak; elsewhere only the
    trees' bytes (`measured: false`).  `budget_bytes` defaults to the
    card's memory."""
    from swim_tpu_torch import device as devmod
    from swim_tpu_torch.config import SwimConfig
    from swim_tpu_torch.models import ring
    from swim_tpu_torch.sim import runner
    from swim_tpu_torch.utils import threefry

    if variant not in ("stream", "stacked"):
        raise ValueError(f"unknown memwall variant {variant!r}")
    if engine not in ("ring", "ringshard"):
        raise ValueError(f"unknown memwall engine {engine!r}")
    if engine == "ringshard" and variant != "stream":
        raise ValueError("ringshard memory analysis covers the streaming "
                         "study (variant='stream')")
    from swim_tpu_torch.parallel import mesh as pmesh

    dev = devmod.resolve(device)
    cfg_kw.setdefault("ring_probe", probe)
    cfg = SwimConfig(n_nodes=n, **cfg_kw)
    on_card = dev.type == "cuda"
    if on_card:
        base = {}
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
            base[torch.device("cuda", i)] = torch.cuda.memory_allocated(i)
    state, plan, track, crashes, step_fn = _study_inputs(
        cfg, n, periods, crash_fraction, variant,
        device if on_card else META, engine)
    cards = ([c for c in step_fn.mesh.distinct if c.type == "cuda"]
             if step_fn is not None else [dev])
    carry = (state, track) if variant == "stream" else state
    args = (state, track, plan) if variant == "stream" else (state, plan)
    if budget_bytes is None:
        budget_bytes = (torch.cuda.get_device_properties(dev).total_memory
                        if on_card else 0)
    report = {
        "n": int(n),
        "periods": int(periods),
        "crashes": int(crashes),
        "variant": variant,
        "engine": engine,
        "platform": dev.type,
        "ring_probe": cfg.ring_probe,
        "state_bytes": _tree_bytes(state),
        "carry_bytes": _tree_bytes(carry),
        "argument_bytes": _tree_bytes(args),
        "hbm_budget_bytes": int(budget_bytes),
        "measured": on_card,
    }
    if engine == "ringshard":
        report["shards"] = step_fn.mesh.size
        report["devices"] = len(step_fn.mesh.distinct)
        report["shard_state_bytes"] = _tree_bytes(pmesh.block(state, 0))
    if not on_card:
        return report

    key = threefry.key(0)
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    if variant == "stream":
        stepper = runner.make_stepper(cfg, plan, ring.step, step_fn)
        out = runner._run_study_ring_chunk(cfg, state, track, plan, key,
                                           periods, stepper)
    else:
        out = runner.run_study_ring(cfg, state, plan, key, periods)
    peaks = {}
    for c in cards:
        torch.cuda.synchronize(c)
        peaks[str(c)] = int(torch.cuda.max_memory_allocated(c)) - base[c]
    fullest = max(peaks, key=peaks.get)
    total = peaks[fullest]
    if engine == "ringshard":
        report["device_peaks"] = peaks
        report["fullest_device"] = fullest
    arg = report["argument_bytes"]
    report.update({
        "output_bytes": _tree_bytes(tuple(out)),
        "temp_bytes": total - arg,
        "alias_bytes": 0,
        "total_bytes": total,
        "budget_fraction": total / budget_bytes,
        "fits_budget": bool(total <= budget_bytes),
    })
    return report


def gauge_values(report: dict) -> dict[str, float]:
    """MEM_GAUGES name -> value for one report (the reference's)."""
    return {
        "swim_mem_argument_bytes": float(report.get("argument_bytes", 0)),
        "swim_mem_output_bytes": float(report.get("output_bytes", 0)),
        "swim_mem_temp_bytes": float(report.get("temp_bytes", 0)),
        "swim_mem_alias_bytes": float(report.get("alias_bytes", 0)),
        "swim_mem_total_bytes": float(report.get("total_bytes", 0)),
        "swim_mem_state_bytes": float(report["state_bytes"]),
        "swim_mem_hbm_budget_bytes": float(report["hbm_budget_bytes"]),
        "swim_mem_fits_budget": 1.0 if report.get("fits_budget") else 0.0,
    }

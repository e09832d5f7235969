"""Device-memory roofline of the ring engine's protocol period (port of
`swim_tpu/utils/roofline.py`).

The ring engine is memory-bound: every phase is elementwise and bit work
over a few large arrays (win u32[N, WW], cold u32[RW, N] and 4-byte node
vectors), with no matmuls, so the ceiling on periods/sec for one card is

    ceiling = memory bytes per second / bytes touched per period

`ring_traffic` is the reference's per-term accounting of the bytes one
`ring.step` touches, term for term, in two brackets: `fused` (every
producer-consumer chain one pass) and `unfused` (every named
intermediate through memory).  `ceiling_periods_per_sec` divides by the
H100 SXM's 3.35 TB/s (measure.py `HBM_BYTES_PER_S`, the NVIDIA data
sheet).

The reference's `hlo_bytes_accessed` (XLA's cost-analysis estimate of a
compiled step) has no counterpart: eager PyTorch runs no compiled
program with a cost analysis, so the port has no source of achieved
bytes (obs/prof.py reports them as null).
"""
from __future__ import annotations

from typing import Any

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.measure import HBM_BYTES_PER_S

HBM_GBPS = HBM_BYTES_PER_S / 1e9        # 3,350 GB/s


def ring_traffic(cfg: SwimConfig) -> dict[str, Any]:
    """Bytes touched per protocol period by ring.step, by term:
    {"terms": {name: (fused, unfused)}, "fused", "unfused", plus the
    geometry the accounting used}.  Node vectors are 4*N bytes ("nvec"),
    win is WW*nvec, cold RW*nvec; the [R]-table terms are omitted as in
    the reference."""
    from swim_tpu_torch.models.ring import geometry

    g = geometry(cfg)
    n, k = cfg.n_nodes, cfg.k_indirect
    nvec = 4.0 * n
    win = g.ww * nvec
    cold = g.rw * nvec
    waves = 2 + 4 * k
    terms: dict[str, tuple[float, float]] = {}

    # Phase 0: window shift, the invalidation and outgoing-column
    # censuses; rotor defers the cold flush into the query pass, pull
    # flushes here (read + write)
    rotor = cfg.ring_probe == "rotor"
    flush_here = 0.0 if rotor else 2 * cold
    terms["phase0_shift_flush"] = (
        2 * win + flush_here + 3 * g.ow * nvec,
        2 * win + flush_here + (2 * g.ow) * nvec + 4 * g.ow * nvec)
    # top-C per-subject index: C rounds of scatter-max / gather pairs
    terms["topc_index"] = (4 * g.c * nvec, 6 * g.c * nvec)
    # the waves: one selection a period then roll + OR a wave (period
    # scope), or selection + roll + OR every wave (wave scope)
    if cfg.ring_sel_scope == "period":
        terms["waves"] = (2 * win + waves * (3 * win),
                          3 * win + waves * (5 * win))
    else:
        terms["waves"] = (waves * (4 * win), waves * (7 * win))
    # per-wave node-vector plumbing (send flags, partition ids, draws)
    terms["wave_vectors"] = (waves * 4 * nvec, waves * 8 * nvec)
    # buddy forced-bit column selects (rotor + Lifeguard buddy)
    buddy = (1 + k) if (cfg.lifeguard and cfg.buddy) else 0
    terms["buddy_bits"] = (buddy * win, buddy * 2 * win)
    # view / self query pass: the fused cold flush + C+1 selects (rotor)
    # or gathers (pull)
    if rotor:
        terms["query_pass"] = (win + 2 * cold,
                               win + 2 * cold + (g.c + 1) * cold
                               + (g.c + 1) * 2 * nvec)
    else:
        terms["query_pass"] = (win + cold,
                               win + (g.c + 1) * cold
                               + (g.c + 1) * 2 * nvec)
    # Phase C/D: node-vector suspicion, compaction and scatter passes
    terms["phase_cd"] = (12 * nvec, 24 * nvec)

    fused = sum(a for a, _ in terms.values())
    unfused = sum(b for _, b in terms.values())
    return {
        "terms": terms, "fused": fused, "unfused": unfused,
        "n": n, "waves": waves, "ww": g.ww, "rw": g.rw,
        "win_bytes": win, "cold_bytes": cold,
    }


def ceiling_periods_per_sec(cfg: SwimConfig, hbm_gbps: float = HBM_GBPS,
                            n_devices: int = 1) -> dict[str, float]:
    """Memory-bound periods/sec ceiling band for `n_devices` cards."""
    tr = ring_traffic(cfg)
    bw = hbm_gbps * 1e9 * n_devices
    return {
        "ceiling_fused": bw / tr["fused"],
        "ceiling_unfused": bw / tr["unfused"],
        "bytes_fused": tr["fused"],
        "bytes_unfused": tr["unfused"],
    }

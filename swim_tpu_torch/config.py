"""Protocol configuration for the PyTorch port.

The port keeps its own copy of `swim_tpu/config.py`: the same fields,
defaults, validation and derived properties, so that both packages size
the same ring geometry from the same arguments.  The `ring_*_kernel` and
wire fields are carried for parity of construction; the port's ring
engine decides its kernel route by the tensors' device.  `profiling`,
as in the reference, changes nothing on one device: the phase probe is
the `prof` argument of the engines' `step` (obs/prof.py).

`SwimConfig` is a frozen, hashable dataclass: every field is a constant
of one engine instance.  Fault injection parameters live in `FaultPlan`
(swim_tpu_torch/sim/faults.py) as tensors instead.
"""

from __future__ import annotations

import dataclasses
import math


def log_n_of(n: int) -> float:
    """The protocol's log-scaling base: log10 of the cluster size, floored
    at 1 (shared by static configs and live-cluster sizing)."""
    return max(1.0, math.log10(max(n, 10)))


@dataclasses.dataclass(frozen=True)
class SwimConfig:
    """Static protocol constants.

    Timeouts and dissemination bounds follow the SWIM paper (Das et al., DSN
    2002) and the Lifeguard paper (Dadgar et al., 2017); the log-scaled
    multiplier form matches common production practice so sweeps over
    `suspicion_mult` (BASELINE.md config 4) are directly meaningful.
    """

    n_nodes: int
    # --- failure detector ---
    k_indirect: int = 3          # indirect probe fan-out (stock demo: k=3)
    protocol_period: float = 1.0  # seconds; real-node runtime only — the
    #                               vectorized engines use "periods" as the
    #                               unit of simulated time.
    # --- dissemination ---
    max_piggyback: int = 6       # B: max updates piggybacked per message
    retransmit_mult: float = 4.0  # gossip an update for ~mult*log10(N) sends
    # --- suspicion subprotocol ---
    suspicion_mult: float = 5.0  # suspicion timeout = mult * log10(N) periods
    # --- probe target selection ---
    target_selection: str = "uniform"  # "uniform" | "round_robin"
    # --- Lifeguard extensions (Dadgar et al., 2017), switchable variants ---
    lifeguard: bool = False      # master switch (config 5 vs vanilla SWIM)
    lha_max: int = 8             # local-health-aware probe: max health score S;
    #                              probe timeout scales by (1 + S/lha_max).
    dynamic_suspicion: bool = True   # start at suspicion_max_mult × the
    #                                  vanilla timeout, shrink toward the
    #                                  vanilla floor as independent
    #                                  confirmations arrive
    suspicion_max_mult: float = 2.0  # ceiling multiplier (memberlist: 6)
    buddy: bool = True           # buddy system: prioritize telling a suspect
    #                              it is suspected so it can refute fast
    # --- engine capacity knobs (rumor engine only) ---
    rumor_capacity: int = 0      # 0 → sized automatically from n_nodes
    sentinels: int = 4           # independent suspectors tracked per rumor
    # --- ring engine geometry + probe pattern (swim_tpu/models/ring.py) ---
    ring_orig_words: int = 2     # OW: 32-slot words originated per period
    ring_window_periods: int = 6  # window = OW * this many words
    ring_view_c: int = 3         # per-subject top-C view index depth
    ring_probe: str = "rotor"    # "rotor": shared-offset round-robin (all
    #                              waves are rolls; fastest; SWIM §4.3
    #                              bounded-detection regime). "pull":
    #                              pull-sampled uniform probing — preserves
    #                              the paper's geometric e/(e−1) first-
    #                              detection law exactly (gather-based
    #                              delivery; vanilla protocol only).
    ring_sel_scope: str = "wave"  # piggyback-selection freshness (rotor):
    #                              "wave" re-selects before every message
    #                              wave, so acks relay rumors learned
    #                              earlier in the SAME period (exact SWIM
    #                              semantics; 14 full window passes per
    #                              period at k=3). "period" selects once
    #                              from start-of-period knowledge and
    #                              reuses it for all waves — rumors
    #                              learned mid-period relay from the next
    #                              period on (deviation R5,
    #                              docs/PROTOCOL.md), cutting the
    #                              dominant HBM term (utils/roofline.py).
    #                              Pull mode always selects once before
    #                              any delivery; the knob is a no-op
    #                              there.
    ring_selb_kernel: str = "auto"  # first-B piggyback selection path:
    #                              "auto" uses the fused one-pass
    #                              Pallas kernel (ops/selb.py) on the
    #                              TPU backend and the budgeted
    #                              extract loop elsewhere; "pallas"/
    #                              "lax" force one (pallas runs
    #                              interpreted off-TPU; tests pin the
    #                              two bitwise-equal).
    ring_cold_kernel: str = "auto"  # cold-ring flush + view-query path
    #                              (rotor only): "auto" uses the fused
    #                              Pallas kernel (ops/coldsel.py) on the
    #                              TPU backend and the jnp lowering
    #                              elsewhere; "pallas"/"lax" force one
    #                              path (pallas runs interpreted off-TPU
    #                              — tests pin the two bitwise-equal).
    ring_wave_kernel: str = "auto"  # fused wave-OR merge path (rotor +
    #                              ring_sel_scope="period" only): all
    #                              2+4k delivery ORs of the period run
    #                              as ONE pass (ops/wavemerge.py).
    #                              "auto" uses the Pallas kernel on the
    #                              TPU backend (contiguous-DMA rolls in
    #                              the transposed window view) and the
    #                              rolled-OR jnp lowering elsewhere;
    #                              "pallas"/"lax" force one path (pallas
    #                              runs interpreted off-TPU — tests pin
    #                              the two bitwise-equal).  Inert in
    #                              "wave" scope (per-wave re-selection
    #                              reads the live window, so the waves
    #                              cannot be fused) and in pull mode.
    # --- observability (swim_tpu/obs/) ---
    telemetry: bool = False      # per-period engine telemetry (EngineFrame
    #                              counters: piggyback-slot saturation vs
    #                              the B budget, sel-window occupancy,
    #                              wave-merge deliveries, probe failures)
    #                              collected inside the scan. Off by
    #                              default; the tap is additive — protocol
    #                              state is bitwise identical either way
    #                              (tests/test_ring_shard.py pins it) and
    #                              the measured overhead contract lives in
    #                              bench.py --telemetry-overhead.
    profiling: bool = False      # per-period phase markers (obs/prof.py
    #                              PhaseProbe): one cheap replicated i32
    #                              signature per named step phase,
    #                              collected inside the scan so the
    #                              profiled program's phase structure is
    #                              live (not dead-code-eliminated).  Off
    #                              by default; the probe is additive —
    #                              protocol state is bitwise identical
    #                              either way (tests/test_profiler.py +
    #                              the tri-run in tests/test_ring_shard.py
    #                              pin it) and the measured overhead
    #                              contract lives in bench.py --tier
    #                              profiler.
    ring_ici_wire: str = "window"  # sharded wave-exchange payload
    #                              (parallel/ring_shard.py; inert in the
    #                              single-program engine, which has no
    #                              wire). "window" ships each wave's
    #                              full sel window u32[S, WW] (two
    #                              neighbor blocks per wave). "compact"
    #                              ships SWIM's bounded piggyback
    #                              instead: each sel row carries at most
    #                              B = max_piggyback set bits (first-B
    #                              selection), so rows pack into B slot
    #                              indices (ops/wavepack.py) and each
    #                              wave moves ONE packed neighbor block
    #                              — bitwise-equal, ~WW*32/B fewer ICI
    #                              bytes. Requires the fused rotor
    #                              period-scope path (sel is selected
    #                              once per period; wave scope re-packs
    #                              per wave and pull mode has no waves).
    ring_scalar_wire: str = "wide"  # per-wave SCALAR payload format on
    #                              the sharded wave exchange (the ok
    #                              chains, partition ids, buddy
    #                              col/val rows and view-query vectors
    #                              that ride alongside the sel window;
    #                              inert in the single-program engine).
    #                              "wide" rolls each vector separately
    #                              at its storage dtype. "packed"
    #                              bit-packs bool chains to 1 bit/node
    #                              (SWIM's delivery flags are single
    #                              bits), narrow-encodes slot/buddy
    #                              payloads (ops/wavepack.py
    #                              code_dtype), and fuses each wave's
    #                              scalars into ONE u8 ppermute payload
    #                              (pack_bundle) — bitwise-equal after
    #                              receiver-side unpack, ~3x fewer
    #                              scalar ICI bytes. Requires the fused
    #                              rotor period-scope path (the bundle
    #                              rides the fused wave staging).

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ValueError("SWIM needs at least 2 nodes")
        if self.target_selection not in ("uniform", "round_robin"):
            raise ValueError(f"bad target_selection {self.target_selection!r}")
        if self.ring_probe not in ("rotor", "pull"):
            raise ValueError(f"bad ring_probe {self.ring_probe!r}")
        if self.ring_sel_scope not in ("wave", "period"):
            raise ValueError(f"bad ring_sel_scope {self.ring_sel_scope!r}")
        if self.ring_cold_kernel not in ("auto", "pallas", "lax"):
            raise ValueError(
                f"bad ring_cold_kernel {self.ring_cold_kernel!r}")
        if self.ring_selb_kernel not in ("auto", "pallas", "lax"):
            raise ValueError(
                f"bad ring_selb_kernel {self.ring_selb_kernel!r}")
        if self.ring_wave_kernel not in ("auto", "pallas", "lax"):
            raise ValueError(
                f"bad ring_wave_kernel {self.ring_wave_kernel!r}")
        if self.ring_wave_kernel == "pallas" and not (
                self.ring_probe == "rotor"
                and self.ring_sel_scope == "period"):
            raise ValueError(
                "ring_wave_kernel='pallas' requires ring_probe='rotor' "
                "and ring_sel_scope='period': only the period-scope "
                "rotor path fuses its waves (wave scope re-selects from "
                "the live window before every wave, so its deliveries "
                "cannot merge into one pass) — a forced-pallas run "
                "elsewhere would silently use the per-wave path (use "
                "'auto' or 'lax')")
        if self.ring_wave_kernel == "pallas" and (
                2 + 4 * self.k_indirect > 32):
            raise ValueError(
                f"ring_wave_kernel='pallas' is impossible at k_indirect="
                f"{self.k_indirect}: the fused wave merge packs the "
                f"period's 2+4k={2 + 4 * self.k_indirect} wave-ok bits "
                "into one u32 lane mask (ops/wavemerge.py), so only "
                "k_indirect <= 7 can fuse — a forced-pallas run here "
                "would silently fall back to the per-wave path (use "
                "'auto' or 'lax', or lower k_indirect)")
        if self.ring_ici_wire not in ("window", "compact"):
            raise ValueError(f"bad ring_ici_wire {self.ring_ici_wire!r}")
        if self.ring_ici_wire == "compact":
            if not (self.ring_probe == "rotor"
                    and self.ring_sel_scope == "period"):
                raise ValueError(
                    "ring_ici_wire='compact' requires ring_probe='rotor' "
                    "and ring_sel_scope='period': the compact wire packs "
                    "the ONE per-period first-B selection and replays it "
                    "for every wave — wave scope re-selects from the "
                    "live window before each wave (nothing to pack once) "
                    "and pull mode delivers by gather, not waves")
            if 2 + 4 * self.k_indirect > 32:
                raise ValueError(
                    f"ring_ici_wire='compact' is impossible at "
                    f"k_indirect={self.k_indirect}: it rides the fused "
                    f"period-scope merge, whose 2+4k="
                    f"{2 + 4 * self.k_indirect} wave-ok bits must pack "
                    "into one u32 lane mask (k_indirect <= 7)")
        if self.ring_scalar_wire not in ("wide", "packed"):
            raise ValueError(
                f"bad ring_scalar_wire {self.ring_scalar_wire!r}")
        if self.ring_scalar_wire == "packed":
            if not (self.ring_probe == "rotor"
                    and self.ring_sel_scope == "period"):
                raise ValueError(
                    "ring_scalar_wire='packed' requires ring_probe="
                    "'rotor' and ring_sel_scope='period': the packed "
                    "scalar bundle rides the fused period-scope wave "
                    "staging (one ppermute payload per wave) — wave "
                    "scope delivers in-line per wave and pull mode "
                    "exchanges by gather, not rolls")
            if 2 + 4 * self.k_indirect > 32:
                raise ValueError(
                    f"ring_scalar_wire='packed' is impossible at "
                    f"k_indirect={self.k_indirect}: it rides the fused "
                    f"period-scope merge, whose 2+4k="
                    f"{2 + 4 * self.k_indirect} wave-ok bits must pack "
                    "into one u32 lane mask (k_indirect <= 7)")
        if self.ring_cold_kernel == "pallas" and self.ring_probe != "rotor":
            raise ValueError(
                "ring_cold_kernel='pallas' requires ring_probe='rotor': "
                "the pull branch reads cold through gather-style knows_* "
                "lookups before the fused flush+select pass could run — "
                "a forced-pallas pull run would silently use the gather "
                "path (use 'auto' or 'lax' with pull)")
        if self.ring_probe == "pull" and self.lifeguard:
            raise ValueError(
                "ring_probe='pull' supports the vanilla protocol only: "
                "probe outcomes live on the probed node's lanes, so the "
                "prober-side Lifeguard health accounting (LHA) cannot be "
                "tracked without scatters — use rotor mode or the rumor/"
                "dense engines for Lifeguard studies")

    # -- derived constants (plain Python: evaluated at trace time) ----------

    @property
    def log_n(self) -> float:
        return log_n_of(self.n_nodes)

    @property
    def retransmit_limit(self) -> int:
        """How many times a node re-gossips one update before dropping it.

        Infection-style dissemination reaches all N nodes w.h.p. in
        O(log N) rounds; the bound mirrors that.
        """
        return max(1, math.ceil(self.retransmit_mult * self.log_n))

    @property
    def suspicion_periods(self) -> int:
        """Suspicion timeout, in protocol periods (vanilla / Lifeguard max)."""
        return max(1, math.ceil(self.suspicion_mult * self.log_n))

    @property
    def suspicion_max_periods(self) -> int:
        """Lifeguard dynamic-suspicion ceiling, in protocol periods."""
        return max(1, math.ceil(self.suspicion_mult * self.suspicion_max_mult
                                * self.log_n))

    @property
    def gossip_window(self) -> int:
        """Periods for which a rumor stays transmissible (rumor engine).

        A node makes Θ(1) sends per period, so `retransmit_limit` sends
        ≈ `retransmit_limit` periods of eligibility.
        """
        return self.retransmit_limit

    @property
    def rumor_slots(self) -> int:
        """Rumor table capacity R for the O(R·N) rumor engine."""
        if self.rumor_capacity:
            return self.rumor_capacity
        # Enough for moderate churn: a few hundred concurrent rumors minimum,
        # scaled gently with N. Overflow is counted, never silent.
        return int(min(4096, max(256, self.n_nodes // 64)))

    def replace(self, **kw) -> "SwimConfig":
        return dataclasses.replace(self, **kw)


# The reference's stock demo configuration: 32-node in-process cluster,
# k=3 indirect probes, 1 s protocol period (BASELINE.json configs[0]).
STOCK_DEMO = SwimConfig(n_nodes=32, k_indirect=3, protocol_period=1.0)

"""Digests of engine states and the digests of fixed runs.

`digest(state)` is the sha256 of the fields of an engine state
(RingState, DenseState or RumorState) in their declared order, each as
its field name, shape and little-endian bytes in the reference's dtype
(u32 fields as uint32).  It accepts the port's state or a mapping of
numpy arrays (the reference's state through `np.asarray`; the engine is
told by its field names), so one constant holds both packages and the
card to the same trajectory without JAX on the card's machine.

GOLDEN_DIGESTS holds the digest after `golden_run(device, name)` for
three configurations of one run (N = 4096, crashes at a few nodes, loss
0.02, seed 0, 40 periods): `period` (period scope, the waves fused;
also GOLDEN_DIGEST), `wave` (the default SwimConfig: a selection and a
delivery per wave) and `lifeguard` (period scope with Lifeguard, buddy
and dynamic suspicion).  tests/test_torch_golden.py checks each against
both packages.

GOLDEN_DIGEST_MARKERS is `markers_digest` of `golden_markers(device)`:
the int32[40, 6] phase-marker matrices (obs/prof.py
`profiled_ring_run`) of the three golden runs above, in the order
period, wave, lifeguard.

GOLDEN_DIGEST_STUDY is `study_digest` of `golden_study(device)`: a
pull-mode streaming detection study (the default wave scope, N = 4096,
1% of the nodes crashing at random, loss 0.02, seed 0, 40 periods in
chunks of 16), hashing its final state, CompactTrack and series.

ENGINE_DIGESTS holds the digest after `engine_run(device, name)` for
the dense and rumor engines (40 periods, loss 0.05, crashes at a few
nodes, seed 0): `dense` (N = 256), `rumor` (N = 4096) and
`rumor_lifeguard` (N = 4096, Lifeguard with buddy and dynamic
suspicion); the exchange-sharded engine gives the rumor digests
(`engine_run(device, name, sharded=True)`).

GOLDEN_DIGEST_SCALE is the digest after `scale_run(device)`: bench.py's
`ringp` tier at the foot of the one-chip scale ladder, SCALE_N =
4,000,000 nodes in period scope, bench_ring's plan (`scale_plan`: 0.1%
of the nodes crashing in periods [0, SCALE_PERIODS)), seed 0,
SCALE_PERIODS = 3 periods from init.  The JAX package computed it on a
CPU host (8 cores) in 15.6 s, compile included:
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scale.py -m slow
-k scale_anchor` runs it in both packages.  4M is the largest ladder
size XLA:CPU runs; chip_smoke.py's `scale` phase holds the card to it.

GOLDEN_DIGEST_SCALE_STUDY is `study_digest` of `scale_study(device)`:
the detection study of the reference's 4M CPU artifact's command (pull
probing, 12 periods, crash fraction 0.00002, seed 0, the streaming
runner) at SCALE_STUDY_N = 1,000,000 nodes.  The reference's study
program needs about 18,000 bytes of XLA:CPU temporaries a node
(memwall's compile: 18,666,123,648 B at 2**20 nodes), 77.5 GB at 4M,
beyond a 62 GB CPU host; at 1M the JAX package ran it there in 49.2 s
(`-k scale_study_anchor`, slow).

GOLDEN_DIGEST_SERVE is serve/load.py's `state_digest` after
`drive_serve` on a serving hub (serve/hub.py) of SERVE_N = 4096 nodes
in the serve anchor geometry: 8 attached rows, gossip datagrams with
SUSPECT, DEAD and ALIVE claims each period (more than the batch's 64
slots in period SERVE_SPILL_PERIOD), ACKs, an eviction, 12 periods.
`drive_serve` feeds codec bytes through `_on_session_datagram`, so the
same script drives the JAX package's hub.

GOLDEN_DIGEST_BRIDGE is the last of `drive_bridge`'s digests on an
EngineBridgeServer (bridge/engine_server.py) of BRIDGE_N = 2048 nodes in
the bridge tests' geometry (BRIDGE_GEOM), seed BRIDGE_SEED: one raw-socket
session joins as node N-1 and steps BRIDGE_PERIODS periods, acking every
mirrored ping; it sends one ping carrying a suspicion claim, kills a
tensor peer, sets the wire loss, and refutes a suspicion that the server
forges on the wire.  Each digest chains every frame received so far
with the state's `digest` after that period, so one constant holds both
packages and the card to the same frames and states.

GOLDEN_DIGEST_REPLAY_STORM is the sha256 of the verdict artifact of the
library scenario `replay_storm` (a 16-node SimCluster of real nodes
under loss, duplication and stale replay; sim/scenario.py), its
`out_dir` written as "OUT".

GOLDEN_DIGEST_SEARCH is the sha256 of the report file that
`sim/search.py`'s `search(out=path)` writes at its defaults (4
generations of 16 lanes, seed 0, then the flap boundary refinement).
It was computed on the CPU with this package and, the same bytes, with
the JAX package's `swim_tpu/sim/search.py`; chip_smoke.py holds one
search on the card to it.

PUBLISHED_OW8_CPU holds what the JAX package gives for the two
ring_orig_words-8 arms of the small `study lifeguard --budget-arms`
command that tests/test_torch_published.py runs through the port (1,024
nodes), with the command and its seconds: a JAX ring study compiles in
86-130 s at ring_orig_words 8 on a CPU, so the tier-1 test holds those
two arms to this record (every other case of that file runs the JAX
package beside the port), and its `slow` test recomputes the record.
"""
from __future__ import annotations

import hashlib
import socket

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.convert import state_to_numpy
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.utils import threefry

GOLDEN_N = 4096
GOLDEN_PERIODS = 40
GOLDEN_SEED = 0
GOLDEN_LOSS = 0.02
GOLDEN_CRASHES = ([5, 77, 1000, 2049, 4095], [2, 3, 5, 8, 13])

GOLDEN_CONFIGS = {
    "period": dict(ring_sel_scope="period"),
    "wave": {},
    "lifeguard": dict(ring_sel_scope="period", lifeguard=True),
}
GOLDEN_DIGEST = (
    "4863822e1b0f94a33ce318c94ef56f43d947d3a5dd7cc19daf38ddf552817117")
GOLDEN_DIGEST_WAVE = (
    "b3578df2cfd9e1fc4399e8834ddc5ed6f9fc45638b7a33eaa03e4eaea48cdaa8")
GOLDEN_DIGEST_LIFEGUARD = (
    "7285696ffaaa07500cb3b0ffd2fe5e991834c46b7005d8141cab9950d4077c2b")
GOLDEN_DIGESTS = {"period": GOLDEN_DIGEST, "wave": GOLDEN_DIGEST_WAVE,
                  "lifeguard": GOLDEN_DIGEST_LIFEGUARD}

GOLDEN_DIGEST_MARKERS = (
    "ede530ad628edae13f8c3ef0ac566333bd76fffe426be37cd0749534fd3137eb")

STUDY_CONFIG = dict(ring_probe="pull")
STUDY_CRASHES = dict(seed=1, fraction=0.01, start=2, end=20)
STUDY_CHUNK = 16
GOLDEN_DIGEST_STUDY = (
    "fc526b3b9e4d8fa9cf20d31a65a12197ccc1b3492924eeb364179b470e7b492d")

GOLDEN_DIGEST_SEARCH = (
    "ef0889fdcbbef7e38903221be4759f7e85ea2bd4d16e679d3bcb75a312468a05")

SCALE_N = 4_000_000
SCALE_PERIODS = 3
SCALE_CRASH_FRACTION = 0.001
GOLDEN_DIGEST_SCALE = (
    "afafc234d355e3cfc64f404e73affb123d7e4bf71791aeb4299ceee1de5d6d65")
SCALE_STUDY_N = 1_000_000
SCALE_STUDY_PERIODS = 12
SCALE_STUDY_FRACTION = 0.00002
GOLDEN_DIGEST_SCALE_STUDY = (
    "8b57f21a544e9d71dd7ae4471d1cef07e4d45bc13d1d9147b19c8a6de5a48321")

# the JAX package's results for the ring_orig_words-8 arms of
# tests/test_torch_published.py's lifeguard command, computed on the CPU
# (8 virtual devices): each arm's summary and its final `overflow`
PUBLISHED_OW8_CPU = {
 'cmd': 'swim-tpu study lifeguard --nodes 1024 --engine ring --periods 24 '
        '--budget-arms --crash-fraction 0.1 --loss 0.1',
 'seconds': 310.7,
 'arms': {'vanilla_ob8': {'crashed': 119,
                          'suspect_detected': 118,
                          'suspect_latency_mean': 1.076271186440678,
                          'suspect_latency_p50': 1.0,
                          'suspect_latency_p99': 2.0,
                          'dead_view_detected': 68,
                          'dead_view_latency_mean': 16.705882352941178,
                          'dead_view_latency_p50': 17.0,
                          'dead_view_latency_p99': 18.0,
                          'disseminated_detected': 0,
                          'false_dead_views_final': 118,
                          'false_dead_views_peak': 118,
                          'ring_orig_words': 8},
          'lifeguard_ob8': {'crashed': 119,
                            'suspect_detected': 118,
                            'suspect_latency_mean': 1.1016949152542372,
                            'suspect_latency_p50': 1.0,
                            'suspect_latency_p99': 2.0,
                            'dead_view_detected': 33,
                            'dead_view_latency_mean': 19.757575757575758,
                            'dead_view_latency_p50': 20.0,
                            'dead_view_latency_p99': 20.0,
                            'disseminated_detected': 0,
                            'false_dead_views_final': 0,
                            'false_dead_views_peak': 0,
                            'ring_orig_words': 8}},
 'overflow': [0, 0]}

ENGINE_N = {"dense": 256, "rumor": 4096, "rumor_lifeguard": 4096}
ENGINE_LOSS = 0.05
ENGINE_CRASHES = {"dense": ([5, 77, 100, 200, 255], [2, 3, 5, 8, 13]),
                  "rumor": GOLDEN_CRASHES, "rumor_lifeguard": GOLDEN_CRASHES}
ENGINE_DIGESTS = {
    "dense":
        "25f3f0dce732b8fbff5ff0fe6012490e1dae1e14f4c7bd10d27028beb41c873e",
    "rumor":
        "4f3981e573af8c4e368091fdabef7fb57b12e0339262fec08e482f97f329ef7c",
    "rumor_lifeguard":
        "2edac3eb009e8b2501821173e13b4ed2b1a56e76800128e447edca8c3ee9f180",
}

_STATES = (ring.RingState, dense.DenseState, rumor.RumorState)
_DTYPES = {
    "win": "<u4", "cold": "<u4", "inc_self": "<u4", "lha": "<i4",
    "gone_key": "<u4", "subject": "<i4", "rkey": "<u4", "birth0": "<i4",
    "sent_node": "<i4", "sent_time": "<i4", "confirmed": "|b1",
    "overflow": "<i4", "index_overflow": "<i4", "step": "<i4",
    "key": "<u4", "retransmit": "<i4", "deadline": "<i4", "knows": "|b1",
    "birth": "<i4",
}


def digest(state) -> str:
    if isinstance(state, _STATES):
        fields = state._fields
        arrays = state_to_numpy(state)
    else:
        fields = next(c._fields for c in _STATES
                      if set(c._fields) == set(state))
        arrays = {f: np.asarray(state[f]) for f in fields}
    h = hashlib.sha256()
    for f in fields:
        a = np.asarray(arrays[f]).astype(_DTYPES[f], order="C",
                                          copy=False)
        h.update(f"{f}:{a.shape}:".encode())
        h.update(a.data)            # the bytes, hashed without a copy
    return h.hexdigest()


def golden_config(name: str = "period"):
    """(cfg, crash node ids, crash periods) of the golden run `name`."""
    cfg = SwimConfig(n_nodes=GOLDEN_N, **GOLDEN_CONFIGS[name])
    return cfg, GOLDEN_CRASHES[0], GOLDEN_CRASHES[1]


def golden_run(device=None, name: str = "period") -> ring.RingState:
    """The fixed run whose digest is GOLDEN_DIGESTS[name], on `device`."""
    cfg, _, _ = golden_config(name)
    return ring.run(cfg, ring.init_state(cfg, device),
                    golden_plan(name, device), GOLDEN_SEED, GOLDEN_PERIODS)


def golden_plan(name: str = "period", device=None):
    cfg, nodes, at = golden_config(name)
    return faults.with_loss(
        faults.with_crashes(faults.none(cfg.n_nodes, device), nodes, at),
        GOLDEN_LOSS)


def golden_markers(device=None, plain: bool = False) -> dict:
    """Each golden run's phase markers, int32[GOLDEN_PERIODS, 6] by
    name (`plain`: the kernels' plain versions)."""
    from swim_tpu_torch.obs.prof import profiled_ring_run

    out = {}
    for name in GOLDEN_CONFIGS:
        cfg, _, _ = golden_config(name)
        out[name] = profiled_ring_run(
            cfg, ring.init_state(cfg, device), golden_plan(name, device),
            GOLDEN_SEED, GOLDEN_PERIODS, plain=plain).markers
    return out


def markers_digest(markers) -> str:
    """sha256 of each marker matrix (name, shape, little-endian int32
    bytes) in GOLDEN_CONFIGS order; tensors or numpy arrays."""
    h = hashlib.sha256()
    for name in GOLDEN_CONFIGS:
        m = markers[name]
        a = np.asarray(m.cpu() if hasattr(m, "cpu") else m).astype(
            "<i4", copy=False)
        h.update(f"{name}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def study_digest(state, track, series) -> str:
    """sha256 of the state's digest, then of each CompactTrack and
    PeriodSeries field (name, shape, little-endian int32 bytes), in
    declared order.  Each argument is the port's NamedTuple or a
    mapping of numpy arrays by field name."""
    def arrays(nt, fields):
        if isinstance(nt, tuple):
            nt = {f: getattr(nt, f) for f in nt._fields}
        return [(f, np.asarray(nt[f].cpu() if hasattr(nt[f], "cpu")
                               else nt[f]).astype("<i4", copy=False))
                for f in fields]
    h = hashlib.sha256(digest(state).encode())
    for f, a in (arrays(track, runner.CompactTrack._fields)
                 + arrays(series, runner.PeriodSeries._fields)):
        h.update(f"{f}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def study_plan(device=None):
    c = STUDY_CRASHES
    return faults.with_loss(
        faults.with_random_crashes(
            faults.none(GOLDEN_N, device), threefry.key(c["seed"]),
            c["fraction"], c["start"], c["end"]), GOLDEN_LOSS)


def golden_study(device=None) -> runner.RingStudyResult:
    """The study whose digest is GOLDEN_DIGEST_STUDY, on `device`."""
    cfg = SwimConfig(n_nodes=GOLDEN_N, **STUDY_CONFIG)
    return runner.run_study_ring_stream(
        cfg, ring.init_state(cfg, device), study_plan(device),
        threefry.key(GOLDEN_SEED), GOLDEN_PERIODS, chunk=STUDY_CHUNK)


def scale_plan(n: int, device=None, periods: int = SCALE_PERIODS):
    """bench.py `bench_ring`'s plan: SCALE_CRASH_FRACTION of the nodes
    crashing at a uniform period in [0, periods), key 1."""
    return faults.with_random_crashes(
        faults.none(n, device), threefry.key(1), SCALE_CRASH_FRACTION, 0,
        max(periods, 1))


def scale_run(device=None, n: int = SCALE_N) -> ring.RingState:
    """The run whose digest at SCALE_N is GOLDEN_DIGEST_SCALE."""
    cfg = SwimConfig(n_nodes=n, ring_sel_scope="period")
    return ring.run(cfg, ring.init_state(cfg, device),
                    scale_plan(n, device), 0, SCALE_PERIODS)


def scale_study(device=None, n: int = SCALE_STUDY_N
                ) -> runner.RingStudyResult:
    """The study whose digest at SCALE_STUDY_N is
    GOLDEN_DIGEST_SCALE_STUDY: `detection_study`'s plan and streaming
    runner, pull probing."""
    from swim_tpu_torch import device as devmod
    from swim_tpu_torch.sim import experiments

    dev = devmod.resolve(device)
    cfg = SwimConfig(n_nodes=n, **STUDY_CONFIG)
    plan = experiments._crash_plan(n, 0, SCALE_STUDY_FRACTION,
                                   SCALE_STUDY_PERIODS, dev)
    return experiments._run_study(cfg, plan, threefry.key(0),
                                  SCALE_STUDY_PERIODS, "ring", dev,
                                  stream=True)


def engine_config(name: str) -> SwimConfig:
    return SwimConfig(n_nodes=ENGINE_N[name],
                      lifeguard=name == "rumor_lifeguard")


def engine_run(device=None, name: str = "dense", sharded: bool = False):
    """The fixed run whose digest is ENGINE_DIGESTS[name], on `device`.
    `sharded` runs a rumor name on the exchange-sharded engine (the
    default mesh of `device`) and returns the assembled state."""
    cfg = engine_config(name)
    nodes, at = ENGINE_CRASHES[name]
    plan = faults.with_loss(
        faults.with_crashes(faults.none(cfg.n_nodes, device), nodes, at),
        ENGINE_LOSS)
    if sharded:
        from swim_tpu_torch.parallel import mesh as pmesh
        from swim_tpu_torch.parallel import shard_engine

        mesh, state, plan, _ = shard_engine.start(cfg, plan, device)
        return pmesh.assemble(shard_engine.build_run(
            cfg, mesh, GOLDEN_PERIODS)(state, plan, GOLDEN_SEED))
    mod = dense if name == "dense" else rumor
    return mod.run(cfg, mod.init_state(cfg, device), plan, GOLDEN_SEED,
                   GOLDEN_PERIODS)


SERVE_N = 4096
SERVE_ROWS = 8
SERVE_PERIODS = 12
SERVE_SEED = 0
SERVE_SPILL_PERIOD = 3
SERVE_EVICT_PERIOD = 8
GOLDEN_DIGEST_SERVE = (
    "fa53b5d9a77887ded9158e34165172798885c6aa4e93e392a38ec81c07edf3ea")


def serve_hub_kwargs() -> dict:
    """ServeHub keywords of the scripted serve runs (both packages)."""
    return dict(reserved_rows=list(range(SERVE_ROWS)), seed=SERVE_SEED,
                ack_grace=99, frontend="socket")


def serve_datagrams(n: int, t: int, rows: list[int]) -> list:
    """Period t's scripted DGRAMs as (src row, dst node, codec bytes):
    each row a PING with 3 claims (10 in the spill period) cycling
    SUSPECT, DEAD and ALIVE, some with an origin outside [0, n) (the
    hub then names the hearer), then an ACK."""
    from swim_tpu_torch.core import codec
    from swim_tpu_torch.types import MsgKind, Status

    rng = np.random.default_rng(1000 + t)
    per = 10 if t == SERVE_SPILL_PERIOD else 3
    out = []
    for i, row in enumerate(rows):
        gossip = []
        for j in range(per):
            member = int(rng.integers(0, n))
            origin = int(rng.integers(0, n)) if j % 4 else n + j
            gossip.append(codec.WireUpdate(
                member=member, status=Status((t + i + j) % 3),
                incarnation=int(rng.integers(0, 3)), addr=("sim", member),
                origin=origin))
        ping = codec.Message(kind=MsgKind.PING, sender=row, probe_seq=t,
                             gossip=tuple(gossip))
        out.append((row, (row + 1 + 7 * t) % n, codec.encode(ping)))
        out.append((row, 0, codec.encode(codec.Message(
            kind=MsgKind.ACK, sender=row, probe_seq=t))))
    return out


def drive_serve(hub, periods: int, digest) -> list[str]:
    """Attach SERVE_ROWS sessions to `hub`, then `periods` periods of
    the scripted datagrams (the last row evicted before period
    SERVE_EVICT_PERIOD); returns `digest(hub.state)` after each."""
    rows = [hub.attach() for _ in range(SERVE_ROWS)]
    out = []
    for t in range(periods):
        live = [r for r in rows if r is not None]
        for src, dst, payload in serve_datagrams(hub.n, t, live):
            hub._on_session_datagram(None, src, dst, payload)
        if t == SERVE_EVICT_PERIOD:
            hub.evict(rows[-1])
            rows[-1] = None
        hub.step_periods(1)
        out.append(digest(hub.state))
    return out


def golden_serve(device=None, n: int = SERVE_N,
                 periods: int = SERVE_PERIODS) -> list[str]:
    """`drive_serve` on the port's hub on `device`: the digest after
    each period (the last is GOLDEN_DIGEST_SERVE at the defaults)."""
    from swim_tpu_torch.serve import hub as hub_mod
    from swim_tpu_torch.serve import load

    cfg = SwimConfig(n_nodes=n, **load.SERVE_ANCHOR)
    hub = hub_mod.ServeHub(cfg, device=device, **serve_hub_kwargs())
    try:
        return drive_serve(hub, periods, load.state_digest)
    finally:
        hub.close()


GOLDEN_DIGEST_REPLAY_STORM = (
    "07b544fa744e336786da6e0a2fd4758e1e13760fe4105cebb098c6a586930bc6")

BRIDGE_N = 2048
BRIDGE_GEOM = dict(k_indirect=1, max_piggyback=4, ring_window_periods=3,
                   suspicion_mult=2.0)
BRIDGE_SEED = 5
BRIDGE_PERIODS = 16
BRIDGE_SEND_PERIOD = 1       # a PING with a suspicion claim
BRIDGE_KILL_PERIOD = 2       # KILL of a tensor peer
BRIDGE_FORGE_PERIOD = 5      # a forged suspect(X), on the wire only
BRIDGE_LOSS_PERIOD = 9       # SET_LOSS BRIDGE_LOSS
BRIDGE_LOSS = 0.05
GOLDEN_DIGEST_BRIDGE = (
    "50f45a2be82363572673e3ce7713eccc605f00b14df78e0f856c219fc75e8d20")


def bridge_config(n: int = BRIDGE_N) -> dict:
    """SwimConfig keywords of the scripted bridge run (both packages)."""
    return dict(n_nodes=n, **BRIDGE_GEOM)


def drive_bridge(server, periods: int = BRIDGE_PERIODS,
                 digest=digest) -> list[str]:
    """The scripted session against a started EngineBridgeServer of
    either package, joined as `server.x`; returns the chained digest of
    the frames received and `digest(server.state)` after each period.
    The state is read between STEPs, while the server's session thread
    waits for the next frame."""
    from swim_tpu_torch.bridge import protocol as bp
    from swim_tpu_torch.core import codec
    from swim_tpu_torch.types import MsgKind, Status

    n, x = server.n, server.x
    h = hashlib.sha256()
    out = []
    inc = 0
    sock = socket.create_connection(server.address)

    def recv() -> bp.Frame:
        f = bp.read_frame(sock)
        if f is None:
            raise ConnectionError("bridge closed mid-script")
        h.update(bp.pack(f))
        return f

    def send(dst: int, msg) -> None:
        bp.write_frame(sock, bp.Frame(bp.SEND, a=x, b=dst,
                                      payload=codec.encode(msg)))

    try:
        bp.write_frame(sock, bp.Frame(bp.HELLO, a=x))
        if recv().op != bp.WELCOME:
            raise ConnectionError("no WELCOME")
        for t in range(periods):
            if t == BRIDGE_SEND_PERIOD:
                m = n // 8
                send(7, codec.Message(
                    kind=MsgKind.PING, sender=x, probe_seq=1000 + t,
                    gossip=(codec.WireUpdate(m, Status.SUSPECT, 0,
                                             ("sim", m), x),)))
            if t == BRIDGE_KILL_PERIOD:
                bp.write_frame(sock, bp.Frame(bp.KILL, a=n // 16))
            if t == BRIDGE_FORGE_PERIOD:
                server.deliver_forged(3, [codec.WireUpdate(
                    x, Status.SUSPECT, 0, ("sim", x), 3)])
            if t == BRIDGE_LOSS_PERIOD:
                bp.write_frame(sock, bp.Frame(bp.SET_LOSS, t=BRIDGE_LOSS))
            bp.write_frame(sock, bp.Frame(bp.STEP, t=1.0))
            while (f := recv()).op != bp.TIME:
                msg = codec.decode(f.payload)
                if msg.kind != MsgKind.PING:
                    continue
                # ack like a live core; refute a suspicion of ourselves
                claim = [u.incarnation for u in msg.gossip
                         if u.member == x and u.status == Status.SUSPECT
                         and u.incarnation >= inc]
                gossip = ()
                if claim:
                    inc = max(claim) + 1
                    gossip = (codec.WireUpdate(x, Status.ALIVE, inc,
                                               ("sim", x), x),)
                send(f.a, codec.Message(
                    kind=MsgKind.ACK, sender=x, probe_seq=msg.probe_seq,
                    on_behalf=msg.on_behalf, gossip=gossip))
            h.update(digest(server.state).encode())
            out.append(h.hexdigest())
        bp.write_frame(sock, bp.Frame(bp.BYE))
    finally:
        sock.close()
    return out


def golden_bridge(device=None, n: int = BRIDGE_N,
                  periods: int = BRIDGE_PERIODS, cfg_kw: dict | None = None
                  ) -> tuple[list[str], object]:
    """`drive_bridge` against the port's EngineBridgeServer on `device`
    (`cfg_kw` replaces BRIDGE_GEOM); returns (the digests, the server).
    The last digest is GOLDEN_DIGEST_BRIDGE at the defaults."""
    from swim_tpu_torch.bridge import EngineBridgeServer

    kw = bridge_config(n) if cfg_kw is None else dict(n_nodes=n, **cfg_kw)
    server = EngineBridgeServer(SwimConfig(**kw), external_id=n - 1,
                                seed=BRIDGE_SEED, device=device)
    server.start()
    try:
        return drive_bridge(server, periods), server
    finally:
        server.close()
        server.join(timeout=60)

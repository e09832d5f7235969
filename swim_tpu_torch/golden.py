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

GOLDEN_DIGEST_STUDY is `study_digest` of `golden_study(device)`: a
pull-mode streaming detection study (the default wave scope, N = 4096,
1% of the nodes crashing at random, loss 0.02, seed 0, 40 periods in
chunks of 16), hashing its final state, CompactTrack and series.

ENGINE_DIGESTS holds the digest after `engine_run(device, name)` for
the dense and rumor engines (40 periods, loss 0.05, crashes at a few
nodes, seed 0): `dense` (N = 256), `rumor` (N = 4096) and
`rumor_lifeguard` (N = 4096, Lifeguard with buddy and dynamic
suspicion).
"""
from __future__ import annotations

import hashlib

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

STUDY_CONFIG = dict(ring_probe="pull")
STUDY_CRASHES = dict(seed=1, fraction=0.01, start=2, end=20)
STUDY_CHUNK = 16
GOLDEN_DIGEST_STUDY = (
    "fc526b3b9e4d8fa9cf20d31a65a12197ccc1b3492924eeb364179b470e7b492d")

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
        a = np.asarray(arrays[f]).astype(_DTYPES[f], copy=False)
        h.update(f"{f}:{a.shape}:".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def golden_config(name: str = "period"):
    """(cfg, crash node ids, crash periods) of the golden run `name`."""
    cfg = SwimConfig(n_nodes=GOLDEN_N, **GOLDEN_CONFIGS[name])
    return cfg, GOLDEN_CRASHES[0], GOLDEN_CRASHES[1]


def golden_run(device=None, name: str = "period") -> ring.RingState:
    """The fixed run whose digest is GOLDEN_DIGESTS[name], on `device`."""
    cfg, nodes, at = golden_config(name)
    plan = faults.with_loss(
        faults.with_crashes(faults.none(cfg.n_nodes, device), nodes, at),
        GOLDEN_LOSS)
    state = ring.init_state(cfg, device)
    return ring.run(cfg, state, plan, GOLDEN_SEED, GOLDEN_PERIODS)


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


def engine_config(name: str) -> SwimConfig:
    return SwimConfig(n_nodes=ENGINE_N[name],
                      lifeguard=name == "rumor_lifeguard")


def engine_run(device=None, name: str = "dense"):
    """The fixed run whose digest is ENGINE_DIGESTS[name], on `device`."""
    cfg = engine_config(name)
    nodes, at = ENGINE_CRASHES[name]
    plan = faults.with_loss(
        faults.with_crashes(faults.none(cfg.n_nodes, device), nodes, at),
        ENGINE_LOSS)
    mod = dense if name == "dense" else rumor
    return mod.run(cfg, mod.init_state(cfg, device), plan, GOLDEN_SEED,
                   GOLDEN_PERIODS)

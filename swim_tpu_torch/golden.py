"""A digest of RingState and the digest of one fixed run.

`digest(state)` is the sha256 of the 14 RingState fields in their
declared order, each as its field name, shape and little-endian bytes
in the reference's dtype (u32 fields as uint32).  It accepts the port's
RingState or a mapping of numpy arrays (the reference's state through
`np.asarray`), so one constant holds both packages and the card to the
same trajectory without JAX on the card's machine.

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
"""
from __future__ import annotations

import hashlib

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.convert import state_to_numpy
from swim_tpu_torch.models import ring
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

_DTYPES = {
    "win": "<u4", "cold": "<u4", "inc_self": "<u4", "lha": "<i4",
    "gone_key": "<u4", "subject": "<i4", "rkey": "<u4", "birth0": "<i4",
    "sent_node": "<i4", "sent_time": "<i4", "confirmed": "|b1",
    "overflow": "<i4", "index_overflow": "<i4", "step": "<i4",
}


def digest(state) -> str:
    if isinstance(state, ring.RingState):
        arrays = state_to_numpy(state)
    else:
        arrays = {f: np.asarray(state[f]) for f in ring.RingState._fields}
    h = hashlib.sha256()
    for f in ring.RingState._fields:
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

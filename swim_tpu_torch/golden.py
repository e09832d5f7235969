"""A digest of RingState and the digest of one fixed run.

`digest(state)` is the sha256 of the 14 RingState fields in their
declared order, each as its field name, shape and little-endian bytes
in the reference's dtype (u32 fields as uint32).  It accepts the port's
RingState or a mapping of numpy arrays (the reference's state through
`np.asarray`), so one constant holds both packages and the card to the
same trajectory without JAX on the card's machine.

GOLDEN_DIGEST is the digest after `golden_run`: N = 4096, period scope,
crashes at a few nodes, loss 0.02, seed 0, 40 periods
(tests/test_torch_golden.py checks it against both packages).
"""
from __future__ import annotations

import hashlib

import numpy as np

from swim_tpu_torch.config import SwimConfig
from swim_tpu_torch.convert import state_to_numpy
from swim_tpu_torch.models import ring
from swim_tpu_torch.sim import faults

GOLDEN_N = 4096
GOLDEN_PERIODS = 40
GOLDEN_SEED = 0
GOLDEN_LOSS = 0.02
GOLDEN_CRASHES = ([5, 77, 1000, 2049, 4095], [2, 3, 5, 8, 13])

GOLDEN_DIGEST = (
    "4863822e1b0f94a33ce318c94ef56f43d947d3a5dd7cc19daf38ddf552817117")

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


def golden_config():
    """(cfg, crash node ids, crash periods) of the golden run."""
    cfg = SwimConfig(n_nodes=GOLDEN_N, ring_sel_scope="period")
    return cfg, GOLDEN_CRASHES[0], GOLDEN_CRASHES[1]


def golden_run(device=None) -> ring.RingState:
    """The fixed run whose digest is GOLDEN_DIGEST, on `device`."""
    cfg, nodes, at = golden_config()
    plan = faults.with_loss(
        faults.with_crashes(faults.none(cfg.n_nodes, device), nodes, at),
        GOLDEN_LOSS)
    state = ring.init_state(cfg, device)
    return ring.run(cfg, state, plan, GOLDEN_SEED, GOLDEN_PERIODS)

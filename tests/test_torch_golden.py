"""golden.GOLDEN_DIGEST holds both packages to one trajectory.

The JAX package's run and the port's CPU run of the golden config must
both give the committed digest; chip_smoke.py asserts that the port on
the card gives it too, which holds the card to the JAX package without
JAX on the card's machine.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.sim import faults as jfaults
from swim_tpu.types import Status, key_status
from swim_tpu_torch import convert, golden
from swim_tpu_torch.models import ring


@pytest.fixture(scope="module")
def jax_golden_state():
    cfg, nodes, at = golden.golden_config()
    jcfg = JaxSwimConfig(n_nodes=cfg.n_nodes, ring_sel_scope="period")
    plan = jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(cfg.n_nodes), nodes, at),
        golden.GOLDEN_LOSS)
    return jring.run(jcfg, jring.init_state(jcfg), plan,
                     jax.random.key(golden.GOLDEN_SEED),
                     golden.GOLDEN_PERIODS)


def test_jax_run_gives_the_golden_digest(jax_golden_state):
    st = {f: np.asarray(getattr(jax_golden_state, f))
          for f in jax_golden_state._fields}
    assert golden.digest(st) == golden.GOLDEN_DIGEST


def test_port_cpu_run_gives_the_golden_digest():
    assert golden.digest(golden.golden_run("cpu")) == golden.GOLDEN_DIGEST


def test_golden_run_detects_the_crashes(jax_golden_state):
    """The digest pins a run that does something: early crashes are
    tombstoned DEAD, and no rumor was dropped."""
    gone = np.asarray(jax_golden_state.gone_key)
    nodes, at = golden.GOLDEN_CRASHES
    early = [nd for nd, t in zip(nodes, at) if t <= 5]
    assert all(key_status(int(gone[nd])) == Status.DEAD for nd in early)
    assert int(jax_golden_state.overflow) == 0


def test_digest_sees_every_field():
    cfg, _, _ = golden.golden_config()
    base = convert.state_to_numpy(ring.init_state(cfg.replace(n_nodes=64),
                                                  "cpu"))
    ref = golden.digest(base)
    assert golden.digest(convert.state_from_numpy(base, "cpu")) == ref
    for f in ring.RingState._fields:
        changed = {k: v.copy() for k, v in base.items()}
        a = changed[f].reshape(-1) if changed[f].ndim else changed[f]
        if changed[f].ndim:
            a[0] = ~a[0] if a.dtype == np.bool_ else a[0] + 1
        else:
            changed[f] = a + 1
        assert golden.digest(changed) != ref, f

"""golden.GOLDEN_DIGESTS holds both packages to one trajectory each.

The JAX package's run and the port's CPU run of each golden config
(period scope, wave scope, Lifeguard with buddy; the dense engine, the
rumor engine, the rumor engine with Lifeguard) must both give the
committed digest; chip_smoke.py asserts that the port on the card gives
it too, which holds the card to the JAX package without JAX on the
card's machine.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import dense as jdense
from swim_tpu.models import ring as jring
from swim_tpu.models import rumor as jrumor
from swim_tpu.sim import faults as jfaults
from swim_tpu.types import Status, key_status
from swim_tpu_torch import convert, golden
from swim_tpu_torch.models import dense, ring, rumor

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_golden_run(name):
    cfg, nodes, at = golden.golden_config(name)
    jcfg = JaxSwimConfig(n_nodes=cfg.n_nodes, **golden.GOLDEN_CONFIGS[name])
    plan = jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(cfg.n_nodes), nodes, at),
        golden.GOLDEN_LOSS)
    return jring.run(jcfg, jring.init_state(jcfg), plan,
                     jax.random.key(golden.GOLDEN_SEED),
                     golden.GOLDEN_PERIODS)


@pytest.fixture(scope="module")
def jax_golden_state():
    return jax_golden_run("period")


def test_jax_run_gives_the_golden_digest(jax_golden_state):
    st = {f: np.asarray(getattr(jax_golden_state, f))
          for f in jax_golden_state._fields}
    assert golden.digest(st) == golden.GOLDEN_DIGEST


def test_port_cpu_run_gives_the_golden_digest():
    assert golden.digest(golden.golden_run("cpu")) == golden.GOLDEN_DIGEST


@pytest.mark.parametrize("name", ["wave", "lifeguard"])
def test_jax_run_gives_the_golden_digest_of(name):
    ref = jax_golden_run(name)
    st = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    assert golden.digest(st) == golden.GOLDEN_DIGESTS[name]
    if name == "lifeguard":     # the digest pins a run that used Lifeguard
        assert int(st["lha"].max()) > 0


@pytest.mark.parametrize("name", ["wave", "lifeguard"])
def test_port_cpu_run_gives_the_golden_digest_of(name):
    assert (golden.digest(golden.golden_run("cpu", name))
            == golden.GOLDEN_DIGESTS[name])


def test_golden_digests_differ():
    assert len(set(golden.GOLDEN_DIGESTS.values())) == 3
    assert golden.GOLDEN_DIGESTS["period"] == golden.GOLDEN_DIGEST


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


def jax_engine_run(name):
    cfg = golden.engine_config(name)
    jcfg = JaxSwimConfig(n_nodes=cfg.n_nodes, lifeguard=cfg.lifeguard)
    nodes, at = golden.ENGINE_CRASHES[name]
    plan = jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(cfg.n_nodes), nodes, at),
        golden.ENGINE_LOSS)
    mod = jdense if name == "dense" else jrumor
    st = mod.run(jcfg, mod.init_state(jcfg), plan,
                 jax.random.key(golden.GOLDEN_SEED), golden.GOLDEN_PERIODS)
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


@pytest.mark.parametrize("name", sorted(golden.ENGINE_DIGESTS))
def test_engine_digests_from_both_packages(name):
    ref = jax_engine_run(name)
    assert golden.digest(ref) == golden.ENGINE_DIGESTS[name]
    got = golden.engine_run("cpu", name)
    assert golden.digest(got) == golden.ENGINE_DIGESTS[name]
    # the digest pins a run that confirmed deaths (Lifeguard: and moved
    # the health scores)
    if name == "dense":
        assert (ref["key"] >> 31).any()
    else:
        assert ((ref["rkey"] >> 31).astype(bool) & (ref["subject"] >= 0)).any()
    if name == "rumor_lifeguard":
        assert int(ref["lha"].max()) > 0


def test_engine_digests_differ_and_see_every_field():
    assert len(set(golden.ENGINE_DIGESTS.values())) == 3
    for mod, cls, n in ((dense, dense.DenseState, 16),
                        (rumor, rumor.RumorState, 16)):
        cfg = golden.engine_config("dense").replace(n_nodes=n)
        base = convert.state_to_numpy(mod.init_state(cfg, "cpu"))
        ref = golden.digest(base)
        assert golden.digest(convert.state_from_numpy(base, "cpu", cls)) \
            == ref
        for f in cls._fields:
            changed = {k: v.copy() for k, v in base.items()}
            a = changed[f].reshape(-1) if changed[f].ndim else changed[f]
            if changed[f].ndim:
                a[0] = ~a[0] if a.dtype == np.bool_ else a[0] ^ 1
            else:
                changed[f] = a + 1
            assert golden.digest(changed) != ref, f


def test_serve_golden_digest_in_both_packages():
    """golden.drive_serve through the JAX package's hub and the port's
    hub on the CPU: equal digests after every period, the last one
    GOLDEN_DIGEST_SERVE (chip_smoke.py checks the card)."""
    from swim_tpu.serve import hub as jhub
    from swim_tpu.serve import load as jload

    ref = jhub.ServeHub(JaxSwimConfig(n_nodes=golden.SERVE_N,
                                      **jload.SERVE_ANCHOR),
                        **golden.serve_hub_kwargs())
    try:
        want = golden.drive_serve(ref, golden.SERVE_PERIODS,
                                  jload.state_digest)
        assert ref.report()["mirror_spill_slots"] > 0
        assert ref.report()["evicted"] == 1
    finally:
        ref.close()
    got = golden.golden_serve("cpu")
    assert got == want
    assert got[-1] == golden.GOLDEN_DIGEST_SERVE

"""The Phase-D external channel (`ring.ExtOriginations`) against the JAX
package's, bit for bit.

The five cases of tests/test_ext_originations.py, in period and in wave
scope: an empty batch is a no-op, an injected rumor lands with its
hearer holding the bit, duplicates and existing rumors dedup, an
injected suspicion spreads and is refuted, an injected death
disseminates.  Plus one injection case with Lifeguard and buddy and one
on the packed scalar wire.  Every case steps the JAX engine
(`ring.step(..., ext=)`, jitted once per config) and the port from the
same state, randomness and batch, compares all 14 RingState fields
after every period (tolerance 0: bitwise), and then asserts the
reference test's own claims on the port's state.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.ops import lattice as jlattice
from swim_tpu.sim import faults as jfaults
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import ring

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 64
SCOPES = {"period": dict(ring_sel_scope="period"), "wave": {}}
EXTRA = {"lifeguard": dict(ring_sel_scope="period", lifeguard=True),
         "packed": dict(ring_sel_scope="period",
                        ring_scalar_wire="packed")}


def np_fields(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@functools.lru_cache(maxsize=None)
def jax_step(kw: tuple):
    return jax.jit(functools.partial(
        jring.step, JaxSwimConfig(n_nodes=N, **dict(kw))))


def inject(entries, capacity=8):
    """A JAX batch of `capacity` slots holding `entries`."""
    subject = np.full((capacity,), -1, np.int32)
    key = np.zeros((capacity,), np.uint32)
    origin = np.zeros((capacity,), np.int32)
    hearer = np.zeros((capacity,), np.int32)
    for i, (s, k, o, h) in enumerate(entries):
        subject[i], key[i], origin[i], hearer[i] = s, k, o, h
    return jring.ExtOriginations(subject=jnp.asarray(subject),
                                 key=jnp.asarray(key),
                                 origin=jnp.asarray(origin),
                                 hearer=jnp.asarray(hearer))


def run_both(kw: dict, periods: int, ext_by_period=None, seed=0):
    """Both engines for `periods` periods from the initial state, every
    period with a batch (ext_none(8) where none is given); all 14 fields
    equal after every period.  Returns (port state, JAX state)."""
    cfg = SwimConfig(n_nodes=N, **kw)
    jcfg = JaxSwimConfig(n_nodes=N, **kw)
    step = jax_step(tuple(sorted(kw.items())))
    jstate = jring.init_state(jcfg)
    plan = jfaults.none(N)
    pplan = convert.plan_from_numpy(np_fields(plan), "cpu")
    state = convert.state_from_numpy(np_fields(jstate), "cpu")
    key = jax.random.key(seed)
    for t in range(periods):
        ext = (ext_by_period or {}).get(t, jring.ext_none(8))
        rnd = jring.draw_period_ring(key, t, jcfg)
        jstate = step(jstate, plan, rnd, ext=ext)
        state = ring.step(
            cfg, state, pplan,
            convert.randomness_from_numpy(np_fields(rnd), "cpu"),
            ext=convert.ext_from_numpy(np_fields(ext), "cpu"))
        got = convert.state_to_numpy(state)
        for f, want in np_fields(jstate).items():
            assert got[f].dtype == want.dtype, f"{f} dtype @ {t}"
            np.testing.assert_array_equal(got[f], want,
                                          err_msg=f"{f} @ period {t}")
    return state, jstate


def table_lookup(state, subj):
    st = convert.state_to_numpy(state)
    return st["rkey"][st["subject"] == subj]


def resolved(cfg, state) -> np.ndarray:
    return ring.resolved_words(cfg, state).numpy().view(np.uint32)


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_empty_batch_is_bitwise_noop(scope):
    """ext_none is a no-op: the port's run with it equals its run
    without any batch, and both equal the JAX run with it."""
    kw = SCOPES[scope]
    cfg = SwimConfig(n_nodes=N, **kw)
    with_ext, _ = run_both(kw, 6)
    plain = ring.run(cfg, ring.init_state(cfg, "cpu"),
                     convert.plan_from_numpy(np_fields(jfaults.none(N)),
                                             "cpu"), 0, 6)
    assert int(ring.ext_none(8, "cpu").subject.min()) == -1
    for f in ring.RingState._fields:
        assert torch.equal(getattr(with_ext, f), getattr(plain, f)), f


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_injected_rumor_lands_and_hearer_gets_bit(scope):
    kw = SCOPES[scope]
    akey = int(jlattice.alive_key(jnp.uint32(7)))
    out, _ = run_both(kw, 1, {0: inject([(5, akey, 5, 12)])})
    assert akey in table_lookup(out, 5).tolist()
    st = convert.state_to_numpy(out)
    (slot,) = [i for i in range(len(st["subject"]))
               if st["subject"][i] == 5 and st["rkey"][i] == akey]
    words = resolved(SwimConfig(n_nodes=N, **kw), out)
    col = (words[:, slot // 32] >> (slot % 32)) & 1
    assert col[12] == 1 and int(col.sum()) == 1


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_duplicate_and_existing_injections_dedup(scope):
    kw = SCOPES[scope]
    akey = int(jlattice.alive_key(jnp.uint32(3)))
    out, _ = run_both(kw, 2, {0: inject([(9, akey, 9, 4), (9, akey, 9, 30)]),
                              1: inject([(9, akey, 9, 11)])})
    assert len(table_lookup(out, 9)) == 1


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_injected_suspicion_spreads_and_is_refuted(scope):
    kw = SCOPES[scope]
    skey = int(jlattice.suspect_key(jnp.uint32(0)))
    out, _ = run_both(kw, 18, {0: inject([(20, skey, 63, 40)])})
    st = convert.state_to_numpy(out)
    assert int(st["inc_self"][20]) >= 1
    alive_new = int(jlattice.alive_key(jnp.uint32(1)))
    keys = [int(k) for k in table_lookup(out, 20)]
    keys.append(int(st["gone_key"][20]))
    assert any(k >= alive_new and not (k & 1) and not (k >> 31)
               for k in keys), [hex(k) for k in keys]


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_injected_death_disseminates_to_all_views(scope):
    kw = SCOPES[scope]
    dkey = int(jlattice.dead_key(jnp.uint32(0)))
    out, _ = run_both(kw, 20, {2: inject([(33, dkey, 7, 7)])})
    st = convert.state_to_numpy(out)
    if (int(st["gone_key"][33]) >> 31) & 1:
        return   # fully disseminated + tombstoned: every view is DEAD
    slots = [i for i in range(len(st["subject"]))
             if st["subject"][i] == 33 and (int(st["rkey"][i]) >> 31)]
    assert slots, "dead rumor vanished without a tombstone"
    words = resolved(SwimConfig(n_nodes=N, **kw), out)
    sl = slots[0]
    frac = float(((words[:, sl // 32] >> (sl % 32)) & 1).mean())
    assert frac > 0.9, f"dead(33) reached only {frac:.0%} of nodes"


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_injections_under(name):
    """Lifeguard with buddy, and the packed scalar wire: a suspicion, a
    death, a duplicate, a hearer given as -1 (JAX's scatter wraps it to
    row N-1) and one beyond the batch's own entries, every period
    equal; the suspicion is refuted."""
    kw = EXTRA[name]
    skey = int(jlattice.suspect_key(jnp.uint32(0)))
    dkey = int(jlattice.dead_key(jnp.uint32(0)))
    batches = {0: inject([(20, skey, 63, 40), (33, dkey, 7, -1),
                          (33, dkey, 7, 5)]),
               3: inject([(41, skey, 2, 9), (41, skey, 3, 10)])}
    out, _ = run_both(kw, 14, batches)
    assert int(convert.state_to_numpy(out)["inc_self"][20]) >= 1

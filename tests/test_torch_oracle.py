"""The port's scalar oracles (swim_tpu_torch/models/oracle.py,
rumor_oracle.py, ring_oracle.py), exact, on the CPU with the port's
draws only (no JAX draw and no JAX compile in this file):

  * each port oracle against its JAX oracle: the same numpy randomness
    (the port's draws through `prng.to_numpy` / `ring_oracle.to_numpy`)
    and the same plan go into both, and every field of the oracle state
    is equal after every period;
  * the port's dense, rumor and ring engines against the port's
    oracles, in the reference's cases of tests/test_oracle.py,
    tests/test_dense_vs_oracle.py, tests/test_rumor_vs_scalar.py and the
    oracle cases of tests/test_ring.py (TestBitwiseVsOracle but the
    sentinel-cap case, which pins a JAX `lax.cond` the port does not
    have, the geometry sweep one config a case, the pull cases and
    test_lifeguard_join_rotor_bitwise), with the reference's
    comparisons: every field of the dense and rumor states, and for the
    ring the reference's `assert_states_equal` as it is (table slots
    only where `subject >= 0`, cold only outside the window's columns).

`threefry.key(seed)` draws what `jax.random.key(seed)` draws, so every
case keeps the reference's seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import oracle as jax_oracle
from swim_tpu.models import ring_oracle as jax_ring_oracle
from swim_tpu.models import rumor_oracle as jax_rumor_oracle
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import (dense, oracle, ring, ring_oracle, rumor,
                                   rumor_oracle)
from swim_tpu_torch.sim import faults
from swim_tpu_torch.types import Status, key_incarnation, key_status
from swim_tpu_torch.utils import prng, threefry

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def none(n):
    return faults.none(n, CPU)


# ---------------------------------------------------------------------------
# port oracle == JAX oracle on the same numpy draws
# ---------------------------------------------------------------------------

def _assert_oracle_states_equal(a, b, where: str) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{f.name} @ {where}")


def _dense_draws(cfg, seed, t):
    return prng.to_numpy(prng.draw_period(threefry.key(seed), t, cfg, CPU))


def _rumor_draws(cfg, seed, t):
    r = rumor.draw_period_rumor(threefry.key(seed), t, cfg, CPU)
    return rumor.RumorRandomness(base=prng.to_numpy(r.base),
                                 resample_u=prng.host(r.resample_u))


def _ring_draws(cfg, seed, t):
    return ring_oracle.to_numpy(
        ring.draw_period_ring(threefry.key(seed), t, cfg, CPU))


ORACLE_PAIRS = {
    # name: (port module.class, JAX module.class, cfg kw, plan, draws,
    #        periods, seed)
    "dense": (oracle.Oracle, jax_oracle.Oracle,
              dict(n_nodes=24, suspicion_mult=1.5, lifeguard=True),
              lambda n: faults.with_partition(faults.with_crashes(
                  faults.with_loss(none(n), 0.15), [1, 2], [2, 6]),
                  faults.halves(n), 4, 10),
              _dense_draws, 20, 4),
    "rumor": (rumor_oracle.RumorOracle, jax_rumor_oracle.RumorOracle,
              dict(n_nodes=32, rumor_capacity=64, lifeguard=True,
                   dynamic_suspicion=True, buddy=True,
                   suspicion_max_mult=3.0),
              lambda n: faults.with_loss(
                  faults.with_crashes(none(n), [4, 19], [2]), 0.15),
              _rumor_draws, 26, 2),
    "ring": (ring_oracle.RingOracle, jax_ring_oracle.RingOracle,
             dict(n_nodes=32, lifeguard=True, dynamic_suspicion=True,
                  buddy=True),
             lambda n: faults.with_loss(
                 faults.with_crashes(none(n), [4, 19], [2]), 0.1),
             _ring_draws, 22, 2),
    "ring_pull": (ring_oracle.RingOracle, jax_ring_oracle.RingOracle,
                  dict(n_nodes=24, ring_probe="pull"),
                  lambda n: faults.with_joins(faults.with_partition(
                      faults.with_loss(none(n), 0.1), faults.halves(n),
                      3, 9), [20], [5]),
                  _ring_draws, 18, 4),
}


@pytest.mark.parametrize("name", list(ORACLE_PAIRS))
def test_port_oracle_equals_jax_oracle(name):
    port_cls, jax_cls, kw, mk_plan, draws, periods, seed = ORACLE_PAIRS[name]
    cfg = SwimConfig(**kw)
    plan = mk_plan(cfg.n_nodes)
    ours = port_cls(cfg, plan)
    theirs = jax_cls(JaxSwimConfig(**kw), faults.to_numpy(plan))
    for t in range(periods):
        rnd = draws(cfg, seed, t)
        ours.step(rnd)
        theirs.step(rnd)
        _assert_oracle_states_equal(ours.state, theirs.state,
                                    f"{name} period {t}")


# ---------------------------------------------------------------------------
# tests/test_oracle.py: the dense oracle's behaviour
# ---------------------------------------------------------------------------

def statuses(state):
    return np.vectorize(key_status)(state.key.astype(np.int64))


def _oracle_quiet():
    cfg = SwimConfig(n_nodes=12)
    o = oracle.Oracle(cfg, none(12))
    o.run(threefry.key(0), 6)
    assert (statuses(o.state) == Status.ALIVE).all()
    assert (o.state.key == o.state.key[0, 0]).all()


def _oracle_crash_disseminated():
    cfg = SwimConfig(n_nodes=16, suspicion_mult=2.0)
    o = oracle.Oracle(cfg, faults.with_crashes(none(16), [5], 0))
    o.run(threefry.key(1), 30)
    st = statuses(o.state)
    live = [i for i in range(16) if i != 5]
    assert all(st[i, 5] == Status.DEAD for i in live)
    for i in live:
        for j in live:
            assert st[i, j] == Status.ALIVE


def _oracle_first_detection_time():
    n = 24
    cfg = SwimConfig(n_nodes=n)
    times = []
    for seed in range(40):
        o = oracle.Oracle(cfg, faults.with_crashes(none(n), [0], 0))
        detected_at = None
        for t in range(12):
            o.step(_dense_draws(cfg, seed, t))
            if any(key_status(int(o.state.key[i, 0])) != Status.ALIVE
                   for i in range(1, n)):
                detected_at = t + 1
                break
        assert detected_at is not None
        times.append(detected_at)
    expect = 1.0 / (1.0 - (1.0 - 1.0 / (n - 1)) ** (n - 1))
    assert abs(float(np.mean(times)) - expect) < 0.45


def _oracle_refutation():
    n = 8
    cfg = SwimConfig(n_nodes=n, suspicion_mult=8.0)
    g = np.zeros(n, np.int32)
    g[7] = 1
    o = oracle.Oracle(cfg, faults.with_partition(none(n), g, 0, 3))
    o.run(threefry.key(3), 20)
    st = o.state
    assert all(key_status(int(st.key[i, 7])) != Status.DEAD
               for i in range(n))
    assert key_incarnation(int(st.key[7, 7])) >= 1
    assert all(key_incarnation(int(st.key[i, 7])) >= 1 for i in range(n))


def _oracle_partition_mutual_death():
    n = 10
    cfg = SwimConfig(n_nodes=n, suspicion_mult=1.0)
    o = oracle.Oracle(cfg, faults.with_partition(none(n), faults.halves(n),
                                                 0, 10**6))
    o.run(threefry.key(4), 40)
    st = statuses(o.state)
    for i in range(n):
        for j in range(n):
            if (i < n // 2) == (j < n // 2):
                assert st[i, j] != Status.DEAD
            else:
                assert st[i, j] == Status.DEAD


ORACLE_BEHAVIOUR = {
    "quiet_cluster_stays_converged": _oracle_quiet,
    "crash_is_detected_and_disseminated": _oracle_crash_disseminated,
    "first_detection_time_matches_paper": _oracle_first_detection_time,
    "refutation_bumps_incarnation": _oracle_refutation,
    "partition_mutual_death": _oracle_partition_mutual_death,
}


@pytest.mark.parametrize("name", list(ORACLE_BEHAVIOUR))
def test_dense_oracle_behaviour(name):
    ORACLE_BEHAVIOUR[name]()


# ---------------------------------------------------------------------------
# tests/test_dense_vs_oracle.py: the port's dense engine == the oracle
# ---------------------------------------------------------------------------

def dense_run_both(cfg, plan, seed, periods):
    o = oracle.Oracle(cfg, plan)
    est = dense.init_state(cfg, CPU)
    key = threefry.key(seed)
    for t in range(periods):
        rnd = prng.draw_period(key, t, cfg, CPU)
        o.step(rnd)
        est = dense.step(cfg, est, plan, rnd)
        got = convert.state_to_numpy(est)
        for name in ("key", "retransmit", "deadline", "lha"):
            a = got[name]
            b = np.asarray(getattr(o.state, name))
            if not np.array_equal(a, b):
                bad = np.argwhere(a != b)[:8]
                raise AssertionError(
                    f"{name} diverged at period {t}; first diffs at "
                    f"{bad.tolist()}: engine={a[tuple(bad[0])]} "
                    f"oracle={b[tuple(bad[0])]}")
    return o, est


def _rr_bounded_detection():
    n = 16
    cfg = SwimConfig(n_nodes=n, target_selection="round_robin")
    o = oracle.Oracle(cfg, faults.with_crashes(none(n), [7], [2]))
    first = None
    for t in range(2 + n):
        o.step(_dense_draws(cfg, 11, t))
        views = o.state.key[:, 7]
        if any(key_status(int(views[i])) != Status.ALIVE
               for i in range(n) if i != 7):
            first = t
            break
    assert first is not None and first <= 2 + n - 1


def _run_matches_loop():
    cfg = SwimConfig(n_nodes=16, suspicion_mult=2.0)
    plan = faults.with_crashes(none(16), [4], [0])
    st = dense.init_state(cfg, CPU)
    for t in range(12):
        st = dense.step(cfg, st, plan,
                        prng.draw_period(threefry.key(8), t, cfg, CPU))
    ran = dense.run(cfg, dense.init_state(cfg, CPU), plan, 8, 12)
    for a, b in zip(ran, st):
        assert torch.equal(a, b)


def _join_crash():
    for sel in ("uniform", "round_robin"):
        n = 20
        plan = faults.with_joins(none(n), [16, 17], [4])
        plan = faults.with_crashes(plan, [2, 16], [8])
        dense_run_both(SwimConfig(n_nodes=n, target_selection=sel),
                       faults.with_loss(plan, 0.1), 6, 16)


def _tiny_cluster_edges():
    for n, seed in ((2, 6), (3, 7)):
        dense_run_both(SwimConfig(n_nodes=n, suspicion_mult=1.0),
                       faults.with_crashes(none(n), [0], [1]), seed, 10)


def _everything(n=24):
    plan = faults.with_crashes(faults.with_loss(none(n), 0.15), [1, 2],
                               [2, 6])
    return faults.with_partition(plan, faults.halves(n), 4, 10)


DENSE_CASES = {
    "quiet_cluster": lambda: dense_run_both(
        SwimConfig(n_nodes=16), none(16), 0, 8),
    "stock_demo_with_crashes": lambda: dense_run_both(
        SwimConfig(n_nodes=32, suspicion_mult=2.0),
        faults.with_crashes(none(32), [3, 17], [0, 4]), 1, 20),
    "lossy_network": lambda: dense_run_both(
        SwimConfig(n_nodes=20, suspicion_mult=2.0),
        faults.with_loss(none(20), 0.3), 2, 16),
    "partition_heals": lambda: dense_run_both(
        SwimConfig(n_nodes=18, suspicion_mult=3.0),
        faults.with_partition(none(18), faults.halves(18), 2, 9), 3, 18),
    "everything_at_once": lambda: dense_run_both(
        SwimConfig(n_nodes=24, suspicion_mult=1.5), _everything(), 4, 24),
    "lifeguard_parity": lambda: dense_run_both(
        SwimConfig(n_nodes=20, suspicion_mult=2.0, lifeguard=True),
        faults.with_crashes(faults.with_loss(none(20), 0.25), [5], [3]),
        5, 18),
    "tiny_cluster_edges": _tiny_cluster_edges,
    "piggyback_wider_than_cluster": lambda: dense_run_both(
        SwimConfig(n_nodes=4, suspicion_mult=2.0, lifeguard=True),
        faults.with_loss(none(4), 0.3), 9, 14),
    "round_robin_parity": lambda: dense_run_both(
        SwimConfig(n_nodes=22, suspicion_mult=2.0,
                   target_selection="round_robin"),
        faults.with_crashes(faults.with_loss(none(22), 0.2), [4, 9],
                            [2, 5]), 10, 24),
    "round_robin_bounded_detection": _rr_bounded_detection,
    "run_matches_python_loop": _run_matches_loop,
    "join_crash_bitwise": _join_crash,
}


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_engine_equals_oracle(name):
    DENSE_CASES[name]()


# ---------------------------------------------------------------------------
# tests/test_rumor_vs_scalar.py: the port's rumor engine == the oracle
# ---------------------------------------------------------------------------

def rumor_assert_states_equal(ost, est, t):
    got = convert.state_to_numpy(est)
    np.testing.assert_array_equal(ost.knows, got["knows"],
                                  err_msg=f"knows @ period {t}")
    for name in ("inc_self", "lha", "gone_key", "subject", "rkey", "birth",
                 "sent_node", "sent_time", "confirmed"):
        np.testing.assert_array_equal(getattr(ost, name), got[name],
                                      err_msg=f"{name} @ period {t}")
    assert int(ost.overflow) == int(got["overflow"]), t
    assert int(ost.step) == int(got["step"]), t


def rumor_run_both(cfg, plan, periods, seed=7):
    orc = rumor_oracle.RumorOracle(cfg, plan)
    est = rumor.init_state(cfg, CPU)
    max_sentinels = 0
    for t in range(periods):
        rnd = rumor.draw_period_rumor(threefry.key(seed), t, cfg, CPU)
        orc.step(rnd)
        est = rumor.step(cfg, est, plan, rnd)
        rumor_assert_states_equal(orc.state, est, t)
        max_sentinels = max(max_sentinels, int(
            (est.sent_node >= 0).sum(dim=1).max()))
    return orc.state, est, max_sentinels


def _rumor_crash_loss():
    orc, _, _ = rumor_run_both(
        SwimConfig(n_nodes=32, rumor_capacity=64),
        faults.with_loss(faults.with_crashes(none(32), [5], [1]), 0.15), 22)
    assert key_status(int(orc.gone_key[5])) == Status.DEAD


def _rumor_tiny_table():
    orc, _, _ = rumor_run_both(
        SwimConfig(n_nodes=24, rumor_capacity=2),
        faults.with_loss(faults.with_crashes(none(24), [3, 11, 17], [1]),
                         0.3), 12, seed=5)
    assert int(orc.overflow) > 0


def _rumor_dynamic():
    _, _, max_sentinels = rumor_run_both(
        SwimConfig(n_nodes=32, rumor_capacity=64, lifeguard=True,
                   dynamic_suspicion=True, buddy=True,
                   suspicion_max_mult=3.0),
        faults.with_loss(faults.with_crashes(none(32), [4, 19], [2]), 0.15),
        26, seed=2)
    assert max_sentinels >= 2, max_sentinels


def _rumor_join_rejoin():
    n = 28
    plan = faults.with_joins(none(n), [24, 25], [4])
    plan = faults.with_crashes(plan, [2, 24], [8])
    plan = faults.with_joins(plan, [26], [10])
    orc, _, _ = rumor_run_both(SwimConfig(n_nodes=n, rumor_capacity=64),
                               faults.with_loss(plan, 0.1), 20, seed=6)
    for alive_joiner in (25, 26):
        assert key_status(int(orc.gone_key[alive_joiner])) != Status.DEAD


RUMOR_CASES = {
    "crash_loss_full_lifecycle": _rumor_crash_loss,
    "partition": lambda: rumor_run_both(
        SwimConfig(n_nodes=32, rumor_capacity=64),
        faults.with_partition(faults.with_loss(none(32), 0.1),
                              faults.halves(32), 2, 7), 12, seed=3),
    "round_robin": lambda: rumor_run_both(
        SwimConfig(n_nodes=24, rumor_capacity=64,
                   target_selection="round_robin"),
        faults.with_crashes(none(24), [9], [2]), 15, seed=11),
    "tiny_table_overflow": _rumor_tiny_table,
    "dynamic_suspicion_bitwise": _rumor_dynamic,
    "lifeguard_no_dynamic": lambda: rumor_run_both(
        SwimConfig(n_nodes=32, rumor_capacity=64, lifeguard=True,
                   dynamic_suspicion=False, buddy=True),
        faults.with_loss(faults.with_crashes(none(32), [7], [1]), 0.2),
        18, seed=9),
    "join_crash_rejoin_bitwise": _rumor_join_rejoin,
    "round_robin_join_bitwise": lambda: rumor_run_both(
        SwimConfig(n_nodes=20, rumor_capacity=64,
                   target_selection="round_robin"),
        faults.with_crashes(faults.with_joins(none(20), [17], [3]), [5],
                            [6]), 16, seed=8),
}


@pytest.mark.parametrize("name", list(RUMOR_CASES))
def test_rumor_engine_equals_oracle(name):
    RUMOR_CASES[name]()


# ---------------------------------------------------------------------------
# tests/test_ring.py: the port's ring engine == the oracle
# ---------------------------------------------------------------------------

def ring_assert_states_equal(orc, est, t):
    """The reference's assert_states_equal (tests/test_ring.py), as it
    is (ring_oracle.mismatches): freed table slots and cold's copies of
    window columns are undefined in the packed representation and are
    not compared."""
    bad = ring_oracle.mismatches(orc, convert.state_to_numpy(est))
    assert not bad, f"{bad} @ period {t}"


def ring_run_both(cfg, plan, periods, seed=7):
    orc = ring_oracle.RingOracle(cfg, plan)
    est = ring.init_state(cfg, CPU)
    key = threefry.key(seed)
    for t in range(periods):
        rnd = ring.draw_period_ring(key, t, cfg, CPU)
        orc.step(ring_oracle.to_numpy(rnd))
        est = ring.step(cfg, est, plan, rnd)
        ring_assert_states_equal(orc, est, t)
    return orc.state, est


def _ring_crash():
    orc, _ = ring_run_both(SwimConfig(n_nodes=32),
                           faults.with_crashes(none(32), [5], [2]), 26)
    assert key_status(int(orc.gone_key[5])) == Status.DEAD
    assert orc.overflow == 0


def _ring_loss_refutation():
    orc, _ = ring_run_both(SwimConfig(n_nodes=32),
                           faults.with_loss(none(32), 0.08), 30, seed=3)
    assert not any(key_status(int(k)) == Status.DEAD for k in orc.gone_key)


def _ring_join_churn():
    n = 24
    plan = faults.with_joins(none(n), [20, 21], [5])
    plan = faults.with_crashes(plan, [3, 20], [9])
    plan = faults.with_joins(plan, [22], [12])
    orc, _ = ring_run_both(SwimConfig(n_nodes=n), plan, 24, seed=5)
    assert key_status(int(orc.gone_key[3])) == Status.DEAD
    assert key_status(int(orc.gone_key[20])) == Status.DEAD
    for alive_joiner in (21, 22):
        assert key_status(int(orc.gone_key[alive_joiner])) != Status.DEAD


def _ring_period_scope():
    orc, _ = ring_run_both(
        SwimConfig(n_nodes=32, ring_sel_scope="period"),
        faults.with_loss(faults.with_crashes(none(32), [5], [2]), 0.06),
        26, seed=11)
    assert key_status(int(orc.gone_key[5])) == Status.DEAD


def _ring_scopes_differ():
    n = 32
    plan = faults.with_loss(faults.with_crashes(none(n), [5, 11], [2]), 0.2)
    wins = {}
    for scope in ("wave", "period"):
        cfg = SwimConfig(n_nodes=n, ring_sel_scope=scope)
        est = ring.init_state(cfg, CPU)
        for t in range(8):
            est = ring.step(cfg, est, plan,
                            ring.draw_period_ring(threefry.key(11), t, cfg,
                                                  CPU))
        wins[scope] = est.win.clone()
    assert not torch.equal(wins["wave"], wins["period"])


def _ring_pull_crash():
    orc, _ = ring_run_both(SwimConfig(n_nodes=32, ring_probe="pull"),
                           faults.with_crashes(none(32), [5], [2]), 26,
                           seed=1)
    assert key_status(int(orc.gone_key[5])) == Status.DEAD


RING_CASES = {
    "crash_full_lifecycle": _ring_crash,
    "loss_refutation": _ring_loss_refutation,
    "partition": lambda: ring_run_both(
        SwimConfig(n_nodes=24),
        faults.with_partition(faults.with_loss(none(24), 0.05),
                              faults.halves(24), 3, 9), 16, seed=4),
    "join_churn": _ring_join_churn,
    "lifeguard_dynamic": lambda: ring_run_both(
        SwimConfig(n_nodes=32, lifeguard=True, dynamic_suspicion=True,
                   buddy=True),
        faults.with_loss(faults.with_crashes(none(32), [4, 19], [2]), 0.1),
        22, seed=2),
    "tiny_budget_overflow": lambda: ring_run_both(
        SwimConfig(n_nodes=24, ring_orig_words=1),
        faults.with_loss(faults.with_crashes(none(24), [3, 11, 17], [1]),
                         0.25), 14, seed=5),
    "period_sel_scope_lifecycle": _ring_period_scope,
    "period_sel_scope_differs_from_wave": _ring_scopes_differ,
    "pull_crash_lifecycle": _ring_pull_crash,
    "pull_loss_partition_join": lambda: ring_run_both(
        SwimConfig(n_nodes=24, ring_probe="pull"),
        faults.with_joins(faults.with_partition(
            faults.with_loss(none(24), 0.1), faults.halves(24), 3, 9),
            [20], [5]), 18, seed=4),
    "lifeguard_join_rotor": lambda: ring_run_both(
        SwimConfig(n_nodes=16, lifeguard=True),
        faults.with_loss(faults.with_joins(none(16), [10, 11, 12, 13], [5]),
                         0.3), 12, seed=3),
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_engine_equals_oracle(name):
    RING_CASES[name]()


# tests/test_ring.py TestConfigSweep.CONFIGS, one case each
GEOMETRY_CONFIGS = [
    dict(n_nodes=24, ring_orig_words=1, ring_window_periods=2,
         ring_view_c=2, k_indirect=1),
    dict(n_nodes=48, ring_orig_words=2, ring_window_periods=3,
         ring_view_c=2, k_indirect=2, lifeguard=True),
    dict(n_nodes=48, ring_orig_words=1, ring_window_periods=6,
         ring_view_c=3, k_indirect=3),
    dict(n_nodes=96, ring_orig_words=2, ring_window_periods=2,
         ring_view_c=4, k_indirect=3, max_piggyback=3, lifeguard=True),
    dict(n_nodes=32, ring_orig_words=3, ring_window_periods=2,
         ring_view_c=2, k_indirect=1, ring_probe="pull"),
    dict(n_nodes=48, ring_orig_words=2, ring_window_periods=3,
         ring_view_c=2, k_indirect=2, ring_sel_scope="period",
         lifeguard=True),
    dict(n_nodes=24, ring_orig_words=1, ring_window_periods=2,
         ring_view_c=2, k_indirect=1, ring_sel_scope="period",
         max_piggyback=3),
]


@pytest.mark.parametrize("i", range(len(GEOMETRY_CONFIGS)))
def test_ring_geometry_sweep(i):
    kw = GEOMETRY_CONFIGS[i]
    n = kw["n_nodes"]
    plan = faults.with_loss(none(n), 0.06)
    plan = faults.with_crashes(plan, [5, n - 3], [2, 6])
    plan = faults.with_joins(plan, [n - 1], [4])
    ring_run_both(SwimConfig(**kw), plan, 18, seed=10 + i)


def test_ring_comparison_masks_only_what_the_reference_masks():
    """ring_oracle.mismatches sees a flipped window bit and a live
    slot's key, and ignores a freed slot's stale metadata."""
    cfg = SwimConfig(n_nodes=16)
    plan = faults.with_crashes(none(16), [3], [1])
    orc = ring_oracle.RingOracle(cfg, plan)
    est = ring.init_state(cfg, CPU)
    for t in range(6):
        rnd = ring.draw_period_ring(threefry.key(7), t, cfg, CPU)
        orc.step(ring_oracle.to_numpy(rnd))
        est = ring.step(cfg, est, plan, rnd)
    got = convert.state_to_numpy(est)
    assert ring_oracle.mismatches(orc, got) == []
    live = np.flatnonzero(orc.state.subject >= 0)
    free = np.flatnonzero(orc.state.subject < 0)
    assert live.size and free.size
    flipped = dict(got, win=got["win"] ^ np.uint32(1))
    assert ring_oracle.mismatches(orc, flipped) == ["win"]
    stale = got["rkey"].copy()
    stale[free[0]] ^= np.uint32(4)
    assert ring_oracle.mismatches(orc, dict(got, rkey=stale)) == []
    stale[live[0]] ^= np.uint32(4)
    assert ring_oracle.mismatches(orc, dict(got, rkey=stale)) == ["rkey"]

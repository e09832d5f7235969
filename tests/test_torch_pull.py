"""The port's pull-uniform probe against `swim_tpu.models.ring`, bit for
bit.

  * `pow_f32` against its numpy twin `py_pow_f32` and the JAX
    `pow_f32`, over bases near 1 and exponents up to 2**31 - 1;
  * `draw_period_ring` with ring_probe="pull" (nine f32 uniforms, the
    rotor offsets, the empty u16 legs) against the JAX draw;
  * the pull step per period, all 14 RingState fields, for a crash
    plan, a loss + partition plan and a join plan, in period and wave
    scope; each JAX step is compiled once per config, takes the plan
    as an argument and runs with its telemetry tap; the port steps
    without and with the tap, both states equal the JAX state and the
    eight EngineFrame fields (the pull path's three gossip deliveries)
    the JAX frame;
  * pull with Lifeguard is refused by both packages' SwimConfig.

Tolerance: exact.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import (assert_same_frame, jax_tapped_step,
                                one_torch_thread, port_step_both)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.sim import faults as jfaults
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.models import ring
from swim_tpu_torch.utils import threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 32
SCOPES = {"period": dict(ring_probe="pull", ring_sel_scope="period"),
          "wave": dict(ring_probe="pull")}


def np_fields(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def rnd_fields(rnd) -> dict:
    d = {f: np.asarray(getattr(rnd, f)) for f in rnd._fields if f != "pull"}
    d["pull"] = None if rnd.pull is None else np_fields(rnd.pull)
    return d


def assert_same_state(port, ref, where):
    got = convert.state_to_numpy(port)
    for f in jring.RingState._fields:
        want = np.asarray(getattr(ref, f))
        assert got[f].dtype == want.dtype, f"{f} dtype @ {where}"
        np.testing.assert_array_equal(got[f], want, err_msg=f"{f} @ {where}")


@functools.lru_cache(maxsize=None)
def jax_step(scope):
    """(state, plan, rnd) -> (state, EngineFrame)."""
    return jax_tapped_step(jring, JaxSwimConfig(n_nodes=N, **SCOPES[scope]))


@functools.lru_cache(maxsize=None)
def jax_draw(scope, seed):
    jcfg = JaxSwimConfig(n_nodes=N, **SCOPES[scope])
    key = jax.random.key(seed)
    return jax.jit(lambda t: jring.draw_period_ring(key, t, jcfg))


def jax_plan(name):
    none = jfaults.none(N)
    if name == "crash":
        return jfaults.with_crashes(none, [5, 17], [2, 3])
    if name == "partition":
        return jfaults.with_partition(jfaults.with_loss(none, 0.1),
                                      jfaults.halves(N), 3, 9)
    if name == "join":
        plan = jfaults.with_joins(none, [20, 21], [5])
        plan = jfaults.with_crashes(plan, [3, 20], [6])
        return jfaults.with_joins(plan, [22], [10])
    raise KeyError(name)


def test_pow_f32_matches_numpy_and_jax():
    """Equal to the numpy twin everywhere and to the JAX function
    wherever the result is a normal float: XLA on the CPU flushes
    subnormals to zero, and the engine never produces one (its bases are
    1 - 1/m with exponents up to m, whose powers stay near 1/e)."""
    rng = np.random.default_rng(0)
    ms = np.array([2, 3, 31, 999, 65536, 999_999, 2**24 + 7], np.int64)
    bases = np.concatenate([
        np.float32(1.0) - np.float32(1.0) / ms.astype(np.float32),
        rng.random(8).astype(np.float32), [0.0, 1.0, 0.5]]).astype(
            np.float32)
    expos = np.array([0, 1, 2, 3, 7, 31, 999, 65535, 999_999, 2**24 + 3,
                      2**31 - 1], np.int32)
    tiny = np.finfo(np.float32).tiny
    for i, b in enumerate(bases):
        got = ring.pow_f32(torch.tensor(b), torch.from_numpy(expos)).numpy()
        want = np.asarray(jring.pow_f32(jnp.float32(b), jnp.asarray(expos)))
        normal = want >= tiny
        if i < len(ms):       # the engine's domain: exponent <= m
            assert normal[expos <= ms[i]].all()
        np.testing.assert_array_equal(got[normal].view(np.uint32),
                                      want[normal].view(np.uint32))
        twin = np.array([ring.py_pow_f32(float(b), int(e)) for e in expos],
                        np.float32)
        np.testing.assert_array_equal(twin.view(np.uint32),
                                      got.view(np.uint32))
        assert twin[6] == np.float32(jring.py_pow_f32(float(b), 999))


@pytest.mark.parametrize("scope", ["period", "wave"])
def test_pull_randomness_matches_jax(scope):
    cfg = SwimConfig(n_nodes=N, **SCOPES[scope])
    for t in (0, 5, N - 1, 3 * N):
        want = rnd_fields(jax_draw(scope, 7)(t))
        got = convert.randomness_to_numpy(
            ring.draw_period_ring(threefry.key(7), t, cfg, "cpu"))
        assert set(got) == set(want)
        for f, a in want.items():
            if f == "pull":
                for g, b in a.items():
                    assert got["pull"][g].dtype == b.dtype == np.float32
                    np.testing.assert_array_equal(
                        got["pull"][g].view(np.uint32), b.view(np.uint32),
                        err_msg=f"pull.{g} @ {t}")
            else:
                assert a.shape == got[f].shape, f
                np.testing.assert_array_equal(got[f], a, err_msg=f)


STEP_CASES = [(sc, name, seed) for sc in ("period", "wave")
              for name, seed in (("crash", 3), ("partition", 4),
                                 ("join", 5))]


@pytest.mark.parametrize("scope,name,seed", STEP_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in STEP_CASES])
def test_pull_step_parity(scope, name, seed):
    periods = 16
    cfg = SwimConfig(n_nodes=N, **SCOPES[scope])
    jplan = jax_plan(name)
    plan = convert.plan_from_numpy(np_fields(jplan), "cpu")
    js = jring.init_state(JaxSwimConfig(n_nodes=N, **SCOPES[scope]))
    ts = ring.init_state(cfg, "cpu")
    suspected = delivered = 0
    for t in range(periods):
        rnd = jax_draw(scope, seed)(t)
        js, jframe = jax_step(scope)(js, jplan, rnd)
        plain, ts, frame = port_step_both(
            ring, cfg, ts, plan,
            convert.randomness_from_numpy(rnd_fields(rnd), "cpu"))
        where = f"{scope} {name} period {t}"
        assert_same_state(plain, js, f"{where} (untapped)")
        assert_same_state(ts, js, where)
        assert_same_frame(frame, jframe, where)
        delivered += int(frame.waves_delivered)
        suspected = max(suspected, int(((ts.subject >= 0)
                                        & ((ts.rkey & 1) == 1)).sum()))
    # the runs have teeth: a suspicion was raised and spread
    assert suspected > 0 and delivered > 0
    assert int(ts.win.ne(0).sum()) > 0


def test_pull_with_lifeguard_is_refused_by_both_configs():
    with pytest.raises(ValueError, match="vanilla protocol only"):
        JaxSwimConfig(n_nodes=N, ring_probe="pull", lifeguard=True)
    with pytest.raises(ValueError, match="vanilla protocol only"):
        SwimConfig(n_nodes=N, ring_probe="pull", lifeguard=True)

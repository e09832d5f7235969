"""Shared cases of the dense and rumor engine parity tests
(tests/test_torch_dense.py, tests/test_torch_rumor.py,
tests/test_torch_golden.py); it holds no tests itself.

A case is (SwimConfig keywords, fault plan builder, periods).  Plans
are built with the JAX package's constructors and carried to the port
through numpy (convert.py), so both packages step the same plan.
`jax_trajectory` steps the JAX engine one period at a time (one
compile per config), with its telemetry tap, and keeps every period's
randomness, state and EngineFrame as numpy arrays (the reference pins
the tapped state bitwise to the untapped one).  `check_port_trajectory`
steps the port from the same initial state with the same randomness,
without and with the tap, and compares every field of both states and
the eight frame fields (values and int32 dtype) after every period,
with tolerance 0.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.obs.engine import frame_from_tap as jax_frame_from_tap
from swim_tpu.sim import faults as jfaults
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.obs.engine import EngineFrame, frame_from_tap


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread for a whole test module (its
    module-scoped fixtures included): these tensors are small, and the
    test runner shares the cores among its workers, where every thread
    pool the size of the machine oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_together(jobs: dict) -> dict:
    """{name: fn()} for zero-argument JAX calls, started together on a
    thread pool of up to 4, each result blocked on: XLA compiles outside
    the GIL, so the compiles a test module shares at module scope
    overlap."""
    with ThreadPoolExecutor(min(len(jobs), 4)) as pool:
        futs = {name: pool.submit(fn) for name, fn in jobs.items()}
        return {name: jax.block_until_ready(f.result())
                for name, f in futs.items()}


def np_fields(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def plan_fields(plan) -> dict:
    """A FaultPlan or FaultProgram as the mapping convert.py takes."""
    if isinstance(plan, jfaults.FaultProgram):
        d = {f: np.asarray(getattr(plan, f)) for f in plan._fields
             if f != "base"}
        d["base"] = np_fields(plan.base)
        return d
    return np_fields(plan)


def port_plan(plan):
    if isinstance(plan, jfaults.FaultProgram):
        return convert.program_from_numpy(plan_fields(plan), "cpu")
    return convert.plan_from_numpy(plan_fields(plan), "cpu")


def faults_plan(n: int, periods: int):
    """Crashes, loss 0.2, a 2-way partition, late joiners, and a program
    with a gray segment and a flapping link segment."""
    plan = jfaults.with_crashes(jfaults.none(n), [1, n // 2, n - 3],
                                [3, 5, 9])
    plan = jfaults.with_loss(plan, 0.2)
    plan = jfaults.with_partition(plan, jfaults.halves(n), 6, 14)
    plan = jfaults.with_joins(plan, [n - 1, n - 2], [4, 7])
    prog = jfaults.as_program(plan, np.arange(n) % 3, capacity=2)
    prog = jfaults.with_segment(prog, 0, start=0, end=periods, kind="gray",
                                level=0.3, domain=1)
    return jfaults.with_segment(prog, 1, start=2, end=periods,
                                kind="link_loss", level=0.5, domain=2,
                                period=5, on=2)


def crash_loss_plan(n: int, loss: float, crashes=None):
    nodes, at = crashes or ([0, n // 3, n - 1], [2, 4, 6])
    return jfaults.with_loss(
        jfaults.with_crashes(jfaults.none(n), [x % n for x in nodes], at),
        loss)


@functools.lru_cache(maxsize=None)
def jax_tapped_step(mod, jcfg):
    """The JAX engine's step with its telemetry tap, jitted: (state,
    plan, rnd) -> (state, EngineFrame).  One per (engine, config), so
    cases that differ only in their plan share one compile."""
    def tapped(st, plan, rnd):
        tap: dict = {}
        st = mod.step(jcfg, st, plan, rnd, tap=tap)
        return st, jax_frame_from_tap(tap)
    return jax.jit(tapped)


def assert_same_frame(got, want, where: str) -> None:
    """The port's EngineFrame of 0-d tensors against the JAX frame: all
    eight fields, int32, equal."""
    for f in EngineFrame._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.int32 and w.dtype == np.int32, \
            f"{f} dtype @ {where}"
        assert g.shape == w.shape and int(g) == int(w), \
            f"{f} @ {where}: {int(g)} != {int(w)}"


def port_step_both(mod, cfg, st, plan, rnd, **kw):
    """The port's step from `st` without and with the tap: (untapped
    state, tapped state, frame).  A ring state's `cold` (updated in
    place) is cloned for the untapped step."""
    if hasattr(st, "cold"):
        plain_st = mod.step(cfg, st._replace(cold=st.cold.clone()), plan,
                            rnd, **kw)
    else:
        plain_st = mod.step(cfg, st, plan, rnd, **kw)
    tap: dict = {}
    tapped = mod.step(cfg, st, plan, rnd, tap=tap)
    return plain_st, tapped, frame_from_tap(tap, st.step.device)


def jax_trajectory(mod, draw, cfg_kw: dict, plan, periods: int,
                   seed: int = 0) -> dict:
    """The JAX engine `mod` (dense or rumor) stepped period by period
    with its tap, each period's `draw` jitted: {"init": numpy state,
    "rnd": [numpy draws], "states": [numpy state after each period],
    "frames": [its EngineFrame]}."""
    jcfg = JaxSwimConfig(**cfg_kw)
    step = jax_tapped_step(mod, jcfg)
    jdraw = jax.jit(lambda key, t: draw(key, t, jcfg))
    st = mod.init_state(jcfg)
    out = {"init": np_fields(st), "rnd": [], "states": [], "frames": []}
    key = jax.random.key(seed)
    for t in range(periods):
        rnd = jdraw(key, t)
        out["rnd"].append(rnd)
        st, frame = step(st, plan, rnd)
        out["states"].append(np_fields(st))
        out["frames"].append(jax.tree_util.tree_map(np.asarray, frame))
    out["rnd"] = [jax.tree_util.tree_map(np.asarray, r) for r in out["rnd"]]
    return out


def check_port_trajectory(mod, cls, rnd_from, cfg_kw: dict, plan,
                          traj: dict) -> object:
    """Step the port's `mod` from the trajectory's initial state with
    its randomness (`rnd_from` turns one period's numpy draws into the
    port's), without and with the tap; every field of both states and
    every frame field equal after every period.  Returns the last
    state."""
    cfg = SwimConfig(**cfg_kw)
    st = convert.state_from_numpy(traj["init"], "cpu", cls)
    tplan = port_plan(plan)
    for t, (rnd, want, frame) in enumerate(zip(
            traj["rnd"], traj["states"], traj["frames"])):
        plain_st, st, got_frame = port_step_both(mod, cfg, st, tplan,
                                                 rnd_from(rnd))
        assert_same_frame(got_frame, frame, f"period {t}")
        for which, s in (("untapped", plain_st), ("tapped", st)):
            got = convert.state_to_numpy(s)
            for f in cls._fields:
                np.testing.assert_array_equal(
                    got[f], want[f], err_msg=f"period {t}, {which}, {f}")
    return st

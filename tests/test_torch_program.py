"""The port's FaultProgram against `swim_tpu.sim.faults` and the rotor
step under it against `swim_tpu.models.ring`, bit for bit.

  * the constructors (`as_program`, `with_segment`, `pad_program`) give the
    reference's arrays, and refuse what it refuses;
  * `link_lanes` over 12 periods of a program with a flapping segment,
    overlapping segments on one domain and a saturating sum;
  * the rotor step under a three-segment program (gray, flapping link
    loss, send loss on every node), all 14 RingState fields per period,
    in period and wave scope; the JAX step runs with its telemetry tap,
    the port's without and with it, both states equal the JAX state and
    the eight EngineFrame fields the JAX frame;
  * a program with zero segments runs exactly the plain plan's step;
    pull-uniform probing with a program raises, as the reference does;
  * the packed scalar wire (period scope, fused): all 14 fields equal to
    the JAX packed step after every period, with Lifeguard and buddy
    under the program at k = 3 and k = 1 and vanilla under a plain plan,
    the port's kernel wrappers and plain versions both, and equal to
    the port's own wide-wire run.

Tolerance: exact.
"""
from __future__ import annotations

import jax
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
from swim_tpu_torch.ops import wavemerge
from swim_tpu_torch.sim import faults

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 48


def np_fields(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def prog_fields(prog) -> dict:
    d = {f: np.asarray(getattr(prog, f)) for f in prog._fields if f != "base"}
    d["base"] = np_fields(prog.base)
    return d


def build(mod, plan, segments, capacity=None):
    """The same program through either package's constructors."""
    prog = mod.as_program(plan, np.arange(N) % 4,
                          capacity=capacity or len(segments))
    for slot, seg in enumerate(segments):
        prog = mod.with_segment(prog, slot, **seg)
    return prog


SEGMENTS = [
    dict(start=0, end=40, kind="gray", level=0.3, domain=1),
    dict(start=2, end=30, kind="link_loss", level=0.5, domain=2, period=6,
         on=3),
    dict(start=0, end=40, kind="send_loss", level=0.1),
]
# overlapping segments on domain 3 whose send lanes saturate at LANE_MAX
LANE_SEGMENTS = SEGMENTS + [
    dict(start=1, end=9, kind="recv_loss", level=0.9, domain=3),
    dict(start=0, end=12, kind="link_loss", level=0.8, domain=3, period=4,
         on=1),
    dict(start=0, end=12, kind="send_loss", level=1.0, domain=3),
]


def plans():
    jplan = jfaults.with_loss(jfaults.with_crashes(jfaults.none(N), [3, 30],
                                                   [4, 6]), 0.05)
    return jplan, convert.plan_from_numpy(np_fields(jplan), "cpu")


def assert_same_program(port, ref):
    want = prog_fields(ref)
    for f in faults.FaultProgram._fields:
        if f == "base":
            continue
        got = getattr(port, f).numpy()
        if want[f].dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)


def test_constructors_match_the_reference():
    jplan, plan = plans()
    jp = build(jfaults, jplan, SEGMENTS, capacity=4)
    tp = build(faults, plan, SEGMENTS, capacity=4)
    assert_same_program(tp, jp)
    assert_same_program(faults.pad_program(tp, 7), jfaults.pad_program(jp, 7))
    assert_same_program(convert.program_from_numpy(prog_fields(jp), "cpu"),
                        jp)
    for bad in (dict(kind="jitter", level=0.1),
                dict(kind="gray", level=1.5),
                dict(kind="gray", level=0.1, period=4, on=5)):
        with pytest.raises(ValueError):
            faults.with_segment(tp, 0, start=0, end=1, **bad)
    with pytest.raises(ValueError):
        faults.pad_program(tp, 2)
    assert faults.level_to_threshold(1.0) == jfaults.level_to_threshold(1.0)


def test_link_lanes_match_over_a_flapping_program():
    jplan, plan = plans()
    jp = build(jfaults, jplan, LANE_SEGMENTS)
    tp = build(faults, plan, LANE_SEGMENTS)
    saturated = 0
    for t in range(12):
        want = jfaults.link_lanes(jp, t)
        got = faults.link_lanes(tp, torch.tensor(t, dtype=torch.int32))
        for name, a, b in zip(("send", "recv", "reply"), want, got):
            np.testing.assert_array_equal(
                b.numpy().view(np.uint32), np.asarray(a),
                err_msg=f"{name} lane @ {t}")
        saturated += int((got[0] == faults.LANE_MAX).sum())
    assert saturated > 0


@pytest.mark.parametrize("scope", ["period", "wave"])
def test_program_step_parity(scope):
    kw = dict(ring_sel_scope="period") if scope == "period" else {}
    jcfg = JaxSwimConfig(n_nodes=N, **kw)
    cfg = SwimConfig(n_nodes=N, **kw)
    jplan, plan = plans()
    jp = build(jfaults, jplan, SEGMENTS)
    tp = build(faults, plan, SEGMENTS)
    key = jax.random.key(3)
    jstep = jax_tapped_step(jring, jcfg)
    jdraw = jax.jit(lambda t: jring.draw_period_ring(key, t, jcfg))
    js = jring.init_state(jcfg)
    ts = ring.init_state(cfg, "cpu")
    plain = ring.init_state(cfg, "cpu")
    for t in range(12):
        rnd = jdraw(t)
        js, jframe = jstep(js, jp, rnd)
        trnd = convert.randomness_from_numpy(
            {f: np.asarray(getattr(rnd, f)) for f in rnd._fields
             if f != "pull"}, "cpu")
        untapped, ts, frame = port_step_both(ring, cfg, ts, tp, trnd)
        plain = ring.step(cfg, plain, plan, trnd)
        assert_same_frame(frame, jframe, f"period {t}")
        for s in (untapped, ts):
            got = convert.state_to_numpy(s)
            for f in jring.RingState._fields:
                np.testing.assert_array_equal(
                    got[f], np.asarray(getattr(js, f)), err_msg=f"{f} @ {t}")
    # the lanes changed the run: it differs from the plain plan's
    assert not torch.equal(ts.win, plain.win)


def test_empty_program_is_the_plain_plan_and_pull_refuses_programs():
    _, plan = plans()
    cfg = SwimConfig(n_nodes=N)
    empty = faults.as_program(plan)
    assert faults.split_program(empty) == (plan, None)
    assert faults.split_program(faults.empty_program(N, "cpu"))[1] is None
    want = ring.run(cfg, ring.init_state(cfg, "cpu"), plan, 5, 5)
    got = ring.run(cfg, ring.init_state(cfg, "cpu"), empty, 5, 5)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    pcfg = SwimConfig(n_nodes=N, ring_probe="pull")
    with pytest.raises(NotImplementedError, match="pull-uniform"):
        ring.run(pcfg, ring.init_state(pcfg, "cpu"),
                 build(faults, plan, SEGMENTS[:1]), 0, 1)
    jcfg = JaxSwimConfig(n_nodes=N, ring_probe="pull")
    jprog = build(jfaults, jfaults.none(N), SEGMENTS[:1])
    with pytest.raises(NotImplementedError, match="pull-uniform"):
        jax.eval_shape(lambda: jring.step(
            jcfg, jring.init_state(jcfg), jprog,
            jring.draw_period_ring(jax.random.key(0), 0, jcfg)))


PACKED_CASES = {
    "lg-buddy-k3": (dict(lifeguard=True, k_indirect=3), True),
    "lg-buddy-k1": (dict(lifeguard=True, k_indirect=1), True),
    "vanilla-k3-plan": (dict(k_indirect=3), False),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_step_parity(case, monkeypatch):
    """The packed scalar wire equals the JAX packed step field for field
    each period, and the port's wide wire on the same draws; with buddy,
    the fused merge receives 1 + k decoded forced-bit rows, some set."""
    kw, with_prog = PACKED_CASES[case]
    forced = dict(rows=0, bits=0)
    real_merge = wavemerge.merge_waves

    def spy(win, sel, oks, offs, bcol, bval):
        forced["rows"] = max(forced["rows"], bcol.shape[0])
        forced["bits"] += int((bval != 0).sum())
        return real_merge(win, sel, oks, offs, bcol, bval)

    monkeypatch.setattr(wavemerge, "merge_waves", spy)
    kw = dict(kw, ring_sel_scope="period")
    jcfg = JaxSwimConfig(n_nodes=N, ring_scalar_wire="packed", **kw)
    cfg = SwimConfig(n_nodes=N, ring_scalar_wire="packed", **kw)
    wide = SwimConfig(n_nodes=N, **kw)
    jplan, plan = plans()
    if with_prog:
        jplan, plan = (build(jfaults, jplan, SEGMENTS),
                       build(faults, plan, SEGMENTS))
    key = jax.random.key(8)
    jstep = jax.jit(lambda st, rnd: jring.step(jcfg, st, jplan, rnd))
    jdraw = jax.jit(lambda t: jring.draw_period_ring(key, t, jcfg))
    js = jring.init_state(jcfg)
    ts = ring.init_state(cfg, "cpu")
    tw = ring.init_state(wide, "cpu")
    lha_seen = 0
    for t in range(14):
        rnd = jdraw(t)
        js = jstep(js, rnd)
        trnd = convert.randomness_from_numpy(
            {f: np.asarray(getattr(rnd, f)) for f in rnd._fields
             if f != "pull"}, "cpu")
        plain = ring.step(cfg, ts._replace(cold=ts.cold.clone()), plan,
                          trnd, plain=True)
        ts = ring.step(cfg, ts, plan, trnd)
        tw = ring.step(wide, tw, plan, trnd)
        for name, s in (("plain", plain), ("wrapped", ts), ("wide", tw)):
            got = convert.state_to_numpy(s)
            for f in jring.RingState._fields:
                np.testing.assert_array_equal(
                    got[f], np.asarray(getattr(js, f)),
                    err_msg=f"{case} {name} {f} @ {t}")
        lha_seen = max(lha_seen, int(ts.lha.max()))
    assert int(ts.overflow) >= 0 and int(ts.subject.max()) >= 0
    if kw.get("lifeguard"):
        assert lha_seen > 0, "no health score left 0"
        assert forced["rows"] == 1 + kw["k_indirect"]
        assert forced["bits"] > 0, "no buddy bit was forced"

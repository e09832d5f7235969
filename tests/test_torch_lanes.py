"""Batched studies as one step over a lane axis: the pieces under
`torch.func.vmap`, on the CPU, with no JAX (the file also runs on a
card machine, `--noconftest`).

  * each kernel's custom op under vmap (P = 3 lanes; N = 37 and N = 64,
    so coldsel's 16-byte and 4-byte paths are both shaped; flush rows
    and offsets shared by the lanes or one set a lane; VB = 0 and
    VB > 0; V = 1 and V > 1; the lane axis at dim 0 and at dim 1) equals
    the plain version run lane by lane, bitwise, and so does the plain
    version called on lane-stacked tensors; the round-robin Feistel walk
    under vmap equals its serial walk;
  * the lane-stacked draws of the ring (rotor and pull), dense and rumor
    engines equal the per-lane draws, bitwise, the rotor offsets one
    shared copy;
  * a batched period of each engine at N = 32, P = 3 dispatches at most
    LANE_OPS more aten ops (views aside) than one lane's serial period,
    counted with a TorchDispatchMode: the lanes are not looped (a loop
    would add about twice the serial count);
  * lanes that start at different steps are refused, and a batched
    flush into an unbatched cold ring.

PyTorch's vmap fallback (an op without a batching rule runs lane by
lane) is an error here.  Tolerance: exact.
"""
from __future__ import annotations

import collections
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from swim_tpu_torch import SwimConfig
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.ops import coldsel, sampling, selb, wavemerge
from swim_tpu_torch.sim import faults, runner
from swim_tpu_torch.utils import prng, threefry
from swim_tpu_torch.utils.tree import tree_map

P = 3
# non-view aten ops a batched period may dispatch beyond one lane's
# serial period: the lane index ramps the batching rules of advanced
# indexing build (45-92 at N = 32) and a few copies
LANE_OPS = 150
VIEWS = {"view", "_unsafe_view", "unsqueeze", "squeeze", "permute",
         "select", "slice", "expand", "alias", "t", "transpose",
         "as_strided", "detach", "lift_fresh", "unbind", "split",
         "diagonal", "view_as", "_reshape_alias"}


@pytest.fixture(autouse=True)
def one_thread_no_fallback():
    """One torch thread, and the vmap fallback's warning as an error."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    torch.set_num_threads(before)


def rand_i32(gen, shape):
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         dtype=torch.int32)


def vmap(fn, *args, dims):
    return torch.func.vmap(fn, in_dims=dims)(*args)


def lane(x, p, dim=0):
    return x if dim is None else x.select(dim, p)


@pytest.mark.parametrize("n", [37, 64])
@pytest.mark.parametrize("dim", [0, 1])
def test_selb_under_vmap(n, dim):
    gen = torch.Generator().manual_seed(n + dim)
    win = rand_i32(gen, (P, n, 12))
    win[torch.rand(win.shape, generator=gen) < 0.4] = 0
    win = win.movedim(0, dim).contiguous()
    got = vmap(lambda w: selb.select_first_b(w, 6), win, dims=(dim,))
    want = torch.stack([selb.select_first_b_plain(lane(win, p, dim), 6)
                        for p in range(P)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [37, 64])
@pytest.mark.parametrize("shared_flush", [True, False])
@pytest.mark.parametrize("q", [1, 5])
def test_coldsel_under_vmap(n, shared_flush, q):
    gen = torch.Generator().manual_seed(n * 10 + q)
    rw, ow = 16, 3
    cold = rand_i32(gen, (P, rw, n))
    fr = torch.randint(-1, rw + 1, (ow,) if shared_flush else (P, ow),
                       generator=gen, dtype=torch.int32)
    fv = rand_i32(gen, (P, ow, n))
    qr = torch.randint(-2, rw + 2, (P, q, n), generator=gen,
                       dtype=torch.int32)
    fr_dim = None if shared_flush else 0
    c_v = cold.clone()
    s_v = vmap(lambda c, f, v, r: coldsel.cold_update_select(c, f, v, r)[1],
               c_v, fr, fv, qr, dims=(0, fr_dim, 0, 0))
    c_w = cold.clone()
    s_w = torch.stack([coldsel.cold_update_select_plain(
        c_w[p], lane(fr, p, fr_dim), fv[p], qr[p])[1] for p in range(P)])
    assert torch.equal(c_v, c_w) and torch.equal(s_v, s_w)
    # the plain version on the lane-stacked tensors, as the rule calls it
    c_l = cold.clone()
    _, s_l = coldsel.cold_update_select_plain(c_l, fr, fv, qr)
    assert torch.equal(c_l, c_w) and torch.equal(s_l, s_w)


@pytest.mark.parametrize("n", [37, 64])
@pytest.mark.parametrize("v,vb", [(1, 0), (1, 1), (6, 0), (6, 2)])
@pytest.mark.parametrize("shared_offs", [True, False])
def test_wavemerge_under_vmap(n, v, vb, shared_offs):
    gen = torch.Generator().manual_seed(n * 100 + v * 10 + vb)
    ww = 12
    win = rand_i32(gen, (P, n, ww))
    sel = rand_i32(gen, (P, n, ww))
    oks = torch.rand((P, v, n), generator=gen) < 0.5
    offs = torch.randint(-2 * n, 2 * n, (v,) if shared_offs else (P, v),
                         generator=gen, dtype=torch.int32)
    bcol = torch.randint(-1, ww + 1, (P, vb, n), generator=gen,
                         dtype=torch.int32)
    bval = torch.where(torch.rand((P, vb, n), generator=gen) < 0.5,
                       1 << torch.randint(0, 31, (P, vb, n), generator=gen,
                                          dtype=torch.int32), 0)
    off_dim = None if shared_offs else 0
    got = win.clone()
    vmap(wavemerge.merge_waves, got, sel, oks, offs, bcol, bval,
         dims=(0, 0, 0, off_dim, 0, 0))
    want = win.clone()
    for p in range(P):
        wavemerge.merge_waves_plain(want[p], sel[p], oks[p],
                                    lane(offs, p, off_dim), bcol[p],
                                    bval[p])
    assert torch.equal(got, want)
    stacked = win.clone()
    wavemerge.merge_waves_plain(stacked, sel, oks, offs, bcol, bval)
    assert torch.equal(stacked, want)


def test_feistel_walk_under_vmap():
    n = 37
    node = torch.arange(n, dtype=torch.int32)
    steps = torch.tensor([0, 40, 75], dtype=torch.int32)

    def target(t):
        return sampling.round_robin_target(node, (t // (n - 1)).expand(n),
                                           (t % (n - 1)).expand(n), n)

    got = vmap(target, steps, dims=(0,))
    for p in range(P):
        assert torch.equal(got[p], target(steps[p]))
        assert got[p].tolist() == [
            sampling.py_round_robin_target(i, int(steps[p]) // (n - 1),
                                           int(steps[p]) % (n - 1), n)
            for i in range(n)]


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


DRAW_CFGS = {
    "ring": ("ring", dict()),
    "ring_pull": ("ring", dict(ring_probe="pull")),
    "dense": ("dense", dict()),
    "rumor": ("rumor", dict()),
}


@pytest.mark.parametrize("case", sorted(DRAW_CFGS))
def test_lane_draws_equal_per_lane_draws(case):
    kind, kw = DRAW_CFGS[case]
    cfg = SwimConfig(n_nodes=40, **kw)
    keys = [threefry.key(7 + p) for p in range(P)]
    batched = list(runner.lane_draws(cfg, kind, keys, 3, 2, "cpu"))
    for p in range(P):
        single = list(runner.lane_draws(cfg, kind, [keys[p]], 3, 2, "cpu"))
        if kind == "ring":
            serial = list(ring.period_randomness(cfg, keys[p], 3, 2, "cpu"))
        elif kind == "dense":
            serial = [prng.draw_period(keys[p], t, cfg, "cpu")
                      for t in (3, 4)]
        else:
            serial = [rumor.draw_period_rumor(keys[p], t, cfg, "cpu")
                      for t in (3, 4)]
        for b, s1, s in zip(batched, single, serial):
            for x, y, z in zip(leaves(b), leaves(s1), leaves(s)):
                # a leaf the lanes share has the serial draw's shape
                shared = x.shape == z.shape
                assert x.dtype == z.dtype
                assert torch.equal(x if shared else x[p], z)
                assert torch.equal(y if shared else y[0], z)
    if kind == "ring":
        assert batched[0].s_off.dim() == 0
        assert tuple(batched[0].q_off.shape) == (cfg.k_indirect,)


class OpCount(TorchDispatchMode):
    """Non-view aten ops dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


ENGINES = {
    "dense": (dense, "dense", dict(lifeguard=True)),
    "dense_round_robin": (dense, "dense",
                          dict(target_selection="round_robin")),
    "rumor": (rumor, "rumor", dict(lifeguard=True, telemetry=True)),
    "ring_wave": (ring, "ring", dict(lifeguard=True, telemetry=True)),
    "ring_period": (ring, "ring", dict(ring_sel_scope="period")),
    "ring_pull": (ring, "ring", dict(ring_probe="pull", telemetry=True)),
}


def _program(n: int):
    plan = faults.with_loss(faults.with_crashes(
        faults.none(n, "cpu"), [3, n - 5], [1, 3]), 0.05)
    prog = faults.as_program(plan, np.arange(n) % 4, capacity=1)
    return faults.with_segment(prog, 0, kind="gray", start=1, end=5,
                               level=0.3, domain=1)


def _serial_draw(cfg, kind, key, t):
    return next(iter(runner.lane_draws(cfg, kind, [key], t, 1, "cpu")))


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_batched_period_dispatches_one_lanes_ops(case):
    mod, kind, kw = ENGINES[case]
    n = 32
    cfg = SwimConfig(n_nodes=n, **kw)
    prog = _program(n)
    if cfg.ring_probe == "pull":        # pull takes no FaultProgram
        prog = faults.base_of(prog)
    keys = [threefry.key(5 + p) for p in range(P)]
    plans = runner.batch_states([prog] * P)
    state = runner.batch_states([mod.init_state(cfg, "cpu")
                                 for _ in range(P)])
    track = runner.StudyTrack(*(torch.full((P, n), runner.NEVER,
                                           dtype=torch.int32)
                                for _ in range(3)))
    rnds = list(runner.lane_draws(cfg, kind, keys, 0, 2, "cpu"))
    period = runner.batch_period(cfg, kind, rnds[0])
    state, track, _, _ = period(state, track, plans, rnds[0])
    with OpCount() as batched:
        out = period(state, track, plans, rnds[1])
    assert tuple(out[0].step.shape) == (P,)

    step, body, _ = runner._BODIES[kind]
    stepper = runner.make_stepper(cfg, prog, step)
    one = [tree_map(lambda x: x[0], t) for t in (state, track)]
    rnd1 = tree_map(lambda x: x[0] if x.dim() and x.shape[0] == 1 else x,
                    _serial_draw(cfg, kind, keys[0], 1))
    if kind == "ring":
        rnd1 = rnd1._replace(s_off=rnds[1].s_off, q_off=rnds[1].q_off)
    with OpCount() as serial:
        want = body(cfg, *one, faults.base_of(prog), rnd1, stepper)
    got = [tree_map(lambda x: x[0], t) for t in out[:2]] + [
        [x[0] for x in out[2]]]
    for x, y in zip(leaves(got[0]) + leaves(got[1]) + got[2],
                    leaves(want[0]) + leaves(want[1]) + list(want[2])):
        assert torch.equal(x, y)
    b, s = sum(batched.ops.values()), sum(serial.ops.values())
    assert s > 300
    assert b <= s + LANE_OPS, (b, s, (batched.ops - serial.ops)
                               .most_common(8))


def test_batched_refusals():
    cfg = SwimConfig(n_nodes=32)
    states = runner.batch_states([
        ring.init_state(cfg, "cpu"),
        ring.init_state(cfg, "cpu")._replace(step=torch.tensor(
            1, dtype=torch.int32))])
    plans = faults.stack_programs([_program(32)] * 2).program
    with pytest.raises(ValueError, match="different steps"):
        runner.run_study_batch(cfg, states, plans,
                               [threefry.key(0), threefry.key(1)], 2,
                               "ring")
    with pytest.raises(ValueError, match="root keys"):
        runner.run_study_batch(cfg, states, plans, [threefry.key(0)], 2,
                               "ring")
    cold = torch.zeros((8, 40), dtype=torch.int32)
    fv = torch.zeros((P, 2, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="batched cold"):
        vmap(lambda v: coldsel.cold_update_select(
            cold, torch.tensor([0, 1], dtype=torch.int32), v,
            torch.zeros((1, 40), dtype=torch.int32))[1], fv, dims=(0,))

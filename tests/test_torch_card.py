"""The port on a CUDA card: kernels against their plain versions.

Every test here needs the card and skips without one.  The file imports
no JAX (the card's machine has none): run it there without the repo's
conftest, which imports JAX,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py

  * each CUDA kernel equals its plain PyTorch version bitwise, on the
    cases of tests/test_torch_kernels.py, and counts its launches;
  * each kernel on views 4 bytes past a 16-byte boundary, which take
    the kernels' 4-byte paths;
  * each kernel at the published studies' wider rings (ring_orig_words
    4 and 8: selb and wavemerge on WW 24 and 48, wavemerge one-wave and
    fused with VB 0 and 1, coldsel flushing 4 and 8 rows into RW 224,
    284 and 512) against its plain version;
  * a run on the card equals the same run on the CPU (plain versions),
    in period scope, in wave scope and with Lifeguard, under pull-uniform
    probing and under a FaultProgram;
  * kernels equal plain versions on the card under pull and under a
    program, with the launches a period each path makes;
  * the card reproduces the digests of golden.GOLDEN_DIGESTS and the
    study digest;
  * the dense and rumor engines (plain PyTorch) on the card equal the
    CPU, under crashes, loss, a partition and a program, vanilla and
    with Lifeguard; the card reproduces golden.ENGINE_DIGESTS; a study
    period of each engine makes no host sync;
  * a telemetry study period of each engine (ring: the default wave
    scope, with its three kernels) at 20,000 nodes makes no host sync
    and gives int32 frames on the card that saw deliveries (card frames
    against the CPU's: chip_smoke.py's engine parity, dense 2,048 and
    rumor 100,000 nodes); the lanes of a P = 2 ring batch with
    telemetry equal their serial runs on the card, and so do the lanes
    of a `ringshard` batch (one sharded step a period, one lane's
    launches), whose batched period makes no host sync;
  * a minified packed scenario: its verdict on the card has the CPU's
    bytes, and its Lifeguard arm's kernels equal their plain versions;
  * the serving hub: golden.drive_serve (injections with a spill, an
    eviction) on the card gives the CPU's state digest after every
    period, with selb, wavemerge and coldsel once a period, and a small
    `run_load` on the udppump frontend keeps `ok_parity`;
  * the lockstep bridge: golden.drive_bridge against an
    EngineBridgeServer on the card gives GOLDEN_DIGEST_BRIDGE, with the
    kernels' launches a period;
  * the phase profiler: GOLDEN_DIGEST_MARKERS on the card, and a
    profiled run whose kernels equal their plain versions and ring.run;
  * the sharded ring engine (8 shards on the card) equals the
    single-device engine and its plain versions in wave scope and on
    the compact and packed wires, with 8x the selb and coldsel
    launches and wavemerge once a wave on each shard, and a sharded
    period makes no host sync;
    memwall measures the sharded streaming study's peak on the card;
  * the exchange-sharded rumor engine (8 shards on the card) gives the
    rumor golden digests and the single-device rumor study, launches no
    kernel, and a sharded study period makes no host sync;
  * on the mesh card, CPU, card, CPU: ringshard in both scopes and
    `shard` equal one card, a study checkpointed on the card's 8 slots
    resumes there bitwise, and the audit's sharded wire arms pass with
    the bytes copied between the devices equal to their model.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_cases import (
    COLDSEL_CASES, COLDSEL_QUIET_CASES, SELB_CASES, WAVE_CASES, WIDE_COLDSEL,
    WIDE_SELB, WIDE_WAVE, carrier, coldsel_input, selb_input,
    wave_case_input, wavemerge_input, wide_wave_input)

from swim_tpu_torch import SwimConfig, convert, golden
from swim_tpu_torch.models import dense, ring, rumor
from swim_tpu_torch.ops import coldsel, selb, wavemerge
from swim_tpu_torch.sim import experiments, faults, runner
from swim_tpu_torch.utils import prng, threefry
from swim_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("n,ww,b", SELB_CASES)
def test_selb_kernel_matches_plain(cuda, n, ww, b):
    win = carrier(selb_input(n + b, n, ww), cuda)
    before = selb.launches
    got = selb.select_first_b(win, b)
    assert selb.launches == before + 1
    assert torch.equal(got, selb.select_first_b_plain(win, b))


@pytest.mark.parametrize("rw,n,ow,q,flush", COLDSEL_CASES)
def test_coldsel_kernel_matches_plain(cuda, rw, n, ow, q, flush):
    cold, fr, fv, qr = (carrier(a, cuda) for a in
                        coldsel_input(rw * n + ow, rw, n, ow, q, flush))
    before = coldsel.launches
    got = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
    assert coldsel.launches == before + 1
    want = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rw,n,ow,q,flush", COLDSEL_QUIET_CASES)
def test_coldsel_kernel_matches_plain_on_main_path_shapes(cuda, rw, n, ow, q,
                                                          flush):
    cold, fr, fv, qr = (carrier(a, cuda) for a in coldsel_input(
        rw * n + ow, rw, n, ow, q, flush, quiet=True))
    got = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
    want = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,ww,v,vb,offs", WAVE_CASES)
def test_wavemerge_kernel_matches_plain(cuda, n, ww, v, vb, offs):
    win, sel, oks, offs, bcol, bval = wave_case_input(n, ww, v, vb, offs)
    args = [carrier(sel, cuda), torch.from_numpy(oks).to(cuda),
            carrier(offs, cuda), carrier(bcol, cuda), carrier(bval, cuda)]
    before = wavemerge.launches
    got = wavemerge.merge_waves(carrier(win, cuda), *args)
    assert wavemerge.launches == before + 1
    want = wavemerge.merge_waves_plain(carrier(win, cuda), *args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,ww,b", WIDE_SELB)
def test_selb_kernel_matches_plain_on_wide_rings(cuda, n, ww, b):
    win = carrier(selb_input(n + ww, n, ww), cuda)
    assert torch.equal(selb.select_first_b(win, b),
                       selb.select_first_b_plain(win, b))


@pytest.mark.parametrize("rw,n,ow,q,flush", WIDE_COLDSEL)
@pytest.mark.parametrize("quiet", [False, True])
def test_coldsel_kernel_matches_plain_on_wide_rings(cuda, rw, n, ow, q, flush,
                                                    quiet):
    cold, fr, fv, qr = (carrier(a, cuda) for a in coldsel_input(
        rw + n + ow, rw, n, ow, q, flush, quiet=quiet))
    got = coldsel.cold_update_select(cold.clone(), fr, fv, qr)
    want = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,ww,v,vb,offs", WIDE_WAVE)
def test_wavemerge_kernel_matches_plain_on_wide_rings(cuda, n, ww, v, vb,
                                                      offs):
    win, sel, oks, offs, bcol, bval = wide_wave_input(n, ww, v, vb, offs)
    args = [carrier(sel, cuda), torch.from_numpy(oks).to(cuda),
            carrier(offs, cuda), carrier(bcol, cuda), carrier(bval, cuda)]
    got = wavemerge.merge_waves(carrier(win, cuda), *args)
    assert torch.equal(got, wavemerge.merge_waves_plain(carrier(win, cuda),
                                                        *args))


def _unaligned(t):
    """A copy of `t` whose data starts 4 bytes past a 16-byte boundary,
    so the kernels take their 4-byte paths."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view(t.shape)
    return view.copy_(t)


def test_selb_kernel_unaligned_view(cuda):
    win = carrier(selb_input(5, 1000, 12), cuda)
    got = selb.select_first_b(_unaligned(win), 6)
    assert torch.equal(got, selb.select_first_b_plain(win, 6))


@pytest.mark.parametrize("which", ["cold", "flush_vals", "q_rows"])
def test_coldsel_kernel_unaligned_view(cuda, which):
    """One argument 4 bytes past a 16-byte boundary, N % 4 == 0: the
    kernel takes its 4-byte path and the result does not change."""
    args = dict(zip(("cold", "flush_rows", "flush_vals", "q_rows"),
                    (carrier(a, cuda) for a in coldsel_input(
                        7, 128, 4096, 2, 4, [0, 9], quiet=True))))
    want = coldsel.cold_update_select_plain(
        args["cold"].clone(), args["flush_rows"], args["flush_vals"],
        args["q_rows"])
    args["cold"] = args["cold"].clone()
    args[which] = _unaligned(args[which])
    got = coldsel.cold_update_select(**args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wavemerge_kernel_unaligned_view(cuda):
    win, sel, oks, offs, bcol, bval = (
        torch.from_numpy(a).to(cuda) if a.dtype == bool else carrier(a, cuda)
        for a in wavemerge_input(6, 1000, 12, 14, 1))
    got = wavemerge.merge_waves(_unaligned(win), _unaligned(sel), oks, offs,
                                bcol, bval)
    want = wavemerge.merge_waves_plain(win.clone(), sel, oks, offs, bcol,
                                       bval)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(ring_sel_scope="period"), {},
    dict(ring_sel_scope="period", lifeguard=True), dict(lifeguard=True),
    dict(ring_sel_scope="period", k_indirect=8, lifeguard=True)],
    ids=["period", "wave", "lifeguard", "lifeguard_wave", "lifeguard_k8"])
def test_card_run_equals_cpu_run(cuda, kw):
    n, periods = 1500, 12
    cfg = SwimConfig(n_nodes=n, **kw)
    runs = {}
    for dev in ("cpu", cuda):
        plan = faults.with_loss(faults.with_crashes(
            faults.none(n, dev), [5, 77, 600], [1, 2, 3]), 0.05)
        runs[str(dev)] = convert.state_to_numpy(
            ring.run(cfg, ring.init_state(cfg, dev), plan, 3, periods))
    for f in ring.RingState._fields:
        np.testing.assert_array_equal(runs[str(cuda)][f], runs["cpu"][f],
                                      err_msg=f)


@pytest.mark.parametrize("name", list(golden.GOLDEN_DIGESTS))
def test_card_run_gives_the_golden_digest(cuda, name):
    assert (golden.digest(golden.golden_run(cuda, name))
            == golden.GOLDEN_DIGESTS[name])


def slice_plan(name, n, dev):
    """The pull path's crash plan, or a three-segment FaultProgram."""
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n, dev), threefry.key(2), 0.01, 1, 8), 0.05)
    if name == "pull":
        return plan
    prog = faults.as_program(plan, np.arange(n) % 4, capacity=3)
    prog = faults.with_segment(prog, 0, start=0, end=12, kind="gray",
                               level=0.3, domain=1)
    prog = faults.with_segment(prog, 1, start=2, end=12, kind="link_loss",
                               level=0.2, domain=2, period=6, on=3)
    return faults.with_segment(prog, 2, start=0, end=12, kind="send_loss",
                               level=0.05)


SLICE_CFGS = {"pull": dict(ring_probe="pull"),
              "pull_period": dict(ring_probe="pull", ring_sel_scope="period"),
              "program": {}, "program_period": dict(ring_sel_scope="period")}


@pytest.mark.parametrize("name", list(SLICE_CFGS))
def test_slice_kernels_equal_plain_and_cpu(cuda, name):
    """Kernels against plain versions on the card, and the card against
    the CPU, under pull and under a program; launches a period: pull
    selb 1 and nothing else, the program's rotor path as without it."""
    n, periods = 20_000, 12
    cfg = SwimConfig(n_nodes=n, **SLICE_CFGS[name])
    kind = name.split("_")[0]
    before = (selb.launches, coldsel.launches, wavemerge.launches)
    k = ring.run(cfg, ring.init_state(cfg, cuda), slice_plan(kind, n, cuda),
                 4, periods)
    made = [a - b for a, b in zip((selb.launches, coldsel.launches,
                                   wavemerge.launches), before)]
    p = ring.run(cfg, ring.init_state(cfg, cuda), slice_plan(kind, n, cuda),
                 4, periods, plain=True)
    c = ring.run(cfg, ring.init_state(cfg, "cpu"), slice_plan(kind, n, "cpu"),
                 4, periods)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f
        assert torch.equal(getattr(k, f).cpu(), getattr(c, f)), f
    scope_waves = 1 if cfg.ring_sel_scope == "period" else 14
    want = ([1, 0, 0] if kind == "pull"
            else [scope_waves, 1, scope_waves])
    assert made == [periods * w for w in want]


def test_card_study_gives_the_golden_digest(cuda):
    res = golden.golden_study(cuda)
    assert (golden.study_digest(res.state, res.track, res.series)
            == golden.GOLDEN_DIGEST_STUDY)


@pytest.mark.parametrize("name", list(SLICE_CFGS))
def test_study_period_makes_no_host_sync(cuda, name):
    """A study period (step, census, milestones) under pull and under a
    program queues its work without waiting for the card: with
    PyTorch's sync check set to raise, a host sync inside fails."""
    n = 20_000
    cfg = SwimConfig(n_nodes=n, **SLICE_CFGS[name])
    plan = slice_plan(name.split("_")[0], n, cuda)
    key = threefry.key(4)
    track = runner.compact_track_init(plan, 12)
    base = faults.base_of(plan)
    stepper = runner.make_stepper(cfg, plan, ring.step)
    # the first period builds the per-(cfg, device) tables
    state, track, _, _ = runner.study_period(
        cfg, ring.init_state(cfg, cuda), track, base,
        ring.draw_period_ring(key, 0, cfg, cuda), stepper)
    rnd = ring.draw_period_ring(key, 1, cfg, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, track, row, _ = runner.study_period(cfg, state, track,
                                                   base, rnd, stepper)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.step) == 2 and len(row) == 4


@pytest.mark.parametrize("engine,kw", [
    ("ring", {}), ("ring", {"ring_probe": "pull"}), ("dense", {}),
    ("rumor", {"lifeguard": True})], ids=["wave", "pull", "dense", "rumor"])
def test_batched_study_period_makes_no_host_sync(cuda, engine, kw):
    """A batched study period (the lanes' draws and one vmapped period)
    queues its work without waiting for the card: the draws' lane keys
    go over from pinned memory."""
    n, p = 4_096, 3
    cfg = SwimConfig(n_nodes=n, telemetry=True, **kw)
    mod = {"ring": ring, "dense": dense, "rumor": rumor}[engine]
    plan = faults.with_random_crashes(faults.none(n, cuda), threefry.key(2),
                                      0.01, 1, 6)
    plans = runner.batch_states([plan] * p)
    state = runner.batch_states([mod.init_state(cfg, cuda)] * p)
    track = runner.StudyTrack(*(torch.full((p, n), runner.NEVER,
                                           dtype=torch.int32, device=cuda)
                                for _ in range(3)))
    keys = [threefry.key(10 + i) for i in range(p)]
    draws = runner.lane_draws(cfg, engine, keys, 0, 2, cuda)
    rnd = next(draws)
    period = runner.batch_period(cfg, engine, rnd)
    # the first period builds the per-(cfg, device) tables
    state, track, _, _ = period(state, track, plans, rnd)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, track, row, frame = period(state, track, plans, next(draws))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step.tolist() == [2] * p and len(row) == 4


# ------------------------------------------------ dense and rumor engines

ENGINES = {"dense": (dense, dense.DenseState, prng.draw_period,
                     runner.run_study, runner.dense_study_period),
           "rumor": (rumor, rumor.RumorState, rumor.draw_period_rumor,
                     runner.run_study_rumor, runner.rumor_study_period)}


def engine_plan(n, dev):
    """Crashes, loss 0.1, a partition over periods 3-7 and a program with
    a gray and a flapping link segment."""
    plan = faults.with_partition(faults.with_loss(faults.with_random_crashes(
        faults.none(n, dev), threefry.key(2), 0.05, 1, 6), 0.1),
        faults.halves(n), 3, 7)
    prog = faults.as_program(plan, np.arange(n) % 3, capacity=2)
    prog = faults.with_segment(prog, 0, start=0, end=12, kind="gray",
                               level=0.3, domain=1)
    return faults.with_segment(prog, 1, start=2, end=12, kind="link_loss",
                               level=0.4, domain=2, period=4, on=2)


@pytest.mark.parametrize("opts", [{}, {"lifeguard": True},
                                  {"target_selection": "round_robin"}],
                         ids=["vanilla", "lifeguard", "round_robin"])
@pytest.mark.parametrize("name,n", [("dense", 300), ("rumor", 3000)])
def test_engine_card_run_equals_cpu_run(cuda, name, n, opts):
    mod, cls = ENGINES[name][:2]
    cfg = SwimConfig(n_nodes=n, **opts)
    runs = {}
    for dev in ("cpu", cuda):
        runs[str(dev)] = convert.state_to_numpy(
            mod.run(cfg, mod.init_state(cfg, dev), engine_plan(n, dev), 5,
                    12))
    for f in cls._fields:
        np.testing.assert_array_equal(runs[str(cuda)][f], runs["cpu"][f],
                                      err_msg=f)


@pytest.mark.parametrize("name", list(golden.ENGINE_DIGESTS))
def test_card_engine_run_gives_the_golden_digest(cuda, name):
    assert (golden.digest(golden.engine_run(cuda, name))
            == golden.ENGINE_DIGESTS[name])


@pytest.mark.parametrize("name,n", [("dense", 1000), ("rumor", 20_000)])
def test_engine_study_period_makes_no_host_sync(cuda, name, n):
    mod, _, draw, run_study, period = ENGINES[name]
    cfg = SwimConfig(n_nodes=n, lifeguard=True)
    plan = engine_plan(n, cuda)
    key = threefry.key(4)
    res = run_study(cfg, mod.init_state(cfg, cuda), plan, key, 2)
    rnd = draw(key, 2, cfg, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _, row, _ = period(cfg, res.state, res.track,
                                  faults.base_of(plan), rnd,
                                  runner.make_stepper(cfg, plan, mod.step))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(state.step) == 3 and len(row) == 4


# ------------------------------------------------- telemetry and batches

TAPPED = {"dense": (dense, prng.draw_period, runner.dense_study_period),
          "rumor": (rumor, rumor.draw_period_rumor,
                    runner.rumor_study_period),
          "ring": (ring, ring.draw_period_ring, runner.study_period)}


@pytest.mark.parametrize("name", list(TAPPED))
def test_telemetry_study_period_makes_no_host_sync(cuda, name):
    """Two telemetry study periods on the card, the second with
    PyTorch's sync check set to raise; each gives an int32 frame."""
    n = 20_000
    cfg = SwimConfig(n_nodes=n, telemetry=True)
    mod, draw, period = TAPPED[name]
    plan = engine_plan(n, cuda)
    stepper = runner.make_stepper(cfg, plan, mod.step)
    track = (runner.compact_track_init(plan, 8) if name == "ring"
             else runner._new_track(n, cuda))
    state = mod.init_state(cfg, cuda)
    frames = []
    for t in range(2):
        rnd = draw(threefry.key(6), t, cfg, cuda)
        torch.cuda.synchronize()
        if t:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, track, row, frame = period(
                cfg, state, track, faults.base_of(plan), rnd, stepper)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        frames.append(frame)
    assert int(state.step) == 2 and len(row) == 4
    assert all(x.dtype == torch.int32 and x.device == state.step.device
               for f in frames for x in f)
    assert int(frames[1].waves_delivered) > 0


def test_ring_batch_lanes_equal_serial_on_the_card(cuda):
    n, periods = 20_000, 6
    cfg = SwimConfig(n_nodes=n, telemetry=True)
    progs = [slice_plan("program", n, cuda),
             faults.pad_program(faults.as_program(
                 slice_plan("pull", n, cuda)), 3)]
    keys = [threefry.key(11), threefry.key(12)]
    before = (selb.launches, coldsel.launches, wavemerge.launches)
    batched = experiments._run_study_batch(cfg, progs, keys, periods,
                                           "ring", device=cuda)
    made = [a - b for a, b in zip((selb.launches, coldsel.launches,
                                   wavemerge.launches), before)]
    # one step a period for both lanes: one lane's launches
    assert made == [periods * 14, periods, periods * 14]
    for p in range(2):
        serial = experiments._run_study(cfg, progs[p], keys[p], periods,
                                        "ring", cuda)
        pairs = []
        tree_map(lambda a, b: pairs.append(torch.equal(a, b)),
                 runner.lane_result(batched, p), serial)
        assert pairs and all(pairs), f"lane {p}"


@pytest.mark.parametrize("kw", [{}, dict(
    ring_sel_scope="period", ring_scalar_wire="packed", lifeguard=True,
    buddy=True)], ids=["wave", "period_packed"])
def test_ringshard_batch_lanes_equal_serial_on_the_card(cuda, kw):
    """A `ringshard` batch (8 shards on the card, two lanes, telemetry)
    is one sharded step a period: each lane equals its serial sharded
    study, and the kernels launch one lane's count."""
    n, periods = 20_000, 4
    cfg = SwimConfig(n_nodes=n, telemetry=True, **kw)
    progs = [slice_plan("program", n, cuda),
             faults.pad_program(faults.as_program(
                 slice_plan("pull", n, cuda)), 3)]
    keys = [threefry.key(13), threefry.key(14)]

    def launches():
        return [selb.launches, coldsel.launches, wavemerge.launches]

    before = launches()
    batched = experiments._run_study_batch(cfg, progs, keys, periods,
                                           "ringshard", device=cuda)
    made = [a - b for a, b in zip(launches(), before)]
    for p in range(2):
        before = launches()
        serial = experiments._run_study(cfg, progs[p], keys[p], periods,
                                        "ringshard", cuda)
        assert [a - b for a, b in zip(launches(), before)] == made
        pairs = []
        tree_map(lambda a, b: pairs.append(torch.equal(a, b)),
                 runner.lane_result(batched, p), serial)
        assert pairs and all(pairs), f"lane {p}"
    assert made[1] == 8 * periods


def test_batched_sharded_period_makes_no_host_sync(cuda):
    """A batched sharded study period (8 shards on the card, three
    lanes) queues its work without waiting for the card."""
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import ring_shard

    n, p = 20_000, 3
    cfg = SwimConfig(n_nodes=n, telemetry=True)
    plan = faults.as_program(faults.with_random_crashes(
        faults.none(n, cuda), threefry.key(2), 0.01, 1, 6))
    _, state, plans, step = ring_shard.start(
        cfg, faults.stack_programs([plan] * p).program, cuda)
    track = runner.StudyTrack(*(torch.full((p, n), runner.NEVER,
                                           dtype=torch.int32, device=cuda)
                                for _ in range(3)))
    draws = ring.period_draws(cfg, [threefry.key(10 + i) for i in range(p)],
                              0, 2, cuda)
    rnd, shifts = next(draws)
    period = runner.batch_period(cfg, "ring", rnd, step)
    state, track, _, _ = period(state, track, plans, rnd, shifts)
    rnd, shifts = next(draws)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, track, row, _ = period(state, track, plans, rnd, shifts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pmesh.assemble(state.step).tolist() == [2] * p and len(row) == 4


def test_packed_scenario_card_equals_cpu(cuda, tmp_path):
    """A minified packed ring scenario (gray lanes, a rack crash and a
    flapping link, Lifeguard with buddy against vanilla): the verdict
    written on the card has the CPU's bytes, and the Lifeguard arm with
    the kernels equals the plain versions on the card, selb, wavemerge
    and coldsel each launching once a period."""
    from swim_tpu_torch.sim import scenario

    ring_cfg = dict(ring_probe="rotor", ring_scalar_wire="packed",
                    ring_sel_scope="period", lifeguard=True, buddy=True)
    sc = scenario.Scenario(
        name="card_mini", n=4096, periods=12, config=ring_cfg,
        domains="blocks:8",
        events=({"kind": "gray", "domain": 1, "start": 2, "end": 10,
                 "level": 0.43},
                {"kind": "crash", "domain": 2, "start": 4},
                {"kind": "link_loss", "domain": 3, "start": 1, "end": 11,
                 "level": 0.3, "period": 4, "on": 2}),
        arms={"lha": {},
              "vanilla": {"gate": False,
                          "config": {"lifeguard": False, "buddy": False}}},
        expect=({"check": "lane_charged", "arm": "lha"},))
    texts = []
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        out = tmp_path / name
        _, path = scenario.run(sc, out_dir=str(out), device=dev)
        texts.append(path_text(path, out))
    assert texts[0] == texts[1]
    _, cfg, prog = scenario._arm_prepare(sc, {}, cuda)
    before = (selb.launches, coldsel.launches, wavemerge.launches)
    k = ring.run(cfg, ring.init_state(cfg, cuda), prog, sc.seed, sc.periods)
    made = [a - b for a, b in zip((selb.launches, coldsel.launches,
                                   wavemerge.launches), before)]
    p = ring.run(cfg, ring.init_state(cfg, cuda), prog, sc.seed, sc.periods,
                 plain=True)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    assert made == [sc.periods] * 3


def path_text(path, out_dir) -> str:
    with open(path) as fh:
        return fh.read().replace(str(out_dir), "OUT")


def test_serve_hub_card_equals_cpu(cuda):
    from swim_tpu_torch.ops import coldsel, selb, wavemerge

    periods = 10
    before = (selb.launches, coldsel.launches, wavemerge.launches)
    card = golden.golden_serve(cuda, n=3000, periods=periods)
    after = (selb.launches, coldsel.launches, wavemerge.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (periods,) * 3
    assert card == golden.golden_serve("cpu", n=3000, periods=periods)


def test_serve_run_load_on_the_card(cuda):
    from swim_tpu_torch.serve import load as serve_load

    res = serve_load.run_load(n_nodes=20_000, sessions=32, periods=3,
                              n_sockets=4, echo_samples=100,
                              frontend="udppump")
    assert res["ok_parity"], res
    assert res["frontend"] == "udppump"
    assert res["clean"]["admission"]["sessions"] == 32


def test_bridge_golden_digest_on_the_card(cuda):
    """golden.drive_bridge against an EngineBridgeServer on the card:
    GOLDEN_DIGEST_BRIDGE, with selb and wavemerge once a wave (k = 1: 6
    waves) and coldsel once a period."""
    from swim_tpu_torch.ops import coldsel, selb, wavemerge

    before = (selb.launches, wavemerge.launches, coldsel.launches)
    got, server = golden.golden_bridge(cuda)
    after = (selb.launches, wavemerge.launches, coldsel.launches)
    periods = golden.BRIDGE_PERIODS
    assert server.t == periods == int(server.state.step)
    assert tuple(a - b for a, b in zip(after, before)) == (
        6 * periods, 6 * periods, periods)
    assert got[-1] == golden.GOLDEN_DIGEST_BRIDGE


def test_profiled_run_and_marker_digest_on_the_card(cuda):
    """The phase profiler on the card: the golden runs' markers give
    GOLDEN_DIGEST_MARKERS, and a profiled period-scope run at 20,000
    nodes launches each kernel once a period, equals its plain versions
    (markers and state) and `ring.run`."""
    from swim_tpu_torch.obs import prof

    assert golden.markers_digest(golden.golden_markers(cuda)) \
        == golden.GOLDEN_DIGEST_MARKERS
    cfg = SwimConfig(n_nodes=20_000, ring_sel_scope="period")
    plan = faults.with_random_crashes(faults.none(20_000, cuda),
                                      threefry.key(1), 0.01, 0, 6)
    before = (selb.launches, wavemerge.launches, coldsel.launches)
    got = prof.profiled_ring_run(cfg, ring.init_state(cfg, cuda), plan, 2,
                                 6)
    after = (selb.launches, wavemerge.launches, coldsel.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 6, 6)
    plain = prof.profiled_ring_run(cfg, ring.init_state(cfg, cuda), plan,
                                   2, 6, plain=True)
    want = ring.run(cfg, ring.init_state(cfg, cuda), plan, 2, 6)
    assert torch.equal(got.markers, plain.markers)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(got.state, f), getattr(want, f)), f
        assert torch.equal(getattr(plain.state, f), getattr(want, f)), f


def _shard_merge_launches(cfg) -> int:
    """wavemerge calls a period on each card shard of the sharded ring:
    one a wave, and in wave scope under Lifeguard's buddy one more for
    each wave whose sender forces a bit; none under pull."""
    if cfg.ring_probe == "pull":
        return 0
    waves = 2 + 4 * cfg.k_indirect
    fused = cfg.ring_sel_scope == "period" and waves <= wavemerge.MAX_WAVES
    buddy = cfg.lifeguard and cfg.buddy and not fused
    return waves + (1 + cfg.k_indirect if buddy else 0)


@pytest.mark.parametrize("kw", [
    {}, dict(ring_sel_scope="period", ring_ici_wire="compact",
             ring_scalar_wire="packed")], ids=["wave", "compact_packed"])
def test_ringshard_equals_one_device_on_the_card(cuda, kw):
    """The sharded ring engine, 8 shards on the card, at 20,000 nodes for
    4 periods: state equal to the single-device engine's and to its own
    plain versions, selb and coldsel launched 8 times as often as on one
    device and wavemerge once a wave on each shard; one more sharded
    period makes no host sync."""
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import ring_shard

    n, periods = 20_000, 4
    cfg = SwimConfig(n_nodes=n, **kw)
    plan = faults.with_random_crashes(faults.none(n, cuda),
                                      threefry.key(1), 0.01, 0, periods)
    mesh = pmesh.make_mesh(devices=[cuda] * 8)

    def launches():
        return (selb.launches, coldsel.launches, wavemerge.launches)

    def sharded(plain):
        st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, cuda),
                                  plan)
        return ring_shard.build_run(cfg, mesh, periods, plain=plain)(
            st, pl, 3), pl

    before = launches()
    want = ring.run(cfg, ring.init_state(cfg, cuda), plan, 3, periods)
    mid = launches()
    got, pl = sharded(False)
    after = launches()
    one = [b - a for a, b in zip(before, mid)]
    assert [b - a for a, b in zip(mid, after)] == \
        [8 * one[0], 8 * one[1], 8 * periods * _shard_merge_launches(cfg)]
    plain = pmesh.assemble(sharded(True)[0])
    for f in ring.RingState._fields:
        assert torch.equal(getattr(pmesh.assemble(got), f),
                           getattr(want, f)), f
        assert torch.equal(getattr(plain, f), getattr(want, f)), f
    rnd = ring.draw_period_ring(threefry.key(3), periods, cfg, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ring_shard.mapped_step(cfg, mesh)(got, pl, rnd,
                                          ring.rotor_offsets(cfg, periods))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_ringshard_memwall_is_measured_on_the_card(cuda):
    """memwall's ringshard row on the card (80,000 nodes, 4 periods of the
    streaming pull study on 8 shards): a measured peak at least the
    placed state's bytes and inside the card's memory, the state bytes
    8 equal shards'."""
    from swim_tpu_torch.obs import memwall

    rep = memwall.study_memory_analysis(80_000, periods=4,
                                        engine="ringshard", device=cuda)
    assert rep["measured"] is True and rep["platform"] == "cuda"
    assert rep["shards"] == 8
    assert rep["shard_state_bytes"] * 8 == rep["state_bytes"]
    assert rep["state_bytes"] <= rep["total_bytes"] <= \
        rep["hbm_budget_bytes"]
    assert rep["fits_budget"] is True


@pytest.mark.parametrize("name", ["rumor", "rumor_lifeguard"])
def test_card_shard_engine_gives_the_golden_digest(cuda, name):
    """The exchange-sharded rumor engine, 8 shards on the card."""
    assert (golden.digest(golden.engine_run(cuda, name, sharded=True))
            == golden.ENGINE_DIGESTS[name])


def test_shard_engine_equals_one_device_on_the_card(cuda):
    """The exchange-sharded rumor engine at 20,000 nodes for 3 study
    periods equals the single-device rumor study and launches no kernel
    of the port; one more sharded study period makes no host sync."""
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import shard_engine

    n = 20_000
    cfg = SwimConfig(n_nodes=n)
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n, cuda), threefry.key(1), 0.01, 0, 3), 0.1)
    key = threefry.key(3)
    want = runner.run_study_rumor(cfg, rumor.init_state(cfg, cuda), plan,
                                  key, 3)
    before = (selb.launches, coldsel.launches, wavemerge.launches)
    _, st, pl, step = shard_engine.start(cfg, plan, cuda)
    got = runner.run_study_rumor(cfg, st, pl, key, 3, step)
    assert (selb.launches, coldsel.launches, wavemerge.launches) == before
    for f in rumor.RumorState._fields:
        assert torch.equal(pmesh.assemble(getattr(got.state, f)),
                           getattr(want.state, f)), f
    for a, b in zip(got.track + got.series, want.track + want.series):
        assert torch.equal(a, b)
    rnd = rumor.draw_period_rumor(key, 3, cfg, cuda)
    stepper = runner.make_stepper(cfg, pl, rumor.step, step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.rumor_study_period(cfg, got.state, got.track,
                                  faults.base_of(plan), rnd, stepper)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _mixed_mesh(cuda):
    """chip_smoke.py phase 19's mesh: card, CPU, card, CPU."""
    from swim_tpu_torch.parallel import mesh as pmesh

    return pmesh.make_mesh(devices=[cuda, "cpu", cuda, "cpu"])


@pytest.mark.parametrize("kw", [dict(ring_sel_scope="period"), {}],
                         ids=["period", "wave"])
def test_ringshard_on_a_card_and_cpu_mesh_equals_one_card(cuda, kw):
    """ringshard at 4,096 nodes on the mixed mesh for 2 periods: every
    field equals ring.run on the card; selb and coldsel launch on the
    two card shards only (twice one card's), wavemerge on them once a
    wave; the bytes
    copied between the devices equal the mesh's model of the recorded
    exchanges."""
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import ring_shard

    n, periods = 4096, 2
    mesh = _mixed_mesh(cuda)
    cfg = SwimConfig(n_nodes=n, **kw)
    plan = faults.with_random_crashes(faults.none(n, cuda),
                                      threefry.key(1), 0.01, 0, periods)

    def launches():
        return [selb.launches, coldsel.launches, wavemerge.launches]

    before = launches()
    want = ring.run(cfg, ring.init_state(cfg, cuda), plan, 3, periods)
    mid = launches()
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, cuda), plan)
    step = ring_shard.mapped_step(cfg, mesh)
    step.record = []
    mesh.copied_bytes = 0
    for rnd, shifts in ring.period_draws(cfg, threefry.key(3), 0, periods,
                                         cuda):
        st = step(st, pl, rnd, shifts)
    after = launches()
    one = [b - a for a, b in zip(before, mid)]
    assert [b - a for a, b in zip(mid, after)] == \
        [2 * one[0], 2 * one[1], 2 * periods * _shard_merge_launches(cfg)]
    assert [b.device.type for b in st.win.blocks] == \
        ["cuda", "cpu", "cuda", "cpu"]
    got = pmesh.assemble(st)
    for f in ring.RingState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert mesh.copied_bytes == \
        ring_shard.mesh_copy_bytes(step.record, mesh) > 0


def test_shard_engine_on_a_card_and_cpu_mesh_equals_one_card(cuda):
    """The exchange-sharded rumor engine at 4,096 nodes (loss 0.1, 3
    periods) on the mixed mesh equals rumor.run on the card."""
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import shard_engine

    n, periods = 4096, 3
    mesh = _mixed_mesh(cuda)
    cfg = SwimConfig(n_nodes=n)
    plan = faults.with_loss(faults.with_random_crashes(
        faults.none(n, cuda), threefry.key(1), 0.01, 0, periods), 0.1)
    want = rumor.run(cfg, rumor.init_state(cfg, cuda), plan, 3, periods)
    st, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, cuda),
                                plan)
    got = pmesh.assemble(shard_engine.build_run(cfg, mesh, periods)(
        st, pl, 3))
    for f in rumor.RumorState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert mesh.copied_bytes > 0


def test_audit_wire_arms_on_a_card_and_cpu_mesh(cuda):
    """The audit's sharded wire arms (audit.sharded_wire_arms, 512
    nodes) on the mixed mesh: every row passes, and each arm copies
    between the devices exactly its model's bytes, more than none."""
    from swim_tpu_torch.analysis import audit

    rows = []
    out = audit.sharded_wire_arms(_mixed_mesh(cuda), 512,
                                  lambda *row: rows.append(row))
    assert len(rows) == 3 * len(audit.WIRE_ARMS)
    assert all(ok for _, _, ok, _ in rows), rows
    assert out["unattributed"] == 0
    for arm, c in out["copies"].items():
        assert c["copied"] == c["model"] > 0, arm


def test_study_checkpointed_on_the_card_resumes_on_a_mixed_mesh(
        cuda, tmp_path):
    """A streaming ringshard pull study at 4,096 nodes checkpointed on 8
    slots of the card after 2 of its 4 periods and resumed on the mixed
    mesh: track and series equal the one-card ring study's."""
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import ring_shard

    class Stop(RuntimeError):
        pass

    class StopAfterSnapshot(runner.StudyCheckpointer):
        def save(self, *a, **kw):
            super().save(*a, **kw)
            raise Stop

    n, periods, every = 4096, 4, 2
    cfg = SwimConfig(n_nodes=n, ring_probe="pull")
    plan = experiments._crash_plan(n, 0, 0.01, periods, cuda)
    key = threefry.key(0)
    want = runner.run_study_ring_stream(cfg, ring.init_state(cfg, cuda),
                                        plan, key, periods, chunk=every)
    for mesh, ckpt in (
            (pmesh.make_mesh(devices=[cuda] * 8),
             StopAfterSnapshot(str(tmp_path), every=every)),
            (_mixed_mesh(cuda), runner.StudyCheckpointer(str(tmp_path),
                                                         every=every))):
        st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, cuda),
                                  plan)
        try:
            got = runner.run_study_ring_stream(
                cfg, st, pl, key, periods, ring_shard.mapped_step(cfg, mesh),
                ckpt=ckpt)
        except Stop:
            continue
    for part in ("track", "series"):
        for a, b in zip(getattr(got, part), getattr(want, part)):
            assert torch.equal(a, b), part

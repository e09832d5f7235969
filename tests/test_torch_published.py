"""The JAX package's published study commands at a small size: the port
against the JAX package run beside it on the same inputs, every field.

  * `study suspicion_sweep --engine ring`, 2 mults x 2 losses, through
    both packages' CLIs: the whole JSON, and each point;
  * `study lifeguard --engine ring --budget-arms` (ring_orig_words 2
    and 8, Lifeguard off and on) through the port's CLI, held to the JAX
    package's CLI without `--budget-arms` (the two ring_orig_words-2
    arms), and its ring_orig_words-8 arms to golden.PUBLISHED_OW8_CPU:
    each arm with its final `overflow`; at this crash fraction and loss
    the OW-2 arms originate more than their budget holds and the OW-8
    arms do not;
  * the sized call (`suspicion_sweep(..., ring_orig_words=4)`) on the
    port's `ring` and `ringshard` (8 shard slots of the CPU) against the
    JAX `ring`;
  * the lean geometry arm (published.geometry_arm): `ring.run`'s final
    state by digest and its `overflow`;
  * the pull-law computation (published.pull_law) at two seeds, every
    field but the wall and the platform;
  * published.py's own parts: the JSON comparison and the rows' studies,
    and the kernels' launches a period each configuration calls for.

The JAX package compiles one of these ring studies in about 18 s on a
CPU at ring_orig_words 2, 37 s at 4 and 86-130 s at 8 (its per-word ops
unroll), so its cases (tests/torch_published_jax.py) start together in
four worker processes while the port runs in this one.  The
ring_orig_words-8 arms alone are held to a record; the `slow` test
recomputes it through the JAX package's CLI.  Nothing here reads
`bench_results/`.

Tolerance: exact.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import pytest
import torch_published_jax as jaxside
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu_torch import SwimConfig, golden, measure, published
from swim_tpu_torch.sim import experiments

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 1024
PERIODS = 24
CRASH, LOSS = 0.1, 0.1
SWEEP = ["study", "suspicion_sweep", "--nodes", str(N), "--engine", "ring",
         "--periods", str(PERIODS), "--mults", "5.0", "2.0", "--losses",
         "0.02", str(LOSS), "--crash-fraction", str(CRASH)]
LIFEGUARD = ["study", "lifeguard", "--nodes", str(N), "--engine", "ring",
             "--periods", str(PERIODS), "--budget-arms", "--crash-fraction",
             str(CRASH), "--loss", str(LOSS)]
LIFEGUARD_OW2 = [a for a in LIFEGUARD if a != "--budget-arms"]
SIZED = dict(n=N, crash_fraction=CRASH, periods=10)
LEAN = dict(n=4096, periods=20)
PULL = dict(n=2048, crashes=24, seeds=2, periods=20)
ARMS = ("vanilla", "lifeguard", "vanilla_ob8", "lifeguard_ob8")
OW8 = golden.PUBLISHED_OW8_CPU


def with_overflow(module, fn):
    """(fn(), the final `overflow` of each study that `module`'s
    `_run_study` ran meanwhile, in order)."""
    real, seen = module._run_study, []

    def keep(*a, **k):
        res = real(*a, **k)
        seen.append(int(res.state.overflow))
        return res
    module._run_study = keep
    try:
        return fn(), seen
    finally:
        module._run_study = real


def jax_jobs(pool) -> dict:
    """{case: future} of the JAX package's cases, started on `pool`, the
    longest first."""
    return {
        "sized": pool.submit(jaxside.suspicion_sweep,
                             **{**published.SIZED_4M, **SIZED,
                                "engine": "ring", "ring_orig_words": 4}),
        "sweep": pool.submit(jaxside.cli, SWEEP),
        "lifeguard": pool.submit(jaxside.cli, LIFEGUARD_OW2),
        "lean": pool.submit(jaxside.geometry_arm, LEAN["n"],
                            LEAN["periods"], published.GEOMETRY_ARMS["lean"]),
        "pull": pool.submit(jaxside.pull_law, **PULL,
                            crash_at=published.PULL_CRASH_AT),
    }


@pytest.fixture(scope="module")
def runs():
    """({case: the port's result}, {case: the JAX package's}): the JAX
    cases started first in four worker processes, the port's run
    meanwhile in this one."""
    with ProcessPoolExecutor(4, multiprocessing.get_context("spawn"),
                             initializer=jaxside.init) as pool:
        ref = jax_jobs(pool)
        port = {
            "sweep": published.study_cli(SWEEP, device="cpu"),
            "lifeguard": with_overflow(
                experiments,
                lambda: published.study_cli(LIFEGUARD, device="cpu")),
            "sized": published.sized_sweep("ring", 4, device="cpu", **SIZED),
            "sized_ringshard": published.sized_sweep(
                "ringshard", 4, device="cpu", **SIZED),
            "lean": published.geometry_arm("lean", device="cpu", **LEAN),
            "pull": published.pull_law(device="cpu", **PULL),
        }
        ref = {case: f.result() for case, f in ref.items()}
    ref["sweep"] = ref["sweep"][0]    # a CLI's (result, overflows)
    return port, ref


def test_suspicion_sweep_cli_equals_the_reference(runs):
    port, ref = runs
    assert port["sweep"] == ref["sweep"]
    assert len(port["sweep"]["points"]) == 4


@pytest.mark.parametrize("i", range(4))
def test_suspicion_sweep_point_equals_the_reference(runs, i):
    port, ref = runs
    got, want = port["sweep"]["points"][i], ref["sweep"]["points"][i]
    assert got == want
    assert got["crashed"] > 0 and got["suspect_detected"] > 0


def lifeguard_want(ref) -> tuple[dict, list]:
    """The JAX package's whole lifeguard result and overflows: its CLI's
    ring_orig_words-2 arms (without `--budget-arms`), then the recorded
    ring_orig_words-8 ones."""
    res, overflow = ref["lifeguard"]
    return ({**res, "arms": {**res["arms"], **OW8["arms"]}},
            overflow + OW8["overflow"])


def test_lifeguard_budget_arms_cli_equals_the_reference(runs):
    port, ref = runs
    assert port["lifeguard"][0] == lifeguard_want(ref)[0]
    assert list(port["lifeguard"][0]["arms"]) == list(ARMS)


@pytest.mark.parametrize("i,arm", enumerate(ARMS))
def test_lifeguard_budget_arm_equals_the_reference(runs, i, arm):
    """Each arm's summary and final overflow; at this crash fraction and
    loss the OW-2 arms originate more than their budget holds (so the
    overflow path runs) and the OW-8 arms do not."""
    port, ref = runs
    (got, overflow), (want, want_overflow) = port["lifeguard"], \
        lifeguard_want(ref)
    assert got["arms"][arm] == want["arms"][arm]
    assert overflow[i] == want_overflow[i]
    ow = got["arms"][arm]["ring_orig_words"]
    assert ow == (8 if arm.endswith("ob8") else 2)
    assert (overflow[i] > 0) == (ow == 2)


def test_sized_call_on_ring_equals_the_reference(runs):
    port, ref = runs
    assert port["sized"] == ref["sized"]
    assert port["sized"]["points"][0]["crashed"] > 0


def test_sized_call_on_ringshard_equals_ring(runs):
    port, _ = runs
    assert port["sized_ringshard"] == {**port["sized"], "engine": "ringshard"}


def test_lean_geometry_arm_equals_the_reference(runs):
    (arm, state), (fields, overflow) = runs[0]["lean"], runs[1]["lean"]
    assert golden.digest(state) == golden.digest(fields)
    assert arm["overflow"] == overflow
    assert {k: arm["geometry"][k] for k in ("ww", "c", "k", "sel_scope",
                                             "suspicion_mult")} == \
        {"ww": 6, "c": 2, "k": 1, "sel_scope": "period",
         "suspicion_mult": 2.0}


def test_pull_law_equals_the_reference(runs):
    got, want = runs[0]["pull"], runs[1]["pull"]
    skip = ("wall_seconds", "platform")
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert got["samples"] > 0 and got["ks_pass"]


def test_differing_names_every_path():
    want = {"a": 1, "b": {"c": [1, 2.5], "d": "x"}, "e": 3}
    got = {"a": 1, "b": {"c": [1, 2.75], "d": "y"}, "f": 3}
    assert published.differing(want, want) == []
    assert published.differing(got, want) == ["b.c[1]", "b.d", "e", "f"]
    assert published.differing([1, 2], [1]) == [""]
    assert published._at(got, "b.c[1]") == 2.75


def test_ringshard_row_runs_with_its_ring_row():
    """sized_4m_ringshard is held to suspicion_4m_sized's result, so
    `--only` refuses it alone (before it looks for a card)."""
    with pytest.raises(SystemExit) as e:
        published.main(["--only", "sized_4m_ringshard"])
    assert e.value.code == 2
    assert list(published.ROWS).index("suspicion_4m_sized") < \
        list(published.ROWS).index("sized_4m_ringshard")


@pytest.mark.parametrize("kw,engine,want", [
    ({}, "ring", (14, 1, 14)),
    ({"ring_orig_words": 8, "lifeguard": True}, "ring", (14, 1, 14)),
    ({"ring_sel_scope": "period"}, "ring", (1, 1, 1)),
    (published.GEOMETRY_ARMS["lean"], "ring", (1, 1, 1)),
    ({"ring_probe": "pull"}, "ring", (1, 0, 0)),
    ({}, "ringshard", (112, 8, 112)),
    ({"ring_orig_words": 4}, "ringshard", (112, 8, 112)),
])
def test_launches_a_period(kw, engine, want):
    cfg = SwimConfig(n_nodes=N, **kw)
    got = measure.launches_a_period(cfg, engine)
    assert (got["selb"], got["coldsel"], got["wavemerge"]) == want


def test_every_row_names_its_studies():
    periods = {name: sum(p for _, _, p in row.studies())
               for name, row in published.ROWS.items()}
    assert periods["suspicion_1m"] == 1000
    assert periods["lifeguard_1m"] == 400
    assert periods["geometry"] == 3 * published.GEOMETRY_PERIODS
    assert periods["pull_law"] == 5 * 30
    ows = [c.ring_orig_words for c, _, _ in
           published.ROWS["lifeguard_1m"].studies()]
    assert ows == [2, 2, 8, 8]
    assert not published.ROWS["suspicion_4m"].asserted


@pytest.mark.slow
def test_ow8_record_is_the_jax_packages():
    """golden.PUBLISHED_OW8_CPU recomputed through the JAX package's CLI
    (several minutes: two ring_orig_words-8 study compiles)."""
    got, overflow = jaxside.cli(LIFEGUARD)
    assert {k: got["arms"][k] for k in OW8["arms"]} == OW8["arms"]
    assert overflow[2:] == OW8["overflow"]

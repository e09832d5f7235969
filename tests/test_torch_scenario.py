"""The port's scenario layer against `swim_tpu.sim.scenario` and the byte
bill against `swim_tpu.obs.ici`.

  * the library: the same names and spec dicts; `compile_program` gives
    the reference's FaultProgram field for field for every library spec
    and each of its arms, and for a synthetic spec with random crashes,
    explicit crash nodes, a partition, explicit domain labels and padded
    capacity; `fault_gauges` the reference's arrays; `validate` and
    `domain_labels` raise the reference's ValueError messages;
  * `trace_ici_bytes(cfg, d)`: total and breakdown (keys, values and
    their order) equal to the reference's on the wide and packed scalar
    wires, the window and compact ICI wires, with and without a program,
    vanilla, Lifeguard with and without buddy, in wave scope, past 32
    waves and under pull, at d = 4 and d = 8; it states no time, and the
    serving mirror raises;
  * `run`: the verdict file's bytes equal the reference's (out_dir
    normalised, as tests/test_scenario_batch.py does) for `gray_10pct` at
    its library size and for minified ring (three arms, every check kind
    the arms support), rumor (random crashes, a partition, per-arm loss
    and seed), dense and study-mode specs; `run(batch=True)` gives the
    serial bytes; `replay_storm` (the real-node arm: a SimCluster of
    core/node.py nodes) gives the reference's verdict bytes and passes;
    a `ringshard` spec raises naming the sharding item; without a card
    the entry points given no device raise.

Torch runs on one thread.  Tolerance: exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.obs import ici as jici
from swim_tpu.sim import scenario as jscenario
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.obs import ici
from swim_tpu_torch.sim import faults, scenario

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RING_CFG = {"ring_probe": "rotor", "ring_scalar_wire": "packed",
            "ring_sel_scope": "period", "lifeguard": True, "buddy": True}

SYNTHETIC = dict(
    name="synthetic", n=96, periods=20, engine="ring", seed=5,
    config=RING_CFG, loss=0.05, domains=list(np.arange(96) % 5),
    crashes={"fraction": 0.1, "start": 3, "end": 9},
    partition={"start": 4, "end": 12},
    capacity=5,
    events=(
        {"kind": "crash", "nodes": [1, 7, 90], "start": 6},
        {"kind": "crash", "domain": 3, "start": 11},
        {"kind": "gray", "domain": 1, "start": 2, "end": 18, "level": 0.4},
        {"kind": "send_loss", "start": 1, "end": 5, "level": 0.2},
        {"kind": "link_loss", "domain": 4, "start": 3, "end": 19,
         "level": 0.3, "period": 5, "on": 2},
        {"kind": "recv_loss", "domain": 0, "start": 0, "end": 20,
         "level": 1.0},
    ))


def specs(name):
    """(port spec, reference spec) of a library name or the synthetic."""
    if name == "synthetic":
        return (scenario.Scenario(**SYNTHETIC),
                jscenario.Scenario(**SYNTHETIC))
    return scenario.get(name), jscenario.get(name)


def assert_same_program(port, ref, what):
    fields = faults.to_numpy(port.base)._asdict()
    for f in port.base._fields:
        want = np.asarray(getattr(ref.base, f))
        assert fields[f].dtype == want.dtype, f"{what}: base.{f} dtype"
        np.testing.assert_array_equal(fields[f], want,
                                      err_msg=f"{what}: base.{f}")
    for f in port._fields:
        if f == "base":
            continue
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, f"{what}: {f} dtype"
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {f}")


def test_library_is_the_reference_library():
    assert sorted(scenario.LIBRARY) == sorted(jscenario.LIBRARY)
    for name in jscenario.LIBRARY:
        assert scenario.get(name).spec_dict() == \
            jscenario.get(name).spec_dict(), name
    assert scenario.get("gray-10pct") is scenario.LIBRARY["gray_10pct"]
    with pytest.raises(KeyError):
        scenario.get("nope")


@pytest.mark.parametrize("name", sorted(jscenario.LIBRARY) + ["synthetic"])
def test_compile_program_matches_the_reference(name):
    sc, jsc = specs(name)
    arm_specs = [{}] + [dict(a) for a in (jsc.arms or {}).values()]
    for i, spec in enumerate(arm_specs):
        assert_same_program(
            scenario.compile_program(scenario._arm_scenario(sc, spec),
                                     "cpu"),
            jscenario.compile_program(jscenario._arm_scenario(jsc, spec)),
            f"{name} arm {i}")


@pytest.mark.parametrize("name", sorted(jscenario.LIBRARY) + ["synthetic"])
def test_fault_gauges_match_the_reference(name):
    sc, jsc = specs(name)
    got, want = scenario.fault_gauges(sc), jscenario.fault_gauges(jsc)
    assert sorted(got) == sorted(want) == ["flap_active", "gray_nodes"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


BAD_SPECS = {
    "engine": dict(engine="tpu"),
    "n": dict(n=1),
    "periods": dict(periods=0),
    "study": dict(study="nope"),
    "event-key": dict(events=[{"kind": "crash", "start": 1, "x": 2}]),
    "event-kind": dict(events=[{"kind": "jitter", "start": 1}]),
    "start": dict(events=[{"kind": "crash"}]),
    "window": dict(events=[{"kind": "gray", "start": 3, "end": 3,
                            "level": 0.1}]),
    "level": dict(events=[{"kind": "gray", "start": 1, "end": 3,
                           "level": 1.5}]),
    "duty": dict(events=[{"kind": "link_loss", "start": 1, "end": 9,
                          "level": 0.1, "period": 3, "on": 4}]),
    "domain": dict(domains="blocks:4",
                   events=[{"kind": "crash", "start": 1, "domain": 4}]),
    "crash-target": dict(events=[{"kind": "crash", "start": 1,
                                  "domain": 0, "nodes": [1]}]),
    "arm-key": dict(arms={"a": {"lifeguard": True}}),
    "blocks-count": dict(domains="blocks:0"),
    "domain-form": dict(domains="ring:4"),
    "domain-arg": dict(domains="blocks:x"),
    "domain-shape": dict(domains=[0, 1, 2]),
    "domain-range": dict(n=4, domains=[0, 1, 2, 300]),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_validate_raises_the_reference_errors(case):
    kw = {"name": "bad", "n": 16, **BAD_SPECS[case]}
    with pytest.raises(ValueError) as want:
        jscenario.validate(jscenario.Scenario(**kw))
    with pytest.raises(ValueError) as got:
        scenario.validate(scenario.Scenario(**kw))
    assert str(got.value) == str(want.value)


def test_domain_labels_match_the_reference():
    for n, spec in ((10, "blocks:3"), (10, "stripe:4"), (7, None),
                    (5, [4, 0, 255, 1, 1]), (300, "blocks:256")):
        got = scenario.domain_labels(n, spec)
        want = jscenario.domain_labels(n, spec)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ byte bill

# name -> (SwimConfig keywords, the (d, program?) bills compared)
ICI_CONFIGS = {
    "wide": (dict(ring_sel_scope="period"), ((4, False), (8, True))),
    "packed": (dict(ring_sel_scope="period", ring_scalar_wire="packed"),
               ((4, True), (8, False))),
    "lg-wide": (dict(ring_sel_scope="period", lifeguard=True),
                ((8, True),)),
    "lg-packed": (dict(ring_sel_scope="period", ring_scalar_wire="packed",
                       lifeguard=True), ((4, False), (8, True))),
    "lg-nobuddy-packed": (dict(ring_sel_scope="period", lifeguard=True,
                               buddy=False, ring_scalar_wire="packed"),
                          ((4, True),)),
    "lg-compact": (dict(ring_sel_scope="period", lifeguard=True,
                        ring_ici_wire="compact"), ((4, True),)),
    "lg-compact-packed-k1": (dict(ring_sel_scope="period", lifeguard=True,
                                  ring_ici_wire="compact", k_indirect=1,
                                  ring_scalar_wire="packed"),
                             ((8, True), (4, False))),
    "wave-lg": (dict(lifeguard=True), ((8, True),)),
    "k8-lg": (dict(ring_sel_scope="period", lifeguard=True, k_indirect=8),
              ((4, True),)),
    "pull": (dict(ring_probe="pull"), ((4, False), (8, False))),
}


@pytest.mark.parametrize("name", sorted(ICI_CONFIGS))
def test_ici_bill_matches_the_reference(name):
    """Under a plain plan or gray_10pct's program (pull takes none)."""
    kw, bills = ICI_CONFIGS[name]
    n = 256
    jcfg, cfg = JaxSwimConfig(n_nodes=n, **kw), SwimConfig(n_nodes=n, **kw)
    jprog = jscenario.compile_program(jscenario.get("gray_10pct"))
    prog = scenario.compile_program(scenario.get("gray_10pct"), "cpu")
    for d, with_prog in bills:
        want = jici.trace_ici_bytes(jcfg, d, plan=jprog if with_prog
                                    else None)
        got = ici.trace_ici_bytes(cfg, d, plan=prog if with_prog else None)
        assert sorted(got) == ["breakdown", "per_chip_bytes_per_period"]
        assert got["per_chip_bytes_per_period"] == \
            want["per_chip_bytes_per_period"]
        assert list(got["breakdown"].items()) == \
            list(want["breakdown"].items()), f"d={d}"
        assert ("roll_link_thr" in got["breakdown"]) == with_prog
        assert sum(got["breakdown"].values()) == \
            got["per_chip_bytes_per_period"]


def test_ici_bill_refuses_the_serving_mirror():
    """The serving hub's mirror, ported since: the bill with
    `ext_capacity` equals the reference's at d = 4 and 8, its
    `ext_mirror_rows` term 16 bytes a slot."""
    for d in (4, 8):
        got = ici.trace_ici_bytes(SwimConfig(n_nodes=64), d, ext_capacity=8)
        want = jici.trace_ici_bytes(JaxSwimConfig(n_nodes=64), d,
                                    ext_capacity=8)
        assert got["per_chip_bytes_per_period"] == \
            want["per_chip_bytes_per_period"]
        assert list(got["breakdown"].items()) == \
            list(want["breakdown"].items()), f"d={d}"
        assert got["breakdown"]["ext_mirror_rows"] == 16 * 8


# ------------------------------------------------------------- verdicts

MINI_RING = dict(
    name="mini_ring", n=64, periods=10, engine="ring", config=RING_CFG,
    domains="blocks:4",
    events=({"kind": "crash", "domain": 2, "start": 3},
            {"kind": "link_loss", "domain": 1, "start": 1, "end": 9,
             "level": 0.3, "period": 4, "on": 2}),
    arms={"main": {},
          "storm": {"gate": False, "events": (
              {"kind": "link_loss", "domain": 1, "start": 1, "end": 9,
               "level": 0.9, "period": 4, "on": 2},)},
          "reseeded": {"gate": False, "seed": 2, "loss": 0.1}},
    expect=({"check": "metric_zero", "arm": "main"},
            {"check": "metric_nonzero", "arm": "main", "metric": "crashed"},
            {"check": "lane_charged", "arm": "main"},
            {"check": "lane_charged", "arm": "reseeded"},
            {"check": "rule_fired", "arm": "storm",
             "rule": "flap_false_dead"},
            {"check": "fewer", "less": "main", "than": "storm"},
            {"check": "metric_max", "arm": "reseeded",
             "metric": "suspect_views_peak", "limit": 40},
            {"check": "require_points"},
            {"check": "no_such_check"}))

MINI_RUMOR = dict(
    name="mini_rumor", n=256, periods=8, engine="rumor",
    partition={"start": 2, "end": 5}, crashes={"fraction": 0.05},
    arms={"loss_000": {"loss": 0.0},
          "loss_020": {"loss": 0.2, "seed": 3}},
    allow_rules=("false_dead_views", "probe_failure_burst",
                 "stalled_dissemination", "overflow_growth",
                 "saturation_spike"),
    expect=({"check": "metric_nonzero", "arm": "loss_020",
             "metric": "suspect_views_peak"},
            {"check": "metric_nonzero", "arm": "loss_000",
             "metric": "false_dead_views_peak"}))

MINI_DENSE = dict(
    name="mini_dense", n=32, periods=6, engine="auto",
    config={"lifeguard": True}, domains="stripe:3",
    events=({"kind": "gray", "domain": 1, "start": 1, "end": 5,
             "level": 0.5},
            {"kind": "crash", "nodes": [4], "start": 2}))

MINI_STUDY = dict(
    name="mini_study", n=512, periods=12, engine="ring", study="detection",
    study_kw={"n": 512, "crash_fraction": 0.02, "periods": 12,
              "engine": "ring", "telemetry": True,
              "flight_record": "mini_study.jsonl",
              "ring_sel_scope": "period", "suspicion_mult": 2.0,
              "retransmit_mult": 2.0, "k_indirect": 1,
              "ring_window_periods": 3, "ring_view_c": 2},
    allow_rules=("overflow_growth",),
    expect=({"check": "detection_law", "z": 3.0, "ks": 1.358,
             "strict": False},
            {"check": "require_points", "min": 1}),
    artifact="mini_study.json")

VERDICT_SPECS = {"gray_10pct": None, "ring": MINI_RING, "rumor": MINI_RUMOR,
                 "dense": MINI_DENSE, "study": MINI_STUDY}


def verdict_text(path, out_dir) -> str:
    with open(path) as fh:
        return fh.read().replace(str(out_dir), "OUT")


@pytest.mark.parametrize("case", sorted(VERDICT_SPECS))
def test_verdict_bytes_match_the_reference(case, tmp_path):
    """The port's verdict file, serial and batched, has the reference's
    bytes; the gated arms' checks hold where the reference's do."""
    kw = VERDICT_SPECS[case]
    if kw is None:
        sc, jsc = scenario.get(case), jscenario.get(case)
    else:
        sc, jsc = scenario.Scenario(**kw), jscenario.Scenario(**kw)
    want_v, want_p = jscenario.run(jsc, out_dir=str(tmp_path / "jax"))
    got_v, got_p = scenario.run(sc, out_dir=str(tmp_path / "ser"),
                                device="cpu")
    want = verdict_text(want_p, tmp_path / "jax")
    assert verdict_text(got_p, tmp_path / "ser") == want
    _, bat_p = scenario.run(sc, out_dir=str(tmp_path / "bat"), batch=True,
                            device="cpu")
    assert verdict_text(bat_p, tmp_path / "bat") == want
    assert got_v["verdict"] == want_v["verdict"]
    if case == "gray_10pct":
        assert got_v["verdict"] == "pass"
        assert got_v["arms"]["lha"]["ici"]["roll_link_thr_bytes"] > 0
    if case == "ring":
        # the arms really diverged, and the checks have both outcomes
        arms = got_v["arms"]
        assert arms["main"] != arms["storm"] != arms["reseeded"]
        assert {c["ok"] for c in got_v["checks"]} == {True, False}


def test_replay_storm_and_ringshard_raise(tmp_path):
    """Of the two engines that raised, `ringshard` still does (the
    sharding item); `replay_storm` runs since the host protocol layer is
    ported (its bytes: test_replay_storm_verdict_matches_the_reference)."""
    verdict, _ = scenario.run(scenario.get("replay-storm"),
                              out_dir=str(tmp_path), device="cpu")
    assert verdict["arms"]["real"]["engine"] == "real"
    shard = scenario.Scenario(name="shard", n=32, periods=2,
                              engine="ringshard", config=RING_CFG)
    for batch in (False, True):
        with pytest.raises(NotImplementedError, match="sharding"):
            scenario.run(shard, out_dir=str(tmp_path), batch=batch,
                         device="cpu")


def test_replay_storm_verdict_matches_the_reference(tmp_path):
    """The real-node arm (a 16-node core/cluster.py SimCluster under 30%
    duplication and 30% stale replay): the reference's verdict bytes
    (golden.GOLDEN_DIGEST_REPLAY_STORM) and its assertions."""
    import hashlib

    from swim_tpu_torch import golden

    want_v, want_p = jscenario.run(jscenario.get("replay-storm"),
                                   out_dir=str(tmp_path / "jax"))
    verdict, path = scenario.run(scenario.get("replay-storm"),
                                 out_dir=str(tmp_path / "port"),
                                 device="cpu")
    text = verdict_text(path, tmp_path / "port")
    assert text == verdict_text(want_p, tmp_path / "jax")
    assert hashlib.sha256(text.encode()).hexdigest() == \
        golden.GOLDEN_DIGEST_REPLAY_STORM
    assert verdict["verdict"] == "pass", verdict["checks"]
    real = verdict["arms"]["real"]
    # the adversarial deliveries happened, and the protocol shrugged
    assert real["network"]["duplicated"] > 0
    assert real["network"]["replayed"] > 0
    assert real["counters"]["decode_errors"] == 0
    assert real["false_dead_views_final"] == 0


def test_entry_points_run_on_the_card_by_default(tmp_path):
    """Without a card, no device means an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    sc = dataclasses.replace(scenario.get("gray_10pct"), periods=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenario.run(sc, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scenario.compile_program(sc)

"""The port's command line (swim_tpu_torch/cli.py) against the
reference's `swim-tpu`.

`cli.main([..., "--device", "cpu"])` prints the reference's output for
the same arguments: `info` (JSON), `demo` (every byte), `simulate`
(dense at 64 nodes; JSON but its timing fields and the device count),
`study detection` (tiny), `scenario list` and `show`, `trend` over a
tmp_path repo, and `observe` on a dump written by the port's flight
recorder.  `profile` prints a well-formed report and writes its
artifact; `audit` exits 2 with its reason, `--engine ringshard`
prints the ring engine's output and `--engine shard` the rumor
engine's;
without a card a tensor command exits 2 naming the missing card.
Tolerance: exact.
"""
from __future__ import annotations

import json

import pytest
import torch
from test_torch_instruments import write_bench_repo
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu import cli as jcli
from swim_tpu_torch import cli
from swim_tpu_torch.sim import experiments

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TIMING = ("seconds", "periods_per_sec", "devices")


def run_both(capsys, argv):
    """(port rc, port stdout), (reference rc, reference stdout)."""
    rc = cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    jrc = jcli.main(argv)
    return (rc, out), (jrc, capsys.readouterr().out)


def test_info_equals_reference(capsys):
    got, want = run_both(capsys, ["info", "--nodes", "1000"])
    assert got[0] == want[0] == 0
    assert json.loads(got[1]) == json.loads(want[1])
    assert got[1] == want[1]


def test_demo_equals_reference_byte_for_byte(capsys):
    argv = ["demo", "--nodes", "8", "--settle", "4", "--duration", "12",
            "--kill", "2", "--loss", "0.05", "--tail", "6"]
    got, want = run_both(capsys, argv)
    assert got == want
    assert got[0] == 0 and '"all_kills_detected_everywhere": true' in got[1]


def test_simulate_dense_equals_reference(capsys):
    argv = ["simulate", "--nodes", "64", "--periods", "12", "--engine",
            "dense", "--crash-fraction", "0.1", "--loss", "0.05"]
    got, want = run_both(capsys, argv)
    assert got[0] == want[0] == 0
    g, w = json.loads(got[1]), json.loads(want[1])
    assert {k: v for k, v in g.items() if k not in TIMING} \
        == {k: v for k, v in w.items() if k not in TIMING}
    assert g["crashed"] > 0 and g["devices"] == 1


def test_study_detection_equals_reference(capsys):
    argv = ["study", "detection", "--nodes", "64", "--periods", "10",
            "--crash-fraction", "0.1"]
    got, want = run_both(capsys, argv)
    assert got[0] == want[0] == 0
    assert json.loads(got[1]) == json.loads(want[1])


@pytest.mark.parametrize("argv", [
    ["scenario", "list"], ["scenario", "list", "--json"],
    ["scenario", "show", "flap"], ["scenario", "show", "gray-10pct"]],
    ids=["list", "list-json", "show-flap", "show-gray"])
def test_scenario_list_and_show_equal_reference(capsys, argv):
    got, want = run_both(capsys, argv)
    assert got == want and got[0] == 0


def test_trend_equals_reference(capsys, tmp_path):
    write_bench_repo(tmp_path)
    for extra in (["--json"], ["--json", "--check"], []):
        got, want = run_both(capsys, ["trend", "--repo", str(tmp_path),
                                      *extra])
        assert got == want
    assert got[0] == 0 and "gate: FAIL" in got[1]
    assert run_both(capsys, ["trend", "--repo", str(tmp_path),
                             "--check"])[0][0] == 1


def test_observe_port_dump_equals_reference(capsys, tmp_path):
    path = str(tmp_path / "dump.jsonl")
    experiments.detection_study(n=64, periods=8, crash_fraction=0.1,
                                flight_record=path, telemetry=True,
                                device="cpu")
    got, want = run_both(capsys, ["observe", path, "--json"])
    assert got[0] == want[0] == 0
    assert json.loads(got[1]) == json.loads(want[1])
    got, want = run_both(capsys, ["observe", path])
    assert got == want


def test_profile_prints_a_well_formed_report(capsys, tmp_path):
    out = str(tmp_path / "prof.json")
    rc = cli.main(["--device", "cpu", "profile", "--nodes", "256",
                   "--settle", "1", "--reps", "1", "--json", "--check",
                   "--out", out])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert rep["nodes"] == 256 and rep["platform_actual"] == "cpu"
    assert rep["phases_active"][0] == "select"
    assert rep["coverage_pct"] >= 95.0
    assert json.load(open(out)) == rep
    rc = cli.main(["--device", "cpu", "profile", "--nodes", "256",
                   "--settle", "0", "--reps", "1", "--sel-scope", "wave"])
    text = capsys.readouterr().out
    assert rc == 0 and text.startswith("phase attribution @ 256 nodes (cpu)")


@pytest.mark.parametrize("argv", [
    ["simulate", "--engine", "ringshard"], ["simulate", "--engine", "shard"],
    ["study", "detection", "--engine", "ringshard"], ["audit"]],
    ids=["sim-ringshard", "sim-shard", "study-ringshard", "audit"])
def test_unported_commands_exit_2(capsys, argv, tmp_path, monkeypatch):
    """The commands once refused run now.  `audit --check --json` on the
    CPU exits 0 with a report whose checked rows all pass, and writes
    nothing without `--out`; `ringshard` and `shard` run: their simulate
    and study print the ring (rumor) engine's JSON but for the engine's
    name (and simulate's timing fields)."""
    if argv == ["audit"]:
        monkeypatch.chdir(tmp_path)
        assert cli.main(["--device", "cpu", *argv, "--check", "--json",
                         "--wire-n", "128", "--retrace-n", "64"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["platform"] == "cpu" and report["wire_n"] == 128
        rows = [r for c in report["contracts"].values()
                for r in c["checks"]]
        assert all(r["status"] in ("pass", "not_applicable") for r in rows)
        assert sum(r["status"] == "pass" for r in rows) \
            == report["totals"]["checks_total"] > 0
        assert report["totals"]["failures"] == 0
        assert list(tmp_path.iterdir()) == []
        return
    sharded = argv[-1]
    small = ["--nodes", "64", "--periods", "6"]
    if sharded == "shard":
        # crashes under loss, long enough for one to be seen by all
        small = ["--nodes", "64", "--periods", "16", "--crash-fraction",
                 "0.05", "--loss", "0.1"]
    outs = []
    for engine in (sharded, {"ringshard": "ring", "shard": "rumor"}[sharded]):
        args = [a if a != sharded else engine for a in argv] + small
        assert cli.main(["--device", "cpu", *args]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out.pop("engine") == engine
        outs.append({k: v for k, v in out.items() if k not in TIMING})
    assert outs[0] == outs[1]
    if sharded == "shard":
        assert outs[0]["crashed_detected_by_all_live"] > 0


def test_without_a_card_the_tensor_commands_exit_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["simulate", "--nodes", "64"],
                 ["profile", "--nodes", "256"],
                 ["study", "detection", "--nodes", "64"],
                 ["study", "detection", "--nodes", "64", "--engine", "ring",
                  "--mem-report"],
                 ["audit", "--wire-n", "128", "--retrace-n", "64"]):
        assert cli.main(argv) == 2
        assert "no CUDA card" in capsys.readouterr().err


def test_mem_report_runs_on_the_named_device(capsys):
    """`study --mem-report` takes its device from --device: on the CPU
    the trees' bytes, nothing measured."""
    from swim_tpu_torch.obs import memwall

    assert cli.main(["--device", "cpu", "study", "detection", "--nodes",
                     "256", "--periods", "12", "--crash-fraction", "0.02",
                     "--engine", "ring", "--mem-report"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == memwall.study_memory_analysis(
        256, periods=12, crash_fraction=0.02, device="cpu")
    assert got["measured"] is False and got["platform"] == "cpu"
    assert cli.main(["--device", "cpu", "study", "fp_sweep",
                     "--mem-report"]) == 2

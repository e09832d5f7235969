"""The port's contract audit (swim_tpu_torch/analysis/audit.py), on the
CPU: the cases of tests/test_audit.py in their eager forms.

* The detectors on synthetic inputs, each with a SEEDED VIOLATION that
  must surface through `check_report` under the owning contract's name:
  the exchange-record helpers and the wire predicates, the tally
  attribution (verbatim), the build budget, the census's chunked working
  set, the pull step's serialized row gathers, float64 values and host
  reads under the dispatch mode (the counterparts of the reference's two
  hygiene cases), and the mode seeing the shards' threads.
* The report plumbing: the synthetic waiver, `not_applicable`, byte-stable
  writing, gauges, and `render_audit` byte-equal to the JAX package's on
  a reference-shaped report.
* One `run_audit(wire_n=128, retrace_n=64, periods=2, device="cpu")` end
  to end, shared at module scope: every checked row passes, only the
  named rows are not_applicable, and a second run writes identical bytes.
"""
from __future__ import annotations

import json

import pytest
import torch

from swim_tpu.obs.expo import render_audit as jax_render_audit
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.analysis import audit
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs import ici
from swim_tpu_torch.obs.expo import render_audit
from swim_tpu_torch.parallel import mesh as pmesh, ring_shard
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import threefry

CPU = "cpu"
N = 64
D = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mini_report(contract: str, arm: str, ok, detail: str) -> dict:
    """One-check report assembled the way run_audit assembles rows,
    waivers included, so name-firing tests go through the same status
    machinery the real report does."""
    return audit.assemble_report(
        {contract: [{"arm": arm, "ok": ok, "detail": detail}]},
        {"retraces_extra": 0, "unattributed_collective_bytes": 0,
         "undonated_bytes": None, "barrier_chains_missing": 0})


def _assert_fires(contract: str, arm: str, detail: str) -> None:
    ok, failures = audit.check_report(
        _mini_report(contract, arm, False, detail))
    assert not ok
    assert failures == [f"{contract}/{arm}: {detail}"]


def _rec(op, payloads, blocks=1, terms=None):
    """A ShardedStep.record entry: payloads as (dtype, shape[, wire])."""
    desc = [{"dtype": p[0], "shape": p[1],
             "wire_dtype": p[2] if len(p) > 2 else p[0]} for p in payloads]
    return {"op": op, "dtype": desc[0]["dtype"], "shape": desc[0]["shape"],
            "payloads": desc, "blocks": blocks, "bytes": 0,
            "terms": terms or {}}


# ---------------------------------------------------------------------------
# exchange records and the wire predicates
# ---------------------------------------------------------------------------

SYN_RECORD = [
    _rec("ppermute", [("uint8", (20,))], blocks=2),
    _rec("ppermute", [("int32", (8, 4), "uint32")], blocks=2),
    _rec("psum", [("int32", (16,))]),
    _rec("all_gather", [("int32", (16,))], blocks=D),
    _rec("ppermute", [("int64", (8,)), ("bool", (8,))]),
]


def test_exchange_records_take_the_reference_form():
    records = audit.exchange_records(SYN_RECORD)
    assert [r["op"] for r in records] == [
        "collective-permute", "collective-permute", "all-reduce",
        "all-gather", "collective-permute"]
    assert records[0]["payloads"] == [{"dtype": "u8", "elems": 20,
                                       "bytes": 20}]
    assert records[1]["payloads"][0]["dtype"] == "u32"   # the carrier
    assert records[3]["payloads"] == [
        {"dtype": "s32", "elems": 16, "bytes": 64},
        {"dtype": "s32", "elems": 16 * D, "bytes": 64 * D}]
    assert records[4]["payload_bytes"] == 64
    assert audit.max_payload_elems(records, "all-gather") == 16 * D
    assert {p["dtype"] for p in audit.cperm_payloads(records)} == {
        "u8", "u32", "s64", "pred"}


def test_family_bytes_count_blocks_and_gathered_output():
    fam = audit.family_bytes(SYN_RECORD)
    assert fam == {"ppermute": 2 * 20 + 2 * 128 + (64 + 8),
                   "psum": 64, "all_gather": 64 * D}


@pytest.mark.parametrize("case", ["s32_lane", "allgather_ceiling"])
def test_wire_negative_fires_by_name(case):
    s = 16
    if case == "s32_lane":
        # a packed-wire period shipping an [S]-shaped s32 lane and no u8
        records = audit.exchange_records(
            [_rec("ppermute", [("int32", (s,))], blocks=2)])
        problems = audit.wire_problems(records, packed=True, shard_rows=s)
        assert problems == ["no u8 cperm payload on the packed wire",
                            "[S]-shaped scalar lanes on the packed wire: "
                            "['s32[16]']"]
        arm = "window+packed"
    else:
        per = audit.ALLGATHER_MAX_ELEMS // D + 8
        records = audit.exchange_records(
            [_rec("ppermute", [("uint8", (4,))], blocks=2),
             _rec("all_gather", [("int32", (per,))], blocks=D)])
        problems = audit.wire_problems(records, packed=True, shard_rows=s)
        assert problems == [
            f"all-gather payload {per * D} elems > bookkeeping ceiling "
            f"{audit.ALLGATHER_MAX_ELEMS}"]
        arm = "compact+packed"
    _assert_fires("wire_contracts", arm, "; ".join(problems))


# ---------------------------------------------------------------------------
# ICI tally attribution (verbatim)
# ---------------------------------------------------------------------------

def test_tally_fully_attributed_is_quiet():
    loose = audit.tally_unattributed(
        {"ppermute": 1000}, {"roll_ok_waves": 600, "roll_pid_waves": 400})
    assert not any(loose.values())


def test_tally_dropped_term_fires_by_name():
    loose = audit.tally_unattributed(
        {"ppermute": 1000}, {"roll_pid_waves": 400})
    assert loose["ppermute"] == 600
    _assert_fires("ici_tally_completeness", "window+wide",
                  "unattributed={'ppermute': 600}")


def test_tally_unknown_term_is_vocabulary_drift():
    assert audit.tally_unattributed({}, {"mystery_term": 5}) == {
        "unknown_term:mystery_term": 5}
    assert audit.tally_unattributed({"while_unbounded": 64}, {}) == {
        "while_unbounded": 64}


def test_tally_term_vocabulary_is_sorted_union():
    assert list(audit.ICI_TERMS) == sorted(set(audit.ICI_TERMS))
    assert "candidates_all_gather" in audit.ICI_TERMS


@pytest.mark.parametrize("arm", [a for a, _ in audit.WIRE_ARMS])
def test_port_bill_keys_lie_in_the_vocabulary(arm):
    overrides = dict(audit.WIRE_ARMS)[arm]
    cfg = SwimConfig(n_nodes=N, **audit.SMALL_GEOM, **overrides)
    keys = set(ici.trace_ici_bytes(cfg, D, ext_capacity=4)["breakdown"])
    assert keys and keys <= set(audit.ICI_TERMS), keys - set(audit.ICI_TERMS)


# ---------------------------------------------------------------------------
# build budget
# ---------------------------------------------------------------------------

def _sharded_period(step, cfg, mesh, prog):
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, CPU), prog)
    step(st, pl, ring.draw_period_ring(threefry.key(0), 0, cfg, CPU),
         ring.rotor_offsets(cfg, 0))


@pytest.mark.parametrize("rebuild", [False, True],
                         ids=["held_step_builds_once", "rebuild_fires"])
def test_build_budget(rebuild):
    """A sweep through one held ShardedStep builds it once; a synthetic
    arm that builds a step per program value fires by name."""
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period",
                     ring_ici_wire="compact", ring_scalar_wire="packed",
                     **audit.SMALL_GEOM)
    mesh = pmesh.make_mesh(devices=[CPU] * D)
    progs = audit._program_sweep(N, CPU)[:2]
    held: dict = {}

    def value(prog):
        if rebuild or "step" not in held:
            held["step"] = ring_shard.mapped_step(cfg, mesh)
        _sharded_period(held["step"], cfg, mesh, prog)

    builds = audit.count_builds(value, progs)
    ok, extra, detail = audit.build_row(builds, len(progs))
    assert builds == {"ShardedStep": 2 if rebuild else 1}
    assert ok is (not rebuild) and extra == int(rebuild)
    if rebuild:
        _assert_fires("retrace_budget", "ringshard", detail)


def test_lru_seams_are_counted():
    cfg = SwimConfig(n_nodes=N, lifeguard=True, dynamic_suspicion=True)
    from swim_tpu_torch.models import rumor
    builds = audit.count_builds(
        lambda v: rumor.dynamic_timeout_table(cfg, v), ["cpu", "meta"])
    assert builds == {"lru:rumor.dynamic_timeout_table": 2}
    assert not audit.build_row(builds, 2)[0]


# ---------------------------------------------------------------------------
# bounded working sets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", ["forced", "default"],
                         ids=["census_chunked", "chunkless_fires"])
def test_census_working_set(budget):
    cfg = SwimConfig(n_nodes=N, **audit.SMALL_GEOM)
    up = torch.ones((N,), dtype=torch.bool)
    state = ring.init_state(cfg, CPU)
    forced = 4 * N
    chunks = audit.census_chunks(cfg, state, up,
                                 forced if budget == "forced" else 1 << 23)
    ok, detail = audit.census_row(chunks, forced)
    if budget == "forced":
        assert ok and len(chunks) >= audit.CENSUS_FLOOR_CHUNKS
        assert max(chunks) <= forced
    else:
        # one chunk per matrix, each far above the forced budget
        assert len(chunks) == 2 and max(chunks) > forced and not ok
        _assert_fires("barrier_survival", "census_chunked", detail)
    # a measured peak above the limit fails too
    limit = audit.CENSUS_BYTES_PER_PAIR * forced + audit.CENSUS_SLACK_BYTES
    assert not audit.census_row(chunks, forced, peak=limit + 1)[0]


@pytest.mark.parametrize("held", [False, True],
                         ids=["pull_step_serialized", "held_gathers_fire"])
def test_pull_row_gathers(held):
    cfg = SwimConfig(n_nodes=N, ring_probe="pull", **audit.SMALL_GEOM)
    ops = ring.GlobalOps(cfg, CPU)
    watch = audit.RowGatherWatch(ops)
    if not held:
        ring.step(cfg, ring.init_state(cfg, CPU), faults.none(N, CPU),
                  ring.draw_period_ring(threefry.key(0), 0, cfg, CPU),
                  ops=ops)
        assert watch.issued == 3 and watch.max_live == 1
        assert audit.gather_row(watch)[0]
        return
    mat = torch.zeros((N, 2), dtype=torch.int32)
    idx = torch.arange(N)
    a = ops.gather_rows(mat, idx)
    b = ops.gather_rows(mat, idx)      # issued while `a` is alive
    del a, b
    ok, detail = audit.gather_row(watch)
    assert not ok and watch.max_live == 2
    _assert_fires("barrier_survival", "pull_gather_step", detail)


# ---------------------------------------------------------------------------
# hygiene: the dispatch mode
# ---------------------------------------------------------------------------

def test_f64_hygiene_fires_by_name():
    violations = audit.hygiene_violations(
        lambda: torch.ones(4, dtype=torch.float64) * 2.0)
    assert violations and all(v.startswith("f64:") for v in violations)
    assert "f64:mul" in violations
    _assert_fires("hot_path_hygiene", "study/dense", "; ".join(violations))


class _ItemOps(ring.GlobalOps):
    """A GlobalOps that reads every global sum to the host."""

    def gsum(self, partial):
        return torch.tensor(partial.sum().item(), dtype=partial.dtype)


def test_item_in_a_step_fires_sync():
    cfg = SwimConfig(n_nodes=N, **audit.SMALL_GEOM)
    violations = audit.hygiene_violations(lambda: ring.step(
        cfg, ring.init_state(cfg, CPU), faults.none(N, CPU),
        ring.draw_period_ring(threefry.key(0), 0, cfg, CPU),
        ops=_ItemOps(cfg, CPU)))
    assert "sync:_local_scalar_dense" in violations
    _assert_fires("hot_path_hygiene", "study/ring", "; ".join(violations))


def test_clean_step_is_clean():
    cfg = SwimConfig(n_nodes=N, **audit.SMALL_GEOM)
    assert audit.hygiene_violations(lambda: ring.step(
        cfg, ring.init_state(cfg, CPU), faults.none(N, CPU),
        ring.draw_period_ring(threefry.key(0), 0, cfg, CPU))) == []


def test_shard_threads_are_seen_only_from_inside():
    """A mode entered by the caller sees none of a shard thread's ops;
    the ShardWatch entered in every shard's body sees each shard's."""
    mesh = pmesh.make_mesh(devices=[CPU] * D)

    def body(rank, coll):
        return torch.ones(2, dtype=torch.float64).sum()

    with audit.HygieneWatch() as outside:
        pmesh.run_spmd(mesh, body)
    assert outside.found == set()
    inside = audit.ShardWatch()
    pmesh.run_spmd(mesh, body, around=inside)
    assert "f64:sum" in inside.found
    assert sorted(inside.ops) == list(range(D))

    # and a real sharded period: every shard's ops are watched, clean
    cfg = SwimConfig(n_nodes=N, **audit.SMALL_GEOM)
    step = ring_shard.mapped_step(cfg, mesh)
    step.around = audit.ShardWatch()
    _sharded_period(step, cfg, mesh, faults.none(N, CPU))
    assert step.around.found == set()
    assert sorted(step.around.ops) == list(range(D))
    assert min(step.around.ops.values()) > 100


# ---------------------------------------------------------------------------
# report plumbing
# ---------------------------------------------------------------------------

def test_synthetic_waiver_suppresses_a_failure(monkeypatch):
    assert audit.WAIVERS == ()
    monkeypatch.setattr(audit, "WAIVERS", ({
        "contract": "barrier_survival", "arm": "census_chunked",
        "reason": "synthetic", "pointer": "tests/test_torch_audit.py"},))
    report = _mini_report("barrier_survival", "census_chunked", False,
                          "1 census chunk(s)")
    row = report["contracts"]["barrier_survival"]["checks"][0]
    assert row["status"] == "waived"
    assert row["waived_by"] == "tests/test_torch_audit.py"
    assert report["totals"]["waived"] == 1
    assert audit.check_report(report) == (True, [])


def test_not_applicable_is_counted_apart():
    report = _mini_report("donation_coverage", "dense", None, "n/a")
    block = report["contracts"]["donation_coverage"]
    assert block["status"] == "not_applicable"
    assert block["checks"][0]["status"] == "not_applicable"
    t = report["totals"]
    assert (t["checks_total"], t["failures"], t["not_applicable"]) == (0, 0,
                                                                       1)
    assert t["undonated_bytes"] is None
    assert audit.check_report(report) == (True, [])
    with pytest.raises(ValueError, match="NOT_APPLICABLE"):
        _mini_report("wire_contracts", "window+wide", None, "unmeasured")


def test_write_report_is_byte_stable(tmp_path):
    report = _mini_report("wire_contracts", "window+wide", True, "ok")
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    audit.write_report(report, str(a))
    audit.write_report(report, str(b))
    assert a.read_bytes() == b.read_bytes()
    text = a.read_text()
    assert text.endswith("\n") and json.loads(text) == report


REF_REPORT = {"wire_n": 512, "retrace_n": 256, "platform": "cpu",
              "totals": {
                  "checks_total": 29, "failures": 0, "waived": 1,
                  "retraces_extra": 0, "unattributed_collective_bytes": 0,
                  "undonated_bytes": 0, "barrier_chains_missing": 0}}


def test_gauges_cover_the_table():
    values = audit.gauge_values(REF_REPORT)
    assert set(values) == set(audit.AUDIT_GAUGES)
    assert values["swim_audit_checks_total"] == 29
    assert values["swim_audit_waived_total"] == 1


def test_render_audit_equals_the_reference():
    assert render_audit(REF_REPORT) == jax_render_audit(REF_REPORT)
    assert render_audit(REF_REPORT, {"job": "x"}) == jax_render_audit(
        REF_REPORT, {"job": "x"})


def test_render_audit_null_total_is_nan():
    report = json.loads(json.dumps(REF_REPORT))
    report["totals"]["undonated_bytes"] = None
    text = render_audit(report)
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert len(samples) == len(audit.AUDIT_GAUGES)
    undonated = [ln for ln in samples
                 if ln.startswith("swim_audit_undonated_bytes{")]
    assert len(undonated) == 1 and undonated[0].endswith(" NaN")


def test_every_contract_has_a_description():
    assert set(audit.CONTRACTS) == set(audit.EAGER_FORMS) == {
        "retrace_budget", "donation_coverage", "wire_contracts",
        "ici_tally_completeness", "barrier_survival", "hot_path_hygiene"}
    assert {c for c, _ in audit.NOT_APPLICABLE} <= set(audit.CONTRACTS)


# ---------------------------------------------------------------------------
# end to end, shared at module scope
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_runs(_one_thread):
    kw = dict(wire_n=128, retrace_n=64, periods=2, device=CPU)
    return audit.run_audit(**kw), audit.run_audit(**kw)


def test_run_audit_green_end_to_end(two_runs):
    report = two_runs[0]
    ok, failures = audit.check_report(report)
    assert ok, failures
    assert report["platform"] == "cpu" and report["devices"] == D
    assert set(report["contracts"]) == set(audit.CONTRACTS)
    na = set()
    for contract, block in report["contracts"].items():
        assert block["checks"], f"{contract} has no arms"
        for row in block["checks"]:
            assert row["status"] in ("pass", "not_applicable"), row
            if row["status"] == "not_applicable":
                na.add((contract, row["arm"]))
    assert na == set(audit.NOT_APPLICABLE)
    t = report["totals"]
    assert t["failures"] == 0 and t["retraces_extra"] == 0
    assert t["unattributed_collective_bytes"] == 0
    assert t["barrier_chains_missing"] == 0
    assert t["undonated_bytes"] is None
    assert t["not_applicable"] == len(audit.NOT_APPLICABLE)
    assert t["checks_total"] == 24
    arms = {c: [r["arm"] for r in b["checks"]]
            for c, b in report["contracts"].items()}
    assert arms["hot_path_hygiene"] == [
        f"ringshard/{a}" for a, _ in audit.WIRE_ARMS] + [
        "study/dense", "study/rumor", "study/ring"]
    assert arms["retrace_budget"] == ["dense", "rumor", "ring",
                                      "ring_stream_chunk", "ringshard"]


def test_run_audit_writes_identical_bytes(two_runs, tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    audit.write_report(two_runs[0], str(a))
    audit.write_report(two_runs[1], str(b))
    assert a.read_bytes() == b.read_bytes()


def test_each_kernel_is_a_seam_of_its_own(monkeypatch):
    """A load of each of the three kernels in one arm is one build per
    seam; a second load of one kernel fires."""
    from swim_tpu_torch import _kernels

    def fake_lib(name):
        if name not in _kernels._loaded:
            _kernels._loaded[name] = object()
            _kernels.loads[name] = _kernels.loads.get(name, 0) + 1
        return _kernels._loaded[name]

    monkeypatch.setattr(_kernels, "_loaded", {})
    monkeypatch.setattr(_kernels, "loads", {})
    builds = audit.count_builds(lambda v: [fake_lib(k) for k in v],
                                [("selb", "coldsel", "wavemerge"),
                                 ("selb", "coldsel", "wavemerge")])
    assert builds == {"kernel:coldsel": 1, "kernel:selb": 1,
                      "kernel:wavemerge": 1}
    assert audit.build_row(builds, 2)[0]

    def reload_selb(v):
        fake_lib("selb")
        _kernels._loaded.pop("selb")

    builds = audit.count_builds(reload_selb, [0, 1])
    assert builds == {"kernel:selb": 2}
    ok, extra, detail = audit.build_row(builds, 2)
    assert not ok and extra == 1
    _assert_fires("retrace_budget", "ring", detail)

"""The port's coverage-guided search against `swim_tpu.sim.search`.

  * `Candidate.events` / `to_scenario`, the search constants and
    `violations_of` equal the reference's; `_mutate` draws the same
    candidates from the same numpy generator, 300 steps from each of
    three seeds;
  * `explore` (3 lanes x 2 generations) and `refine_boundary` (3 lanes x
    2 generations, the library's flap template) give the reference's
    reports, dict for dict: the batches run the packed Lifeguard ring at
    the library's size (256 nodes, 48 periods), lane by lane;
  * `search` assembles and writes the reference's report bytes from the
    same phase results (both packages' phases stubbed alike), and is
    deterministic;
  * without a card, the entry points given no device raise.

Torch runs on one thread.  Tolerance: exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread  # noqa: F401 (fixture)

from swim_tpu.sim import search as jsearch
from swim_tpu_torch.sim import search

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAP = dict(kind="link_loss", start=8, end=40, period=6, on=3, domain=3)


def test_candidates_and_constants_match_the_reference():
    for name in ("NEVER", "SEARCH_N", "SEARCH_PERIODS", "SEARCH_DOMAINS",
                 "SEARCH_CAPACITY"):
        assert getattr(search, name) == getattr(jsearch, name), name
    assert dict(search.SEARCH_CONFIG) == dict(jsearch.SEARCH_CONFIG)
    for kw in ({}, dict(kind="gray", level=0.3141592653, start=4, end=20,
                        period=6, on=3, domain=5, crash_domain=2,
                        crash_start=10)):
        c, jc = search.Candidate(**kw), jsearch.Candidate(**kw)
        assert c.events() == jc.events()
        assert c.spec_dict() == jc.spec_dict()
        assert c.to_scenario("x", seed=3).spec_dict() == \
            jc.to_scenario("x", seed=3).spec_dict()


def test_mutation_draws_the_reference_candidates():
    for seed in (0, 1, 7):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        c, jc = search.Candidate(), jsearch.Candidate()
        for _ in range(300):
            c, jc = search._mutate(c, rng), jsearch._mutate(jc, jrng)
            assert c.spec_dict() == jc.spec_dict()
            assert 0.02 <= c.level <= 0.98 and c.end <= search.SEARCH_PERIODS


def test_violations_match_the_reference():
    base = dict(false_dead_final=0, false_dead_peak=0, undetected_crashes=0)
    for over in ({}, dict(false_dead_final=2), dict(false_dead_peak=100),
                 dict(undetected_crashes=1),
                 dict(false_dead_final=5, false_dead_peak=300,
                      undetected_crashes=4)):
        sig = {**base, **over}
        assert search.violations_of(sig, search.Candidate()) == \
            jsearch.violations_of(sig, jsearch.Candidate())


def test_explore_matches_the_reference():
    want = jsearch.explore(generations=2, pop=3, seed=1)
    got = search.explore(generations=2, pop=3, seed=1, device="cpu")
    assert got == want
    assert got["evaluated"] == 6 and got["archive"]


def test_refine_boundary_matches_the_reference():
    want = jsearch.refine_boundary(jsearch.Candidate(**FLAP), pop=3,
                                   max_generations=2, seed=0)
    got = search.refine_boundary(search.Candidate(**FLAP), pop=3,
                                 max_generations=2, seed=0, device="cpu")
    assert got == want
    assert got["found"] and len(got["history"]) == 2


def test_search_report_matches_the_reference(tmp_path, monkeypatch):
    """The search report from stubbed phases: the same bytes on disk
    and the same dict, in both packages, on every rerun."""
    calls = []

    def fake_explore(generations, pop, seed, **kw):
        calls.append(("explore", generations, pop, seed))
        return {"generations": generations, "pop": pop, "seed": seed,
                "evaluated": generations * pop, "archive": [],
                "violations": [{"level": np.float64(0.25)}]}

    def fake_refine(template, pop, seed, **kw):
        calls.append(("refine", template.spec_dict(), pop, seed))
        return {"found": True, "clean_level": 0.26, "violation_level": 0.27,
                "width": 0.01, "template": template.spec_dict(),
                "history": [{"grid": [np.float32(0.5)]}]}

    for mod in (search, jsearch):
        monkeypatch.setattr(mod, "explore", fake_explore)
        monkeypatch.setattr(mod, "refine_boundary", fake_refine)
    want = jsearch.search(generations=2, pop=5, seed=4,
                          out=str(tmp_path / "jax.json"))
    got = search.search(generations=2, pop=5, seed=4,
                         out=str(tmp_path / "port.json"), device="cpu")
    again = search.search(generations=2, pop=5, seed=4,
                          out=str(tmp_path / "again.json"), device="cpu")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "again.json").read_bytes()
    for rep in (got, again):
        rep.pop("artifact")
    want.pop("artifact")
    assert got == want == again
    assert calls[0] == ("explore", 2, 5, 4) and calls[1][0] == "refine"
    assert calls[1][1] == jsearch.Candidate(**FLAP).spec_dict()


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for call in (lambda: search.run_generation([search.Candidate()]),
                 lambda: search.search(generations=1, pop=1),
                 lambda: search.explore(generations=1, pop=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

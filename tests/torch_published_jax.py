"""The JAX package's side of tests/test_torch_published.py; it holds no
tests itself.

A JAX ring study spends about half of its compile tracing in Python
(9 s of 18 at ring_orig_words 2, 13 s of 33 at 4 on a CPU), which
threads would take turns at, so the test module runs each of these
functions in a worker process of its own (started with `spawn`, `init`
first) beside the port.  Nothing here imports the port: its constants
come in as arguments, and a state goes back as numpy arrays.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os

import numpy as np


def init() -> None:
    """The test session's JAX settings (tests/conftest.py) in a worker."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)


def cli(argv: list) -> tuple[dict, list]:
    """`swim-tpu <argv>` through the JAX package's cli.main: (its printed
    result, the final `overflow` of each study it ran, in order)."""
    from swim_tpu import cli as jcli
    from swim_tpu.sim import experiments as jexperiments

    real, overflow = jexperiments._run_study, []

    def keep(*a, **k):
        res = real(*a, **k)
        overflow.append(int(res.state.overflow))
        return res
    jexperiments._run_study = keep
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = jcli.main(list(argv))
    finally:
        jexperiments._run_study = real
    if rc != 0:
        raise RuntimeError(f"swim-tpu {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), overflow


def suspicion_sweep(**kw) -> dict:
    from swim_tpu.sim import experiments as jexperiments

    return jexperiments.suspicion_sweep(**kw)


def geometry_arm(n: int, periods: int, cfg_kw: dict) -> tuple[dict, int]:
    """An arm of scripts/geometry_ablation.py: `ring.run` under 0.1%
    crashes in [0, periods), the key folded with 99; (the final state's
    fields, its overflow)."""
    import jax

    from swim_tpu import SwimConfig
    from swim_tpu.models import ring as jring
    from swim_tpu.sim import faults as jfaults

    cfg = SwimConfig(n_nodes=n, **cfg_kw)
    plan = jfaults.with_random_crashes(jfaults.none(n), jax.random.key(1),
                                       0.001, 0, periods)
    st = jring.run(cfg, jring.init_state(cfg), plan,
                   jax.random.fold_in(jax.random.key(0), 99), periods)
    return ({f: np.asarray(getattr(st, f)) for f in st._fields},
            int(st.overflow))


def pull_law(n: int, crashes: int, seeds: int, periods: int,
             crash_at: int) -> dict:
    """scripts/pull_law_131k.py's computation (its wall left at 0)."""
    import jax

    from swim_tpu import SwimConfig
    from swim_tpu.models import ring as jring
    from swim_tpu.sim import faults as jfaults
    from swim_tpu.sim import runner as jrunner

    cfg = SwimConfig(n_nodes=n, ring_probe="pull")
    victims = np.linspace(0, n - 1, crashes).astype(np.int32)
    lats = []
    for seed in range(seeds):
        plan = jfaults.with_crashes(jfaults.none(n), victims, crash_at)
        res = jrunner.run_study_ring(cfg, jring.init_state(cfg), plan,
                                     jax.random.key(seed), periods)
        first = np.asarray(res.track.first_suspect)[victims]
        detected = first != int(jrunner.NEVER)
        lats.append(first[detected].astype(np.int64) - crash_at + 1)
    lats = np.concatenate(lats)
    p = 1.0 - (1.0 - 1.0 / (n - 1)) ** (n - crashes)
    ks_k = np.arange(0, int(lats.max()) + 1)
    emp = np.searchsorted(np.sort(lats), ks_k, side="right") / len(lats)
    d = float(np.abs(emp - (1.0 - (1.0 - p) ** ks_k)).max())
    crit = 1.628 / math.sqrt(len(lats))
    return {"study": "pull_detection_law", "n": n,
            "crashes_per_seed": crashes, "seeds": seeds,
            "periods": periods, "engine": "ring", "ring_probe": "pull",
            "platform": "cpu", "samples": int(len(lats)),
            "latency_mean": float(lats.mean()), "expected_mean": 1.0 / p,
            "e_over_e_minus_1": math.e / (math.e - 1.0),
            "ks_distance": d, "ks_critical_alpha01": crit,
            "ks_pass": d < crit, "wall_seconds": 0.0}

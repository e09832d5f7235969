"""The port stands alone: no JAX, no swim_tpu, the card by default.

  * no module of swim_tpu_torch, not chip_smoke.py and not the card's
    tests (run where JAX is not installed) import `jax` or `swim_tpu` /
    `swim_tpu.*` (walked with `ast`; `swim_tpu_torch` itself shares the
    first letters and is allowed);
  * a subprocess in which `jax` and `swim_tpu` cannot be imported
    imports the port, runs a few CPU periods of each path and engine, two
    periods of the sharded ring engine on 8 shards, two of the
    partitioned dense and rumor engines on 8 shards, a small streaming
    study, a small study with the default engine and
    telemetry, its flight-recorder dump read back by the analyzer, a
    batch of two fault programs, a small packed scenario with its
    byte bill, two periods of an in-process serving hub with one
    injected claim, two periods of an engine bridge server with one
    raw-socket session, 2 s of a 3-node SimCluster of real nodes, two
    profiled periods, the exposition of the cluster's registries, a
    memory report, two periods of each scalar oracle, one ring step
    under the audit's dispatch mode, an audit exposition and the CLI's
    `info` and `simulate`;
  * chip_smoke.py defines no top-level function, class or constant
    twice (Python keeps the later definition, so an earlier copy would
    be dead code);
  * without CUDA, the entry points given no device raise instead of
    running on the CPU.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from swim_tpu_torch import SwimConfig, device
from swim_tpu_torch.bridge import EngineBridgeServer
from swim_tpu_torch.models import ring
from swim_tpu_torch.obs import memwall, prof
from swim_tpu_torch.ops import coldsel, selb, wavemerge
from swim_tpu_torch.parallel import shard_engine
from swim_tpu_torch.serve import load as serve_load
from swim_tpu_torch.serve.hub import ServeHub
from swim_tpu_torch.sim import faults

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "swim_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_card.py",
    ROOT / "tests" / "test_torch_cases.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "swim_tpu")


def imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            mods.append(node.module)
    return mods


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"ring.py", "selb.py", "coldsel.py", "wavemerge.py",
            "threefry.py", "chip_smoke.py", "runner.py", "experiments.py",
            "checkpoint.py", "metrics.py", "analyze.py", "dense.py",
            "rumor.py", "prng.py", "scatter.py", "common.py", "engine.py",
            "health.py", "recorder.py", "tree.py", "scenario.py",
            "search.py", "ici.py", "wavepack.py", "codec.py",
            "transport.py", "hub.py", "load.py", "trace.py",
            "servetrace.py", "types.py", "serve_tail.py", "clock.py",
            "gossip.py", "membership.py", "node.py", "cluster.py",
            "registry.py", "protocol.py", "server.py", "client.py",
            "engine_server.py", "prof.py", "expo.py", "memwall.py",
            "trend.py", "profiling.py", "roofline.py", "cli.py",
            "shard_engine.py", "audit.py", "oracle.py", "rumor_oracle.py",
            "ring_oracle.py", "partition.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"swim_tpu_torch/core/codec.py",
            "swim_tpu_torch/core/transport.py",
            "swim_tpu_torch/native/__init__.py",
            "swim_tpu_torch/native/transport.py",
            "swim_tpu_torch/serve/hub.py",
            "swim_tpu_torch/serve/load.py",
            "swim_tpu_torch/native/codec.py",
            "swim_tpu_torch/bridge/engine_server.py",
            "swim_tpu_torch/core/node.py",
            "swim_tpu_torch/analysis/__init__.py",
            "swim_tpu_torch/analysis/audit.py",
            "swim_tpu_torch/models/oracle.py",
            "swim_tpu_torch/models/rumor_oracle.py",
            "swim_tpu_torch/models/ring_oracle.py",
            "swim_tpu_torch/parallel/partition.py"} <= rel


def test_chip_smoke_defines_each_name_once():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.extend(t.id for t in targets if isinstance(t, ast.Name))
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, f"chip_smoke.py defines {twice} more than once"
    assert "main" in names and "bridge_phase" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("swim_tpu") and _forbidden("swim_tpu.models.ring")
    assert _forbidden("jax.numpy") and not _forbidden("swim_tpu_torch.ops")


def test_steps_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['swim_tpu'] = None\n"
        "import swim_tpu_torch, chip_smoke\n"
        "from swim_tpu_torch import SwimConfig\n"
        "from swim_tpu_torch.models import ring\n"
        "from swim_tpu_torch.sim import faults\n"
        "plan = faults.with_crashes(faults.none(20, 'cpu'), [2], [0])\n"
        "for kw in (dict(ring_sel_scope='period'), {},\n"
        "           dict(lifeguard=True)):\n"
        "    cfg = SwimConfig(n_nodes=20, **kw)\n"
        "    st = ring.run(cfg, ring.init_state(cfg, 'cpu'), plan, 1, 2)\n"
        "    assert int(st.step) == 2\n"
        "from swim_tpu_torch.sim import runner\n"
        "from swim_tpu_torch.utils import threefry\n"
        "cfg = SwimConfig(n_nodes=64, ring_probe='pull')\n"
        "plan = faults.with_random_crashes(faults.none(64, 'cpu'),\n"
        "                                  threefry.key(1), 0.1, 1, 3)\n"
        "res = runner.run_study_ring_stream(\n"
        "    cfg, ring.init_state(cfg, 'cpu'), plan, threefry.key(0), 4,\n"
        "    chunk=2)\n"
        "assert int(res.state.step) == 4\n"
        "assert res.series.dead_views.numel() == 4\n"
        "from swim_tpu_torch.parallel import mesh as pmesh, ring_shard\n"
        "mesh = pmesh.make_mesh(devices=['cpu'] * 8)\n"
        "st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, 'cpu'),\n"
        "                          plan)\n"
        "st = ring_shard.build_run(cfg, mesh, 2)(st, pl, 0)\n"
        "assert int(pmesh.assemble(st).step) == 2\n"
        "from swim_tpu_torch.parallel import shard_engine\n"
        "cfg = SwimConfig(n_nodes=64)\n"
        "mesh, st, pl, _ = shard_engine.start(cfg, plan, 'cpu')\n"
        "st = shard_engine.build_run(cfg, mesh, 2)(st, pl, 0)\n"
        "assert int(pmesh.assemble(st).step) == 2\n"
        "from swim_tpu_torch.parallel import partition\n"
        "for eng in ('dense', 'rumor'):\n"
        "    mesh, st, pl, _ = partition.start(\n"
        "        cfg, eng, plan, pmesh.make_mesh(devices=['cpu'] * 8))\n"
        "    st = partition.build_run(cfg, mesh, eng, 2)(st, pl, 0)\n"
        "    assert int(pmesh.assemble(st).step) == 2\n"
        "from swim_tpu_torch.models import dense, rumor\n"
        "for mod in (dense, rumor):\n"
        "    cfg = SwimConfig(n_nodes=64, lifeguard=True)\n"
        "    st = mod.run(cfg, mod.init_state(cfg, 'cpu'), plan, 1, 3)\n"
        "    assert int(st.step) == 3\n"
        "from swim_tpu_torch.sim import experiments\n"
        "import tempfile, os\n"
        "from swim_tpu_torch.obs import analyze\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    path = os.path.join(d, 'fr.jsonl')\n"
        "    out = experiments.detection_study(\n"
        "        n=64, periods=4, device='cpu', telemetry=True,\n"
        "        flight_record=path)\n"
        "    assert analyze.analyze(path)['periods'] == 4\n"
        "assert out['engine'] == 'dense' and 'telemetry' in out\n"
        "progs = [faults.as_program(plan), faults.as_program(plan, capacity=2)]\n"
        "res = experiments._run_study_batch(SwimConfig(n_nodes=64), progs,\n"
        "    [threefry.key(0), threefry.key(1)], 3, 'ring', device='cpu')\n"
        "assert tuple(res.series.dead_views.shape) == (2, 3)\n"
        "from swim_tpu_torch.sim import scenario, search\n"
        "sc = scenario.Scenario(name='t', n=32, periods=3, config=dict(\n"
        "    ring_sel_scope='period', ring_scalar_wire='packed',\n"
        "    lifeguard=True), domains='blocks:4', events=({'kind': 'gray',\n"
        "    'domain': 1, 'start': 0, 'end': 3, 'level': 0.5},))\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    v, _ = scenario.run(sc, out_dir=d, batch=True, device='cpu')\n"
        "assert v['arms']['main']['ici']['roll_link_thr_bytes'] > 0\n"
        "assert search.violations_of(dict(false_dead_final=1,\n"
        "    false_dead_peak=1, undetected_crashes=0), None)\n"
        "from swim_tpu_torch.core import codec\n"
        "from swim_tpu_torch.serve import hub as hub_mod, load\n"
        "from swim_tpu_torch.types import MsgKind, Status\n"
        "hub = hub_mod.ServeHub(SwimConfig(n_nodes=64, **load.SERVE_ANCHOR),\n"
        "    reserved_rows=[3], frontend='socket', device='cpu')\n"
        "try:\n"
        "    row = hub.attach()\n"
        "    hub._on_session_datagram(None, row, 9, codec.encode(\n"
        "        codec.Message(kind=MsgKind.PING, sender=row, gossip=(\n"
        "            codec.WireUpdate(20, Status.SUSPECT, 0, ('sim', 20),\n"
        "                             row),))))\n"
        "    hub.step_periods(2)\n"
        "    assert hub.report()['mirror_updates'] == 1\n"
        "    assert int((hub.state.subject == 20).sum()) == 1\n"
        "    assert len(load.state_digest(hub.state)) == 64\n"
        "finally:\n"
        "    hub.close()\n"
        "import socket\n"
        "from swim_tpu_torch.bridge import EngineBridgeServer\n"
        "from swim_tpu_torch.bridge import protocol as bp\n"
        "srv = EngineBridgeServer(SwimConfig(n_nodes=64, k_indirect=1),\n"
        "                         external_id=63, device='cpu')\n"
        "srv.start()\n"
        "sock = socket.create_connection(srv.address)\n"
        "try:\n"
        "    bp.write_frame(sock, bp.Frame(bp.HELLO, a=63))\n"
        "    assert bp.read_frame(sock).op == bp.WELCOME\n"
        "    for _ in range(2):\n"
        "        bp.write_frame(sock, bp.Frame(bp.STEP, t=1.0))\n"
        "        while bp.read_frame(sock).op != bp.TIME:\n"
        "            pass\n"
        "    assert srv.t == int(srv.state.step) == 2\n"
        "    bp.write_frame(sock, bp.Frame(bp.BYE))\n"
        "finally:\n"
        "    sock.close()\n"
        "    srv.close()\n"
        "    srv.join(timeout=30)\n"
        "from swim_tpu_torch.core.cluster import SimCluster\n"
        "c = SimCluster(SwimConfig(n_nodes=3), seed=1)\n"
        "c.start()\n"
        "c.run(2.0)\n"
        "assert c.converged_all_alive()\n"
        "assert sum(n.stats['probes'] for n in c.nodes) > 0\n"
        "from swim_tpu_torch.obs import expo, memwall, prof\n"
        "assert 'swim_build_info' in expo.render_prometheus(\n"
        "    ({'node': str(n.id)}, n.registry) for n in c.nodes)\n"
        "cfg = SwimConfig(n_nodes=64, ring_sel_scope='period')\n"
        "r = prof.profiled_ring_run(cfg, ring.init_state(cfg, 'cpu'),\n"
        "                           faults.none(64, 'cpu'), 0, 2)\n"
        "assert tuple(r.markers.shape) == (2, 6)\n"
        "assert not memwall.study_memory_analysis(64, device='cpu')[\n"
        "    'measured']\n"
        "from swim_tpu_torch.analysis import audit\n"
        "from swim_tpu_torch.models import (oracle, ring_oracle,\n"
        "                                   rumor_oracle)\n"
        "from swim_tpu_torch.utils import prng\n"
        "cfg = SwimConfig(n_nodes=16)\n"
        "plan = faults.with_crashes(faults.none(16, 'cpu'), [2], [0])\n"
        "assert oracle.Oracle(cfg, plan).run(threefry.key(0), 2).step == 2\n"
        "assert rumor_oracle.RumorOracle(cfg, plan).run(\n"
        "    threefry.key(0), 2).step == 2\n"
        "orc = ring_oracle.RingOracle(cfg, plan)\n"
        "orc.step(ring_oracle.to_numpy(\n"
        "    ring.draw_period_ring(threefry.key(0), 0, cfg, 'cpu')))\n"
        "assert orc.packed_state()[0].shape == (16, ring.geometry(cfg).ww)\n"
        "assert audit.hygiene_violations(lambda: ring.step(\n"
        "    cfg, ring.init_state(cfg, 'cpu'), plan,\n"
        "    ring.draw_period_ring(threefry.key(0), 0, cfg, 'cpu'))) == []\n"
        "assert 'swim_audit_checks_total' in expo.render_audit(\n"
        "    audit.assemble_report({}, dict(retraces_extra=0,\n"
        "        unattributed_collective_bytes=0, undonated_bytes=None,\n"
        "        barrier_chains_missing=0)))\n"
        "from swim_tpu_torch import cli\n"
        "assert cli.main(['--device', 'cpu', 'info']) == 0\n"
        "assert cli.main(['--device', 'cpu', 'simulate', '--nodes', '64',\n"
        "                 '--periods', '2']) == 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'swim_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = SwimConfig(n_nodes=16, ring_sel_scope="period")
    plan = faults.none(16, "cpu")
    for call in (lambda: ring.RingEngine(cfg, plan),
                 lambda: ring.init_state(cfg),
                 lambda: faults.none(16),
                 lambda: device.resolve(None),
                 lambda: ring.ext_none(4),
                 lambda: ServeHub(cfg, [1], frontend="socket"),
                 lambda: EngineBridgeServer(cfg, external_id=1),
                 lambda: serve_load.run_load(n_nodes=64, sessions=1),
                 lambda: prof.profile_ring(cfg),
                 lambda: memwall.study_memory_analysis(64),
                 lambda: shard_engine.start(SwimConfig(n_nodes=16), plan,
                                            None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cpu_tensors_take_the_plain_path_only():
    """The wrappers count launches only where a kernel ran: a CPU call
    runs the plain version and leaves the counts alone."""
    before = (selb.launches, coldsel.launches, wavemerge.launches)
    win = torch.zeros((8, 2), dtype=torch.int32)
    selb.select_first_b(win, 3)
    coldsel.cold_update_select(torch.zeros((4, 8), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros((1, 8), dtype=torch.int32),
                               torch.zeros((2, 8), dtype=torch.int32))
    e = torch.zeros((0, 8), dtype=torch.int32)
    wavemerge.merge_waves(win, win.clone(), torch.zeros((2, 8), dtype=bool),
                          torch.zeros(2, dtype=torch.int32), e, e)
    assert (selb.launches, coldsel.launches, wavemerge.launches) == before

"""The port stands alone: no JAX, no swim_tpu, the card by default.

  * no module of swim_tpu_torch, not chip_smoke.py and not the card's
    tests (run where JAX is not installed) import `jax` or `swim_tpu` /
    `swim_tpu.*` (walked with `ast`; `swim_tpu_torch` itself shares the
    first letters and is allowed);
  * a subprocess in which `jax` and `swim_tpu` cannot be imported
    imports the port and runs one CPU step;
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
from swim_tpu_torch.models import ring
from swim_tpu_torch.ops import coldsel, selb, wavemerge
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
            "threefry.py", "chip_smoke.py"} <= names


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
        "cfg = SwimConfig(n_nodes=20, ring_sel_scope='period')\n"
        "plan = faults.with_crashes(faults.none(20, 'cpu'), [2], [0])\n"
        "st = ring.run(cfg, ring.init_state(cfg, 'cpu'), plan, 1, 2)\n"
        "assert int(st.step) == 2\n"
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
                 lambda: device.resolve(None)):
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

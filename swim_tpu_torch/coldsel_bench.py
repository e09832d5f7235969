"""Time builds of the cold-ring kernel against each other on one card.

    python3 -m swim_tpu_torch.coldsel_bench \\
        [--variant NAME=SOURCE.cu[,-DFLAG...]]... [--nodes N]

Each variant is one build of a `coldsel_launch` source (the package's
own `csrc/coldsel.cu` is always the variant `change`; give the parent
commit's source as `--variant parent=path/to/coldsel.cu`).  All variants
run on the same three inputs, in turns (first to last, then last to
first), each checked bitwise against the plain version first:

  * `synthetic`: chip_smoke.py's input, a row per column and query drawn
    uniformly from [-2, RW + 2);
  * `quiet`: the arguments the ring engine gives the kernel in a period
    of a 1M-node run with 0.1% of the nodes crashing over the run;
  * `busy`: the same from a late period of a run in which 5% of the
    nodes crashed in the first periods.

One JSON line per (input, variant, turn) with the median ms, and one per
input with what it asks of the card (`measure.coldsel_profile`).  The
lines also go to chiprun_out/coldsel_bench.jsonl.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from swim_tpu_torch import SwimConfig, _kernels, measure
from swim_tpu_torch.models import ring
from swim_tpu_torch.ops import coldsel
from swim_tpu_torch.sim import faults
from swim_tpu_torch.utils import threefry

QUIET = dict(fraction=0.001, start=0, end=100, periods=106)
BUSY = dict(fraction=0.05, start=0, end=4, periods=45)


def synthetic_input(n: int, rw: int, ow: int, q: int, seed: int = 1234,
                    run: int = 1, rows: int | None = None):
    """`run`: aligned runs of that many columns share their row;
    `rows`: queries name rows [0, rows) only (default [-2, RW + 2))."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand_u32(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             device="cuda", dtype=torch.int32)

    cold = rand_u32((rw, n))
    fr = torch.randint(0, rw, (ow,), generator=gen, device="cuda",
                       dtype=torch.int32)
    fv = rand_u32((ow, n))
    lo, hi = (-2, rw + 2) if rows is None else (0, rows)
    qr = torch.randint(lo, hi, (q, (n + run - 1) // run), generator=gen,
                       device="cuda", dtype=torch.int32)
    qr = qr.repeat_interleave(run, dim=1)[:, :n].contiguous()
    return cold, fr, fv, qr


def captured_input(cfg, fraction, start, end, periods, seed: int = 1):
    """(coldsel's arguments in period `periods` of a run of `cfg` whose
    plan crashes `fraction` of the nodes over [start, end), the ring
    slots in use at that period)."""
    plan = faults.with_random_crashes(
        faults.none(cfg.n_nodes, "cuda"), threefry.key(seed), fraction,
        start, end)
    engine = ring.RingEngine(cfg, plan, seed=0)
    used = int((engine.run(periods).subject >= 0).sum())
    return measure.capture_inputs(engine)["coldsel"], used


def build_variant(name: str, source: Path, flags: list[str]):
    out = _kernels.BUILD_DIR / f"libcoldsel-bench-{name}.so"
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [_kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", *flags, "-o", str(out), str(source)], check=True)
    fn = ctypes.CDLL(str(out)).coldsel_launch
    fn.argtypes = _kernels.SIGNATURES["coldsel"]
    fn.restype = ctypes.c_int

    def call(cold, fr, fv, qr):
        sel = torch.empty_like(qr)
        _kernels.check(name, fn(
            cold.data_ptr(), fr.data_ptr(), fv.data_ptr(), qr.data_ptr(),
            sel.data_ptr(), cold.shape[1], cold.shape[0], fr.shape[0],
            qr.shape[0], _kernels.stream_of(cold)))
        return cold, sel
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--diagnose", action="store_true",
                    help="also time synthetic inputs whose rows come in "
                         "aligned runs of 8 and 16 columns, and one "
                         "limited to 32 rows")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("coldsel_bench: PyTorch sees no CUDA device")
    card = measure.card_line()
    specs = [("change", _kernels.CSRC / "coldsel.cu", [])]
    for v in args.variant:
        name, rest = v.split("=", 1)
        src, *flags = rest.split(",")
        specs.append((name, Path(src), flags))
    variants = [(nm, build_variant(nm, src, fl)) for nm, src, fl in specs]

    cfg = SwimConfig(n_nodes=args.nodes, ring_sel_scope="period")
    g = ring.geometry(cfg)
    inputs = {
        "synthetic": synthetic_input(args.nodes, g.rw, g.ow, g.c + 1),
        "quiet": captured_input(cfg, **QUIET)[0],
        "busy": captured_input(cfg, **BUSY)[0],
    }
    if args.diagnose:
        shape = (args.nodes, g.rw, g.ow, g.c + 1)
        inputs["runs8"] = synthetic_input(*shape, run=8)
        inputs["runs16"] = synthetic_input(*shape, run=16)
        inputs["rows32"] = synthetic_input(*shape, rows=32)
    lines = []

    def emit(**kw):
        lines.append(json.dumps(kw))
        print(lines[-1], flush=True)

    for what, (cold, fr, fv, qr) in inputs.items():
        emit(input=what, card=card, shape=list(cold.shape),
             ow=fr.shape[0], q=qr.shape[0],
             **measure.coldsel_profile(cold, fr, fv, qr))
        want = coldsel.cold_update_select_plain(cold.clone(), fr, fv, qr)
        for nm, call in variants:
            got = call(cold.clone(), fr, fv, qr)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{nm} differs from the plain version "
                                     f"on the {what} input")
        for turn, order in enumerate((variants, variants[::-1])):
            for nm, call in order:
                emit(input=what, variant=nm, turn=turn, card=card,
                     ms=measure.gpu_ms(lambda: call(cold, fr, fv, qr)))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "coldsel_bench.jsonl").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()

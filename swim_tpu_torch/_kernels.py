"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of its source, so an edited source
rebuilds and a stale library is never loaded.  `build()` starts one nvcc
per missing library, all at once, and waits for them together.  Nothing
here runs at import: the CPU tests import every module and this machine
may have no nvcc.

Every C entry point launches on the stream it is given, allocates
nothing and returns cudaGetLastError(); `check()` raises on a nonzero
code.  `launch()` calls one on its tensor's card: the `<<<>>>` launch
and `cudaFuncSetAttribute` act on the thread's current device, which a
caller on another card (a shard of a multi-card mesh) need not have set.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# kernel name -> argtypes of its `<name>_launch` entry point
SIGNATURES = {
    "selb": [_P, _P, _LL, _I, _I, _P],
    "coldsel": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _LL, _LL, _P],
    "wavemerge": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _LL, _LL,
                  _LL, _LL, _P],
}

_loaded: dict[str, ctypes.CDLL] = {}
# libraries loaded into `_loaded` so far, by kernel name: the build
# seam analysis/audit.py counts (a load follows a build or finds one)
loads: dict[str, int] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the swim_tpu_torch kernels")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> float:
    """Compile every missing kernel library, in parallel; returns the
    wall seconds spent (0.0 when all were built already)."""
    names = list(SIGNATURES if names is None else names)
    todo = [(nm, _lib_path(nm)) for nm in names if not _lib_path(nm).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for nm, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(CSRC / f"{nm}.cu")]
        procs.append((nm, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for nm, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{nm}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    if name not in _loaded:
        build([name])
        dll = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(dll, f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _loaded[name] = dll
        loads[name] = loads.get(name, 0) + 1
    return _loaded[name]


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, t: torch.Tensor, *args) -> None:
    """Kernel `name`'s entry point on `args` and the current stream of
    `t`'s card, run with that card as the current device; raises on a
    nonzero code."""
    with torch.cuda.device(t.device):
        check(name, getattr(lib(name), f"{name}_launch")(*args,
                                                          stream_of(t)))

"""Native (C++) datapath of the port: the udppump UDP pump.

`udppump.cpp` (a copy of the reference's) is an epoll socket pump on a
native thread, consumed through ctypes by native/transport.py.  It
builds with g++ on first use into `swim_tpu_torch/_build/native/`,
under a name carrying a hash of the source (an edited source rebuilds).
Without a toolchain `pump_lib()` returns None and the serving hub's
"auto" frontend falls back to a Python socket.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build" / "native"
_LOCK = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}


def _load(name: str) -> ctypes.CDLL | None:
    """Compile (once) and dlopen `name`.cpp; None without a toolchain."""
    with _LOCK:
        if name in _cache:
            return _cache[name]
        src = _DIR / f"{name}.cpp"
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        so = BUILD_DIR / f"lib{name}-{tag}.so"
        lib: ctypes.CDLL | None = None
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, str(src), "-pthread"],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            lib = None
        _cache[name] = lib
        return lib


def pump_lib() -> ctypes.CDLL | None:
    return _load("udppump")

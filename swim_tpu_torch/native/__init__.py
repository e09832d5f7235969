"""Native (C++) datapath of the port (copies of the reference's sources):

  * `codec.cpp`: the C ABI twin of core/codec.py (native/codec.py binds
    it through ctypes);
  * `udppump.cpp`: an epoll socket pump on a native thread, consumed
    through ctypes by native/transport.py;
  * `bridge_client.cpp`: a SWIM core in C++ that joins a cluster over
    the lockstep bridge (an executable; it #includes codec.cpp).

Each builds with g++ on first use into `swim_tpu_torch/_build/native/`,
under a name carrying a hash of its sources (an edited source rebuilds).
Without a toolchain the loaders return None: the serving hub's "auto"
frontend falls back to a Python socket and callers of the codec keep
core/codec.py.
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


_BIN: dict[str, str | None] = {}


def _build(name: str, out: str, flags: list[str],
           sources: tuple[str, ...]) -> Path:
    """g++ `name`.cpp into BUILD_DIR once; the output's name carries a
    hash of `sources`.  Raises OSError / SubprocessError without a
    toolchain."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update((_DIR / src).read_bytes())
    path = BUILD_DIR / out.format(tag=digest.hexdigest()[:12])
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-std=c++17", *flags, "-o", tmp,
                        str(_DIR / f"{name}.cpp")],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, path)
    return path


def _load(name: str) -> ctypes.CDLL | None:
    """Compile (once) and dlopen `name`.cpp; None without a toolchain."""
    with _LOCK:
        if name in _cache:
            return _cache[name]
        lib: ctypes.CDLL | None = None
        try:
            lib = ctypes.CDLL(str(_build(
                name, f"lib{name}-{{tag}}.so",
                ["-shared", "-fPIC", "-pthread"], (f"{name}.cpp",))))
        except (OSError, subprocess.SubprocessError):
            lib = None
        _cache[name] = lib
        return lib


def codec_lib() -> ctypes.CDLL | None:
    return _load("codec")


def pump_lib() -> ctypes.CDLL | None:
    return _load("udppump")


def bridge_client_bin() -> str | None:
    """Path of the compiled bridge_client executable (built at first
    use); None without a toolchain."""
    with _LOCK:
        if "bridge_client" not in _BIN:
            try:
                _BIN["bridge_client"] = str(_build(
                    "bridge_client", "bridge_client-{tag}", [],
                    ("bridge_client.cpp", "codec.cpp")))
            except (OSError, subprocess.SubprocessError):
                _BIN["bridge_client"] = None
        return _BIN["bridge_client"]


def available() -> dict[str, bool]:
    return {"codec": codec_lib() is not None,
            "udppump": pump_lib() is not None}

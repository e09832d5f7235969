"""Native UDP transport: the udppump datapath behind the Transport ABC
(port of `swim_tpu/native/transport.py`).

The socket lives on a C++ epoll thread: sends enqueue into the pump's
outbox, and a drainer thread polls inbound BATCHES out of the pump, one
GIL crossing per batch.  Receiver callbacks run on the drainer thread,
or on an asyncio loop when one is given.
"""
from __future__ import annotations

import ctypes
import logging
import socket
import threading

from swim_tpu_torch.core.transport import Address, Receiver, Transport
from swim_tpu_torch.native import pump_lib

_META_CAP = 1024
_BUF_CAP = 1 << 20
_POLL_S = 0.002         # the drainer's poll interval


def is_available() -> bool:
    return pump_lib() is not None


class NativeUDPTransport(Transport):
    def __init__(self, host: str = "127.0.0.1", port: int = 0, loop=None):
        """`loop`: an optional asyncio loop; when given, receiver
        callbacks are marshalled onto it with call_soon_threadsafe, so a
        Node driven by an AsyncioClock sees single-threaded delivery (as
        with core/transport.py's UDPTransport).  Without it, callbacks
        run on the drainer thread and the caller owns their
        serialization."""
        lib = pump_lib()
        if lib is None:
            raise RuntimeError("native udppump unavailable (no toolchain)")
        lib.pump_create.restype = ctypes.c_void_p
        lib.pump_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
        lib.pump_port.restype = ctypes.c_uint16
        lib.pump_port.argtypes = [ctypes.c_void_p]
        lib.pump_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint16,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int]
        lib.pump_recv.restype = ctypes.c_int
        lib.pump_recv.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint32),
                                  ctypes.c_int]
        lib.pump_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 3
        lib.pump_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.pump_create(host.encode(), port)
        if not self._h:
            raise OSError(f"could not bind UDP {host}:{port}")
        self._local: Address = (host, lib.pump_port(self._h))
        self._resolved: dict[str, str] = {}
        self._hlock = threading.Lock()  # orders send/stats against close
        self._receiver: Receiver | None = None
        self._loop = loop
        self._stop = threading.Event()
        self._buf = (ctypes.c_uint8 * _BUF_CAP)()
        self._meta = (ctypes.c_uint32 * (4 * _META_CAP))()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        base = ctypes.addressof(self._buf)
        while not self._stop.wait(_POLL_S):
            n = self._lib.pump_recv(self._h, self._buf, _BUF_CAP,
                                    self._meta, _META_CAP)
            if n <= 0 or self._receiver is None:
                continue
            off = 0
            for i in range(n):
                # meta carries host-order values; big-endian re-encode
                # recovers network order on any platform
                ip = socket.inet_ntoa(
                    int(self._meta[4 * i]).to_bytes(4, "big"))
                port = int(self._meta[4 * i + 1])
                ln = int(self._meta[4 * i + 2])
                payload = ctypes.string_at(base + off, ln)
                off += ln
                try:
                    if self._loop is not None:
                        self._loop.call_soon_threadsafe(
                            self._receiver, (ip, port), payload)
                    else:
                        self._receiver((ip, port), payload)
                except Exception:  # noqa: BLE001 — a broken handler must
                    # not kill the drainer and deafen the transport
                    logging.getLogger(__name__).exception(
                        "receiver callback failed; datagram dropped")

    # ------------------------------------------------------------ Transport

    def send(self, to: Address, payload: bytes) -> None:
        if not self._h:
            return  # closed transport: datagram loss is legal on this seam
        host = to[0]
        ip = self._resolved.get(host)
        if ip is None:
            # the pump takes IPv4 literals only: resolve names once
            try:
                ip = socket.gethostbyname(host)
            except OSError:
                return
            self._resolved[host] = ip
        arr = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        with self._hlock:
            if not self._h:
                return
            self._lib.pump_send(self._h, ip.encode(), to[1], arr,
                                len(payload))

    def set_receiver(self, receiver: Receiver) -> None:
        self._receiver = receiver

    @property
    def local_address(self) -> Address:
        return self._local

    def stats(self) -> dict[str, int]:
        rx = ctypes.c_uint64()
        tx = ctypes.c_uint64()
        dr = ctypes.c_uint64()
        with self._hlock:
            if not self._h:
                raise RuntimeError("transport closed")
            self._lib.pump_stats(self._h, ctypes.byref(rx), ctypes.byref(tx),
                                 ctypes.byref(dr))
        return {"rx": rx.value, "tx": tx.value, "drops": dr.value}

    def close(self) -> None:
        if not self._h:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # a wedged receiver callback is still inside pump_recv:
            # leak the pump rather than free memory under its feet
            return
        with self._hlock:
            h, self._h = self._h, None
        if h:
            self._lib.pump_destroy(h)

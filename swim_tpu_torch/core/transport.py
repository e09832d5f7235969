"""The transport seam (port of the ABC of `swim_tpu/core/transport.py`).

A datagram transport: fire-and-forget sends, one receiver callback.
Addresses are opaque `(host, port)` tuples.  The port's implementation
is native/transport.py's `NativeUDPTransport` (the serving hub's
udppump frontend).
"""
from __future__ import annotations

import abc
from typing import Callable

Address = tuple[str, int]
Receiver = Callable[[Address, bytes], None]


class Transport(abc.ABC):
    """Datagram-style message transport (unreliable, unordered is
    allowed)."""

    @abc.abstractmethod
    def send(self, to: Address, payload: bytes) -> None:
        """Fire-and-forget send; loss is legal and expected."""

    @abc.abstractmethod
    def set_receiver(self, receiver: Receiver) -> None:
        """Register the inbound callback (sender address, payload)."""

    @property
    @abc.abstractmethod
    def local_address(self) -> Address:
        ...

    def close(self) -> None:
        pass

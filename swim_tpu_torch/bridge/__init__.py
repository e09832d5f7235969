"""Host bridge: external protocol cores and simulated clusters (port of
`swim_tpu/bridge/`).

A lockstep TCP protocol (protocol.py); a server hosting an in-process
cluster of real Nodes (server.py); a server whose other members are
rows of the ring engine's state on the device (engine_server.py); and
the client that hosts Python cores against either (client.py).
"""

from swim_tpu_torch.bridge.client import BridgeTransport, ExternalNodeHost
from swim_tpu_torch.bridge.engine_server import EngineBridgeServer
from swim_tpu_torch.bridge.server import BridgeServer

__all__ = ["BridgeServer", "BridgeTransport", "EngineBridgeServer",
           "ExternalNodeHost"]

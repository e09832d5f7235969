"""Serving hub (port of `swim_tpu/serve`): thousands of concurrent
external cores on one ring-engine cluster on one device.

serve/hub.py runs the ring engine free of any client barrier and admits
and evicts sessions over a datagram frontend (the udppump epoll
datapath when g++ is present, a Python UDP socket otherwise);
serve/load.py is the load harness.
"""

from swim_tpu_torch.serve.hub import EXT_CAPACITY, SESSION_GAUGES, ServeHub

__all__ = ["EXT_CAPACITY", "SESSION_GAUGES", "ServeHub"]

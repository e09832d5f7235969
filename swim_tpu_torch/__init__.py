"""PyTorch port of swim_tpu for one NVIDIA H100.

The JAX package `swim_tpu` is the reference; this package imports
neither it nor JAX.  It runs the ring engine (models/ring.py), with
the three TPU kernels of that engine as CUDA kernels (ops/selb.py,
ops/coldsel.py, ops/wavemerge.py; sources in csrc/), the dense and
rumor engines in plain PyTorch (models/dense.py, models/rumor.py), and
the studies of sim/experiments.py on all three, with the engines'
telemetry frames, the health monitor, the flight recorder and the
analyzer (obs/), batched fault-program studies, the scenario library and
search, the serving hub, the host protocol layer and the bridge, and
the instruments (the phase profiler, the memory wall, the Prometheus
exposition, the trend gate) with the `swim-tpu-torch` command line
(cli.py).  State lives in torch.int32 tensors holding the u32 bit
patterns of the reference's arrays (ops/u32.py).
"""
__version__ = "0.1.0"

from swim_tpu_torch.config import STOCK_DEMO, SwimConfig  # noqa: E402

__all__ = ["STOCK_DEMO", "SwimConfig", "__version__"]

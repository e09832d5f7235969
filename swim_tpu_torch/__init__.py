"""PyTorch port of swim_tpu for one NVIDIA H100.

The JAX package `swim_tpu` is the reference; this package imports
neither it nor JAX.  It runs the ring engine (models/ring.py), with
the three TPU kernels of that engine as CUDA kernels (ops/selb.py,
ops/coldsel.py, ops/wavemerge.py; sources in csrc/), the dense and
rumor engines in plain PyTorch (models/dense.py, models/rumor.py), and
the studies of sim/experiments.py on all three, with the engines'
telemetry frames, the health monitor, the flight recorder and the
analyzer (obs/) and batched fault-program studies.  State lives in
torch.int32 tensors holding the u32 bit patterns of the reference's
arrays (ops/u32.py).
"""
from swim_tpu_torch.config import SwimConfig

__all__ = ["SwimConfig"]

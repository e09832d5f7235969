"""PyTorch port of swim_tpu for one NVIDIA H100.

The JAX package `swim_tpu` is the reference; this package imports
neither it nor JAX.  It runs the period-scope rotor ring engine
(models/ring.py) end to end, with the three TPU kernels of that path as
CUDA kernels (ops/selb.py, ops/coldsel.py, ops/wavemerge.py; sources in
csrc/).  State lives in torch.int32 tensors holding the u32 bit
patterns of the reference's arrays (ops/u32.py).
"""
from swim_tpu_torch.config import SwimConfig

__all__ = ["SwimConfig"]

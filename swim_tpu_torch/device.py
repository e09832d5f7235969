"""Default device of the port: the CUDA card, or an error.

Counterpart of `swim_tpu/utils/platform.py`.  Every entry point that
takes `device=None` resolves it here, so the port runs on the card
unless the caller names another device (the CPU tests pass
`device="cpu"`).  It never falls back to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA card, and
    raises when PyTorch sees no card.  A CUDA device always carries its
    index, so it compares equal to the device of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "swim_tpu_torch runs on a CUDA device by default and "
                "PyTorch sees none; pass device='cpu' to run on the CPU "
                "explicitly")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

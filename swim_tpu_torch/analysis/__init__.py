"""The contract audit (port of `swim_tpu/analysis/`).

`audit` verifies the contracts the performance claims rest on — build
budget, wire payloads, ICI tally completeness, bounded working sets,
hot-path hygiene — in the forms eager PyTorch can check: the sharded
engine's recorded exchanges, counted builds, a TorchDispatchMode over
the steps, and seams counted while the programs run.  Import-time
light, like the obs stack.
"""

from swim_tpu_torch.analysis import audit  # noqa: F401

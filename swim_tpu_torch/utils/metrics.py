"""Host-side digest of a study's per-period series (port of
`series_digest` of `swim_tpu/utils/metrics.py`)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def series_digest(series: Any) -> dict[str, Any]:
    """`_final`/`_peak`/`_sum`/`_mean` of every per-period array of a
    NamedTuple (tensors or numpy arrays).  Integer series digest to
    int, float series keep their values; `_mean` is always a float."""
    out: dict[str, Any] = {}
    for name in series._fields:
        arr = getattr(series, name)
        arr = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
               else np.asarray(arr))
        cast = float if np.issubdtype(arr.dtype, np.floating) else int
        out[f"{name}_final"] = cast(arr[-1]) if arr.size else 0
        out[f"{name}_peak"] = cast(arr.max()) if arr.size else 0
        out[f"{name}_sum"] = cast(arr.sum()) if arr.size else 0
        out[f"{name}_mean"] = float(arr.mean()) if arr.size else 0.0
    return out

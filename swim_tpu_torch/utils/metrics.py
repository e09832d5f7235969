"""Host-side aggregation (port of `swim_tpu/utils/metrics.py`): the
real-node cluster totals (`aggregate_nodes`) and the digest of a study's
per-period series (`series_digest`)."""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch


def aggregate_nodes(nodes: Iterable[Any]) -> dict[str, Any]:
    """Fold per-node `stats` counters into cluster totals, with derived
    health signals: the probe failure rate, messages per probe and,
    under Lifeguard, the highest local health score."""
    nodes = list(nodes)
    totals: dict[str, int] = {}
    for n in nodes:
        for k, v in n.stats.items():
            totals[k] = totals.get(k, 0) + v
    probes = totals.get("probes", 0)
    out: dict[str, Any] = {"nodes": len(nodes), **totals}
    out["probe_failure_rate"] = (
        totals.get("probe_failures", 0) / probes if probes else 0.0)
    out["messages_per_probe"] = (
        totals.get("messages_out", 0) / probes if probes else 0.0)
    if nodes and hasattr(nodes[0], "lha"):
        out["lha_max"] = max(n.lha for n in nodes)
    return out


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

"""Leaf-wise maps over nested NamedTuples of tensors (the port's pytrees:
states, plans, study results).  None is structure, not a leaf: it maps
to None."""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, *trees):
    """`fn` applied to the corresponding leaves of `trees`, which share
    one NamedTuple structure."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)

"""The shard mesh, placed tensors and the in-process collectives (port
of `swim_tpu/parallel/mesh.py`, with the collectives its JAX mesh gets
from XLA).

The reference shards the node axis over a 1-D mesh of JAX devices, one
shard each.  One card is one device, so the port's `Mesh` is a list of
D shard slots, each with a torch.device; `make_mesh()` gives the
reference's tier-1 mesh, 8 shards, all on the port's device (the card
unless the caller names another).

A placed tensor is a `Sharded`: its D blocks, one per shard, in shard
order, each in storage of its own, and the axis they split (None for a
replicated tensor, whose D blocks hold equal values).  `shard_state` and
`state_shardings` place a NamedTuple of tensors by the reference's rule
(the node axis is the leading one, or the one the state type's
SHARD_AXES names; a tensor whose node axis is not N long replicates),
and `assemble` stitches a placed tree back into whole tensors.

`Collectives` is what a sharded step runs against: D threads, one per
shard, in lockstep, because the reference's step body is SPMD code that
calls collectives mid-step.  Each collective is a rendezvous: every
shard posts its block and waits, the last one combines the posted
blocks (a stack, an integer sum or max), and every shard reads what it
needs.  The shards take turns between rendezvous (one runs at a time),
which keeps D threads from contending for the interpreter.  All
reductions are integer, so a sum is the same in any order.  A shard
that raises aborts the rendezvous, so every other shard raises too; a
wait longer than BARRIER_TIMEOUT_S seconds breaks it the same way.  `run_spmd`
runs one function on every shard and returns their results in shard
order.

On the card every shard thread launches on the caller's current stream,
so the exchanged tensors are ordered by the stream and need no event.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch

from swim_tpu_torch import device as devmod

NODE_AXIS = "nodes"
DEFAULT_SHARDS = 8
BARRIER_TIMEOUT_S = 600.0


class Mesh:
    """D shard slots over the node axis, each with its torch.device."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.size = len(self.devices)
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return f"Mesh({self.size} shards on {sorted(set(map(str, self.devices)))})"


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> Mesh:
    """1-D mesh over the node axis: `devices` (one shard each), cut to
    `n_devices`; by default DEFAULT_SHARDS shards on the port's default
    device (the card; swim_tpu_torch/device.py)."""
    if devices is None:
        devices = [devmod.resolve(None)] * (n_devices or DEFAULT_SHARDS)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh([devmod.resolve(d) for d in devices])


class Sharded:
    """One tensor placed over a mesh: `blocks[i]` lives on shard i.
    `axis` is the node axis the blocks split (concatenated in shard
    order they give the whole tensor), or None for a replicated tensor
    (every block holds the whole value)."""

    __slots__ = ("blocks", "axis")

    def __init__(self, blocks, axis: int | None):
        self.blocks = list(blocks)
        self.axis = axis

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def shape(self) -> tuple:
        shape = list(self.blocks[0].shape)
        if self.axis is not None:
            shape[self.axis] = sum(b.shape[self.axis] for b in self.blocks)
        return tuple(shape)

    def whole(self) -> torch.Tensor:
        if self.axis is None:
            return self.blocks[0]
        return torch.cat(self.blocks, dim=self.axis)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.blocks[0].dtype}, "
                f"axis={self.axis}, shards={len(self.blocks)})")


def _node_dim(state, n: int | None) -> int | None:
    """The node-axis length: explicit `n`, else the largest leading dim.
    States that declare SHARD_AXES require `n`: their replicated tables
    or word-major matrices can be longer than N at small N."""
    if n is not None:
        return n
    if getattr(type(state), "SHARD_AXES", None):
        raise ValueError(
            f"shard_state/state_shardings: pass n= explicitly for "
            f"{type(state).__name__} (it declares SHARD_AXES; inferring "
            f"the node axis from the largest leading dim can mis-shard)")
    return max((x.shape[0] for x in _leaves(state)
                if isinstance(x, torch.Tensor) and x.dim() >= 1),
               default=None)


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [] if tree is None else [tree]


def state_shardings(state, mesh: Mesh, n: int | None = None):
    """The node axis of every leaf (None = replicated), in the state's
    structure: the node axis is the leading one unless the state type's
    SHARD_AXES names another for the field, and a leaf whose node axis
    is not N long replicates."""
    nn = _node_dim(state, n)
    overrides = getattr(type(state), "SHARD_AXES", {})

    def spec_of(name, x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(spec_of(nm, y) for nm, y in zip(x._fields, x)))
        axis = overrides.get(name, 0)
        if (isinstance(x, torch.Tensor) and x.dim() > axis
                and x.shape[axis] == nn):
            return axis
        return None

    fields = getattr(state, "_fields", ())
    return type(state)(*(spec_of(nm, x) for nm, x in zip(fields, state)))


def split(x: torch.Tensor, mesh: Mesh, axis: int | None) -> Sharded:
    """x placed on `mesh`: D contiguous blocks along `axis` (N % D == 0),
    or D copies when `axis` is None; every block in storage of its own."""
    d = mesh.size
    if axis is None:
        return Sharded([x.to(dev, copy=True) for dev in mesh.devices], None)
    n = x.shape[axis]
    if n % d:
        raise ValueError(f"node axis of {n} does not split over {d} shards")
    s = n // d
    return Sharded([x.narrow(axis, i * s, s).to(dev, copy=True)
                    .contiguous() for i, dev in enumerate(mesh.devices)],
                   axis)


def place_tree(tree, specs, mesh: Mesh):
    """`tree` with every tensor leaf split by the matching leaf of
    `specs` (an axis or None); None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(place_tree(x, sp, mesh)
                            for x, sp in zip(tree, specs)))
    return split(tree, mesh, specs)


def shard_state(state, mesh: Mesh, n: int | None = None):
    """Place a NamedTuple state onto the mesh by `state_shardings`."""
    return place_tree(state, state_shardings(state, mesh, n), mesh)


def block(tree, i: int):
    """Shard i's view of a placed tree: each Sharded leaf's block i;
    plain tensors pass as they are."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(block(x, i) for x in tree))
    if isinstance(tree, Sharded):
        return tree.blocks[i]
    return tree


def gather_blocks(per_shard: list, specs):
    """The placed tree whose block i is `per_shard[i]` (trees of one
    structure), each leaf split by the matching leaf of `specs`."""
    first = per_shard[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(gather_blocks(list(parts), sp) for parts, sp
                             in zip(zip(*per_shard), specs)))
    return Sharded(per_shard, specs)


def assemble(tree):
    """Whole tensors from a placed tree (each Sharded leaf stitched in
    shard order, a replicated one read from shard 0); anything else
    passes unchanged.  The census, checkpoints and tests read these."""
    if isinstance(tree, Sharded):
        return tree.whole()
    if isinstance(tree, tuple):
        return type(tree)(*(assemble(x) for x in tree))
    return tree


# ---------------------------------------------------------------------------
# Collectives: D shard threads in lockstep
# ---------------------------------------------------------------------------


class Collectives:
    """Rendezvous collectives among D shard threads (see the module
    note).  Every method is called by all D shards in the same order
    with `rank` = the caller's shard; the results of reductions and
    gathers are shared by the shards and must not be written to.

    The shards take turns: shard r runs until its next collective,
    posts its block there and hands the turn to shard r+1; the last
    shard combines the posted blocks and hands the turn back to shard
    0.  One shard runs at a time, so the threads never contend for the
    interpreter, and every shard runs its step in the same order."""

    def __init__(self, d: int):
        self.d = d
        self._turn = [threading.Event() for _ in range(d)]
        self._slots: list = [None] * d
        self._out: Any = None
        self._broken = False

    def _check(self) -> None:
        if self._broken:
            raise threading.BrokenBarrierError

    def wait_turn(self, rank: int) -> None:
        """Block until shard `rank` holds the turn."""
        ev = self._turn[rank]
        if not ev.wait(BARRIER_TIMEOUT_S):
            self.abort()
            raise threading.BrokenBarrierError
        ev.clear()
        self._check()

    def pass_turn(self, rank: int) -> None:
        self._turn[(rank + 1) % self.d].set()

    def exchange(self, rank: int, x, combine: Callable):
        """Post x, let every shard post, and return combine(posted
        list), computed once by the last shard."""
        self._check()
        self._slots[rank] = x
        if rank == self.d - 1:
            self._out = None        # free the last result first
            self._out = combine(self._slots)
            self._slots = [None] * self.d
        self.pass_turn(rank)
        self.wait_turn(rank)
        return self._out

    def abort(self) -> None:
        """Release every shard: each waiting or later exchange raises."""
        self._broken = True
        for ev in self._turn:
            ev.set()

    # -- the collectives of the reference's shard_map ---------------------
    def stack(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """[D, *x.shape]: every shard's x in shard order (all_gather;
        a ppermute reads the block it needs from it)."""
        return self.exchange(rank, x, torch.stack)

    def stack_many(self, rank: int, xs: tuple) -> tuple:
        """`stack` of several tensors in one rendezvous."""
        return self.exchange(
            rank, xs, lambda slots: tuple(torch.stack(col)
                                          for col in zip(*slots)))

    def psum(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's x, in x's integer dtype."""
        return self.exchange(
            rank, x, lambda slots: torch.stack(slots).sum(0, dtype=x.dtype))

    def pmax(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        return self.exchange(rank, x,
                             lambda slots: torch.stack(slots).amax(0))


def run_spmd(mesh: Mesh, fn: Callable, around: Callable | None = None
             ) -> list:
    """[fn(rank, collectives) for every shard], the D calls running at
    once, one thread each, on the mesh's devices.  `around(rank)`, when
    given, is a context manager each shard's thread enters around its
    call (thread-local state such as a TorchDispatchMode does not cross
    into the shard threads from the caller's).  If a shard raises, the
    others are released from their barrier and the first error is
    raised here (a barrier broken by it is not the error)."""
    d = mesh.size
    coll = Collectives(d)
    results: list = [None] * d
    errors: list = [None] * d
    stream = None
    dev0 = mesh.devices[0]
    if dev0.type == "cuda":
        stream = torch.cuda.current_stream(dev0)

    def body(rank: int) -> None:
        dev = mesh.devices[rank]
        with contextlib.ExitStack() as ctx:
            if dev.type == "cuda":
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(
                    stream if dev == dev0 else
                    torch.cuda.current_stream(dev)))
            if around is not None:
                ctx.enter_context(around(rank))
            try:
                coll.wait_turn(rank)
                results[rank] = fn(rank, coll)
                coll.pass_turn(rank)
            except BaseException as e:      # noqa: BLE001 (re-raised)
                errors[rank] = e
                coll.abort()

    with mesh._lock:
        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"shard-{r}", daemon=True)
                   for r in range(d)]
        for t in threads:
            t.start()
        coll.pass_turn(d - 1)          # shard 0 goes first
        for t in threads:
            t.join()
    real = [e for e in errors
            if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    broken = [e for e in errors if e is not None]
    if broken:
        raise RuntimeError("a shard's barrier broke (timeout after "
                           f"{BARRIER_TIMEOUT_S} s)") from broken[0]
    return results

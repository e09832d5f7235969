"""The shard mesh, placed tensors and the in-process collectives (port
of `swim_tpu/parallel/mesh.py`, with the collectives its JAX mesh gets
from XLA).

The reference shards the node axis over a 1-D mesh of JAX devices, one
shard each.  The port's `Mesh` is a list of D shard slots, each with a
torch.device.  `make_mesh()` takes every card PyTorch sees, one shard
each, as the reference's takes `jax.devices()`; on one card it gives
the reference's tier-1 mesh, DEFAULT_SHARDS slots on that card.  A
caller may name the devices, the CPU included (a mixed mesh such as
["cuda", "cpu", "cuda", "cpu"] makes every exchange cross a device
boundary); the default mesh never takes the CPU.

A placed tensor is a `Sharded`: its D blocks, one per shard, in shard
order, each in storage of its own on its shard's device, and the axis
they split (None for a replicated tensor, whose D blocks hold equal
values).  `shard_state` and `state_shardings` place a NamedTuple of
tensors by the reference's rule (the node axis is the leading one, or
the one the state type's SHARD_AXES names; a tensor whose node axis is
not N long replicates), and `assemble` stitches a placed tree back into
whole tensors on shard 0's device.

`Collectives` is what a sharded step runs against: D threads, one per
shard, in lockstep, because the reference's step body is SPMD code that
calls collectives mid-step.  Each collective is a rendezvous: every
shard posts its block and waits, then every shard reads what it needs
in its own thread, on its own device: a permute reads only the posts
of the shards it names (one of another device copied in, one of its
own device as it is), a stack is built once per device from the
posted blocks, an integer sum or max is computed once, on the device
of the first shard that reads it, and copied to the others.  The
shards take turns between rendezvous (one runs at a time), which keeps
D threads from contending for the interpreter.  All reductions are
integer, so a sum is the same in any order.  A shard that raises
aborts the rendezvous, so every other shard raises too; a wait longer
than BARRIER_TIMEOUT_S seconds breaks it the same way.  `run_spmd`
runs one function on every shard and returns their results in shard
order.

Ordering on the card: each shard runs on the caller's current stream of
its device, and records an event on it when it posts.  A block read on
another device is copied after the copying stream waits on that event
(PyTorch's cross-device copy runs on the source device's current stream
of the reading thread, which need not be the poster's), so no copy
relies on two threads sharing a stream.  `Mesh.copied_bytes` counts the
bytes the collectives copy between distinct devices.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple

import torch

from swim_tpu_torch import device as devmod

NODE_AXIS = "nodes"
DEFAULT_SHARDS = 8
BARRIER_TIMEOUT_S = 600.0


class Mesh:
    """D shard slots over the node axis, each with its torch.device.
    `copied_bytes` counts the bytes the collectives have copied between
    distinct devices and `rendezvous` the collectives completed (a
    caller zeroes them before the work it reads)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.size = len(self.devices)
        self.distinct = tuple(dict.fromkeys(self.devices))
        self.copied_bytes = 0
        self.rendezvous = 0
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return f"Mesh({self.size} shards on {[str(d) for d in self.distinct]})"

    def stack_copies(self) -> int:
        """Blocks one stack copies between devices: every device takes
        the blocks of the shards on the others."""
        return sum(self.size - self.devices.count(dv) for dv in self.distinct)

    def permute_copies(self, offsets) -> int:
        """Blocks one permute copies between devices when every shard
        reads the posts of shards me + o, o in `offsets`: those on
        another device than the reader's."""
        d = self.size
        return sum(self.devices[(r + o) % d] != self.devices[r]
                   for r in range(d) for o in offsets)

    def reduce_copies(self) -> int:
        """Blocks one psum or pmax copies between devices: the blocks of
        the other devices into shard 0's, then the result out to each
        other device."""
        return (self.size - self.devices.count(self.devices[0])
                + len(self.distinct) - 1)


def _named(device) -> torch.device:
    """A named shard device (device.py's form), or a ValueError when
    it is a card PyTorch does not see."""
    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if (dev.index or 0) >= cards:
            raise ValueError(f"mesh device {dev} is not available "
                             f"(PyTorch sees {cards} CUDA devices)")
    return devmod.resolve(dev)


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> Mesh:
    """1-D mesh over the node axis.  `devices` names one device a
    shard (the CPU only where named; a device PyTorch does not see
    raises), cut to `n_devices`.  By default, one shard per card when
    PyTorch sees two or more, cut to `n_devices`; on one card
    `n_devices` (DEFAULT_SHARDS) slots on it (swim_tpu_torch/device.py:
    no card raises)."""
    if devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards >= 2:
            devices = [torch.device("cuda", i)
                       for i in range(cards)][:n_devices]
        else:
            devices = [devmod.resolve(None)] * (n_devices or DEFAULT_SHARDS)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh([_named(d) for d in devices])


def start_mesh(device=None) -> Mesh:
    """The mesh a sharded engine's `start` builds: `make_mesh()` when no
    device is named, else DEFAULT_SHARDS slots on the named one."""
    if device is None:
        return make_mesh()
    return make_mesh(devices=[device] * DEFAULT_SHARDS)


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
        """The whole tensor on shard 0's device: the blocks stitched in
        shard order (each copied there from its own device), or a
        replicated one's block 0."""
        if self.axis is None:
            return self.blocks[0]
        dev = self.device
        return torch.cat([b.to(dev) for b in self.blocks], dim=self.axis)

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
    """Whole tensors from a placed tree, each on its shard 0's device
    (`Sharded.whole`); anything else passes unchanged.  The census,
    checkpoints and tests read these."""
    if isinstance(tree, Sharded):
        return tree.whole()
    if isinstance(tree, tuple):
        return type(tree)(*(assemble(x) for x in tree))
    return tree


# ---------------------------------------------------------------------------
# Collectives: D shard threads in lockstep
# ---------------------------------------------------------------------------


class _Post(NamedTuple):
    """What one shard posted: its value (a tensor or a tuple of them),
    and on the card the event recorded after it on `stream`."""

    value: Any
    ready: Any
    stream: Any


class Collectives:
    """Rendezvous collectives among the D shard threads of `mesh` (see
    the module note).  Every method is called by all D shards in the
    same order with `rank` = the caller's shard, and returns the result
    on the caller's device; results are shared by the shards of one
    device and must not be written to.

    The shards take turns: shard r runs until its next collective,
    posts its block there and hands the turn to shard r+1; the last
    shard's post completes the rendezvous and hands the turn back to
    shard 0.  Each shard then reads its result in its turn, before it
    posts again, so the posted blocks stay readable until the last
    shard posts the next rendezvous.  One shard runs at a time, so the
    threads never contend for the interpreter, every shard runs its step
    in the same order, and the per-device results need no lock."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.d = mesh.size
        self._turn = [threading.Event() for _ in range(self.d)]
        self._slots: list = [None] * self.d
        self._posted: list = []
        self._results: dict = {}       # device -> _Post of its result
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

    def abort(self) -> None:
        """Release every shard: each waiting or later exchange raises."""
        self._broken = True
        for ev in self._turn:
            ev.set()

    def _post(self, rank: int, x) -> list[_Post]:
        """Post x, let every shard post, and return every shard's post."""
        self._check()
        ready, stream = self._event(self.mesh.devices[rank])
        self._slots[rank] = _Post(x, ready, stream)
        if rank == self.d - 1:
            self._posted, self._slots = self._slots, [None] * self.d
            self._results = {}
            self.mesh.rendezvous += 1
        self.pass_turn(rank)
        self.wait_turn(rank)
        return self._posted

    def _event(self, dev: torch.device) -> tuple:
        """(event, stream): an event recorded on `dev`'s current stream,
        where a block posted there may be read on another device."""
        if dev.type != "cuda" or len(self.mesh.distinct) == 1:
            return None, None
        stream = torch.cuda.current_stream(dev)
        ready = torch.cuda.Event()
        ready.record(stream)
        return ready, stream

    def _fetch(self, post: _Post, dev: torch.device) -> torch.Tensor:
        """A posted tensor on `dev`: one of another device is copied
        once its event has fired on the copying stream (the bytes
        counted in mesh.copied_bytes)."""
        x = post.value
        if x.device == dev:
            return x
        if post.ready is not None:
            cs = torch.cuda.current_stream(x.device)
            cs.wait_event(post.ready)
            if cs != post.stream:
                x.record_stream(cs)
        self.mesh.copied_bytes += x.numel() * x.element_size()
        return x.to(dev)

    def _once_per_device(self, rank: int, make: Callable):
        """make(dev) computed once per device per rendezvous and shared
        by the shards of that device."""
        dev = self.mesh.devices[rank]
        if dev not in self._results:
            self._results[dev] = _Post(make(dev), None, None)
        return self._results[dev].value

    def _gathered(self, posts: list[_Post], dev: torch.device) -> list:
        return [self._fetch(p, dev) for p in posts]

    # -- the collectives of the reference's shard_map ---------------------
    def permute(self, rank: int, x, srcs: tuple) -> list:
        """[post of shard j on the caller's device for j in srcs]: every
        shard posts x (a tensor or a tuple of them) and reads only the
        posts of the shards `srcs` names (host ints; ppermute).  A post
        of the caller's device is read as it is, one of another device
        copied (`_fetch`, whose copy waits on the post's event and
        keeps the source block alive on the copying stream).  Every
        shard passes the same shift, so every shard enters every
        exchange, and reads in its turn before it posts again, while
        the posts are held.  A post read as it is is the poster's own
        tensor: neither shard writes it afterwards (the rule for every
        collective's result)."""
        posts = self._post(rank, x)
        dev = self.mesh.devices[rank]
        out = []
        for j in srcs:
            p = posts[j]
            out.append(tuple(self._fetch(p._replace(value=v), dev)
                             for v in p.value)
                       if isinstance(p.value, tuple) else self._fetch(p, dev))
        return out

    def stack(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """[D, *x.shape]: every shard's x in shard order (all_gather)."""
        posts = self._post(rank, x)
        return self._once_per_device(
            rank, lambda dev: torch.stack(self._gathered(posts, dev)))

    def stack_many(self, rank: int, xs: tuple) -> tuple:
        """`stack` of several tensors in one rendezvous."""
        posts = self._post(rank, tuple(xs))

        def make(dev):
            cols = zip(*(self._gathered([p._replace(value=v) for v in
                                         p.value], dev) for p in posts))
            return tuple(torch.stack(col) for col in cols)
        return self._once_per_device(rank, make)

    def _reduce(self, rank: int, x: torch.Tensor, op: Callable):
        """op of the posted blocks, computed on the device of the first
        shard to read it and copied to each other device."""
        posts = self._post(rank, x)
        dev = self.mesh.devices[rank]
        if dev not in self._results:
            if self._results:
                out = self._fetch(next(iter(self._results.values())), dev)
            else:
                out = op(torch.stack(self._gathered(posts, dev)))
            self._results[dev] = _Post(out, *self._event(dev))
        return self._results[dev].value

    def psum(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's x, in x's integer dtype."""
        return self._reduce(rank, x, lambda s: s.sum(0, dtype=x.dtype))

    def pmax(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(rank, x, lambda s: s.amax(0))


def run_spmd(mesh: Mesh, fn: Callable, around: Callable | None = None
             ) -> list:
    """[fn(rank, collectives) for every shard], the D calls running at
    once, one thread each, on the mesh's devices: a card shard's thread
    runs on that card and on the caller's current stream of it, so what
    the caller does on a card after the call is ordered after the
    shards' work there.  `around(rank)`, when given, is a context
    manager each shard's thread enters around its call (thread-local
    state such as a TorchDispatchMode does not cross into the shard
    threads from the caller's).  If a shard raises, the others are
    released from their barrier and the first error is raised here (a
    barrier broken by it is not the error)."""
    d = mesh.size
    coll = Collectives(mesh)
    results: list = [None] * d
    errors: list = [None] * d
    streams = {dev: torch.cuda.current_stream(dev)
               for dev in mesh.distinct if dev.type == "cuda"}

    def body(rank: int) -> None:
        dev = mesh.devices[rank]
        with contextlib.ExitStack() as ctx:
            if dev.type == "cuda":
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(streams[dev]))
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

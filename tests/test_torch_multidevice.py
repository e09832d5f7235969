"""The sharded engines with each shard's blocks on its own device
(`swim_tpu_torch/parallel/mesh.py`), on the CPU.

The CPU is one device, so a second one is stood in for by `meta`, which
carries shapes and dtypes and no values: a mesh of ["cpu", "meta"] * 4
runs every op of a shard on that shard's device, and an op that mixes
the two raises, as an op mixing two cards would.  A meta block read on
the CPU has no data to copy; the tests hand the CPU zeros of its shape
and count its bytes as the mesh counts a copy (`meta_reads_as_zeros`).

  * The sharded ring census (`runner._placed_knowers`: each shard's
    count of its own rows, the partial counts summed in int64 and cut
    to int32) equals the assembled one-device census and the JAX
    package's census of the same state, bitwise; partial counts that
    overflow int32 wrap as JAX's int32 sum wraps.
  * `make_mesh()` with the card count patched to 1, 2 and 4: 8 slots of
    the one card, else one shard per card; `n_devices` cuts the list; a
    named card PyTorch does not see raises, and so does the default
    mesh without a card.
  * Each collective returns shard r's result on `mesh.devices[r]`; on
    an all-CPU mesh the values are the reference's and no byte is
    copied; on the mixed mesh a stack copies `stack_copies()` blocks, a
    psum or pmax `reduce_copies()`, a permute only the named posts of
    another device (`permute_copies`).
  * One sharded period of each engine on the mixed mesh keeps every
    block on its shard's device; the ring's exchange record is the
    all-CPU mesh's, and the bytes the mesh copied equal
    `ring_shard.mesh_copy_bytes` of that record (0 on the all-CPU
    mesh).  On a blocked mesh (4 CPU shards, then 4 meta) the rolls,
    ring hops and compact wire blocks copy what the permute model
    counts, less than a stack of every block would; on 8 distinct
    cards the model gives a roll at most 2 blocks a shard and a ring
    hop 1.  A sharded step without the period's host shifts raises.
  * A ringshard (full-track and streaming), `shard` and partitioned
    study started by `experiments._run_study` holds no block of its
    placed initial state by its second period but the ones the engine
    carries in place.
  * The audit's sharded wire arms pass on a mixed mesh, the bytes
    copied equal to the model of their exchanges.
  * A streaming ringshard study's snapshot from an all-CPU mesh
    restores onto the mixed mesh, each block on its template's device
    and the CPU blocks bitwise; the study resumes bitwise on another
    mesh of the same D; a placed checkpoint restores each block onto
    the device of its template's block.

The same checks on a mesh of the card and the CPU, with values, are in
tests/test_torch_card.py and chip_smoke.py's phase 19.  Tolerance:
exact.  The port's ops run on one thread.
"""
from __future__ import annotations

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_engine_cases import one_torch_thread

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu_torch import SwimConfig, convert
from swim_tpu_torch.analysis import audit
from swim_tpu_torch.models import ring, rumor
from swim_tpu_torch.parallel import mesh as pmesh
from swim_tpu_torch.parallel import partition, ring_shard, shard_engine
from swim_tpu_torch.sim import experiments, faults, runner
from swim_tpu_torch.utils import checkpoint, threefry

pytestmark = pytest.mark.usefixtures("one_torch_thread")
assert one_torch_thread

D = 8
N = 64
SMALL_GEOM = dict(suspicion_mult=1.0, k_indirect=1, max_piggyback=2,
                  ring_window_periods=2, ring_view_c=2)
MIXED = ["cpu", "meta"] * (D // 2)
META = torch.device("meta")


@pytest.fixture
def meta_reads_as_zeros(monkeypatch):
    """A meta block read on the CPU: zeros of its shape, its bytes
    counted as a copy."""
    real = pmesh.Collectives._fetch

    def fetch(self, post, dev):
        x = post.value
        if x.device == META and dev.type == "cpu":
            self.mesh.copied_bytes += x.numel() * x.element_size()
            return torch.zeros(x.shape, dtype=x.dtype)
        return real(self, post, dev)

    monkeypatch.setattr(pmesh.Collectives, "_fetch", fetch)


def crash_plan(n: int = N):
    return faults.with_crashes(faults.none(n, "cpu"), [5, 23, 41], [0, 1, 2])


# ---------------------------------------------------------------------------
# the census, per shard
# ---------------------------------------------------------------------------

def test_placed_census_equals_whole_and_jax_census():
    """The study's census of a placed state after 3 pull periods (the
    study default) equals the assembled state's and JAX's, bitwise."""
    kw = dict(ring_probe="pull", **SMALL_GEOM)
    cfg = SwimConfig(n_nodes=N, **kw)
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                              crash_plan())
    placed = ring_shard.build_run(cfg, mesh, 3)(st, pl, 5)
    whole = pmesh.assemble(placed)
    up = torch.from_numpy(np.random.default_rng(4).random(N) < 0.8)
    got = runner._placed_knowers(cfg, placed, up)
    assert got.dtype == torch.int32 and int(got.max()) > 0
    assert torch.equal(got, ring.live_knower_counts(cfg, whole, up))
    js = jring.RingState(**{f: jnp.asarray(v) for f, v in
                            convert.state_to_numpy(whole).items()})
    want = jring.live_knower_counts(JaxSwimConfig(n_nodes=N, **kw), js,
                                    jnp.asarray(up.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    st_w, t, _, _, knowers, _, _ = runner._census(cfg, placed,
                                                  faults.base_of(crash_plan()))
    assert st_w.win is None and st_w.cold is None
    assert int(t) == 2 and knowers.shape == got.shape


def test_placed_census_wraps_as_jax_int32_sum(monkeypatch):
    """Per-shard counts whose sum leaves int32: the int64 sum cut to
    32 bits, as JAX's int32 sum of the same partial counts."""
    cfg = SwimConfig(n_nodes=N, **SMALL_GEOM)
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    placed, _ = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                                 crash_plan())
    r = ring.geometry(cfg).rw * ring.WORD
    rng = np.random.default_rng(7)
    parts = rng.integers(2**28, 2**31 - 1, size=(D, r), dtype=np.int64)
    parts[:, :3] = [2**31 - 1, 2**30, 1]
    parts = parts.astype(np.int32)
    shard = iter(range(D))
    monkeypatch.setattr(ring, "live_knower_counts",
                        lambda cfg, st, up: torch.from_numpy(
                            parts[next(shard)]).to(st.win.device))
    got = runner._placed_knowers(cfg, placed, torch.ones(N, dtype=bool))
    want = np.asarray(jnp.sum(jnp.asarray(parts), axis=0, dtype=jnp.int32))
    assert (parts.astype(np.int64).sum(0) > 2**31 - 1).sum() > r // 2
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _cards(monkeypatch, count: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("count,n_devices,want", [
    (1, None, ["cuda:0"] * pmesh.DEFAULT_SHARDS),
    (1, 4, ["cuda:0"] * 4),
    (2, None, ["cuda:0", "cuda:1"]),
    (4, None, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (4, 2, ["cuda:0", "cuda:1"]),
])
def test_default_mesh_follows_the_card_count(monkeypatch, count, n_devices,
                                             want):
    _cards(monkeypatch, count)
    mesh = pmesh.make_mesh(n_devices)
    assert [str(d) for d in mesh.devices] == want
    assert all(d.type == "cuda" for d in mesh.devices)
    assert pmesh.start_mesh().devices == pmesh.make_mesh().devices
    assert pmesh.start_mesh("cpu").devices == (torch.device("cpu"),) * 8


@pytest.mark.parametrize("count,devices", [
    (2, ["cuda:0", "cuda:2"]), (1, ["cuda", "cpu", "cuda:1"]),
    (0, ["cpu", "cuda"])])
def test_a_named_device_not_seen_raises(monkeypatch, count, devices):
    _cards(monkeypatch, count)
    with pytest.raises(ValueError, match="not available"):
        pmesh.make_mesh(devices=devices)


def test_the_default_mesh_without_a_card_raises(monkeypatch):
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()


def test_mesh_copy_counts():
    mesh = pmesh.Mesh(["cuda:0", "cpu", "cuda:0", "cpu"])
    assert mesh.distinct == (torch.device("cuda:0"), torch.device("cpu"))
    assert (mesh.stack_copies(), mesh.reduce_copies()) == (4, 3)
    cards = pmesh.Mesh([f"cuda:{i}" for i in range(8)])
    assert (cards.stack_copies(), cards.reduce_copies()) == (56, 14)
    one = pmesh.Mesh(["cuda:0"] * 8)
    assert (one.stack_copies(), one.reduce_copies()) == (0, 0)


def _collectives(mesh):
    """Every shard's stack, stack_many, psum and pmax of small int32
    blocks made on its own device."""
    def body(rank, coll):
        dev = mesh.devices[rank]
        x = torch.full((3,), rank + 1, dtype=torch.int32, device=dev)
        y = torch.arange(2, dtype=torch.int64, device=dev) + rank
        return (coll.stack(rank, x), coll.stack_many(rank, (x, y)),
                coll.psum(rank, x), coll.pmax(rank, y))
    return pmesh.run_spmd(mesh, body)


def test_collectives_on_a_cpu_mesh_copy_nothing():
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    for rank, (st, (sx, sy), ps, pm) in enumerate(_collectives(mesh)):
        assert st.tolist() == [[r + 1] * 3 for r in range(4)]
        assert torch.equal(sx, st)
        assert sy.tolist() == [[r, r + 1] for r in range(4)]
        assert ps.tolist() == [10] * 3 and pm.tolist() == [3, 4]
        assert ps.dtype == torch.int32 and pm.dtype == torch.int64
    assert mesh.copied_bytes == 0


def test_collectives_return_on_each_shards_device(meta_reads_as_zeros):
    mesh = pmesh.make_mesh(devices=MIXED[:4])
    out = _collectives(mesh)
    for rank, res in enumerate(out):
        flat = [res[0], *res[1], res[2], res[3]]
        assert all(t.device == mesh.devices[rank] for t in flat), rank
        assert res[0].shape == (4, 3) and res[1][1].shape == (4, 2)
    stack_b, many_b, sum_b, max_b = 12, 12 + 16, 12, 16
    assert mesh.copied_bytes == (
        (stack_b + many_b) * mesh.stack_copies()
        + (sum_b + max_b) * mesh.reduce_copies())


def test_permute_reads_only_the_named_posts(meta_reads_as_zeros):
    """Every shard reads the posts of shards me+1 and me-1 (a tuple
    post too): the values on an all-CPU mesh, each on the reader's
    device, and on the mixed mesh only the reads of another device's
    posts copied."""
    def body(rank, coll):
        dev = coll.mesh.devices[rank]
        x = torch.full((3,), rank + 1, dtype=torch.int32, device=dev)
        y = torch.arange(2, dtype=torch.int64, device=dev) + rank
        d = coll.d
        return (coll.permute(rank, x, ((rank + 1) % d, (rank - 1) % d)),
                coll.permute(rank, (x, y), ((rank + 1) % d,)))

    cpu = pmesh.make_mesh(devices=["cpu"] * 4)
    for rank, (pair, ((nx, ny),)) in enumerate(pmesh.run_spmd(cpu, body)):
        assert [t.tolist() for t in pair] == [[(rank + 1) % 4 + 1] * 3,
                                              [(rank - 1) % 4 + 1] * 3]
        assert nx.tolist() == pair[0].tolist()
        assert ny.tolist() == [(rank + 1) % 4, (rank + 1) % 4 + 1]
    assert cpu.copied_bytes == 0
    mixed = pmesh.make_mesh(devices=MIXED[:4])
    for rank, (pair, ((nx, ny),)) in enumerate(pmesh.run_spmd(mixed, body)):
        assert all(t.device == mixed.devices[rank]
                   for t in (*pair, nx, ny))
    assert mixed.permute_copies((1, -1)) == 8
    assert mixed.permute_copies((0,)) == 0
    assert mixed.copied_bytes == 12 * mixed.permute_copies((1, -1)) + \
        (12 + 16) * mixed.permute_copies((1,))


# ---------------------------------------------------------------------------
# a sharded period on the mixed mesh
# ---------------------------------------------------------------------------

def _ring_period(mesh, **kw):
    cfg = SwimConfig(n_nodes=N, **{"ring_sel_scope": "period", **SMALL_GEOM,
                                   **kw})
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                              crash_plan())
    step = ring_shard.mapped_step(cfg, mesh, plain=True)
    step.record = []
    mesh.copied_bytes = 0
    out = step(st, pl, ring.draw_period_ring(threefry.key(0), 0, cfg, "cpu"),
               ring.rotor_offsets(cfg, 0))
    return out, step.record


def test_ring_period_keeps_each_shard_on_its_device(meta_reads_as_zeros):
    mesh = pmesh.make_mesh(devices=MIXED)
    out, record = _ring_period(mesh)
    for f in ring.RingState._fields:
        assert [b.device for b in getattr(out, f).blocks] == \
            list(mesh.devices), f
    copied = mesh.copied_bytes
    assert copied == ring_shard.mesh_copy_bytes(record, mesh) > 0
    cpu = pmesh.make_mesh(devices=["cpu"] * D)
    _, cpu_record = _ring_period(cpu)
    assert cpu_record == record
    assert cpu.copied_bytes == ring_shard.mesh_copy_bytes(record, cpu) == 0


# (wire keywords) of the exchanges the permute model is checked on
PERMUTE_WIRES = {
    "window": {},
    "compact_packed": dict(ring_ici_wire="compact",
                           ring_scalar_wire="packed"),
    "pull": dict(ring_probe="pull"),
}


def _posted(e) -> int:
    return sum(getattr(torch, p["dtype"]).itemsize
               * torch.Size(p["shape"]).numel() for p in e["payloads"])


def _stack_model(record, mesh) -> int:
    """What the exchanges of `record` copied when every roll, ring hop
    and compact block stacked every shard's post on every device."""
    return sum(_posted(e) * (mesh.reduce_copies() if e["op"] == "psum"
                             else mesh.stack_copies()) for e in record)


@pytest.mark.parametrize("wire", list(PERMUTE_WIRES))
def test_blocked_mesh_copies_what_the_permutes_read(meta_reads_as_zeros,
                                                    wire):
    """4 CPU shards then 4 meta: one period's copied bytes equal
    `mesh_copy_bytes` of its record, below what stacking every post
    copied; every ppermute entry names the shard offsets it read."""
    mesh = pmesh.make_mesh(devices=["cpu"] * 4 + ["meta"] * 4)
    _, record = _ring_period(mesh, **PERMUTE_WIRES[wire])
    perms = [e for e in record if e["op"] == "ppermute"]
    assert perms and all(e["srcs"] for e in perms)
    assert all("srcs" not in e for e in record if e["op"] != "ppermute")
    copied = mesh.copied_bytes
    assert copied == ring_shard.mesh_copy_bytes(record, mesh) > 0
    assert copied < _stack_model(record, mesh)


def test_card_mesh_model_reads_two_blocks_a_roll_and_one_a_hop():
    """On a mesh named with 8 distinct cards (arithmetic over the
    record, no card), each roll copies at most 2 blocks a shard, each
    ring hop 1, each compact block at most 1: the rolls' fetch factor
    (copied over D times the bill's bytes) at most 1, where the stack
    copied (D - 1) / 2 times the bill."""
    cards = pmesh.Mesh([f"cuda:{i}" for i in range(D)])
    for wire, kw in PERMUTE_WIRES.items():
        _, record = _ring_period(pmesh.make_mesh(devices=["cpu"] * D), **kw)
        rolls = [e for e in record if e["op"] == "ppermute"
                 and e["blocks"] == 2]
        hops = [e for e in record if "ring_pass" in e["terms"]]
        assert bool(hops) == (wire == "pull") and bool(rolls) != bool(hops)
        for e in record:
            if e["op"] != "ppermute":
                continue
            most = 2 if e["blocks"] == 2 else 1
            got = ring_shard.mesh_copy_bytes([e], cards)
            assert got <= most * D * _posted(e), (wire, e)
            assert got < _stack_model([e], cards), (wire, e)
        for e in hops:
            assert ring_shard.mesh_copy_bytes([e], cards) == D * _posted(e)
        if rolls:
            bill = sum(e["blocks"] * _posted(e) for e in rolls)
            assert ring_shard.mesh_copy_bytes(rolls, cards) <= D * bill
            assert _stack_model(rolls, cards) == D * bill * (D - 1) / 2


def test_a_sharded_step_needs_the_host_shifts():
    """The sharded step without the period's host shifts, or with a
    list of another length, raises; a roll by a device shift raises."""
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period", **SMALL_GEOM)
    mesh = pmesh.make_mesh(devices=["cpu"] * D)
    st, pl = ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                              crash_plan())
    step = ring_shard.mapped_step(cfg, mesh)
    rnd = ring.draw_period_ring(threefry.key(0), 0, cfg, "cpu")
    with pytest.raises(ValueError, match="host shifts"):
        step(st, pl, rnd)
    with pytest.raises(ValueError, match="host shifts"):
        step(st, pl, rnd, ring.rotor_offsets(cfg, 0)[:1])
    assert step.takes_shifts

    def body(rank, coll):
        ops = ring_shard.ShardOps(cfg, D, rank, coll, "cpu")
        return ops.roll_from(torch.zeros(N // D), rnd.s_off)

    with pytest.raises(TypeError, match="host int"):
        pmesh.run_spmd(mesh, body)


class _FirstStateWatch:
    """A study's step_fn wrapped: at its first call it keeps a weak
    reference to block 0 of every placed field of the initial state; at
    its second, `held` names the fields whose initial block is alive
    and not the one the state carries (in place) into that period."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.takes_shifts = getattr(step_fn, "takes_shifts", False)
        self.calls = 0
        self.refs: dict = {}
        self.held = self.gone = None

    def __call__(self, state, plan, rnd, *shifts):
        self.calls += 1
        blocks = {f: getattr(state, f).blocks[0] for f in state._fields
                  if isinstance(getattr(state, f), pmesh.Sharded)}
        if self.calls == 1:
            self.refs = {f: weakref.ref(b) for f, b in blocks.items()}
        elif self.calls == 2:
            gc.collect()
            self.held = {f for f, r in self.refs.items()
                         if r() is not None and r() is not blocks[f]}
            self.gone = {f for f, r in self.refs.items() if r() is None}
        del blocks
        return self.step_fn(state, plan, rnd, *shifts)


# (engine, start module, stream, the field whose initial block must go)
FIRST_STATE_CASES = {
    "ringshard": ("ringshard", ring_shard, False, "win"),
    "ringshard_stream": ("ringshard", ring_shard, True, "win"),
    "shard": ("shard", shard_engine, False, "knows"),
    "partitioned_dense": ("dense", partition, False, "key"),
}


@pytest.mark.parametrize("case", list(FIRST_STATE_CASES))
def test_studies_drop_their_placed_initial_state(monkeypatch, case):
    """`experiments._run_study` of a sharded or partitioned study at
    N = 64 (8 CPU shard slots; the partitioned one with the slots
    counted as devices): by the second period no frame holds a block of
    the placed initial state but those the engine updates in place."""
    engine, mod, stream, field = FIRST_STATE_CASES[case]
    watches = []
    real = mod.start

    def start(*a, **kw):
        mesh, st, pl, step_fn = real(*a, **kw)
        watches.append(_FirstStateWatch(step_fn))
        return mesh, st, pl, watches[-1]

    monkeypatch.setattr(mod, "start", start)
    device = "cpu"
    if mod is partition:
        device = None
        monkeypatch.setattr(pmesh, "make_mesh",
                            lambda *a, **kw: pmesh.Mesh(["cpu"] * D))
        monkeypatch.setattr(partition, "partitions", lambda mesh: True)
    cfg = SwimConfig(n_nodes=N, rumor_capacity=64, **SMALL_GEOM)
    plan = faults.with_crashes(faults.none(N, "cpu"), [5, 23], [0, 1])
    res = experiments._run_study(cfg, plan, threefry.key(3), 3, engine,
                                 device, stream=stream)
    (watch,) = watches
    assert watch.calls == 3 and int(res.state.step) == 3
    assert watch.held == set(), watch.held
    assert field in watch.gone


def test_shard_engine_period_keeps_each_shard_on_its_device(
        meta_reads_as_zeros):
    mesh = pmesh.make_mesh(devices=MIXED)
    cfg = SwimConfig(n_nodes=N, rumor_capacity=64, **SMALL_GEOM)
    plan = faults.with_loss(crash_plan(), 0.1)
    st, pl = shard_engine.place(cfg, mesh, rumor.init_state(cfg, "cpu"),
                                plan)
    out = shard_engine.build_step(cfg, mesh)(
        st, pl, rumor.draw_period_rumor(threefry.key(0), 0, cfg, "cpu"))
    for f in rumor.RumorState._fields:
        assert [b.device for b in getattr(out, f).blocks] == \
            list(mesh.devices), f
    assert mesh.copied_bytes > 0


def test_audit_wire_arms_on_the_mixed_mesh(monkeypatch, meta_reads_as_zeros):
    """The audit's sharded wire arms (`audit.sharded_wire_arms`) on a
    mixed mesh of D = 4: every row passes (wire, tally with the copied
    bytes against their model, hygiene), and every arm copies bytes.
    Meta has no kernel, so the shards run the kernels' plain versions."""
    real = ring_shard.mapped_step
    monkeypatch.setattr(ring_shard, "mapped_step",
                        lambda cfg, mesh, plain=False: real(cfg, mesh, True))
    rows = []
    out = audit.sharded_wire_arms(pmesh.make_mesh(devices=MIXED[:4]), N,
                                  lambda *row: rows.append(row))
    assert len(rows) == 3 * len(audit.WIRE_ARMS)
    assert all(ok for _, _, ok, _ in rows), rows
    assert out["unattributed"] == 0
    assert sorted(out["copies"]) == sorted(a for a, _ in audit.WIRE_ARMS)
    for arm, c in out["copies"].items():
        assert c["copied"] == c["model"] > 0 and c["fetch_factor"] > 0, arm


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

class _Preempted(RuntimeError):
    pass


class _DyingCheckpointer(runner.StudyCheckpointer):
    def save(self, *a, **kw):
        raise _Preempted(super().save(*a, **kw))


def test_stream_checkpoint_resumes_on_another_mesh(tmp_path):
    """A streaming ringshard study stopped after its first snapshot on
    an all-CPU mesh.  The snapshot restores onto the mixed mesh: each
    block on its template's device, the CPU blocks bitwise the state
    after the snapshot's periods.  The study resumed on another mesh of
    the same D equals the run straight through: track, series, state."""
    periods, every, key = 6, 3, (0, 11)
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period", **SMALL_GEOM)

    def placed(mesh):
        return ring_shard.place(cfg, mesh, ring.init_state(cfg, "cpu"),
                                crash_plan())

    def study(mesh, ckpt=None, chunk=0, upto=periods):
        st, pl = placed(mesh)
        return runner.run_study_ring_stream(
            cfg, st, pl, key, upto, ring_shard.mapped_step(cfg, mesh),
            chunk=chunk, ckpt=ckpt)

    first = pmesh.make_mesh(devices=["cpu"] * D)
    ref = study(first, chunk=every)
    at_snapshot = study(first, upto=every).state
    with pytest.raises(_Preempted):
        study(first, ckpt=_DyingCheckpointer(str(tmp_path), every=every))

    like = placed(pmesh.make_mesh(devices=MIXED))[0]
    got, _, _, _, step = runner.StudyCheckpointer(str(tmp_path)).restore(
        like)
    assert step == every
    for f in ring.RingState._fields:
        g, lk = getattr(got, f), getattr(like, f)
        assert [b.device for b in g.blocks] == [b.device for b in lk.blocks]
        for b, w in zip(g.blocks, getattr(at_snapshot, f).blocks):
            if b.device.type == "cpu":
                assert torch.equal(b, w), f

    other = pmesh.make_mesh(devices=["cpu"] * D)
    res = study(other, ckpt=runner.StudyCheckpointer(str(tmp_path),
                                                     every=every))
    assert res.state.win.blocks[0] is not ref.state.win.blocks[0]
    for part in ("track", "series"):
        for f in getattr(ref, part)._fields:
            assert torch.equal(getattr(getattr(ref, part), f),
                               getattr(getattr(res, part), f)), (part, f)
    for f in ring.RingState._fields:
        assert torch.equal(pmesh.assemble(getattr(ref.state, f)),
                           pmesh.assemble(getattr(res.state, f))), f


def test_placed_checkpoint_restores_onto_the_templates_devices(tmp_path):
    cfg = SwimConfig(n_nodes=N, ring_sel_scope="period", **SMALL_GEOM)
    whole = ring.run(cfg, ring.init_state(cfg, "cpu"), crash_plan(), 4, 2)
    path = str(tmp_path / "placed.npz")
    checkpoint.save_placed(
        path, pmesh.shard_state(whole, pmesh.make_mesh(devices=["cpu"] * D),
                                n=N), (1, 2), 2)
    like = pmesh.shard_state(ring.init_state(cfg, "cpu"),
                             pmesh.make_mesh(devices=MIXED), n=N)
    got, key, step = checkpoint.restore_placed(path, like)
    assert key == (1, 2) and step == 2
    for f in ring.RingState._fields:
        g, lk = getattr(got, f), getattr(like, f)
        assert [b.device for b in g.blocks] == [b.device for b in lk.blocks]
        want = getattr(whole, f)
        s = want.shape[lk.axis] // D if lk.axis is not None else None
        for i, b in enumerate(g.blocks):
            if b.device.type == "cpu":
                w = want if s is None else want.narrow(lk.axis, i * s, s)
                assert torch.equal(b, w), (f, i)

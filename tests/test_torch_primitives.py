"""The port's primitives against the JAX package, bit for bit.

u32 helpers on int32 carriers (keys with bit 31 set included), the
lattice, the Feistel sampler, JAX's threefry2x32 (key / fold_in / split
/ bits in the partitionable layout), the per-period ring randomness and
the sync-free scatters and compaction of ops/scatter.py.
Inputs come from numpy seeds; tolerance: exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swim_tpu import SwimConfig as JaxSwimConfig
from swim_tpu.models import ring as jring
from swim_tpu.ops import lattice as jlattice
from swim_tpu.ops import sampling as jsampling
from swim_tpu_torch import SwimConfig
from swim_tpu_torch.convert import randomness_to_numpy
from swim_tpu_torch.models import ring
from swim_tpu_torch.ops import lattice, sampling, scatter, u32
from swim_tpu_torch.utils import threefry


def carrier(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def u32_sample(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    a[:8] = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 0xFFFF, 0x10000]
    return a


class TestU32:
    def test_order_and_max(self):
        a, b = u32_sample(1), u32_sample(2)
        b[:8] = a[::-1][:8]
        ta, tb = carrier(a), carrier(b)
        np.testing.assert_array_equal(u32.ult(ta, tb).numpy(), a < b)
        np.testing.assert_array_equal(u32.ugt(ta, tb).numpy(), a > b)
        np.testing.assert_array_equal(u32.uge(ta, tb).numpy(), a >= b)
        np.testing.assert_array_equal(as_u32(u32.umax(ta, tb)),
                                      np.maximum(a, b))

    @pytest.mark.parametrize("s", [0, 1, 15, 16, 31])
    def test_logical_shift(self, s):
        a = u32_sample(3 + s)
        np.testing.assert_array_equal(as_u32(u32.lsr(carrier(a), s)),
                                      a >> np.uint32(s))

    def test_popcount_and_bits(self):
        a = u32_sample(4)
        want = np.array([bin(int(x)).count("1") for x in a])
        np.testing.assert_array_equal(u32.popcount(carrier(a)).numpy(), want)
        bit = np.arange(a.size) % 32
        np.testing.assert_array_equal(
            u32.bit_of(carrier(a), torch.from_numpy(bit.astype(np.int32)))
            .numpy(), ((a >> bit.astype(np.uint32)) & 1) == 1)

    def test_wrapping_add_and_mul(self):
        a, b = u32_sample(5), u32_sample(6)
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(
                as_u32(u32.add(carrier(a), carrier(b))), a + b)
            for c in (0x7FEB352D, 0x846CA68B, 0x9E3779B9, 0xFFFFFFFF, 3):
                np.testing.assert_array_equal(
                    as_u32(u32.mul_const(carrier(a), c)), a * np.uint32(c))

    def test_pack_bits(self):
        rng = np.random.default_rng(7)
        flags = rng.random((5, 32)) < 0.5
        flags[0] = True
        want = (flags.astype(np.uint64) << np.arange(32, dtype=np.uint64)
                ).sum(-1).astype(np.uint32)
        np.testing.assert_array_equal(
            as_u32(u32.pack_bits(torch.from_numpy(flags))), want)


class TestLattice:
    def test_pack_and_decode_match_jax(self):
        rng = np.random.default_rng(11)
        status = rng.integers(0, 3, 2048).astype(np.uint8)
        inc = u32_sample(12, 2048)
        inc[8:16] = [0, 1, 2**30 - 2, 2**30 - 1, 2**30, 2**31, 2**32 - 1, 7]
        want = np.asarray(jlattice.pack(jnp.asarray(status),
                                        jnp.asarray(inc)))
        got = lattice.pack(torch.from_numpy(status.astype(np.int32)),
                           carrier(inc))
        np.testing.assert_array_equal(as_u32(got), want)
        keys = u32_sample(13, 2048)
        tk = carrier(keys)
        jk = jnp.asarray(keys)
        np.testing.assert_array_equal(lattice.status_of(tk).numpy(),
                                      np.asarray(jlattice.status_of(jk)))
        np.testing.assert_array_equal(as_u32(lattice.incarnation_of(tk)),
                                      np.asarray(jlattice.incarnation_of(jk)))
        np.testing.assert_array_equal(lattice.is_dead(tk).numpy(),
                                      np.asarray(jlattice.is_dead(jk)))
        np.testing.assert_array_equal(lattice.is_suspect(tk).numpy(),
                                      np.asarray(jlattice.is_suspect(jk)))
        for mine, ref in ((lattice.alive_key, jlattice.alive_key),
                          (lattice.suspect_key, jlattice.suspect_key),
                          (lattice.dead_key, jlattice.dead_key)):
            np.testing.assert_array_equal(as_u32(mine(carrier(inc))),
                                          np.asarray(ref(jnp.asarray(inc))))

    def test_dead_outranks_alive_unsigned(self):
        """DEAD keys carry bit 31: the unsigned max must pick them."""
        alive = lattice.alive_key(carrier(np.array([5], np.uint32)))
        dead = lattice.dead_key(carrier(np.array([0], np.uint32)))
        assert bool(u32.ugt(dead, alive)[0])
        assert torch.equal(u32.umax(alive, dead), dead)


class TestSampling:
    def test_mix32(self):
        a = u32_sample(21)
        want = np.asarray(jsampling._mix32(jnp.asarray(a)))
        np.testing.assert_array_equal(as_u32(sampling._mix32(carrier(a))),
                                      want)
        assert [sampling._py_mix32(int(x)) for x in a[:64]] == \
            want[:64].tolist()

    @pytest.mark.parametrize("m", [2, 3, 31, 1000, 999_999])
    def test_feistel(self, m):
        rng = np.random.default_rng(m)
        x = rng.integers(0, m, 256).astype(np.uint32)
        ka, kb = u32_sample(m + 1, 256), u32_sample(m + 2, 256)
        want = np.asarray(jsampling.feistel(jnp.asarray(x), m,
                                            jnp.asarray(ka),
                                            jnp.asarray(kb)))
        got = sampling.feistel(carrier(x), m, carrier(ka), carrier(kb))
        np.testing.assert_array_equal(got.numpy(), want)
        py = [sampling.py_feistel(int(a), m, int(b), int(c))
              for a, b, c in zip(x[:32], ka[:32], kb[:32])]
        assert py == want[:32].tolist()
        assert py == [jsampling.py_feistel(int(a), m, int(b), int(c))
                      for a, b, c in zip(x[:32], ka[:32], kb[:32])]


class TestThreefry:
    @pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, -3])
    def test_key_fold_in_split(self, seed):
        k = threefry.key(seed)
        jk = jax.random.key(seed)
        assert list(k) == np.asarray(jax.random.key_data(jk)).tolist()
        for data in (0, 1, 39, 2**20 + 5):
            assert list(threefry.fold_in(k, data)) == np.asarray(
                jax.random.key_data(jax.random.fold_in(jk, data))).tolist()
        ks = threefry.split(k, 4)
        want = np.asarray(jax.random.key_data(jax.random.split(jk, 4)))
        assert [list(x) for x in ks] == want.tolist()

    @pytest.mark.parametrize("shape", [(1,), (97,), (4096,), (33, 3),
                                       (1000, 5)])
    def test_bits(self, shape):
        k = threefry.fold_in(threefry.key(5), 17)
        jk = jax.random.fold_in(jax.random.key(5), 17)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = threefry.bits(k, shape, "cpu")
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(as_u32(got), want)


class TestDrawPeriodRing:
    @pytest.mark.parametrize("n,k", [(32, 3), (24, 2), (1001, 3)])
    def test_matches_jax_over_steps(self, n, k):
        """Several periods, including steps past one epoch of N-1."""
        jcfg = JaxSwimConfig(n_nodes=n, k_indirect=k,
                             ring_sel_scope="period")
        cfg = SwimConfig(n_nodes=n, k_indirect=k, ring_sel_scope="period")
        jkey, key = jax.random.key(3), threefry.key(3)
        jdraw = jax.jit(lambda kk, t: jring.draw_period_ring(kk, t, jcfg))
        steps = [0, 1, 2, n - 2, n - 1, n, 2 * n + 5]
        for t in steps:
            want = jdraw(jkey, t)
            got = randomness_to_numpy(ring.draw_period_ring(key, t, cfg,
                                                            "cpu"))
            for f in ring.RingRandomness._fields:
                np.testing.assert_array_equal(
                    got[f], np.asarray(getattr(want, f)),
                    err_msg=f"{f} at step {t}")
            assert ring.rotor_offsets(cfg, t) == (
                [int(want.s_off)] + np.asarray(want.q_off).tolist())


@pytest.mark.parametrize("m,size,p", [(37, 8, 0.3), (37, 64, 0.5),
                                      (1000, 256, 0.01), (5, 5, 1.0),
                                      (9, 4, 0.0)])
def test_first_true_is_nonzero_with_size(m, size, p):
    valid = np.random.default_rng(m + size).random(m) < p
    want = np.asarray(jnp.nonzero(jnp.asarray(valid), size=size,
                                  fill_value=m + 7)[0])
    got = scatter.first_true(torch.from_numpy(valid), size, m + 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_max_drops_out_of_range_and_orders_unsigned():
    dst = u32_sample(3, 16)
    idx = np.array([0, 3, 3, 15, 16, 21, 7], np.int32)
    val = u32_sample(4, 16)[:7].copy()
    val[1] = 0x80000000                   # above every key without bit 31
    want = np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].max(
        jnp.asarray(val), mode="drop"))
    got = scatter.scatter_max(carrier(dst), torch.from_numpy(idx),
                              carrier(val), unsigned=True)
    np.testing.assert_array_equal(as_u32(got), want)
    sdst = dst.view(np.int32)
    swant = np.asarray(jnp.asarray(sdst).at[jnp.asarray(idx)].max(
        jnp.asarray(val.view(np.int32)), mode="drop"))
    sgot = scatter.scatter_max(torch.from_numpy(sdst.copy()),
                               torch.from_numpy(idx),
                               torch.from_numpy(val.view(np.int32).copy()),
                               unsigned=False)
    np.testing.assert_array_equal(sgot.numpy(), swant)

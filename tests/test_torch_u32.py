"""Port's int64 modular core (troy_tpu_torch/ops/u32.py) against the JAX
package's u32 core (troy_tpu/ops/u32.py), bit for bit, on edge values."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.ops import u32 as JU
from troy_tpu.core.modulus import Modulus
from troy_tpu.utils import numth
from troy_tpu_torch.ops import u32 as TU

RNG = np.random.default_rng(101)
PRIMES = [numth.get_prime(2 * 1024, 29), numth.get_prime(2 * 1024, 30)]


def values(q: int, hi: int, size: int = 4096) -> np.ndarray:
    """Edge values (0, 1, q-1, q, 2q-1, hi-1 where < hi) plus random ones."""
    edge = [v for v in (0, 1, q - 1, q, 2 * q - 1, hi - 1) if v < hi]
    return np.concatenate([edge, RNG.integers(0, hi, size=size)]).astype(np.uint32)


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.astype(np.int64)) for a in arrays])


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


@pytest.mark.parametrize("q", PRIMES)
def test_cond_sub_lazy(q):
    (jx,), (tx,) = both(values(q, 2 * q))
    same(JU.cond_sub(jx, JU.u32(q)), TU.cond_sub(tx, q))


@pytest.mark.parametrize("q", PRIMES)
def test_add_sub_neg_mod(q):
    a, b = values(q, q), RNG.permutation(values(q, q))
    (ja, jb), (ta, tb) = both(a, b)
    qj = JU.u32(q)
    same(JU.add_mod(ja, jb, qj), TU.add_mod(ta, tb, q))
    same(JU.sub_mod(ja, jb, qj), TU.sub_mod(ta, tb, q))
    same(JU.neg_mod(ja, qj), TU.neg_mod(ta, q))


@pytest.mark.parametrize("q", PRIMES)
def test_mul_mod_matches_barrett(q):
    m = Modulus(q)
    a, b = values(q, q), RNG.permutation(values(q, q))
    (ja, jb), (ta, tb) = both(a, b)
    same(JU.mul_mod(ja, jb, JU.u32(q), JU.u32(m.ratio64_hi), JU.u32(m.ratio64_lo)),
         TU.mul_mod(ta, tb, q))


@pytest.mark.parametrize("q", PRIMES)
def test_mul_mod_matches_shoup_on_lazy_inputs(q):
    """A multiply by a constant w < q of any u32 x (lazy values up to 2^32)."""
    x = values(q, 1 << 32)
    w = int(RNG.integers(1, q))
    (jx,), (tx,) = both(x)
    same(JU.shoup_mul(jx, JU.u32(w), JU.u32((w << 32) // q), JU.u32(q)),
         TU.mul_mod(tx, w, q))


@pytest.mark.parametrize("q", PRIMES)
def test_barrett_reduce_full_u32(q):
    m = Modulus(q)
    (jz,), (tz,) = both(values(q, 1 << 32))
    same(JU.barrett_reduce_u32(jz, JU.u32(q), JU.u32(m.ratio64_hi),
                               JU.u32(m.ratio64_lo)),
         TU.barrett_reduce(tz, q))


@pytest.mark.parametrize("q", PRIMES)
@pytest.mark.parametrize("terms", [1, 7, 8, 20])
def test_dot_mod(q, terms):
    """Sums of products of values up to 2^30 - 1 across both packages' chunk
    sizes (7 terms in int64, 16 in the u32 pair)."""
    m = Modulus(q)
    a = [values(q, 1 << 30, 512) for _ in range(terms)]
    b = [np.full_like(a[0], (1 << 30) - 1) if i % 3 == 0 else values(q, 1 << 30, 512)
         for i in range(terms)]
    ja, ta = both(*a)
    jb, tb = both(*b)
    same(JU.dot_mod(list(zip(ja, jb)), JU.u32(q), JU.u32(m.ratio64_hi),
                    JU.u32(m.ratio64_lo)),
         TU.dot_mod(list(zip(ta, tb)), q))

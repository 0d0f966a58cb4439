"""Port fused tensor product (troy_tpu_torch/ops/fused_mul.py, the plain
version of the Hopper kernel K4) against the JAX package's
fused_negacyclic_multiply, the Pallas kernel K4 in interpret mode, and
against the port's own unfused NTT -> dyadic_convolute -> INTT.  Bit for
bit, with a batched leading axis."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import troy_tpu.ops.ntt as JNTT
from troy_tpu.ops.fused_mul import fused_negacyclic_multiply as jax_fused
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import dyadic as D, fused_mul as FM, fused_mul_cuda, ntt as NTT

RNG = np.random.default_rng(4243)


def setup(log_n, L):
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    tabs = JNTT.NTTTables(log_n, [JModulus(p) for p in primes])
    pack = dict(tabs.pack())
    if "ss_Ti" not in pack:  # default pack omits the pallas-only Ti tables
        pack.update(tabs._sixstep_pack())
    tt = NTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    return np.array(primes, dtype=np.uint32), pack, tt


def operands(lead, q, n):
    return [(RNG.integers(0, 1 << 30, size=(*lead, 2, len(q), n)).astype(np.uint32)
             % q[:, None]) for _ in range(2)]


def test_fused_matches_jax_kernel():
    log_n, L = 9, 2
    q, pack, tt = setup(log_n, L)
    a, b = operands((2,), q, 1 << log_n)
    want = np.asarray(jax_fused(jnp.asarray(a), jnp.asarray(b), pack))
    got = FM.fused_negacyclic_multiply(torch.from_numpy(a.astype(np.int64)),
                                       torch.from_numpy(b.astype(np.int64)), tt)
    assert tuple(got.shape) == (2, 3, L, 1 << log_n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_fused_matches_unfused(lead):
    log_n, L = 6, 3
    q, _, tt = setup(log_n, L)
    a, b = (torch.from_numpy(x.astype(np.int64)) for x in operands(lead, q, 1 << log_n))
    got = FM.fused_negacyclic_multiply(a, b, tt)
    want = NTT.ntt_inverse(D.dyadic_convolute(NTT.ntt_forward(a, tt),
                                              NTT.ntt_forward(b, tt), tt), tt)
    assert tuple(got.shape) == (*lead, 3, L, 1 << log_n)
    assert torch.equal(got, want)


def test_fused_is_the_negacyclic_product():
    """c1 = a0 b1 + a1 b0 as a negacyclic convolution, by schoolbook."""
    log_n, L = 4, 1
    q, _, tt = setup(log_n, L)
    n, qv = 1 << log_n, int(q[0])
    a, b = operands((), q, n)
    got = FM.fused_negacyclic_multiply(torch.from_numpy(a.astype(np.int64)),
                                       torch.from_numpy(b.astype(np.int64)), tt)

    def negacyclic(x, y):
        out = [0] * n
        for i in range(n):
            for j in range(n):
                k, s = (i + j) % n, -1 if i + j >= n else 1
                out[k] += s * int(x[i]) * int(y[j])
        return [v % qv for v in out]

    a0, a1, b0, b1 = a[0, 0], a[1, 0], b[0, 0], b[1, 0]
    cross = [(u + v) % qv for u, v in zip(negacyclic(a0, b1), negacyclic(a1, b0))]
    assert got[1, 0].tolist() == cross
    assert got[0, 0].tolist() == negacyclic(a0, b0)
    assert got[2, 0].tolist() == negacyclic(a1, b1)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    _, _, tt = setup(4, 1)
    x = torch.zeros(1, 2, 1, 16, dtype=torch.int64)
    with pytest.raises(ValueError):
        fused_mul_cuda.fused_negacyclic_multiply(x, x, tt)
    assert fused_mul_cuda.LAUNCHES == {"fused_negacyclic_multiply": 0}

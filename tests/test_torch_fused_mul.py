"""Port fused tensor product (troy_tpu_torch/ops/fused_mul.py, the plain
version of the Hopper kernel K4) against the JAX package's
fused_negacyclic_multiply, the Pallas kernel K4 in interpret mode, and
against the port's own unfused NTT -> dyadic_convolute -> INTT.  Bit for
bit, with a batched leading axis.

The CUDA kernel (csrc/fused_mul.cu) cannot run here; emulate_fused replays
its schedule in PyTorch (the forward phases of each operand's CTA, the
products split over the cluster's CTAs, the inverse phases) and is held to
the plain version and the JAX kernel."""

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

from .test_torch_ntt import emulate_kernel

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
    assert set(fused_mul_cuda.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# The kernel's schedule (csrc/fused_mul.cu), replayed.
# ---------------------------------------------------------------------------

CLUSTER = fused_mul_cuda.CLUSTER
H100_SMEM_PER_CTA = 232448  # bytes of dynamic shared memory a CTA may opt into


def product_ranges(log_n):
    """The coefficients whose products CTA r of the cluster forms:
    [r ceil(n/4), (r+1) ceil(n/4)) cut at n, as fused_mul_kernel splits them;
    at a plan of one phase (n <= 32) the single CTA of fused_mul_small forms
    them all."""
    n = 1 << log_n
    if len(NTT.kernel_phase_plan(log_n)) == 1:
        return [torch.arange(n)]
    chunk = -(-n // CLUSTER)
    return [torch.arange(min(n, r * chunk), min(n, (r + 1) * chunk)) for r in range(CLUSTER)]


def scalars(t):
    """NTTTables.kernel_scalars as u32 values in int64, (6, L)."""
    return t.kernel_scalars.to(torch.int64) & 0xFFFFFFFF


def mont_redc(x, q, q_inv_neg):
    """csrc/fused_mul.cu:mont_redc on products x < q 2^32 held in int64:
    m = x q_inv_neg mod 2^32, (x + m q) / 2^32, which must be exact and
    below 2q (the 64-bit sum is formed in Python ints)."""
    xs, qs = x.numpy().astype(object), q.numpy().astype(object)
    m = ((xs & 0xFFFFFFFF) * q_inv_neg.numpy().astype(object)) & 0xFFFFFFFF
    total = xs + m * qs
    assert (total % (1 << 32) == 0).all() and (total < 1 << 63).all()
    r = total >> 32
    assert (r < 2 * qs).all()
    return torch.from_numpy(r.astype(np.int64))


def emulate_fused(a, b, t, reverse=False):
    """fused_mul_kernel on a, b (..., 2, L, n): CTA r of a (batch, limb)'s
    cluster runs the NTT kernel's forward phases on operand r (a0, a1, b0,
    b1) into its own shared memory (tests/test_torch_ntt.py:emulate_kernel,
    values left in [0, 4q); the kernel's first phase reads device memory,
    load_phase, with the same arithmetic as a phase in shared memory); then, rank by rank (or in reverse), CTA r forms
    c0, c1, c2 at its coefficient range from the four CTAs' memories and
    writes them, Montgomery-reduced (a b 2^-32 mod q in [0, 2q)), over the
    operands of ranks 0, 1, 2; ranks 0..2 run the inverse phases on their
    memory, scaled by n^-1 2^32 mod q.  Asserts that every coefficient is
    formed exactly once, that every (memory, coefficient) is touched by one
    CTA only (so no CTA overwrites a value a peer still reads), and the
    bounds of every step."""
    n, L = t.n, t.size
    q = t.q.view(L, 1)
    sc = scalars(t)
    assert torch.equal(sc[0], t.q) and torch.equal(sc[4], (t.n_inv << 32) % t.q)
    assert torch.equal((sc[3] * t.q) & 0xFFFFFFFF, torch.full_like(t.q, 0xFFFFFFFF))
    assert torch.equal(sc[5], (sc[4] << 32) // t.q)
    q_inv_neg = sc[3].view(L, 1)
    ops = [a[..., 0, :, :], a[..., 1, :, :], b[..., 0, :, :], b[..., 1, :, :]]
    mem = [emulate_kernel(x, t, inverse=False, lazy=True) for x in ops]
    for m in mem:
        assert ((m >= 0) & (m < 4 * q)).all()
    formed = torch.zeros(n, dtype=torch.int64)
    owner = torch.full((CLUSTER, n), -1, dtype=torch.int64)
    ranges = product_ranges(t.log_n)
    for rank in (reversed if reverse else list)(range(len(ranges))):
        idx = ranges[rank]
        for c in range(CLUSTER):  # every operand read where its CTA holds it
            assert (owner[c, idx] == -1).all()
            owner[c, idx] = rank
        x = [mem[c][..., idx] for c in range(CLUSTER)]
        x = [torch.where(v >= 2 * q, v - 2 * q, v) for v in x]
        a0, a1, b0, b1 = [torch.where(v >= q, v - q, v) for v in x]
        cross = a0 * b1 + a1 * b0
        assert (cross < 1 << 61).all() and (cross < q << 32).all()  # REDC's input bound
        for c, prod in enumerate((a0 * b0, cross, a1 * b1)):
            mem[c][..., idx] = mont_redc(prod, q.expand_as(prod), q_inv_neg.expand_as(prod))
        formed[idx] += 1
    assert (formed == 1).all()
    return torch.stack([emulate_kernel(mem[c], t, inverse=True, n_inv=sc[4])
                        for c in range(3)], dim=-3)


@pytest.mark.parametrize("log_n,L,lead", [(4, 2, (2,)), (9, 2, (1,)), (13, 1, (1,)),
                                          (15, 1, (1,))])
def test_kernel_schedule_matches_plain_and_jax(log_n, L, lead):
    """The kernel's schedule on lazy [0, 2q) input equals the plain version
    and the JAX Pallas K4 (interpret mode), bit for bit, in any order of
    the cluster's CTAs."""
    n = 1 << log_n
    q, pack, tt = setup(log_n, L)
    a, b = [(RNG.integers(0, 1 << 31, size=(*lead, 2, L, n)).astype(np.uint32)
             % (2 * q[:, None])) for _ in range(2)]
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    got = emulate_fused(ta, tb, tt)
    assert tuple(got.shape) == (*lead, 3, L, n)
    assert torch.equal(got, FM.fused_negacyclic_multiply_plain(ta, tb, tt))
    assert torch.equal(got, emulate_fused(ta, tb, tt, reverse=True))
    want = np.asarray(jax_fused(jnp.asarray(a), jnp.asarray(b), pack))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("log_n", range(1, 16))
def test_products_partition(log_n):
    """The CTAs' coefficient ranges cover 0 .. n-1 once each, at every n the
    wrapper accepts, 2 to 32768: a quarter each in a cluster, all of them in
    the single CTA of the one-phase plans (n <= 32)."""
    n = 1 << log_n
    ranges = product_ranges(log_n)
    assert torch.equal(torch.cat(ranges), torch.arange(n))
    assert len(ranges) == (1 if n <= 32 else CLUSTER)
    assert max(len(r) for r in ranges) == -(-n // len(ranges))


@pytest.mark.parametrize("log_n", range(1, 16))
def test_kernel_shared_memory_fits(log_n):
    """A cluster CTA holds its operand's n padded values (one word in 32,
    rounded to 16 bytes) and one limb table (phase_entries pairs), the
    inverse table copied over the forward one; the single CTA of n <= 32
    holds four polynomials and both tables.  shared_bytes, the size
    csrc/fused_mul.cu:variant_shape gives the launch, fits the H100's limit
    at every n the wrapper accepts, 2 to 32768; two tables side by side
    would not at n = 32768."""
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, 1)
    tt = NTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    entries = NTT.phase_entries(log_n)
    assert tt.kernel_phases.shape[-1] == 2 * entries and entries % 2 == 0
    words = (n + (n >> 5) + 3) & ~3
    want = 16 * n + 16 * entries if n <= 32 else 4 * words + 8 * entries
    assert fused_mul_cuda.shared_bytes(log_n) == want
    assert fused_mul_cuda.shared_bytes(log_n) <= H100_SMEM_PER_CTA
    if log_n == 15:
        assert fused_mul_cuda.shared_bytes(log_n) + 8 * entries > H100_SMEM_PER_CTA

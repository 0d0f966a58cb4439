"""The NTT and the fused tensor product at degrees above 32768, to the
reference's 131072 (troy_tpu_torch/ops/ntt.py:default_split,
ops/ntt_cuda.py, ops/fused_mul_cuda.py, csrc/ntt.cu, csrc/tensor_product.cu).

The CUDA kernels cannot run here.  emulate_ntt (tests/test_torch_ntt.py)
replays the two-launch yardstick of the cluster route in PyTorch: the
column kernel's first log2 n1 stages over the columns, then the block
kernel's stages on each block of n2 values with its own slice of the twiddle
heap, and the inverse in reverse (tests/test_torch_cluster.py replays the
cluster kernels).  The split is a parameter of the tables, so the same
schedule is held to the plain transform and the JAX package at small n too;
at n = 65536 and 131072 the plain versions are held to the JAX radix-2 NTT
and to K4's function composed from JAX's NTT and dyadic product."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import troy_tpu.ops.ntt as JNTT
from troy_tpu.ops import dyadic as JD
from troy_tpu.ops.fused_mul import fused_negacyclic_multiply as jax_fused
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import dyadic as D, fused_mul as FM, fused_mul_cuda, ntt as NTT, ntt_cuda

from .test_torch_ntt import emulate_columns, emulate_kernel, emulate_ntt, jax_packs, residues

RNG = np.random.default_rng(65536)


def tables(log_n, L, split=None):
    n = 1 << log_n
    primes = numth.get_primes(2 * n, 30, L)
    return primes, NTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu", split)


def as_tensor(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("log_n,split,L,lead", [
    (8, 1, 2, (2,)), (10, 2, 2, (1,)), (11, 3, 1, (2,)), (12, 5, 1, (1,)),
    (13, 4, 2, (1,)), (16, None, 1, (1,))])
def test_two_launch_schedule_matches_plain_and_jax(log_n, split, L, lead):
    """Each launch of the route equals its plain partial transform on lazy
    [0, 2q) input, and the pair equals the plain NTT and the JAX radix-2 NTT,
    forward and inverse."""
    n = 1 << log_n
    primes, tt = tables(log_n, L, split)
    assert tt.split == (split if split is not None else NTT.CLUSTER_SPLIT[log_n])
    assert tt.block_log_n == log_n - tt.split
    radix2 = jax_packs(log_n, primes, pallas=False)["radix2"]
    lazy = as_tensor(residues((*lead, L, n), primes, factor=2))
    canon = lazy % tt.q.view(L, 1)
    cols = emulate_columns(lazy, tt, inverse=False)
    assert torch.equal(cols, NTT.forward_stages_plain(lazy, tt, 0, tt.split))
    fwd = emulate_kernel(cols, tt, inverse=False)
    assert torch.equal(fwd, NTT.forward_stages_plain(cols, tt, tt.split, log_n))
    assert torch.equal(fwd, NTT.ntt_forward_plain(lazy, tt))
    assert torch.equal(emulate_ntt(lazy, tt, inverse=False), fwd)
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_forward(jnp.asarray(lazy.numpy().astype(np.uint32)), radix2)),
        fwd.numpy())
    blocks = emulate_kernel(lazy, tt, inverse=True)  # [0, 2q) in, scaled by 1
    assert torch.equal(blocks, NTT.inverse_stages_plain(canon, tt, tt.split, log_n, False))
    inv = emulate_columns(blocks, tt, inverse=True)
    assert torch.equal(inv, NTT.inverse_stages_plain(blocks, tt, 0, tt.split, True))
    assert torch.equal(inv, NTT.ntt_inverse_plain(canon, tt))
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_inverse(jnp.asarray(canon.numpy().astype(np.uint32)), radix2)),
        inv.numpy())
    assert torch.equal(emulate_ntt(fwd, tt, inverse=True), canon)


@pytest.mark.parametrize("log_n,split", [(8, 2)])
def test_large_fused_route_matches_plain_and_jax_kernel(log_n, split):
    """K4's five-launch yardstick route with a split (forward NTT of (a, b)
    as one (..., 4, L, n) call, the tensor product, the inverse NTT),
    replayed, equals the plain version and the JAX Pallas K4 in interpret
    mode."""
    n, L = 1 << log_n, 2
    primes, tt = tables(log_n, L, split)
    q = np.array(primes, dtype=np.uint32)[:, None]
    a, b = [(RNG.integers(0, 1 << 31, size=(1, 2, L, n)).astype(np.uint32) % (2 * q))
            for _ in range(2)]
    ta, tb = as_tensor(a), as_tensor(b)
    y = emulate_ntt(torch.cat([ta, tb], dim=-3), tt, inverse=False)
    prod = D.dyadic_convolute(y[..., :2, :, :], y[..., 2:, :, :], tt)
    got = emulate_ntt(prod, tt, inverse=True)
    assert torch.equal(got, FM.fused_negacyclic_multiply_plain(ta, tb, tt))
    jtabs = JNTT.NTTTables(log_n, [JModulus(p) for p in primes])
    pack = dict(jtabs.pack())
    if "ss_Ti" not in pack:
        pack.update(jtabs._sixstep_pack())
    want = np.asarray(jax_fused(jnp.asarray(a), jnp.asarray(b), pack))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("log_n", [16, 17])
def test_plain_versions_match_jax_at_large_n(log_n):
    """At n = 65536 and 131072 over 2 limbs: the plain NTT pair equals the
    JAX radix-2 NTT, and the plain fused product equals K4's function
    composed from the JAX package's NTT and dyadic product."""
    n, L = 1 << log_n, 2
    primes, tt = tables(log_n, L)
    assert tt.split == NTT.CLUSTER_SPLIT[log_n]
    radix2 = jax_packs(log_n, primes, pallas=False)["radix2"]
    lazy = residues((L, n), primes, factor=2)
    fwd = NTT.ntt_forward_plain(as_tensor(lazy), tt)
    want = np.asarray(JNTT.ntt_forward(jnp.asarray(lazy), radix2))
    np.testing.assert_array_equal(want, fwd.numpy())
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_inverse(jnp.asarray(want), radix2)),
        NTT.ntt_inverse_plain(fwd, tt).numpy())
    if log_n == 16:
        a, b = residues((2, L, n), primes), residues((2, L, n), primes)
        got = FM.fused_negacyclic_multiply_plain(as_tensor(a), as_tensor(b), tt)
        ja, jb = (JNTT.ntt_forward(jnp.asarray(v), radix2) for v in (a, b))
        want = JNTT.ntt_inverse(JD.dyadic_convolute(ja, jb, radix2), radix2)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("log_n", [16, 17])
def test_large_tables(log_n):
    """The default route above 32768: clusters of 2^CLUSTER_SPLIT CTAs; the
    block table holds per block the constants psi_br[g] and its slice of
    every phase's heap rows (roots v = 2^(split+r) + b 2^r + u), the column
    table the heap subtree of root 1; the block scalars scale by 1."""
    n = 1 << log_n
    primes, tt = tables(log_n, 1)
    split = tt.split
    assert (tt.block_log_n, split) == (log_n - NTT.CLUSTER_SPLIT[log_n],
                                       NTT.CLUSTER_SPLIT[log_n])
    table = (tt.kernel_phases.to(torch.int64) & 0xFFFFFFFF).view(2, 1, 1 << split, -1, 2)
    assert table.shape[3] == tt.entries == NTT.phase_entries(tt.block_log_n)
    for b in (0, (1 << split) - 1):
        assert torch.equal(table[0, 0, b, 1:16, 0], tt.psi_br[0, 1:16])
        off = NTT.CONSTANT_SLOTS
        for i, (r, k) in enumerate(tt.phase_plan):
            last = i == len(tt.phase_plan) - 1
            slots = NTT.phase_slots(k, last)
            rows = table[1, 0, b, off:off + (slots << r), 0].view(1 << r, slots)
            v = (1 << (split + r)) + (b << r)
            if not last:  # slot 2^l + g holds node v 2^l + g of root v
                assert int(rows[0, 1]) == int(tt.inv_psi_br[0, v])
                assert int(rows[0, 2]) == int(tt.inv_psi_br[0, 2 * v])
            else:         # slot 8 holds psi_br[v 2^3] of the factored levels
                assert int(rows[0, 8]) == int(tt.inv_psi_br[0, v << 3])
            off += slots << r
    col = (tt.column_phases.to(torch.int64) & 0xFFFFFFFF).view(2, 1, 1 << split, 2)
    assert torch.equal(col[0, 0, 1:, 0], tt.psi_br[0, 1:1 << split])
    assert torch.equal(col[1, 0, 1:, 1], (tt.inv_psi_br[0, 1:1 << split] << 32) // tt.q[0])
    bs = tt.block_scalars.to(torch.int64) & 0xFFFFFFFF
    assert bs[:, 0].tolist() == [primes[0], 1, (1 << 32) // primes[0]]
    assert int(tt.barrett_ratio[0]) == ((1 << 64) - 1) // primes[0]


def test_wrappers_refuse_above_131072_and_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor is refused at every
    degree, and so is n = 262144 (above the reference's maximum) on any
    device; tables without a split cannot serve n > 32768."""
    _, tt = tables(4, 1, split=2)
    x = torch.zeros(1, 1, 16, dtype=torch.int64)
    for fn in (ntt_cuda.ntt_forward, ntt_cuda.ntt_inverse):
        with pytest.raises(ValueError):
            fn(x, tt)
    with pytest.raises(ValueError):
        fused_mul_cuda.fused_negacyclic_multiply(x[None].expand(1, 2, 1, 16).contiguous(),
                                                 x[None].expand(1, 2, 1, 16).contiguous(), tt)
    assert set(ntt_cuda.LAUNCHES.values()) == {0}
    assert set(fused_mul_cuda.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="split"):
        NTT.NTTTables(4, [Modulus(numth.get_prime(32, 30))], "cpu", split=4)
    assert NTT.default_split(15) == 0 and NTT.default_split(18) == 4

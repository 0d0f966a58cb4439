"""The cluster routes above n = 32768 (troy_tpu_torch/csrc/ntt.cu:
ntt_cluster_kernel, csrc/fused_mul_large.cu, csrc/ntt_phases.cuh's cluster
helpers; ops/ntt_cuda.py, ops/fused_mul_cuda.py).

The CUDA kernels cannot run here.  emulate_cluster replays the NTT's
cluster kernel CTA by CTA with the kernel's own index maps: the columns CTA
r loads (cluster_columns), the block and padded shared-memory offset each
column value is scattered to (scatter_column), the block phases
(emulate_phases of tests/test_torch_ntt.py, with each block's slice of the
twiddle heap), and the inverse's gather; emulate_fused_large replays K4's
cluster kernel the same way on four operands, with Montgomery products and
the 2^32 in the final scale.  Each is held to the plain version and to the
JAX package (the radix-2 NTT; K4 as the Pallas kernel in interpret mode, or
at n = 65536 through the plain version, which test_torch_large_n.py holds
to JAX's NTT and dyadic product)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import troy_tpu.ops.ntt as JNTT
from troy_tpu.ops.fused_mul import fused_negacyclic_multiply as jax_fused
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import fused_mul as FM, fused_mul_cuda, ntt as NTT, ntt_cuda
from troy_tpu_torch.ops.ntt64 import NTT64Tables
from troy_tpu_torch.core.coeff_modulus import CoeffModulus
from troy_tpu_torch.utils.timer import reset_launch_counts

from .test_torch_ntt import U32, emulate_phases, jax_packs, residues, run_levels, shoup_lazy

RNG = np.random.default_rng(1 << 16)
H100_SMEM_PER_CTA = 232448  # bytes of dynamic shared memory a CTA may opt into


def tables(log_n, L, split=None):
    primes = numth.get_primes(2 << log_n, 30, L)
    return primes, NTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu", split)


def pad(i):
    """csrc/ntt_phases.cuh:pad, one word of padding every 32 values."""
    return i + (i >> 5)


def data_words(log_b):
    n = 1 << log_b
    return (n + (n >> 5) + 3) & ~3


def cluster_columns(t, rank):
    """The columns CTA `rank` runs, thread i column i: [rank n2 / C,
    (rank + 1) n2 / C)."""
    c, n2 = 1 << t.split, 1 << t.block_log_n
    return rank * (n2 // c) + torch.arange(n2 // c)


def column_twiddles(t, inverse, rows):
    """(rows, 1, C, 2) column slots (w, w') of each row's limb."""
    c = 1 << t.split
    limb = torch.arange(rows) % t.size
    table = (t.column_phases.to(torch.int64) & U32)[int(inverse)][limb]
    return table.view(rows, 1, c, 2)


def column_values(x, t, cols):
    """(rows, len(cols), C): value e of each column j, x[e n2 + j]."""
    c, n2 = 1 << t.split, 1 << t.block_log_n
    return x[:, torch.arange(c)[None] * n2 + cols[:, None]]


def forward_columns(x, t, smem, word=0):
    """The forward half before the cluster barrier: every CTA's columns
    loaded (x: (rows, n) lazy residues), their column stages, and value e of
    column j written into CTA e's shared memory (smem: (rows, C, words)) at
    word + pad(j).  Returns the write count of every word."""
    rows, c = x.shape[0], 1 << t.split
    q = t.q[torch.arange(rows) % t.size]
    tw = column_twiddles(t, False, rows)
    writes = torch.zeros(smem.shape[1:], dtype=torch.int64)
    for rank in range(c):
        cols = cluster_columns(t, rank)
        v = run_levels(column_values(x, t, cols), tw.expand(rows, len(cols), c, 2),
                       None, q, t.split, False, t.split)
        for e in range(c):
            smem[:, e, word + pad(cols)] = v[:, :, e]
            writes[e, word + pad(cols)] += 1
    return writes


def inverse_columns(smem, t, n_inv, n_inv_sh, word=0):
    """The inverse half after the cluster barrier: each CTA's columns
    gathered from the blocks at word + pad(j), their column stages, the
    scale (n_inv, its Shoup companion, per row) into [0, q).  Returns
    (rows, n)."""
    rows, c, n2 = smem.shape[0], 1 << t.split, 1 << t.block_log_n
    q = t.q[torch.arange(rows) % t.size]
    tw = column_twiddles(t, True, rows)
    out = torch.full((rows, c * n2), -1, dtype=torch.int64)
    q2 = q.view(rows, 1, 1)
    for rank in range(c):
        cols = cluster_columns(t, rank)
        v = torch.stack([smem[:, e, word + pad(cols)] for e in range(c)], dim=-1)
        v = run_levels(v, tw.expand(rows, len(cols), c, 2), None, q, t.split, True, t.split)
        v = shoup_lazy(v, n_inv.view(rows, 1, 1), n_inv_sh.view(rows, 1, 1), q2)
        out[:, torch.arange(c)[None] * n2 + cols[:, None]] = torch.where(v >= q2, v - q2, v)
    assert (out >= 0).all()  # every value stored once
    return out


def blocks_of(smem, t, word=0):
    """(rows C, n2): each CTA's block read from its padded shared memory."""
    n2 = 1 << t.block_log_n
    return smem[:, :, word + pad(torch.arange(n2))].reshape(-1, n2).clone()


def to_smem(blocks, t, smem, word=0):
    rows = smem.shape[0]
    n2 = 1 << t.block_log_n
    smem[:, :, word + pad(torch.arange(n2))] = blocks.view(rows, 1 << t.split, n2)


def emulate_cluster(x, t, inverse):
    """csrc/ntt.cu:ntt_cluster_kernel on (..., L, n) residues in [0, 2q)."""
    c, log_b = 1 << t.split, t.block_log_n
    rows_x = x.reshape(-1, t.n)
    rows = rows_x.shape[0]
    limb = torch.arange(rows) % t.size
    q = t.q[limb].view(rows, 1)
    smem = torch.full((rows, c, data_words(log_b)), -1, dtype=torch.int64)
    if not inverse:
        writes = forward_columns(rows_x, t, smem)
        assert torch.equal(writes[:, pad(torch.arange(1 << log_b))], torch.ones(c, 1 << log_b,
                                                                                dtype=torch.int64))
        assert writes.sum() == t.n  # and no padding word
        s = emulate_phases(blocks_of(smem, t), t, False).view(rows, t.n)
        s = torch.where(s >= 2 * q, s - 2 * q, s)
        return torch.where(s >= q, s - q, s).view(x.shape)
    # the inverse: each CTA's block loaded, its phases unscaled, then gathered
    to_smem(emulate_phases(rows_x.reshape(-1, 1 << log_b).clone(), t, True), t, smem)
    n_inv = t.n_inv[limb]
    return inverse_columns(smem, t, n_inv, (n_inv << 32) // t.q[limb]).view(x.shape)


def mont_redc(v, q, q_inv_neg):
    """csrc/ntt_phases.cuh:mont_redc in int64: v 2^-32 mod q in [0, 2q) for
    v < q 2^32 (below 2^62 here, so v + m q fits)."""
    m = ((v & U32) * q_inv_neg) & U32
    return (v + m * q) >> 32


def reduce_from_4q(v, q):
    v = torch.where(v >= 2 * q, v - 2 * q, v)
    return torch.where(v >= q, v - q, v)


def emulate_fused_large(a, b, t):
    """csrc/fused_mul_large.cu on a, b (B, 2, L, n) in [0, 2q): per (batch,
    limb) cluster, the four operands' column stages scattered into their
    blocks (operand o at word o * words of every CTA), the forward block
    phases, the products by Montgomery REDC in place over a0, a1, b0, the
    inverse block phases of the three, the gather, the inverse column stages
    and the scale n^-1 2^32 (kernel_scalars rows 4, 5)."""
    c, log_b = 1 << t.split, t.block_log_n
    words = data_words(log_b)
    lead = a.shape[:-3]
    ops = [v.reshape(-1, t.size, t.n) for v in (a[..., 0, :, :], a[..., 1, :, :],
                                                 b[..., 0, :, :], b[..., 1, :, :])]
    cells = ops[0].shape[0] * t.size
    limb = torch.arange(cells) % t.size
    q = t.q[limb].view(cells, 1)
    scal = t.kernel_scalars.to(torch.int64) & U32
    smem = torch.full((cells, c, 4 * words), -1, dtype=torch.int64)
    for o, v in enumerate(ops):
        forward_columns(v.reshape(cells, t.n), t, smem, o * words)
    fwd = [emulate_phases(blocks_of(smem, t, o * words), t, False).view(cells, t.n)
           for o in range(4)]
    a0, a1, b0, b1 = (reduce_from_4q(v, q) for v in fwd)
    qin = scal[3][limb].view(cells, 1)
    prods = [mont_redc(a0 * b0, q, qin), mont_redc(a0 * b1 + a1 * b0, q, qin),
             mont_redc(a1 * b1, q, qin)]
    for p, v in enumerate(prods):
        assert (v < 2 * q).all()
        to_smem(emulate_phases(v.reshape(-1, 1 << log_b).clone(), t, True), t, smem, p * words)
    out = [inverse_columns(smem, t, scal[4][limb], scal[5][limb], p * words)
           for p in range(3)]
    return torch.stack([v.view(*lead, t.size, t.n) for v in out], dim=-3)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n,split,L,lead", [
    (8, 1, 2, (2,)), (9, 2, 2, (1,)), (10, 3, 1, (2,)), (11, 4, 2, (1,)),
    (16, None, 1, (1,)), (17, None, 1, (1,))])
def test_cluster_schedule_matches_plain_and_jax(log_n, split, L, lead):
    """The cluster kernel's schedule on lazy [0, 2q) input equals the plain
    transform and the JAX radix-2 NTT, forward and inverse, at every cluster
    size and at the real degrees (their default clusters)."""
    n = 1 << log_n
    primes, tt = tables(log_n, L, split)
    assert (1 << tt.split) in NTT.CLUSTER_SIZES
    radix2 = jax_packs(log_n, primes, pallas=False)["radix2"]
    lazy = torch.from_numpy(residues((*lead, L, n), primes, factor=2).astype(np.int64))
    canon = lazy % tt.q.view(L, 1)
    fwd = emulate_cluster(lazy, tt, inverse=False)
    assert torch.equal(fwd, NTT.ntt_forward_plain(lazy, tt))
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_forward(jnp.asarray(lazy.numpy().astype(np.uint32)), radix2)),
        fwd.numpy())
    inv = emulate_cluster(lazy, tt, inverse=True)
    assert torch.equal(inv, NTT.ntt_inverse_plain(canon, tt))
    np.testing.assert_array_equal(
        np.asarray(JNTT.ntt_inverse(jnp.asarray(canon.numpy().astype(np.uint32)), radix2)),
        inv.numpy())
    assert torch.equal(emulate_cluster(fwd, tt, inverse=True), canon)


@pytest.mark.parametrize("log_n,split", [(9, 1), (10, 2), (12, 3), (13, 4), (16, 4), (17, 4),
                                         (16, 2)])
def test_cluster_index_maps(log_n, split):
    """The CTAs of a cluster share the columns out, every column once; from
    32 columns a CTA up, a warp's 32 columns start at a multiple of 32, so
    their values in each block are 32 neighbouring shared words (one
    128-byte run, no padding word inside); the values of block e fill CTA
    e's padded block exactly, and the padding words stay free."""
    _, tt = tables(log_n, 1, split)
    c, n2 = 1 << split, 1 << tt.block_log_n
    js = torch.cat([cluster_columns(tt, r) for r in range(c)])
    assert torch.equal(js, torch.arange(n2))
    if n2 // c >= 32:
        warps = pad(js).view(-1, 32)
        assert torch.equal(warps - warps[:, :1], torch.arange(32).expand_as(warps))
    slots = pad(torch.arange(n2))
    assert len(set(slots.tolist())) == n2 and int(slots.max()) < data_words(tt.block_log_n)
    x = torch.arange(c * n2, dtype=torch.int64)[None] % tt.q[0]
    smem = torch.full((1, c, data_words(tt.block_log_n)), -1, dtype=torch.int64)
    writes = forward_columns(x, tt, smem)
    assert writes.sum() == c * n2 and int(writes.max()) == 1
    free = torch.ones(data_words(tt.block_log_n), dtype=torch.bool)
    free[slots] = False
    assert (smem[:, :, free] == -1).all()


@functools.lru_cache(maxsize=None)
def jax_fused_case(log_n, L=2, lead=(2,)):
    """Operands in [0, 2q) and the JAX Pallas K4's product (interpret mode),
    once per degree: the product does not depend on the cluster size."""
    primes = numth.get_primes(2 << log_n, 30, L)
    q = np.array(primes, dtype=np.uint32)[:, None]
    a, b = [(RNG.integers(0, 1 << 31, size=(*lead, 2, L, 1 << log_n)).astype(np.uint32)
             % (2 * q)) for _ in range(2)]
    jtabs = JNTT.NTTTables(log_n, [JModulus(p) for p in primes])
    pack = dict(jtabs.pack())
    if "ss_Ti" not in pack:
        pack.update(jtabs._sixstep_pack())
    want = np.asarray(jax_fused(jnp.asarray(a), jnp.asarray(b), pack))
    return primes, a, b, want


@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_fused_large_schedule_matches_plain_and_jax_kernel(split):
    """K4's cluster kernel, replayed at n = 512 with every cluster size,
    equals the plain version and the JAX Pallas K4 in interpret mode."""
    log_n = 9
    primes, a, b, want = jax_fused_case(log_n)
    tt = NTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu", split)
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    got = emulate_fused_large(ta, tb, tt)
    assert torch.equal(got, FM.fused_negacyclic_multiply_plain(ta, tb, tt))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("log_n,split", fused_mul_cuda.LARGE_SHAPES)
def test_fused_large_at_its_shapes(log_n, split):
    """At each shape the large kernel is built for (n = 65536 and 131072 in
    clusters of 16), one limb: the replay equals the plain version, and a
    CTA's shared memory (four padded blocks, both tables) fits the H100's."""
    primes, tt = tables(log_n, 1, split)
    a, b = (torch.from_numpy(residues((1, 2, 1, 1 << log_n), primes, factor=2).astype(np.int64))
            for _ in range(2))
    assert torch.equal(emulate_fused_large(a, b, tt), FM.fused_negacyclic_multiply_plain(a, b, tt))
    smem = fused_mul_cuda.large_shared_bytes(tt.block_log_n)
    assert smem == 16 * data_words(tt.block_log_n) + 16 * tt.entries <= H100_SMEM_PER_CTA
    assert fused_mul_cuda.large_shared_bytes(14) > H100_SMEM_PER_CTA  # 131072 in 8 blocks


def test_montgomery_products_and_scale():
    """mont_redc(v) = v 2^-32 mod q in [0, 2q) at the products' extremes,
    and the final scale n^-1 2^32 (kernel_scalars rows 4, 5) undoes the
    2^-32 of a product: the large kernel's scalars are the full degree's."""
    log_n, L = 16, 3
    _, tt = tables(log_n, L)
    scal = tt.kernel_scalars.to(torch.int64) & U32
    q = tt.q
    for v in (torch.zeros(L, dtype=torch.int64), (q - 1) ** 2, 2 * (q - 1) ** 2,
              torch.from_numpy(RNG.integers(0, 1 << 60, size=L)) % (2 * q * q)):
        r = mont_redc(v, q, scal[3])
        assert (r < 2 * q).all()
        assert torch.equal(r % q, torch.tensor([int(x) * pow(2, -32, int(p)) % int(p)
                                                for x, p in zip(v, q)]))
    for limb, p in enumerate(q.tolist()):
        assert int(scal[4][limb]) == pow(1 << log_n, -1, p) * (1 << 32) % p
        assert int(scal[5][limb]) == (int(scal[4][limb]) << 32) // p
        assert int(scal[0][limb]) * int(scal[3][limb]) % (1 << 32) == (1 << 32) - 1


def test_cluster_wrappers_refuse():
    """The cluster wrappers launch or raise: a cluster size outside
    {2, 4, 8, 16} (a split of 5), blocks of under two columns a CTA,
    a K4 shape the large kernel is not built for, a CPU tensor, a wide
    table and n above 131072 each raise, and nothing is counted."""
    reset_launch_counts()
    cases = {
        "cluster of 32": (tables(17, 1, split=5)[1], "cluster of 32"),
        "under two columns a CTA": (tables(4, 1, split=2)[1], "fewer than two columns"),
        "CPU tensor": (tables(16, 1)[1], "CUDA tensor"),
        "n above 131072": (tables(18, 1)[1], "CUDA tensor|power of two"),
    }
    for what, (tt, match) in cases.items():
        x = torch.zeros(1, 1, tt.n, dtype=torch.int64)
        for fn in (ntt_cuda.ntt_forward, ntt_cuda.ntt_inverse):
            with pytest.raises(ValueError, match=match):
                fn(x, tt)
        ab = torch.zeros(1, 2, 1, tt.n, dtype=torch.int64)
        with pytest.raises(ValueError, match="cluster of 32|fewer than two columns|large kernel|CUDA"):
            fused_mul_cuda.fused_negacyclic_multiply(ab, ab, tt)
    _, t17 = tables(17, 1, split=3)  # 8 blocks of 16384: four operands do not fit a CTA
    ab = torch.zeros(1, 2, 1, t17.n, dtype=torch.int64)
    with pytest.raises(ValueError, match="large kernel"):
        fused_mul_cuda.fused_negacyclic_multiply(ab, ab, t17)
    wide = NTT64Tables(10, CoeffModulus.create(1 << 10, [60, 40]), "cpu")
    xw = torch.zeros(1, 2, 1 << 10, dtype=torch.int64)
    with pytest.raises(ValueError, match="wide"):
        ntt_cuda.ntt_forward(xw, wide)
    aw = xw[None].expand(1, 2, 2, 1 << 10).contiguous()
    with pytest.raises(ValueError, match="wide"):
        fused_mul_cuda.fused_negacyclic_multiply(aw, aw, wide)
    assert set(ntt_cuda.LAUNCHES.values()) == {0}
    assert set(fused_mul_cuda.LAUNCHES.values()) == {0}


def test_default_cluster_route():
    """Above 32768 the tables' default split is a cluster size of the
    route, with blocks that fit a CTA; n = 65536 and 131072 both get K4's
    large kernel at the default split."""
    for log_n in (16, 17):
        split = NTT.default_split(log_n)
        assert split == NTT.CLUSTER_SPLIT[log_n] and (1 << split) in NTT.CLUSTER_SIZES
        assert log_n - split <= NTT.BLOCK_MAX_LOG_N
        assert (log_n, split) in fused_mul_cuda.LARGE_SHAPES

"""Modular arithmetic for the wide path: residues of primes in (2^30, 2^61).

Counterpart of troy_tpu/ops/u64.py.  The JAX package holds a wide residue as
a (hi, lo) pair of u32 lanes and builds the 128-bit product from four 32x32
products, because the TPU has no 64-bit integer lanes.  PyTorch has int64 on
both the CPU and the GPU, so here a wide residue is one int64 word in
[0, q), q < 2^61, in the same (..., L, n) layout as the fast path.  Sums of
two residues fit (2q < 2^62), so add/sub/neg/compare are plain int64.

Products need 122 bits.  They are built from 31-bit halves, whose partial
products fit int64, and kept as a pair (hi, lo) with value hi * 2^62 + lo,
lo < 2^62 (mul64_wide).  Reductions are exact:

  * Barrett (barrett_reduce_u128, mul_mod64): for q with s = bit_length(q),
    m = floor(2^(s+61) / q) < 2^62 and any P < 2^(s+61) (every product of
    two residues), Qh = floor(floor(P / 2^(s-1)) m / 2^62) is at most 3 below
    floor(P / q), so P - Qh q < 4q < 2^63, then one `%`;
  * Shoup (shoup_mul64): w' = floor(w 2^62 / q) for a constant w < q; for
    x < 2^62, x w - floor(x w' / 2^62) q lies in [0, 2q), so its low 62 bits
    are the whole value.

Outputs are canonical residues, so they equal the JAX package's bit for bit
whatever the method.  The JAX names that describe (hi, lo) u32 pairs keep
their meaning on values here: add64/sub64/geq64 are int64 ops on words below
2^62, the mul64_* functions return the 62-bit split, and words / pack64 /
unpack64 / barrett_ratio_u128 / shoup_word64 are the same host helpers (the
interop and serialize boundaries use pack64 / unpack64).  mul64_wide_k, a
measured negative on the TPU, is not ported.

Constants travel as a Barrett tuple (q, s - 1, m) of tensors or ints that
broadcast against the data (barrett_consts).
"""

from __future__ import annotations

import numpy as np
import torch

M31 = (1 << 31) - 1
M62 = (1 << 62) - 1
_M32 = (1 << 32) - 1
WIDE_BOUND = 1 << 61  # every wide prime is below this


# ---------------------------------------------------------------------------
# Host-side constant helpers (as in the JAX package)
# ---------------------------------------------------------------------------

def words(x: int, n: int = 2) -> tuple:
    """Split a python int into n little-endian u32 numpy-scalar words."""
    return tuple(np.uint32((x >> (32 * i)) & _M32) for i in range(n))


def barrett_ratio_u128(q: int) -> tuple:
    """floor(2^128 / q) as four u32 words (lo64 first), q < 2^62."""
    return words((1 << 128) // q, 4)


def shoup_word64(w: int, q: int) -> tuple:
    """floor(w * 2^64 / q) as two u32 words, for w < q < 2^62."""
    return words((w << 64) // q, 2)


def pack64(a) -> tuple:
    """numpy uint64/object array -> (hi, lo) u32 arrays (host side)."""
    a = np.asarray(a, dtype=np.uint64)
    return (a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32)


def unpack64(hi, lo):
    """(hi, lo) u32 arrays -> numpy uint64 array (host side)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)


def shoup62(w: int, q: int) -> int:
    """The port's Shoup companion floor(w * 2^62 / q) of a constant w < q."""
    return (w << 62) // q


def barrett_consts(values, device=None, shape=(-1, 1)) -> tuple:
    """(q, s - 1, floor(2^(s+61) / q)) for each q < 2^61, as int64 tensors of
    `shape` (an (L, 1) column by default) on device."""
    vals = [int(v) for v in values]
    for v in vals:
        if not 2 <= v < WIDE_BOUND:
            raise ValueError(f"[u64] modulus {v} outside [2, 2^61)")
    sh = [v.bit_length() - 1 for v in vals]
    m = [(1 << (s + 62)) // v for s, v in zip(sh, vals)]

    def col(x):
        return torch.tensor(x, dtype=torch.int64, device=device).reshape(shape)
    return col(vals), col(sh), col(m)


# ---------------------------------------------------------------------------
# 64-bit integer primitives (values below 2^62 in int64 words)
# ---------------------------------------------------------------------------

def add64c(a, b):
    """a + b split at bit 62: (sum mod 2^62, carry)."""
    s = a + b
    return s & M62, s >> 62


def add64(a, b):
    return a + b


def sub64(a, b):
    return a - b


def geq64(a, b):
    return a >= b


def mul64_wide(a, b):
    """a * b for 0 <= a, b < 2^62 as (hi, lo): a*b = hi 2^62 + lo, lo < 2^62.
    Four products of 31-bit halves, each below 2^62; the middle sum is
    below 2^63."""
    a0, a1 = a & M31, a >> 31
    b0, b1 = b & M31, b >> 31
    p1 = a0 * b1 + a1 * b0
    t = a0 * b0 + ((p1 & M31) << 31)
    return a1 * b1 + (p1 >> 31) + (t >> 62), t & M62


def mul64_hi(a, b):
    """floor(a * b / 2^62) for 0 <= a, b < 2^62."""
    return mul64_wide(a, b)[0]


def mul64_lo(a, b):
    """a * b mod 2^62 for 0 <= a, b < 2^62 (three products)."""
    a0, a1 = a & M31, a >> 31
    b0, b1 = b & M31, b >> 31
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & M31) << 31)) & M62


def add128(a, b):
    """Sum of two (hi, lo) pairs, renormalised to lo < 2^62."""
    lo = a[1] + b[1]
    return a[0] + b[0] + (lo >> 62), lo & M62


# ---------------------------------------------------------------------------
# Modular add/sub/neg for q < 2^61
# ---------------------------------------------------------------------------

def cond_sub64(x, q):
    """x - q if x >= q else x."""
    return torch.where(x >= q, x - q, x)


def add_mod64(a, b, q):
    return cond_sub64(a + b, q)


def sub_mod64(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def neg_mod64(a, q):
    return torch.where(a == 0, a, q - a)


def div2_mod64(a, q):
    """a / 2 mod q for odd q."""
    return torch.where((a & 1) == 1, (a >> 1) + ((q + 1) >> 1), a >> 1)


# ---------------------------------------------------------------------------
# Barrett reduction of a 124-bit value, products mod q
# ---------------------------------------------------------------------------

def barrett_reduce_u128(hi, lo, k):
    """(hi 2^62 + lo) mod q for a value below 2^(s+61), s = bit_length(q):
    k = (q, s - 1, m) from barrett_consts."""
    q, s1, m = k
    q1 = (hi << (62 - s1)) + (lo >> s1)            # floor(P / 2^(s-1)) < 2^62
    qh = mul64_hi(q1, m)                           # floor(P / q) - {0..3}
    h4, l4 = mul64_wide(qh, q)
    e = lo - l4
    neg = e < 0
    r = ((hi - h4 - neg.to(hi.dtype)) << 62) + torch.where(neg, e + (1 << 62), e)
    return torch.remainder(r, q)


def barrett_reduce_u64(a, k):
    """a mod q for a non-negative int64 a."""
    return torch.remainder(a, k[0])


def mul_mod64(a, b, k):
    """a * b mod q for residues a, b < q < 2^61."""
    return barrett_reduce_u128(*mul64_wide(a, b), k)


# ---------------------------------------------------------------------------
# Shoup multiplication by a precomputed constant
# ---------------------------------------------------------------------------

def shoup_mul64_lazy(x, w, ws, q):
    """x * w mod q in [0, 2q) for w < q < 2^61, ws = floor(w 2^62 / q), any
    0 <= x < 2^62."""
    qt = mul64_hi(x, ws)
    return (mul64_lo(x, w) - mul64_lo(qt, q)) & M62


def shoup_mul64(x, w, ws, q):
    """x * w mod q in [0, q)."""
    return cond_sub64(shoup_mul64_lazy(x, w, ws, q), q)


# ---------------------------------------------------------------------------
# Sums of products: the keyswitch and base-conversion dots
# ---------------------------------------------------------------------------

def dot_mod64_terms(q: int) -> int:
    """Products a_i b_i (a_i < q, b_i below the output modulus p) that one
    Barrett can take at once: k a_max p < 2^(bit_length(p)+61) holds for
    k = floor(2^61 / q), capped at 16.  Pass q = the largest modulus either
    factor is reduced by."""
    return max(1, min(16, (1 << 61) // q))


def dot_mod64(pairs, k, max_terms: int):
    """sum_i a_i * b_i mod q for a list of (a, b) residue pairs below q: the
    (hi, lo) sums of at most max_terms products (dot_mod64_terms of the
    largest modulus of a stacked limb axis), one Barrett per chunk."""
    q = k[0]
    total = None
    for start in range(0, len(pairs), max_terms):
        acc = None
        for a, b in pairs[start:start + max_terms]:
            p = mul64_wide(a, b)
            acc = p if acc is None else add128(acc, p)
        part = barrett_reduce_u128(*acc, k)
        total = part if total is None else add_mod64(total, part, q)
    return total

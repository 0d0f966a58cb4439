"""Modular arithmetic on int64 residue tensors — the port's scalar core.

Counterpart of troy_tpu/ops/u32.py.  The JAX package keeps residues in u32
lanes and builds every wide product from 16-bit limb multiplies, because the
TPU has no 64-bit integer multiplier.  PyTorch has 64-bit integer tensors on
both the CPU and the GPU (it has no u32 arithmetic), so here a residue is an
int64 in [0, q) with q < 2^30 (core/modulus.py fast path), and the product of
two residues (< 2^60) is exact.  Barrett and Shoup reductions become `%`; the
results are the same canonical residues, so outputs match the JAX package bit
for bit.

Every function is elementwise and broadcasts: moduli are (L, 1) columns
against (..., L, n) data.  Nothing produces a negative value: `%` on a
negative int64 would be correct with torch.remainder but not with fmod, so
subtraction adds q first instead.
"""

from __future__ import annotations

import torch

# 7 * (2^30 - 1)^2 < 2^63: a signed 64-bit accumulator holds 7 products of
# residues exactly (the JAX u32-pair accumulator holds 16, ops/u32.py:159).
DOT_MAX_TERMS = 7


def dot_terms(a_bound: int, b_bound: int) -> int:
    """Products a b with a < a_bound, b < b_bound that an int64 sum holds:
    k (a_bound - 1)(b_bound - 1) < 2^63, at most DOT_MAX_TERMS: 7 for two
    30-bit residues, 4 for a 30-bit residue times a value below 2^31
    (ring2k's t = 2^31), where 7 would pass 2^63."""
    return max(1, min(DOT_MAX_TERMS, ((1 << 63) - 1) // ((a_bound - 1) * (b_bound - 1))))


def cond_sub(x: torch.Tensor, q) -> torch.Tensor:
    """x - q if x >= q else x (single conditional subtraction)."""
    return torch.where(x >= q, x - q, x)


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a + b) mod q for a, b in [0, q)."""
    return cond_sub(a + b, q)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a - b) mod q for a, b in [0, q)."""
    return torch.where(a >= b, a - b, a + q - b)


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    """(-a) mod q for a in [0, q)."""
    return torch.where(a == 0, a, q - a)


def mul_mod(a: torch.Tensor, b, q) -> torch.Tensor:
    """a * b mod q, exact while a * b < 2^63 (any a < 2^32 lazy value times a
    residue below 2^30).  Takes the place of the JAX package's Barrett
    mul_mod and of its Shoup multiply by a constant: both return this same
    canonical residue."""
    return a * b % q


def barrett_reduce(z: torch.Tensor, q) -> torch.Tensor:
    """z mod q for any non-negative int64 z (JAX: barrett_reduce_u32/_u64)."""
    return z % q


def dot_mod(pairs, q, max_terms: int = DOT_MAX_TERMS) -> torch.Tensor:
    """sum_i a_i * b_i mod q for a list of (a, b) tensor pairs: exact int64
    sums of at most max_terms products, one reduction per chunk.  The
    default holds residues below 2^30; dot_terms sizes it for wider
    factors."""
    total = None
    for start in range(0, len(pairs), max_terms):
        acc = None
        for a, b in pairs[start:start + max_terms]:
            acc = a * b if acc is None else acc + a * b
        part = acc % q
        total = part if total is None else add_mod(total, part, q)
    return total

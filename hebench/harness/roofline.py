"""Peaks of one NVIDIA H100 SXM and the least time of a negacyclic NTT.

A frozen copy of chip_smoke.py's bound_us / ntt_bound (MEM_BYTES_PER_S,
INT32_OPS_PER_S, NTT_BUTTERFLY_OPS), plus the count at the wide path's word
width.  The bound of a transform is the larger of its bytes (each input and
each output value once, 8 bytes an int64 residue) over the memory rate and
its operations (the n/2 log2 n butterflies of each polynomial) over the
int32 rate.  It counts the transform's work, not the method's: torch passes
and a kernel that compute one transform have one bound.

Operations of a butterfly: 8 int32 operations at the fast path's 30-bit
words (a Shoup product 3, two adds, two conditional subtracts, one more);
at the wide path's 40-60-bit words each of those 8 is an operation on two
32-bit words, which costs 4 int32 operations (a 64-bit product is four
32-bit partial products; an add, a compare or a select two words with a
carry): 32 a butterfly.
"""

from __future__ import annotations

import math

MEM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock
NTT_BUTTERFLY_OPS = 8                 # a butterfly at 30-bit words
WIDE_WORD_FACTOR = 4                  # int32 operations an operation at 64-bit words


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def ntt_bound_s(shape, wide: bool) -> float:
    """Least seconds of one transform of an int64 tensor (..., n)."""
    polys, n = math.prod(shape[:-1]), shape[-1]
    per_butterfly = NTT_BUTTERFLY_OPS * (WIDE_WORD_FACTOR if wide else 1)
    return bound_s(2 * polys * n * 8, polys * (n // 2) * (n.bit_length() - 1) * per_butterfly)

"""Coefficient / plain modulus factories and HE-standard security tables.

Copy of troy_tpu/core/coeff_modulus.py, so that the PyTorch port imports nothing of
the JAX package.  TPU-native rebuild of reference src/coeff_modulus.{h,cu} +
src/utils/he_standard_params.h.  The security tables are the public
HomomorphicEncryption.org standard maximum log2(q) bounds for classical
128/192/256-bit security.

TPU note: the fast path requires 29/30-bit primes (core/modulus.py), so where
the reference defaults to 36..60-bit primes, `create` accepts only bit sizes
in {29, 30} and callers express a budget as more, smaller primes (e.g. a
reference {60,40,40,60} ~ 200-bit budget becomes seven 29/30-bit primes).
"""

from __future__ import annotations

import enum

from .modulus import Modulus
from ..utils import numth


class SecurityLevel(enum.IntEnum):
    """ref: encryption_parameters.h:249"""

    Nil = 0
    Classical128 = 128
    Classical192 = 192
    Classical256 = 256


# HE standard v1.1 tables: n -> max total log2(q) bits
# (ref: he_standard_params.h:6-40)
_MAX_BITS = {
    SecurityLevel.Classical128: {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881},
    SecurityLevel.Classical192: {1024: 19, 2048: 37, 4096: 75, 8192: 152, 16384: 305, 32768: 611},
    SecurityLevel.Classical256: {1024: 14, 2048: 29, 4096: 58, 8192: 118, 16384: 237, 32768: 476},
}

FAST_PATH_BIT_SIZES = (29, 30)
WIDE_PATH_BIT_SIZES = tuple(range(31, 61))


class CoeffModulus:
    @staticmethod
    def max_bit_count(poly_modulus_degree: int,
                      sec: SecurityLevel = SecurityLevel.Classical128) -> int:
        """ref: coeff_modulus.h max_bit_count"""
        if sec == SecurityLevel.Nil:
            return 2 ** 31
        table = _MAX_BITS[sec]
        if poly_modulus_degree not in table:
            return 0
        return table[poly_modulus_degree]

    @staticmethod
    def create(poly_modulus_degree: int, bit_sizes: list[int]) -> list[Modulus]:
        """Distinct NTT primes (≡ 1 mod 2n) of the given bit sizes
        (ref: coeff_modulus.cu create).  Two residue widths are supported
        through one API: all sizes in {29, 30} select the u32 fast path
        (fastest on TPU); all sizes in 31..60 select the wide u32-pair path
        (the reference's native SEAL-default widths, e.g. {60, 40, 40, 60}).
        Mixing the two ranges in one set is rejected — the whole chain runs
        at a single width."""
        fast = all(b in FAST_PATH_BIT_SIZES for b in bit_sizes)
        wide = all(b in WIDE_PATH_BIT_SIZES for b in bit_sizes)
        if not (fast or wide):
            raise ValueError(
                f"[CoeffModulus.create] bit sizes {bit_sizes} invalid: use "
                f"either all in {FAST_PATH_BIT_SIZES} (u32 fast path) or all "
                "in 31..60 (wide path); the two widths cannot mix"
            )
        out: list[Modulus] = []
        by_size: dict[int, int] = {}
        for b in bit_sizes:
            by_size[b] = by_size.get(b, 0) + 1
        found: dict[int, list[int]] = {
            b: numth.get_primes(2 * poly_modulus_degree, b, c) for b, c in by_size.items()
        }
        for b in bit_sizes:
            out.append(Modulus(found[b].pop(0)))
        return out

    @staticmethod
    def bfv_default(poly_modulus_degree: int,
                    sec: SecurityLevel = SecurityLevel.Classical128) -> list[Modulus]:
        """A sensible default chain filling ~the security budget with 30-bit
        primes, leaving one as the special prime (ref: coeff_modulus.cu
        bfv_default, re-tuned for 30-bit limbs)."""
        budget = CoeffModulus.max_bit_count(poly_modulus_degree, sec)
        if budget <= 0:
            raise ValueError("[CoeffModulus.bfv_default] degree not in security table")
        count = max(1, budget // 30)
        return CoeffModulus.create(poly_modulus_degree, [30] * count)


class PlainModulus:
    @staticmethod
    def batching(poly_modulus_degree: int, bit_size: int) -> Modulus:
        """Smallest-ish prime ≡ 1 mod 2n of given bit size enabling SIMD
        batching (ref: coeff_modulus.h:42)."""
        if bit_size > 30:
            raise ValueError(
                "[PlainModulus.batching] plain modulus > 30 bits unsupported on "
                "the u32 fast path (use the ring2k encoder for wide plaintexts)"
            )
        return Modulus(numth.get_prime(2 * poly_modulus_degree, bit_size))

    @staticmethod
    def batching_multiple(poly_modulus_degree: int, bit_sizes: list[int]) -> list[Modulus]:
        by_size: dict[int, int] = {}
        for b in bit_sizes:
            by_size[b] = by_size.get(b, 0) + 1
        found = {
            b: numth.get_primes(2 * poly_modulus_degree, b, c) for b, c in by_size.items()
        }
        return [Modulus(found[b].pop(0)) for b in bit_sizes]

"""Modulus: a word-size prime modulus with precomputed reduction constants.

Copy of troy_tpu/core/modulus.py, so that the PyTorch port imports nothing of
the JAX package.  TPU-native rebuild of reference src/modulus.{h,cu} + src/utils/uint_small_mod.h.
The reference precomputes const_ratio = floor(2^128 / q) for 64-bit Barrett
reduction on CUDA.  TPUs have no 64-bit integer multiplier, so this build keeps
every device residue in a uint32 lane and constrains fast-path moduli to
[2^28, 2^30): then

  * Barrett:  ratio = floor(2^64 / q) split into two u32 words reduces any
    64-bit (hi, lo) u32-pair product exactly (see ops/u32.py),
  * Shoup:    w' = floor(w * 2^32 / q) fits u32 for any w < q,
  * Harvey lazy NTT values in [0, 4q) fit u32 since 4q < 2^32.

Host-side scalar helpers mirror uint_small_mod.h for setup and tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import numth

# Fast-path modulus bounds (see module docstring).
MOD_MIN = 1 << 28
MOD_MAX = 1 << 30


@dataclass(frozen=True)
class Modulus:
    """An integer modulus with precomputed Barrett constants.

    value        : the modulus q  (0 allowed = "unset", as in reference Modulus())
    ratio64      : floor(2^64 / q) -- (hi, lo) u32 words for device Barrett
    bit_count    : number of significant bits of q
    """

    value: int
    ratio64_hi: int = field(init=False)
    ratio64_lo: int = field(init=False)

    def __post_init__(self):
        q = self.value
        if q == 0:
            object.__setattr__(self, "ratio64_hi", 0)
            object.__setattr__(self, "ratio64_lo", 0)
            return
        if q < 2 or q >= (1 << 61):
            raise ValueError(f"[Modulus] value {q} out of range")
        ratio = (1 << 64) // q
        object.__setattr__(self, "ratio64_hi", (ratio >> 32) & 0xFFFFFFFF)
        object.__setattr__(self, "ratio64_lo", ratio & 0xFFFFFFFF)

    # -- properties mirroring reference Modulus API (modulus.h) ------------
    @property
    def bit_count(self) -> int:
        return self.value.bit_length()

    @property
    def is_zero(self) -> bool:
        return self.value == 0

    @property
    def is_prime(self) -> bool:
        return numth.is_prime(self.value)

    def fits_fast_path(self) -> bool:
        """True if this modulus fits the u32 fast path (see module docstring)."""
        return MOD_MIN < self.value < MOD_MAX

    def fits_wide_path(self) -> bool:
        """True if this modulus fits the wide (u32-pair) path: (2^30, 2^61).
        Matches the reference's native <=61-bit prime range (modulus.h); the
        lower bound keeps every wide prime above any plain modulus and makes
        the two paths disjoint."""
        return MOD_MAX < self.value < (1 << 61)

    # -- host-side scalar modular arithmetic (ref: uint_small_mod.h) -------
    def reduce(self, x: int) -> int:
        return x % self.value

    def shoup(self, w: int) -> int:
        """Shoup precomputed quotient floor(w * 2^32 / q); requires w < q
        (ref: MultiplyUint64Operand, uint_small_mod.h:92 — at 32-bit width)."""
        if not 0 <= w < self.value:
            raise ValueError("[Modulus.shoup] operand must be reduced")
        return (w << 32) // self.value

    def pow(self, base: int, exponent: int) -> int:
        return pow(base, exponent, self.value)

    def invert(self, x: int) -> int:
        return numth.invert_mod(x, self.value)


def make_moduli(values: list[int]) -> list[Modulus]:
    return [Modulus(v) for v in values]

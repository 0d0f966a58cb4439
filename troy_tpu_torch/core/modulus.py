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
    def is_prime(self) -> bool:
        return numth.is_prime(self.value)

    def fits_fast_path(self) -> bool:
        """True if this modulus fits the u32 fast path (see module docstring)."""
        return MOD_MIN < self.value < MOD_MAX

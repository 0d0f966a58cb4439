"""Ciphertext object (counterpart of troy_tpu/core/ciphertext.py).

data is one int64 tensor shaped (size, L, n): poly index, RNS limb,
coefficient.  Leading batch axes may stand in front, (..., size, L, n), as in
the batched LWE packer's (G, 2, L, n) stacks: size reads the poly axis from
the end.  BFV ciphertexts live in the coefficient domain, CKKS
ciphertexts in the NTT domain with their scale, BGV ciphertexts in the NTT
domain with their correction factor (the plaintext is m * cf^-1 mod t).

seed is the PRNG seed of a seed-compressed symmetric ciphertext (ref:
ciphertext.h:154-170): its c1 is uniform_from_seed(seed), regenerated when a
saved ciphertext is loaded (utils/serialize.py).  clone keeps it, like drops
it, and so does setting new data: an operation's result (the evaluator's
clone-and-set) no longer has the seed's c1, where the JAX package keeps the
stale seed and saves a ciphertext that loads wrong (ROADMAP §C).
"""

from __future__ import annotations

import torch

from .params import ParmsID, PARMS_ID_ZERO, WIDE_PARMS_IDS


class Ciphertext:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID = PARMS_ID_ZERO,
                 is_ntt_form: bool = False, scale: float = 1.0,
                 correction_factor: int = 1, seed: int | None = None):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self.correction_factor = correction_factor
        self.seed = seed

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, value: torch.Tensor):
        self._data = value
        self.seed = None

    @property
    def size(self) -> int:
        return self.data.shape[-3]

    @property
    def wide(self) -> bool:
        """True at a wide-path level (40-60-bit primes): one layout holds both
        widths, so this reads the level, not the shape."""
        return self.parms_id in WIDE_PARMS_IDS

    @property
    def coeff_modulus_size(self) -> int:
        return self.data.shape[-2]

    @property
    def poly_modulus_degree(self) -> int:
        return self.data.shape[-1]

    def poly(self, i: int) -> torch.Tensor:
        return self.data[..., i, :, :]

    @staticmethod
    def like(other: "Ciphertext", size: int | None = None) -> "Ciphertext":
        """other's metadata, without its seed, on zero data of `size` polys
        (ref: ciphertext.h:94)."""
        size = other.size if size is None else size
        shape = (*other.data.shape[:-3], size, *other.data.shape[-2:])
        return Ciphertext(other.data.new_zeros(shape), other.parms_id, other.is_ntt_form,
                          other.scale, other.correction_factor)

    def clone(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale,
                          self.correction_factor, self.seed)

    def __repr__(self):
        return (f"Ciphertext(shape={tuple(self.data.shape)}, ntt={self.is_ntt_form}, "
                f"scale={self.scale}, cf={self.correction_factor}, "
                f"parms={self.parms_id[:8]})")

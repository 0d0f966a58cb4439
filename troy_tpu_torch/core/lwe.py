"""LWE ciphertext object (counterpart of troy_tpu/core/lwe.py): an LWE
sample (c0, c1) extracted from one coefficient of an RLWE ciphertext, as
int64 residue tensors on the context's device.

c0: (L,) one scalar per RNS limb; c1: (L, n) the mask coefficients.
"""

from __future__ import annotations

import torch

from .params import ParmsID


class LWECiphertext:
    def __init__(self, c0: torch.Tensor, c1: torch.Tensor, parms_id: ParmsID,
                 scale: float = 1.0, correction_factor: int = 1):
        self.c0 = c0  # (L,)
        self.c1 = c1  # (L, n)
        self.parms_id = parms_id
        self.scale = scale
        self.correction_factor = correction_factor

    @property
    def coeff_modulus_size(self) -> int:
        return self.c1.shape[0]

    @property
    def poly_modulus_degree(self) -> int:
        return self.c1.shape[1]

    def clone(self) -> "LWECiphertext":
        return LWECiphertext(self.c0, self.c1, self.parms_id, self.scale,
                             self.correction_factor)

    def __repr__(self):
        return (f"LWECiphertext(L={self.coeff_modulus_size}, n={self.poly_modulus_degree}, "
                f"scale={self.scale}, cf={self.correction_factor}, "
                f"parms={self.parms_id[:8]})")

"""Ciphertext object (counterpart of troy_tpu/core/ciphertext.py).

data is one int64 tensor shaped (size, L, n): poly index, RNS limb,
coefficient.  Leading batch axes may stand in front, (..., size, L, n), as in
the batched LWE packer's (G, 2, L, n) stacks: size reads the poly axis from
the end.  BFV ciphertexts live in the coefficient domain, CKKS
ciphertexts in the NTT domain with their scale, BGV ciphertexts in the NTT
domain with their correction factor (the plaintext is m * cf^-1 mod t).
"""

from __future__ import annotations

import torch

from .params import ParmsID, PARMS_ID_ZERO


class Ciphertext:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID = PARMS_ID_ZERO,
                 is_ntt_form: bool = False, scale: float = 1.0,
                 correction_factor: int = 1):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self.correction_factor = correction_factor

    @property
    def size(self) -> int:
        return self.data.shape[-3]

    def clone(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form, self.scale,
                          self.correction_factor)

    def __repr__(self):
        return (f"Ciphertext(shape={tuple(self.data.shape)}, ntt={self.is_ntt_form}, "
                f"scale={self.scale}, cf={self.correction_factor}, "
                f"parms={self.parms_id[:8]})")

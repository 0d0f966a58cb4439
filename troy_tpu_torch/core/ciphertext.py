"""Ciphertext object (counterpart of troy_tpu/core/ciphertext.py).

data is one int64 tensor shaped (size, L, n): poly index, RNS limb,
coefficient.  BFV ciphertexts live in the coefficient domain.
"""

from __future__ import annotations

import torch

from .params import ParmsID, PARMS_ID_ZERO


class Ciphertext:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID = PARMS_ID_ZERO,
                 is_ntt_form: bool = False):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form

    @property
    def size(self) -> int:
        return self.data.shape[0]

    def clone(self) -> "Ciphertext":
        return Ciphertext(self.data, self.parms_id, self.is_ntt_form)

    def __repr__(self):
        return (f"Ciphertext(shape={tuple(self.data.shape)}, "
                f"ntt={self.is_ntt_form}, parms={self.parms_id[:8]})")

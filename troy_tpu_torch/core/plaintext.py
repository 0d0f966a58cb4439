"""Plaintext object (counterpart of troy_tpu/core/plaintext.py).

data is an int64 tensor shaped (1, n) for a BFV mod-t plaintext in
coefficient form, or (L, n) residues at a level (a CKKS plaintext, in NTT
form, or a BFV plaintext in RNS form).  scale is the CKKS scale (1.0
otherwise); coeff_count is the number of coefficients an encoder set (n
unless given).
"""

from __future__ import annotations

import torch

from .params import ParmsID, PARMS_ID_ZERO


class Plaintext:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID = PARMS_ID_ZERO,
                 is_ntt_form: bool = False, scale: float = 1.0,
                 coeff_count: int | None = None):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form
        self.scale = scale
        self._coeff_count = coeff_count

    @property
    def coeff_count(self) -> int:
        if self._coeff_count is not None:
            return self._coeff_count
        return self.data.shape[-1]

    def clone(self) -> "Plaintext":
        return Plaintext(self.data, self.parms_id, self.is_ntt_form, self.scale,
                         self._coeff_count)

    def __repr__(self):
        return (f"Plaintext(shape={tuple(self.data.shape)}, ntt={self.is_ntt_form}, "
                f"scale={self.scale}, parms={self.parms_id[:8]})")

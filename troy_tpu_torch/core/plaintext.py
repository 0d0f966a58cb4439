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

    @property
    def coeff_modulus_size(self) -> int:
        return self.data.shape[-2]

    def clone(self) -> "Plaintext":
        return Plaintext(self.data, self.parms_id, self.is_ntt_form, self.scale,
                         self._coeff_count)

    def __repr__(self):
        return (f"Plaintext(shape={tuple(self.data.shape)}, ntt={self.is_ntt_form}, "
                f"scale={self.scale}, parms={self.parms_id[:8]})")


def is_rns_form(plain: Plaintext, wide: bool) -> bool:
    """True for an RNS-form (L, n) plaintext (a scale_up, centralize or NTT
    transform), False for a mod-t (1, n) one.  At the wide width, where the
    JAX package tells them apart by its word axis and the port's layouts
    are one, an RNS-form plaintext is the one with a level."""
    if wide:
        return plain.parms_id != PARMS_ID_ZERO
    return plain.data.shape[-2] > 1

"""Plaintext object (counterpart of troy_tpu/core/plaintext.py).

data is an int64 tensor shaped (1, n) for a BFV mod-t plaintext in
coefficient form.
"""

from __future__ import annotations

import torch

from .params import ParmsID, PARMS_ID_ZERO


class Plaintext:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID = PARMS_ID_ZERO,
                 is_ntt_form: bool = False):
        self.data = data
        self.parms_id = parms_id
        self.is_ntt_form = is_ntt_form

    def __repr__(self):
        return (f"Plaintext(shape={tuple(self.data.shape)}, "
                f"ntt={self.is_ntt_form}, parms={self.parms_id[:8]})")

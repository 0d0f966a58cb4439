"""BFV plaintext scaling, on int64 residue tensors.

Counterpart of troy_tpu/rns/scaling.py (BFVScaler.scale_up, for encrypt):
round(m * Q / t) is decomposed per limb as

    m * [floor(Q/t)]_{q_i} + fix,   fix = floor((m * (Q mod t) + t/2) / t),

and with int64 the floor division by t is exact integer division.
"""

from __future__ import annotations

import torch

from ..core.modulus import Modulus
from ..ops import u32 as U
from .rns_base import RNSBase


class BFVScaler:
    def __init__(self, base_q: RNSBase, t: Modulus):
        tv = t.value
        if tv % 2 == 0:
            raise ValueError("[BFVScaler] plain modulus must be odd")
        self.base_q = base_q
        self.t = t
        Q = base_q.prod
        delta = Q // tv  # floor(Q/t)
        self.coeff_div_plain = torch.tensor(
            [delta % q for q in base_q.values], dtype=torch.int64,
            device=base_q.device).view(-1, 1)
        self.q_mod_t = Q % tv

    def scale_up(self, m: torch.Tensor) -> torch.Tensor:
        """m: (..., n) in [0, t) -> (..., L, n) = round(m * Q / t) mod q."""
        tv = self.t.value
        fix = (m * self.q_mod_t + (tv >> 1)) // tv
        q = self.base_q.q.view(-1, 1)
        prod = U.mul_mod(m[..., None, :], self.coeff_div_plain, q)
        return U.add_mod(prod, U.barrett_reduce(fix[..., None, :], q), q)

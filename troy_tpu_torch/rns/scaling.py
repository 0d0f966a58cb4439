"""BFV plaintext scaling, on int64 residue tensors.

Counterpart of troy_tpu/rns/scaling.py:
  scale_up     : m in [0, t) -> round(m * Q / t) in base q (encrypt, add_plain);
  centralize   : m in [0, t) -> the centred lift [m]_t in base q
                 (multiply_plain);
  decentralize : its inverse for small centred values.

round(m * Q / t) is decomposed per limb as

    m * [floor(Q/t)]_{q_i} + fix,   fix = floor((m * (Q mod t) + t/2) / t),

and with int64 the floor division by t is exact integer division.
"""

from __future__ import annotations

import torch

from ..core.modulus import Modulus
from ..ops import u32 as U, u64 as W
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
        self.t_half = (tv + 1) >> 1
        # centred lift: add (-t) mod q_i to plain coefficients in the upper half
        self.plain_upper_half_increment = torch.tensor(
            [(-tv) % q for q in base_q.values], dtype=torch.int64,
            device=base_q.device).view(-1, 1)

    def scale_up(self, m: torch.Tensor) -> torch.Tensor:
        """m: (..., n) in [0, t) -> (..., L, n) = round(m * Q / t) mod q."""
        tv = self.t.value
        fix = (m * self.q_mod_t + (tv >> 1)) // tv
        q = self.base_q.q.view(-1, 1)
        prod = U.mul_mod(m[..., None, :], self.coeff_div_plain, q)
        return U.add_mod(prod, U.barrett_reduce(fix[..., None, :], q), q)

    def centralize(self, m: torch.Tensor) -> torch.Tensor:
        """m: (..., n) in [0, t) -> (..., L, n) centred lift [m]_t mod q_i
        (ref: scaling_variant.cu centralize)."""
        mm = m[..., None, :]
        q = self.base_q.q.view(-1, 1)
        return U.barrett_reduce(
            torch.where(mm >= self.t_half, mm + self.plain_upper_half_increment, mm), q)

    def decentralize(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of centralize for values whose centred magnitude is below
        q_0 / 2: (..., L, n) -> (..., n) mod t, read from limb 0
        (ref: scaling_variant.cu decentralize)."""
        tv = self.t.value
        q0 = self.base_q.values[0]
        x0 = x[..., 0, :]
        pos = U.barrett_reduce(x0, tv)
        neg = U.neg_mod(U.barrett_reduce(q0 - x0, tv), tv)
        return torch.where(x0 > (q0 >> 1), neg, pos)


class BFVScaler64(BFVScaler):
    """The BFV plaintext scaling at the wide width (ref: scaling_variant.cu at
    the reference's native 64-bit width).  t stays below 2^31, under every
    wide prime, so the mod-t side and the centred lift are BFVScaler's own;
    only the product m * floor(Q/t) mod q_i needs the wide multiply."""

    def __init__(self, base_q: RNSBase, t: Modulus):
        if t.value % 2 == 0:
            raise ValueError("[BFVScaler64] plain modulus must be odd (use ring2k for 2^k)")
        if t.value >= min(base_q.values):
            raise ValueError("[BFVScaler64] t must be below every coeff modulus")
        super().__init__(base_q, t)
        self.k_q = W.barrett_consts(base_q.values, base_q.device)

    def scale_up(self, m: torch.Tensor) -> torch.Tensor:
        """m: (..., n) in [0, t) -> (..., L, n) = round(m * Q / t) mod q."""
        tv = self.t.value
        fix = (m * self.q_mod_t + (tv >> 1)) // tv
        q = self.base_q.q.view(-1, 1)
        prod = W.mul_mod64(m[..., None, :], self.coeff_div_plain, self.k_q)
        return U.add_mod(prod, fix[..., None, :], q)

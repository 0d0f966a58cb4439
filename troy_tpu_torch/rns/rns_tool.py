"""Per-level BFV RNS toolbox, on int64 residue tensors.

Counterpart of troy_tpu/rns/rns_tool.py, for the BFV multiply and decrypt:

  * fast_b_conv_hps: the HPS lift of base q to the auxiliary base Bsk, with
    the q-overflow count alpha estimated in float32;
  * fast_floor_scale_fast_b_conv_sk: floor(t * d / Q) with the x t scale
    folded into the tables, then the Shenoy-Kumaresan conversion back to q;
  * decrypt_scale_and_round: the exact {t, gamma} rounding of t * phase / Q.

The auxiliary primes (B, m_sk, gamma) are chosen by the same search as the
JAX package, so both packages hold the same bases.
"""

from __future__ import annotations

import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..ops import u32 as U
from ..ops.ntt import NTTTables
from .rns_base import RNSBase, BaseConverter


def _aux_primes(n: int, exclude: set[int], count: int, need_ntt: bool = True) -> list[int]:
    """30-bit primes (≡ 1 mod 2n if need_ntt) distinct from `exclude`."""
    out: list[int] = []
    factor = 2 * n if need_ntt else 2
    value = ((1 << 30) - 1) // factor * factor + 1
    while len(out) < count and value > (1 << 29):
        if value not in exclude and numth.is_prime(value):
            out.append(value)
            exclude.add(value)
        value -= factor
    if len(out) < count:
        raise ValueError("[RNSTool] not enough auxiliary primes")
    return out


class RNSTool:
    """BFV toolbox for one modulus-chain level, tables on base_q.device."""

    def __init__(self, log_n: int, base_q: RNSBase, t: Modulus):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.base_q = base_q
        self.t = t
        self.device = dev = base_q.device
        L = base_q.size
        q_values = base_q.values
        Q = base_q.prod
        used = set(q_values)
        used.add(t.value)

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=dev).view(-1, 1)

        # ---- aux base sizing: prod(B) must exceed the post-floor bound
        # ~ t * n * Q * (L+3) with margin (BEHZ §4) -------------------------
        bound = 16 * n * max(t.value, 4) * Q * (L + 3)
        b_primes: list[int] = []
        prod_b = 1
        pool = _aux_primes(n, used, L + 4 + 2)
        i = 0
        while prod_b <= bound:
            if i >= len(pool):
                pool += _aux_primes(n, used, 4)
            prod_b *= pool[i]
            b_primes.append(pool[i])
            i += 1
        m_sk = pool[i]
        self.base_B = RNSBase([Modulus(p) for p in b_primes], dev)
        self.base_Bsk = RNSBase([Modulus(p) for p in b_primes + [m_sk]], dev)
        self.m_sk = Modulus(m_sk)
        self.conv_q_to_Bsk = BaseConverter(base_q, self.base_Bsk)
        self.conv_B_to_q = BaseConverter(self.base_B, base_q)
        self.conv_B_to_m_sk = BaseConverter(self.base_B, RNSBase([self.m_sk], dev))
        # NTT tables for Bsk (the tensor product runs under the aux base too)
        self.bsk_ntt = NTTTables(log_n, self.base_Bsk.moduli, dev)

        bsk_vals = self.base_Bsk.values
        B_prod = self.base_B.prod

        # ---- fastbconv_sk constants ----------------------------------------
        self.inv_prod_B_mod_m_sk = numth.invert_mod(B_prod % m_sk, m_sk)
        self.prod_B_mod_q = col([B_prod % q for q in q_values])
        self.prod_B_m_sk_mod_q = col([(B_prod * m_sk) % q for q in q_values])

        # ---- HPS lift: -Q mod b_j as the alpha-correction dot term; 1/q_i
        # in float32 for the alpha estimate -----------------------------------
        self.hps_neg_q_mod_Bsk = col([(b - Q % b) % b for b in bsk_vals])
        self.hps_inv_q_f32 = torch.tensor([1.0 / q for q in q_values],
                                          dtype=torch.float32, device=dev)

        # ---- t-folded fast_floor constants ----------------------------------
        tv = t.value
        self.ff_inv_punc_t = col([(tv * ip) % q for ip, q in
                                  zip(base_q.inv_punctured, q_values)])
        self.ff_t_qinv_mod_Bsk = col([(tv * numth.invert_mod(Q % b, b)) % b
                                      for b in bsk_vals])
        self.ff_mat_qinv = torch.tensor(
            [[(punc % bv) * numth.invert_mod(Q % bv, bv) % bv
              for punc in base_q.punctured] for bv in bsk_vals],
            dtype=torch.int64, device=dev)

        # ---- {t, gamma} decrypt ---------------------------------------------
        gamma = _aux_primes(n, used, 1, need_ntt=False)[0]
        while numth.gcd(gamma, tv) != 1:
            gamma = _aux_primes(n, used, 1, need_ntt=False)[0]
        self.gamma = Modulus(gamma)
        self.base_t_gamma = RNSBase([Modulus(tv), Modulus(gamma)], dev)
        self.conv_q_to_t_gamma = BaseConverter(base_q, self.base_t_gamma)
        self.prod_t_gamma_mod_q = col([(tv * gamma) % q for q in q_values])
        self.neg_inv_q_mod_t_gamma = col(
            [(-numth.invert_mod(Q % m, m)) % m for m in (tv, gamma)])
        self.inv_gamma_mod_t = numth.invert_mod(gamma % tv, tv)

    # ------------------------------------------------------------------
    # BFV multiply, HPS-style lift of base q to Bsk
    # ------------------------------------------------------------------
    def fast_b_conv_hps(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n): a fast conversion
        with alpha = round(sum_i y_i / q_i) estimated in float32 and folded
        into the dot as one extra term.  Outputs represent x + d*q with d in
        {-1, 0, +1}.  The float32 sum is an explicit left fold over limbs in
        separate elementwise ops, so it rounds the same way on every device
        (and as the JAX package's sum does)."""
        bq = self.base_q
        tmp = U.mul_mod(x, bq.inv_punctured_t.view(-1, 1), bq.q.view(-1, 1))
        inv_q = self.hps_inv_q_f32
        est = tmp[..., 0:1, :].to(torch.float32) * inv_q[0]
        for i in range(1, bq.size):
            est = est + tmp[..., i:i + 1, :].to(torch.float32) * inv_q[i]
        alpha = torch.round(est).to(torch.int64)
        mat = self.conv_q_to_Bsk._mat
        pairs = [(tmp[..., i:i + 1, :], mat[:, i:i + 1]) for i in range(bq.size)]
        pairs.append((alpha, self.hps_neg_q_mod_Bsk))
        return U.dot_mod(pairs, self.base_Bsk.q.view(-1, 1))

    # ------------------------------------------------------------------
    # BFV multiply: floor(t * d / Q) and Shenoy-Kumaresan back to q
    # ------------------------------------------------------------------
    def fast_floor_scale_fast_b_conv_sk(self, d_q: torch.Tensor,
                                        d_bsk: torch.Tensor) -> torch.Tensor:
        """Inputs are the raw tensor-product residues d = c1*c2 (coefficient
        domain) in base q and Bsk; returns floor(t*d/Q) in base q."""
        b = self.base_Bsk.q.view(-1, 1)
        y = U.mul_mod(d_q, self.ff_inv_punc_t, self.base_q.q.view(-1, 1))
        pairs = [(y[..., i:i + 1, :], self.ff_mat_qinv[:, i:i + 1])
                 for i in range(self.base_q.size)]
        x_div = U.dot_mod(pairs, b)
        w = U.mul_mod(d_bsk, self.ff_t_qinv_mod_Bsk, b)
        return self._b_conv_sk(U.sub_mod(w, x_div, b))

    def _b_conv_sk(self, y: torch.Tensor) -> torch.Tensor:
        """Shenoy-Kumaresan exact conversion Bsk -> q."""
        y_B = y[..., :-1, :]
        y_msk = y[..., -1:, :]
        u = self.conv_B_to_q.convert(y_B)
        c_msk = self.conv_B_to_m_sk.convert(y_B)
        msk = self.m_sk.value
        alpha = U.mul_mod(U.sub_mod(c_msk, y_msk, msk), self.inv_prod_B_mod_m_sk, msk)
        q = self.base_q.q.view(-1, 1)
        res = U.sub_mod(u, U.mul_mod(self.prod_B_mod_q, alpha, q), q)
        # alpha centered: alpha >= m_sk/2 means the true alpha is alpha - m_sk
        return torch.where(alpha >= (msk >> 1),
                           U.add_mod(res, self.prod_B_m_sk_mod_q, q), res)

    # ------------------------------------------------------------------
    # BFV decrypt
    # ------------------------------------------------------------------
    def decrypt_scale_and_round(self, phase: torch.Tensor) -> torch.Tensor:
        """phase: (..., L, n) = Delta*m + v mod q (coefficient domain) ->
        (..., n) mod t, by the integer-only {t, gamma} rounding."""
        tv = self.t.value
        gv = self.gamma.value
        q = self.base_q.q.view(-1, 1)
        tmp = U.mul_mod(phase, self.prod_t_gamma_mod_q, q)
        s = self.conv_q_to_t_gamma.convert(tmp)
        s = U.mul_mod(s, self.neg_inv_q_mod_t_gamma, self.base_t_gamma.q.view(-1, 1))
        s_t, s_g = s[..., 0, :], s[..., 1, :]
        s_g_mod_t = U.barrett_reduce(s_g, tv)
        corrected = torch.where(
            s_g > (gv >> 1),
            U.add_mod(s_t, U.sub_mod(gv % tv, s_g_mod_t, tv), tv),
            U.sub_mod(s_t, s_g_mod_t, tv))
        return U.mul_mod(corrected, self.inv_gamma_mod_t, tv)

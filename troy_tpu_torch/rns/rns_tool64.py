"""Per-level RNS toolbox of the wide path (primes in (2^30, 2^61)).

Counterpart of troy_tpu/rns/rns_tool64.py, on int64 residue tensors in the
fast path's layout (..., L, n), with the products of ops/u64.py.  The same
functions as rns/rns_tool.py's RNSTool, at the wide width:

  * the auxiliary primes B, m_sk and gamma are ~59-bit, chosen by the JAX
    package's search (so both packages hold the same bases); m~ stays 2^16;
  * fast_b_conv_hps: the HPS lift q -> Bsk with alpha estimated in float32
    from the 32-bit words of each Shoup product, th (2^32 / q_i) + tl / q_i,
    the limbs summed by explicit adds in order (the JAX package's float
    operations in its order, so the CPU, the card and the JAX package round
    alike);
  * fast_b_conv_m_tilde_sm_mrq: the BEHZ lift;
  * fast_floor_scale_fast_b_conv_sk: floor(t d / Q) with the x t scale folded
    into the tables, then the Shenoy-Kumaresan conversion back to q;
  * divide_and_round_q_last and its NTT form (the CKKS rescale, the BFV mod
    switch), mod_t_and_divide_q_last_ntt (the BGV mod switch);
  * decrypt_scale_and_round through {t, gamma}; _exact_alpha (the JAX
    package's 128-bit fixed-point rounding, the same integer from 31-bit
    word columns) and decrypt_mod_t.

The plain modulus stays below 2^31, under every wide prime.  Base
conversions are rns_base.BaseConverter64: int64 PyTorch on both devices.
The JAX package's unfused floor (fast_floor_fast_b_conv_sk) is not ported:
the folded floor computes the same integer.
"""

from __future__ import annotations

import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..ops import rp as R, u64 as W
from ..ops.ntt64 import NTT64Tables
from .rns_base import RNSBase, BaseConverter64

M_TILDE = 1 << 16
_M31 = (1 << 31) - 1
_M32 = (1 << 32) - 1


def _aux_primes_wide(n: int, exclude: set[int], count: int,
                     need_ntt: bool = True, bits: int = 59) -> list[int]:
    """~59-bit primes (≡ 1 mod 2n if need_ntt) distinct from `exclude`."""
    out: list[int] = []
    factor = 2 * n if need_ntt else 2
    value = ((1 << bits) - 1) // factor * factor + 1
    floor = 1 << (bits - 1)
    while len(out) < count and value > floor:
        if value not in exclude and numth.is_prime(value):
            out.append(value)
            exclude.add(value)
        value -= factor
    if len(out) < count:
        raise ValueError("[RNSTool64] not enough auxiliary primes")
    return out


class RNSTool64:
    """Wide-width BEHZ toolbox for one modulus-chain level; t is None for
    CKKS (only the divisions by the last prime)."""

    def __init__(self, log_n: int, base_q: RNSBase, t: Modulus | None):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.base_q = base_q
        self.t = t
        self.device = dev = base_q.device
        L = base_q.size
        q_values = base_q.values
        Q = base_q.prod
        used = set(q_values)
        if t is not None and not t.is_zero:
            used.add(t.value)

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=dev).view(-1, 1)

        def shoup_col(values, moduli):
            return col(values), col([W.shoup62(v, q) for v, q in zip(values, moduli)])

        self.q_col = col(q_values)
        self.k_q = W.barrett_consts(q_values, dev)
        self._ntt_split = None

        # ---- aux base sizing (BEHZ §4), the JAX package's search ------------
        t_val = t.value if (t is not None and not t.is_zero) else 1
        bound = 16 * n * max(t_val, 4) * Q * (L + 3)
        b_primes: list[int] = []
        prod_b = 1
        pool = _aux_primes_wide(n, used, L + 2)
        i = 0
        while prod_b <= bound:
            if i >= len(pool):
                pool += _aux_primes_wide(n, used, 2)
            prod_b *= pool[i]
            b_primes.append(pool[i])
            i += 1
        m_sk = pool[i] if i < len(pool) else _aux_primes_wide(n, used, 1)[0]
        self.m_sk = m_sk
        self.base_B = RNSBase([Modulus(p) for p in b_primes], dev)
        self.base_Bsk = RNSBase([Modulus(p) for p in b_primes + [m_sk]], dev)
        self.base_Bsk_m_tilde = RNSBase(
            [Modulus(p) for p in b_primes + [m_sk, M_TILDE]], dev)
        self.conv_q_to_Bsk_m_tilde = BaseConverter64(base_q, self.base_Bsk_m_tilde)
        self.conv_q_to_Bsk = BaseConverter64(base_q, self.base_Bsk)
        self.conv_B_to_q = BaseConverter64(self.base_B, base_q)
        self.conv_B_to_m_sk = BaseConverter64(self.base_B, RNSBase([Modulus(m_sk)], dev))
        self.bsk_ntt = NTT64Tables(log_n, self.base_Bsk.values, dev)

        bsk_vals = self.base_Bsk.values
        B_prod = self.base_B.prod
        self.bsk_col = col(bsk_vals)
        self.k_bsk = W.barrett_consts(bsk_vals, dev)

        # ---- BEHZ sm_mrq ---------------------------------------------------
        self.neg_inv_prod_q_mod_m_tilde = (-numth.invert_mod(Q % M_TILDE, M_TILDE)) % M_TILDE
        self.prod_q_mod_Bsk = col([Q % b for b in bsk_vals])
        self.prod_q_m_tilde_mod_Bsk = col([(Q * M_TILDE) % b for b in bsk_vals])
        self.inv_m_tilde_mod_Bsk = shoup_col(
            [numth.invert_mod(M_TILDE % b, b) for b in bsk_vals], bsk_vals)

        # ---- Shenoy-Kumaresan ------------------------------------------------
        ibm = numth.invert_mod(B_prod % m_sk, m_sk)
        self.inv_prod_B_mod_m_sk = (ibm, W.shoup62(ibm, m_sk))
        self.prod_B_mod_q = col([B_prod % q for q in q_values])
        self.prod_B_m_sk_mod_q = col([(B_prod * m_sk) % q for q in q_values])

        # ---- HPS lift: -Q mod b_j as the alpha term; 2^32 / q_i and 1 / q_i
        # in float32 for the estimate ---------------------------------------
        self.hps_neg_q_mod_Bsk = col([(b - Q % b) % b for b in bsk_vals])
        self.hps_inv_q_hi_f32 = torch.tensor([float(1 << 32) / q for q in q_values],
                                             dtype=torch.float32, device=dev)
        self.hps_inv_q_lo_f32 = torch.tensor([1.0 / q for q in q_values],
                                             dtype=torch.float32, device=dev)

        # ---- q_last division (mod switch / rescale) --------------------------
        if L > 1:
            q_last = q_values[-1]
            rest = q_values[:-1]
            self.q_last = q_last
            self.k_last = W.barrett_consts([q_last], dev)
            self.rest_col = col(rest)
            self.k_rest = W.barrett_consts(rest, dev)
            self.inv_q_last_mod_q = shoup_col(
                [numth.invert_mod(q_last % q, q) for q in rest], rest)
            self.q_last_half_mod_q = col([(q_last >> 1) % q for q in rest])
            self.q_last_mod_q = col([q_last % q for q in rest])

        if t is None or t.is_zero:
            return
        tv = t.value
        # ---- t-folded fast floor ------------------------------------------
        self.ff_inv_punc_t = shoup_col(
            [(tv * ip) % q for ip, q in zip(base_q.inv_punctured, q_values)], q_values)
        self.ff_t_qinv_mod_Bsk = shoup_col(
            [(tv * numth.invert_mod(Q % b, b)) % b for b in bsk_vals], bsk_vals)
        self.ff_mat_qinv = [col([(punc % b) * numth.invert_mod(Q % b, b) % b
                                 for b in bsk_vals]) for punc in base_q.punctured]
        self.ff_max_terms = W.dot_mod64_terms(max(q_values + bsk_vals))

        # ---- {t, gamma} decrypt (BFV), BGV t constants ------------------------
        gamma = _aux_primes_wide(n, used, 1, need_ntt=False)[0]
        while numth.gcd(gamma, tv) != 1:
            gamma = _aux_primes_wide(n, used, 1, need_ntt=False)[0]
        self.gamma = gamma
        self.base_t_gamma = RNSBase([Modulus(tv), Modulus(gamma)], dev)
        self.conv_q_to_t_gamma = BaseConverter64(base_q, self.base_t_gamma)
        tg = [tv, gamma]
        self.tg_col = col(tg)
        self.prod_t_gamma_mod_q = shoup_col([(tv * gamma) % q for q in q_values], q_values)
        self.neg_inv_q_mod_t_gamma = shoup_col(
            [(-numth.invert_mod(Q % m, m)) % m for m in tg], tg)
        self.inv_gamma_mod_t = numth.invert_mod(gamma % tv, tv)
        self.gamma_mod_t = gamma % tv
        # exact conversion q -> t (BGV decrypt): floor(2^128 / q_i) in 31-bit
        # limbs, (Q/q_i) mod t, Q mod t
        self.inv_punctured = shoup_col(base_q.inv_punctured, q_values)
        self.punc_mod_t = [p % tv for p in base_q.punctured]
        self.q_mod_t = Q % tv
        self.r128_limbs = [col([((1 << 128) // q >> (31 * w)) & _M31 for q in q_values])
                           for w in range(4)]
        if L > 1:
            self.inv_t_mod_q_last = numth.invert_mod(tv % q_values[-1], q_values[-1])

    # ------------------------------------------------------------------
    # BFV multiply: the lifts q -> Bsk
    # ------------------------------------------------------------------
    def fast_b_conv_m_tilde_sm_mrq(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n): the BEHZ lift (a fast
        conversion of m~ x to Bsk u {m~}, then Montgomery's small reduction)."""
        conv = self.conv_q_to_Bsk_m_tilde.convert(W.mul_mod64(x, M_TILDE, self.k_q))
        x_bsk = conv[..., :-1, :]
        r = conv[..., -1:, :] * self.neg_inv_prod_q_mod_m_tilde & (M_TILDE - 1)
        b = self.bsk_col
        y = W.add_mod64(x_bsk, W.mul_mod64(self.prod_q_mod_Bsk, r, self.k_bsk), b)
        # centring: r >= m~/2 means the true correction is r - m~
        y = torch.where(r >= M_TILDE // 2, W.sub_mod64(y, self.prod_q_m_tilde_mod_Bsk, b), y)
        return W.shoup_mul64(y, *self.inv_m_tilde_mod_Bsk, b)

    def fast_b_conv_hps(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n) representing x + d q,
        d in {-1, 0, +1}: the fast conversion with alpha estimated in float32
        from the 32-bit words of each term and folded into the dot as one
        extra term (HPS17 §4)."""
        conv = self.conv_q_to_Bsk
        tmp = conv._shoup_terms(x)
        hi = self.hps_inv_q_hi_f32
        lo = self.hps_inv_q_lo_f32
        est = None
        for i in range(self.base_q.size):
            ti = tmp[..., i:i + 1, :]
            term = (ti >> 32).to(torch.float32) * hi[i] + (ti & _M32).to(torch.float32) * lo[i]
            est = term if est is None else est + term
        alpha = torch.round(est).to(torch.int64)
        pairs = [(tmp[..., i:i + 1, :], conv.mat[i]) for i in range(self.base_q.size)]
        pairs.append((alpha, self.hps_neg_q_mod_Bsk))
        return W.dot_mod64(pairs, conv.ok, conv.max_terms)

    # ------------------------------------------------------------------
    # BFV multiply: floor(t d / Q) and Shenoy-Kumaresan back to q
    # ------------------------------------------------------------------
    def fast_floor_scale_fast_b_conv_sk(self, d_q: torch.Tensor,
                                        d_bsk: torch.Tensor) -> torch.Tensor:
        """The tensor-product residues d in base q and Bsk (coefficient
        domain) -> floor(t d / Q) in base q."""
        b = self.bsk_col
        y = W.shoup_mul64(d_q, *self.ff_inv_punc_t, self.q_col)
        pairs = [(y[..., i:i + 1, :], self.ff_mat_qinv[i]) for i in range(self.base_q.size)]
        x_div = W.dot_mod64(pairs, self.k_bsk, self.ff_max_terms)
        w = W.shoup_mul64(d_bsk, *self.ff_t_qinv_mod_Bsk, b)
        return self._b_conv_sk(W.sub_mod64(w, x_div, b))

    def _b_conv_sk(self, y: torch.Tensor) -> torch.Tensor:
        """Shenoy-Kumaresan exact conversion Bsk -> q."""
        y_B = y[..., :-1, :]
        u = self.conv_B_to_q.convert(y_B)
        c_msk = self.conv_B_to_m_sk.convert(y_B)
        msk = self.m_sk
        alpha = W.shoup_mul64(W.sub_mod64(c_msk, y[..., -1:, :], msk),
                              *self.inv_prod_B_mod_m_sk, msk)
        q = self.q_col
        res = W.sub_mod64(u, W.mul_mod64(self.prod_B_mod_q, alpha, self.k_q), q)
        # alpha centred: alpha >= m_sk/2 means the true alpha is alpha - m_sk
        return torch.where(alpha >= (msk >> 1), W.add_mod64(res, self.prod_B_m_sk_mod_q, q), res)

    # ------------------------------------------------------------------
    # divisions by the last prime
    # ------------------------------------------------------------------
    def _split_tables(self, qtab):
        if self._ntt_split is None or self._ntt_split[0] is not qtab:
            L = self.base_q.size
            self._ntt_split = (qtab, qtab.take(list(range(L - 1))), qtab.take([L - 1]))
        return self._ntt_split[1:]

    def _rounding_term(self, last: torch.Tensor) -> torch.Tensor:
        """[last + q_last/2]_{q_last} - q_last/2, reduced into each q_i < L."""
        q = self.rest_col
        last_plus = W.add_mod64(last, self.q_last >> 1, self.q_last)
        return W.sub_mod64(torch.remainder(last_plus, q), self.q_last_half_mod_q, q)

    def divide_and_round_q_last(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L, n) coefficient domain -> (..., L-1, n) = round(x / q_last)."""
        tmp = self._rounding_term(x[..., -1:, :])
        return W.shoup_mul64(W.sub_mod64(x[..., :-1, :], tmp, self.rest_col),
                             *self.inv_q_last_mod_q, self.rest_col)

    def divide_and_round_q_last_ntt(self, x: torch.Tensor, qtab) -> torch.Tensor:
        """NTT-domain variant (the CKKS rescale): (..., L, n) -> (..., L-1, n)."""
        down_tab, last_tab = self._split_tables(qtab)
        tmp = R.ntt_forward(self._rounding_term(R.ntt_inverse(x[..., -1:, :], last_tab)),
                            down_tab)
        return W.shoup_mul64(W.sub_mod64(x[..., :-1, :], tmp, self.rest_col),
                             *self.inv_q_last_mod_q, self.rest_col)

    def mod_t_and_divide_q_last_ntt(self, x: torch.Tensor, qtab) -> torch.Tensor:
        """The BGV mod switch, NTT domain: (x - delta) / q_last with delta =
        t [r t^-1]_{q_last} centred, r = [x]_{q_last}."""
        down_tab, last_tab = self._split_tables(qtab)
        q = self.rest_col
        last = R.ntt_inverse(x[..., -1:, :], last_tab)
        h = W.mul_mod64(last, self.inv_t_mod_q_last, self.k_last)
        h_mod = torch.remainder(h, q)
        h_c = torch.where(h > (self.q_last >> 1), W.sub_mod64(h_mod, self.q_last_mod_q, q),
                          h_mod)
        delta = R.ntt_forward(W.mul_mod64(h_c, self.t.value, self.k_rest), down_tab)
        return W.shoup_mul64(W.sub_mod64(x[..., :-1, :], delta, q),
                             *self.inv_q_last_mod_q, q)

    # ------------------------------------------------------------------
    # decrypt
    # ------------------------------------------------------------------
    def decrypt_scale_and_round(self, phase: torch.Tensor) -> torch.Tensor:
        """phase (..., L, n) coefficient domain -> (..., n) mod t, by the
        integer-only {t, gamma} rounding."""
        tv, gv = self.t.value, self.gamma
        tmp = W.shoup_mul64(phase, *self.prod_t_gamma_mod_q, self.q_col)
        s = W.shoup_mul64(self.conv_q_to_t_gamma.convert(tmp),
                          *self.neg_inv_q_mod_t_gamma, self.tg_col)
        s_t, s_g = s[..., 0, :], s[..., 1, :]
        s_g_mod_t = torch.remainder(s_g, tv)
        corrected = torch.where(
            s_g > (gv >> 1),
            W.add_mod64(s_t, W.sub_mod64(self.gamma_mod_t, s_g_mod_t, tv), tv),
            W.sub_mod64(s_t, s_g_mod_t, tv))
        return corrected * self.inv_gamma_mod_t % tv

    def _exact_alpha(self, v: torch.Tensor) -> torch.Tensor:
        """round(sum_i v_i / q_i) for v (..., L, n), v_i in [0, q_i): the sum
        S = sum_i v_i floor(2^128 / q_i), rounded at bit 128 (the JAX
        package's 128-bit fixed point).  v and the reciprocals are cut into
        31-bit limbs; each limb product (< 2^62) is split at bit 31 into word
        columns of base 2^31, summed over limbs, and the carries propagated
        once: alpha = floor((S + 2^127) / 2^128), the same integer."""
        cols = [0] * 6
        for j, vj in enumerate((v & _M31, v >> 31)):
            for w, rw in enumerate(self.r128_limbs):
                p = vj * rw
                cols[j + w] = cols[j + w] + (p & _M31).sum(dim=-2)
                cols[j + w + 1] = cols[j + w + 1] + (p >> 31).sum(dim=-2)
        for c in range(4):
            cols[c + 1] = cols[c + 1] + (cols[c] >> 31)
        # S >> 124 is column 4 and column 5 (alpha < L keeps it small);
        # 128 = 124 + 4, so alpha = ((S >> 127) + 1) >> 1
        top = cols[4] + (cols[5] << 31)
        return ((top >> 3) + 1) >> 1

    def decrypt_mod_t(self, phase: torch.Tensor) -> torch.Tensor:
        """The BGV decrypt: the centred phase mod t, (..., L, n) -> (..., n)."""
        tv = self.t.value
        v = W.shoup_mul64(phase, *self.inv_punctured, self.q_col)
        acc = None
        for i, c in enumerate(self.punc_mod_t):
            term = torch.remainder(v[..., i, :], tv) * c % tv
            acc = term if acc is None else W.add_mod64(acc, term, tv)
        return W.sub_mod64(acc, self._exact_alpha(v) * self.q_mod_t % tv, tv)

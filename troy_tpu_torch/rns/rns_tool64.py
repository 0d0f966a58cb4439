"""Per-level RNS toolbox of the wide path (primes in (2^30, 2^61)).

Counterpart of troy_tpu/rns/rns_tool64.py, on int64 residue tensors in the
fast path's layout (..., L, n), with the products of ops/u64.py.  The same
functions as rns/rns_tool.py's RNSTool, at the wide width:

  * the auxiliary primes B, m_sk and gamma are ~59-bit, chosen by the JAX
    package's search (so both packages hold the same bases); m~ stays 2^16;
  * fast_b_conv_hps: the HPS lift q -> Bsk with alpha estimated in float32
    from the 32-bit words of each Shoup product, th (2^32 / q_i) + tl / q_i,
    summed over the limbs in the order and with the fused multiply-adds
    that XLA's CPU code gives the JAX package's jitted sum (F32FmaSum), run
    exactly in float64, so that the CPU and the card round alike;
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

import math

import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..ops import rp as R, u64 as W
from ..ops.ntt64 import NTT64Tables
from .rns_base import RNSBase, BaseConverter64

M_TILDE = 1 << 16
_M31 = (1 << 31) - 1
_M32 = (1 << 32) - 1


def _round32(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The float32 nearest to the exact s + e (float64 s, and e its
    rounding error, |e| <= half an ulp of s), ties to even, as a float64:
    s rounds as s + e does unless s is a float32 midpoint, where the sign
    of e decides."""
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    inf = torch.full_like(r, math.inf)
    down = torch.where(r64 <= s, r, torch.nextafter(r, -inf)).to(torch.float64)
    up = torch.where(r64 >= s, r, torch.nextafter(r, inf)).to(torch.float64)
    mid = (s - down == up - s) & (down != up)
    return torch.where(mid & (e > 0), up, torch.where(mid & (e < 0), down, r64))


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a + b in float64 and its exact rounding error (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c) on float32 values held in float64: a b is exact
    in float64 (24 + 24 bits), the sum's error is exact by TwoSum, and one
    rounding to float32 follows."""
    return _round32(*_two_sum(a * b, c))


def add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a + b on float32 values held in float64."""
    return _round32(*_two_sum(a, b))


class F32FmaSum:
    """sum_i th_i hi_i + tl_i lo_i over the limb axis in float32 (th, tl
    the 32-bit words of the HPS terms, hi_i = 2^32 / q_i and lo_i = 1 / q_i
    as float32), rounded as XLA 0.9's CPU code (x86-64, AVX-512) runs the
    JAX package's jitted jnp.sum of the products.  A limb's step is
    acc = fma(th_i, hi_i, fma(tl_i, lo_i, acc)); the order depends on the
    limb count L alone:

      * L <= 32: the sum is vectorised over W lanes, lane j taking the
        limbs i = j, j + W, ... of the whole groups of W from 0; the lanes
        are added by halving (lane j + W/2 onto lane j), and the limbs past
        the last whole group are stepped into that sum one by one.  W = L
        at L = 1, 4, 8; W = 1 (a left fold) at the other L below 16; W = 4
        at L = 20 to 23 and W = 8 at the other L from 16 to 32.
      * L > 32 (XLA's tree reduction of a long reduce): each limb's step
        from 0, the L values zero-padded into m = ceil(L / 32) windows of
        32 ((32 m - L) // 2 zeros in front), each window added in order
        from 0, and the m window sums added in order.

    Read from the compiled code of the lift at L = 1 to 9, 12 and 16 (lead
    shapes (), (2,), (2, 2) and (16, 2), n = 32, 2000 and 8192) and from its
    HLO at L = 33; held against the jitted lift on columns built at
    k + 1/2 at every L from 1 to 33 and at 40, 64, 100 and 128.  Above
    L = 128 (more than 4 windows) the windows' order is not verified.

    Every step runs exactly in float64 (fma32, add32), the same on every
    device."""

    def __init__(self, hi: torch.Tensor, lo: torch.Tensor):
        L = hi.numel()
        self.windows = L > 32
        self.lanes = (L if L in (1, 4, 8) else 1 if L < 16 else
                      4 if 20 <= L <= 23 else 8)
        self.hi = hi.to(torch.float64).view(-1, 1)
        self.lo = lo.to(torch.float64).view(-1, 1)

    def step(self, acc, th, tl, i0: int, i1: int) -> torch.Tensor:
        """Limbs i0 .. i1 - 1 (one a lane) stepped into acc."""
        acc = fma32(tl[..., i0:i1, :], self.lo[i0:i1], acc)
        return fma32(th[..., i0:i1, :], self.hi[i0:i1], acc)

    def __call__(self, tmp: torch.Tensor) -> torch.Tensor:
        """tmp: (..., L, n) int64 HPS terms below 2^61 -> (..., 1, n) float32."""
        th = (tmp >> 32).to(torch.float32).to(torch.float64)
        tl = (tmp & _M32).to(torch.float32).to(torch.float64)
        L = tmp.shape[-2]
        if self.windows:
            zero = torch.zeros_like(th[..., :1, :])
            vals = self.step(torch.zeros_like(th), th, tl, 0, L)
            m = -(-L // 32)
            front = (32 * m - L) // 2
            total = zero
            for k in range(m):
                acc = zero
                for i in range(max(0, 32 * k - front), min(L, 32 * (k + 1) - front)):
                    acc = add32(acc, vals[..., i:i + 1, :])
                total = add32(total, acc)
            return total.to(torch.float32)
        W = self.lanes
        whole = L - L % W
        acc = torch.zeros_like(th[..., :W, :])
        for i0 in range(0, whole, W):
            acc = self.step(acc, th, tl, i0, i0 + W)
        while acc.shape[-2] > 1:
            h = acc.shape[-2] // 2
            acc = add32(acc[..., :h, :], acc[..., h:, :])
        for i in range(whole, L):
            acc = self.step(acc, th, tl, i, i + 1)
        return acc.to(torch.float32)


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
        self.hps_sum = F32FmaSum(self.hps_inv_q_hi_f32, self.hps_inv_q_lo_f32)

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
    def _rows(self, kind: str, rows: tuple | None) -> dict:
        """The per-row constants of the Bsk output rows (kind "bsk": the
        lifts and the floor) or the q output rows (kind "q": the SK
        conversion) `rows`, every row when None; cached.  A limb shard
        (parallel/partition.py) computes only its own rows."""
        cache = self.__dict__.setdefault("_row_cache", {})
        if (kind, rows) in cache:
            return cache[kind, rows]
        behz = self.conv_q_to_Bsk_m_tilde
        if kind == "bsk":
            full = dict(q=self.bsk_col, k=self.k_bsk, mat=self.conv_q_to_Bsk.mat,
                        ok=self.conv_q_to_Bsk.ok, hps_neg_q=self.hps_neg_q_mod_Bsk,
                        behz_mat=behz.mat, behz_ok=behz.ok, prod_q=self.prod_q_mod_Bsk,
                        prod_q_m_tilde=self.prod_q_m_tilde_mod_Bsk,
                        inv_m_tilde=self.inv_m_tilde_mod_Bsk)
            if self.t is not None and not self.t.is_zero:
                full.update(ff_mat=self.ff_mat_qinv, ff_t_qinv=self.ff_t_qinv_mod_Bsk)
        else:
            full = dict(q=self.q_col, k=self.k_q, mat=self.conv_B_to_q.mat,
                        ok=self.conv_B_to_q.ok, prod_B=self.prod_B_mod_q,
                        prod_B_m_sk=self.prod_B_m_sk_mod_q)
        if rows is not None:
            ix = torch.tensor(rows, dtype=torch.int64, device=self.device)
            ix_behz = torch.tensor(list(rows) + [behz.obase.size - 1], dtype=torch.int64,
                                   device=self.device)

            def take(v, i):
                return (v[i] if isinstance(v, torch.Tensor) else
                        type(v)(take(c, i) for c in v))
            full = {k: take(v, ix_behz if k.startswith("behz") else ix)
                    for k, v in full.items()}
        cache[kind, rows] = full
        return full

    def fast_b_conv_m_tilde_sm_mrq(self, x: torch.Tensor,
                                   rows: tuple | None = None) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n) (or the Bsk rows
        `rows`): the BEHZ lift (a fast conversion of m~ x to Bsk u {m~},
        then Montgomery's small reduction)."""
        c = self._rows("bsk", rows)
        conv = self.conv_q_to_Bsk_m_tilde
        tmp = conv._shoup_terms(W.mul_mod64(x, M_TILDE, self.k_q))
        conv = W.dot_mod64([(tmp[..., i:i + 1, :], c["behz_mat"][i])
                            for i in range(self.base_q.size)], c["behz_ok"], conv.max_terms)
        x_bsk = conv[..., :-1, :]
        r = conv[..., -1:, :] * self.neg_inv_prod_q_mod_m_tilde & (M_TILDE - 1)
        b = c["q"]
        y = W.add_mod64(x_bsk, W.mul_mod64(c["prod_q"], r, c["k"]), b)
        # centring: r >= m~/2 means the true correction is r - m~
        y = torch.where(r >= M_TILDE // 2, W.sub_mod64(y, c["prod_q_m_tilde"], b), y)
        return W.shoup_mul64(y, *c["inv_m_tilde"], b)

    def fast_b_conv_hps(self, x: torch.Tensor, rows: tuple | None = None) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n) (or the Bsk rows
        `rows`) representing x + d q, d in {-1, 0, +1}: the fast conversion
        with alpha estimated in float32 from the 32-bit words of each term
        and folded into the dot as one extra term (HPS17 §4), the sum rounded
        as the JAX package's jitted lift rounds it (F32FmaSum)."""
        c = self._rows("bsk", rows)
        conv = self.conv_q_to_Bsk
        tmp = conv._shoup_terms(x)
        alpha = torch.round(self.hps_sum(tmp)).to(torch.int64)
        pairs = [(tmp[..., i:i + 1, :], c["mat"][i]) for i in range(self.base_q.size)]
        pairs.append((alpha, c["hps_neg_q"]))
        return W.dot_mod64(pairs, c["ok"], conv.max_terms)

    # ------------------------------------------------------------------
    # BFV multiply: floor(t d / Q) and Shenoy-Kumaresan back to q
    # ------------------------------------------------------------------
    def fast_floor_scale_fast_b_conv_sk(self, d_q: torch.Tensor,
                                        d_bsk: torch.Tensor) -> torch.Tensor:
        """The tensor-product residues d in base q and Bsk (coefficient
        domain) -> floor(t d / Q) in base q."""
        return self._b_conv_sk(self._floor(d_q, d_bsk))

    def _floor(self, d_q: torch.Tensor, d_bsk: torch.Tensor,
               rows: tuple | None = None) -> torch.Tensor:
        """floor(t d / Q) in Bsk (or its rows `rows`; d_bsk holds those
        rows), from d in all of base q."""
        c = self._rows("bsk", rows)
        b = c["q"]
        y = W.shoup_mul64(d_q, *self.ff_inv_punc_t, self.q_col)
        pairs = [(y[..., i:i + 1, :], c["ff_mat"][i]) for i in range(self.base_q.size)]
        x_div = W.dot_mod64(pairs, c["k"], self.ff_max_terms)
        w = W.shoup_mul64(d_bsk, *c["ff_t_qinv"], b)
        return W.sub_mod64(w, x_div, b)

    def _b_conv_sk(self, y: torch.Tensor, rows: tuple | None = None) -> torch.Tensor:
        """Shenoy-Kumaresan exact conversion Bsk -> q (or the q rows `rows`)."""
        c = self._rows("q", rows)
        y_B = y[..., :-1, :]
        tmp = self.conv_B_to_q._shoup_terms(y_B)
        u = W.dot_mod64([(tmp[..., i:i + 1, :], c["mat"][i]) for i in range(self.base_B.size)],
                        c["ok"], self.conv_B_to_q.max_terms)
        c_msk = self.conv_B_to_m_sk.convert(y_B)
        msk = self.m_sk
        alpha = W.shoup_mul64(W.sub_mod64(c_msk, y[..., -1:, :], msk),
                              *self.inv_prod_B_mod_m_sk, msk)
        q = c["q"]
        res = W.sub_mod64(u, W.mul_mod64(c["prod_B"], alpha, c["k"]), q)
        # alpha centred: alpha >= m_sk/2 means the true alpha is alpha - m_sk
        return torch.where(alpha >= (msk >> 1), W.add_mod64(res, c["prod_B_m_sk"], q), res)

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

"""Per-level RNS toolboxes, on int64 residue tensors.

Counterpart of troy_tpu/rns/rns_tool.py.  LastPrimeTool holds what every
scheme needs at a level, the division by its last prime:

  * divide_and_round_q_last: round(x / q_last) into the next level's base,
    for the BFV mod switch and special-prime encryption;
  * divide_and_round_q_last_ntt: the same in the NTT domain, for the CKKS
    rescale and CKKS special-prime encryption; its two NTTs (the last
    limb's inverse, the other limbs' forward) go through the NTT dispatch,
    so on the card they run the NTT kernel.

RNSTool adds the BFV multiply and decrypt, and what BGV needs of t:

  * fast_b_conv_hps: the HPS lift of base q to the auxiliary base Bsk, with
    the q-overflow count alpha estimated in float32 (the default lift);
  * fast_b_conv_m_tilde_sm_mrq: the reference-exact BEHZ lift, a fast
    conversion to Bsk u {m~} of m~ x, then Montgomery's small reduction by m~;
  * fast_floor_scale_fast_b_conv_sk: floor(t * d / Q) with the x t scale
    folded into the tables, then the Shenoy-Kumaresan conversion back to q;
  * decrypt_scale_and_round: the exact {t, gamma} rounding of t * phase / Q;
  * mod_t_and_divide_q_last_ntt: the BGV mod switch, a division by the last
    prime that keeps the payload mod t (NTT domain);
  * decrypt_mod_t: the BGV decrypt, the centred phase mod t by an exact
    base conversion whose overflow count alpha is rounded in 96-bit fixed
    point (_exact_alpha: the JAX package's integer, in int64 word columns).

Every base conversion goes through ops/bconv.base_convert (the Hopper kernel
on a CUDA tensor).  The JAX package's unfused floor, fast_floor_fast_b_conv_sk
(a separate x t pass, then conv_q_to_Bsk), is not ported: the folded floor
computes the same integer (t D - X) / Q and equals it bit for bit.

The auxiliary primes (B, m_sk, gamma) are chosen by the same search as the
JAX package, so both packages hold the same bases.
"""

from __future__ import annotations

import math

import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..utils.timer import span
from ..ops import bconv as BC, ntt as NTT, u32 as U
from ..ops.ntt import NTTTables
from .rns_base import RNSBase, BaseConverter

# m~ of the BEHZ lift (the reference uses 2^32 with 64-bit lanes); the BEHZ
# bound needs only m~ > 2 |base q|, as in the JAX package.
M_TILDE = 1 << 16


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


class F32Fold:
    """sum_i y_i w_i over the limb axis in float32, for integers y_i in
    [0, 1 / w_i] and float32 weights w_i, rounded as XLA on the CPU runs the
    JAX package's jnp.sum of the products: a left fold with each product
    fused into its addition, est = fma(y_i, w_i, est), one rounding a term
    (y_i taken as a float32 first).  The bits agree with the JAX package's
    HPS estimate at 2 to 8 limbs and n = 32 to 8192; the order the TPU
    uses is not known.

    It runs exactly in int64 fixed point.  With w_i = m_i 2^-K (K the largest
    of the weights' last-bit exponents), every product and every rounded
    partial sum is an integer multiple of 2^-K below L 2^(K+1), so each
    est + y_i m_i is exact and one int64 -> float32 conversion rounds it as
    the fma does, on any device."""

    def __init__(self, w: list[float], device):
        self.K = max(24 - math.frexp(v)[1] for v in w)
        m = [v * 2.0 ** self.K for v in w]
        if any(v != int(v) for v in m) or len(w) * 2 ** (self.K + 1) >= 1 << 63:
            raise ValueError("[F32Fold] weights outside the fixed-point range")
        self.m = torch.tensor([int(v) for v in m], dtype=torch.int64, device=device).view(-1, 1)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """y: (..., L, n) int64 -> (..., 1, n) float32."""
        a = y.to(torch.float32).to(torch.int64) * self.m
        est = a[..., 0:1, :].to(torch.float32)
        for i in range(1, a.shape[-2]):
            est = (est.to(torch.int64) + a[..., i:i + 1, :]).to(torch.float32)
        return est * 2.0 ** -self.K


def _col(values, dev) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=dev).view(-1, 1)


class LastPrimeTool:
    """The division by a level's last prime, for every scheme (the per-level
    constants of troy_tpu/rns/rns_tool.py's q_last division, without the
    BFV-only parts)."""

    def __init__(self, log_n: int, base_q: RNSBase):
        self.log_n = log_n
        self.n = 1 << log_n
        self.base_q = base_q
        self.device = base_q.device
        q_values = base_q.values
        if len(q_values) > 1:
            q_last = q_values[-1]
            rest = q_values[:-1]
            self.q_last_half = q_last >> 1
            self.q_last_half_mod_q = _col([(q_last >> 1) % q for q in rest], self.device)
            self.inv_q_last_mod_q = _col([numth.invert_mod(q_last % q, q) for q in rest],
                                         self.device)
        self._ntt_split = None

    def divide_and_round_q_last(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L, n) coefficient domain -> (..., L-1, n) = round(x / q_last):
        (x_i - ([x_last + q_last/2]_{q_last} - q_last/2)) q_last^-1 mod q_i."""
        q_last = self.base_q.values[-1]
        q = self.base_q.q[:-1].view(-1, 1)
        last_plus = U.add_mod(x[..., -1:, :], self.q_last_half, q_last)
        tmp = U.sub_mod(U.barrett_reduce(last_plus, q), self.q_last_half_mod_q, q)
        return U.mul_mod(U.sub_mod(x[..., :-1, :], tmp, q), self.inv_q_last_mod_q, q)

    def _split_tables(self, qtab: NTTTables) -> tuple[NTTTables, NTTTables]:
        """The level's NTT tables cut into the first L-1 limbs and the last
        (cached for the last qtab seen)."""
        if self._ntt_split is None or self._ntt_split[0] is not qtab:
            L = self.base_q.size
            self._ntt_split = (qtab, qtab.take(list(range(L - 1))), qtab.take([L - 1]))
        return self._ntt_split[1:]

    def divide_and_round_q_last_ntt(self, x: torch.Tensor, qtab: NTTTables) -> torch.Tensor:
        """NTT-domain variant (the CKKS rescale): qtab is the level's NTT
        tables (L limbs); (..., L, n) -> (..., L-1, n), NTT domain.  The last
        limb goes to the coefficient domain, is centred and reduced per
        limb, and comes back through the forward NTT of the other limbs."""
        down_tab, last_tab = self._split_tables(qtab)
        last = NTT.ntt_inverse(x[..., -1:, :].contiguous(), last_tab)
        last_plus = U.add_mod(last, self.q_last_half, self.base_q.values[-1])
        q = self.base_q.q[:-1].view(-1, 1)
        tmp = U.sub_mod(U.barrett_reduce(last_plus, q), self.q_last_half_mod_q, q)
        tmp = NTT.ntt_forward(tmp, down_tab)
        return U.mul_mod(U.sub_mod(x[..., :-1, :], tmp, q), self.inv_q_last_mod_q, q)


class RNSTool(LastPrimeTool):
    """BFV toolbox for one modulus-chain level, tables on base_q.device."""

    def __init__(self, log_n: int, base_q: RNSBase, t: Modulus):
        super().__init__(log_n, base_q)
        n = self.n
        self.t = t
        dev = self.device
        L = base_q.size
        q_values = base_q.values
        Q = base_q.prod
        used = set(q_values)
        used.add(t.value)

        def col(values):
            return _col(values, dev)

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
        self.m_tilde = Modulus(M_TILDE)
        self.base_Bsk_m_tilde = RNSBase(
            [Modulus(p) for p in b_primes + [m_sk, M_TILDE]], dev)
        self.conv_q_to_Bsk_m_tilde = BaseConverter(base_q, self.base_Bsk_m_tilde)
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

        # ---- BEHZ sm_mrq: -Q^-1 mod m~, Q and Q m~ mod Bsk, m~^-1 mod Bsk ---
        self.neg_inv_prod_q_mod_m_tilde = (
            -numth.invert_mod(Q % M_TILDE, M_TILDE)) % M_TILDE
        self.prod_q_mod_Bsk = col([Q % b for b in bsk_vals])
        self.prod_q_m_tilde_mod_Bsk = col([(Q * M_TILDE) % b for b in bsk_vals])
        self.inv_m_tilde_mod_Bsk = col([numth.invert_mod(M_TILDE % b, b)
                                        for b in bsk_vals])

        # ---- HPS lift: -Q mod b_j as the alpha-correction dot term; 1/q_i
        # in float32 for the alpha estimate -----------------------------------
        self.hps_neg_q_mod_Bsk = col([(b - Q % b) % b for b in bsk_vals])
        self.hps_inv_q_f32 = torch.tensor([1.0 / q for q in q_values],
                                          dtype=torch.float32, device=dev)
        self.hps_fold = F32Fold(self.hps_inv_q_f32.tolist(), dev)

        # ---- t-folded fast_floor: x_div = sum_i [d_i t q^_i^-1]_{q_i}
        # ((Q/q_i) Q^-1 mod b_j), a base conversion with folded tables -------
        tv = t.value
        self.ff_tables = BC.BConvTables(
            q_values,
            [(tv * ip) % q for ip, q in zip(base_q.inv_punctured, q_values)],
            bsk_vals,
            [[(punc % bv) * numth.invert_mod(Q % bv, bv) % bv
              for punc in base_q.punctured] for bv in bsk_vals],
            dev)
        self.ff_t_qinv_mod_Bsk = col([(tv * numth.invert_mod(Q % b, b)) % b
                                      for b in bsk_vals])

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

        # ---- BGV: the exact conversion q -> t, floor(2^96 / q_i) in three
        # 32-bit words, and the t-corrected division by q_last ----------------
        self.inv_punctured_q = col(base_q.inv_punctured)
        self.conv_matrix_q_to_t = [p % tv for p in base_q.punctured]
        self.q_mod_t = Q % tv
        self.r96_words = [col([((1 << 96) // q >> (32 * w)) & 0xFFFFFFFF
                               for q in q_values]) for w in range(3)]
        if L > 1:
            q_last = q_values[-1]
            self.inv_t_mod_q_last = numth.invert_mod(tv % q_last, q_last)
            self.q_last_mod_q = col([q_last % q for q in q_values[:-1]])

    # ------------------------------------------------------------------
    # BFV multiply, HPS-style lift of base q to Bsk
    # ------------------------------------------------------------------
    def _rows(self, kind: str, rows: tuple | None) -> dict:
        """The per-row constants of the Bsk output rows (kind "bsk": the
        lifts and the floor) or the q output rows (kind "q": the SK
        conversion, whose tables "sk" convert B into those rows and m_sk)
        `rows`, every row when None; cached.  A limb shard
        (parallel/partition.py) computes only its own rows."""
        cache = self.__dict__.setdefault("_row_cache", {})
        if (kind, rows) in cache:
            return cache[kind, rows]
        if kind == "bsk":
            full = dict(q=self.base_Bsk.q.view(-1, 1), mat=self.conv_q_to_Bsk.tables.mat,
                        hps_neg_q=self.hps_neg_q_mod_Bsk,
                        behz=self.conv_q_to_Bsk_m_tilde.tables,
                        prod_q=self.prod_q_mod_Bsk, prod_q_m_tilde=self.prod_q_m_tilde_mod_Bsk,
                        inv_m_tilde=self.inv_m_tilde_mod_Bsk, ff=self.ff_tables,
                        ff_t_qinv=self.ff_t_qinv_mod_Bsk)
            if rows is not None:
                ix = torch.tensor(rows, dtype=torch.int64, device=self.device)
                m_tilde = self.base_Bsk_m_tilde.size - 1
                full = {k: (v[ix] if isinstance(v, torch.Tensor) else
                            BC.take_outputs(v, list(rows) + [m_tilde]) if k == "behz" else
                            BC.take_outputs(v, rows)) for k, v in full.items()}
        else:
            full = dict(q=self.base_q.q.view(-1, 1), prod_B=self.prod_B_mod_q,
                        prod_B_m_sk=self.prod_B_m_sk_mod_q)
            conv = self.conv_B_to_q.tables
            if rows is not None:
                ix = torch.tensor(rows, dtype=torch.int64, device=self.device)
                full = {k: v[ix] for k, v in full.items()}
                conv = BC.take_outputs(conv, rows)
            # B -> the q rows, then m_sk as the last row: one conversion
            full["sk"] = BC.join_outputs(conv, self.conv_B_to_m_sk.tables)
        cache[kind, rows] = full
        return full

    @span("lift")
    def fast_b_conv_hps(self, x: torch.Tensor, rows: tuple | None = None) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n) (or the Bsk rows
        `rows`): a fast conversion with alpha = round(sum_i y_i / q_i)
        estimated in float32 and folded into the dot as one extra term.
        Outputs represent x + d*q with d in {-1, 0, +1}.  The float32 sum
        is F32Fold over all limbs, the same on every device."""
        tabs = self.conv_q_to_Bsk.tables
        c = self._rows("bsk", rows)
        tmp = U.mul_mod(x, tabs.ip.view(-1, 1), tabs.q_in.view(-1, 1))
        alpha = torch.round(self.hps_fold(tmp)).to(torch.int64)
        pairs = [(tmp[..., i:i + 1, :], c["mat"][:, i:i + 1]) for i in range(tabs.L_in)]
        pairs.append((alpha, c["hps_neg_q"]))
        return U.dot_mod(pairs, c["q"])

    # ------------------------------------------------------------------
    # BFV multiply, reference-exact BEHZ lift (steps 1-2)
    # ------------------------------------------------------------------
    @span("lift")
    def fast_b_conv_m_tilde_sm_mrq(self, x: torch.Tensor,
                                   rows: tuple | None = None) -> torch.Tensor:
        """x: (..., L, n) in base q -> (..., |Bsk|, n) (or the Bsk rows
        `rows`): the residues of a value congruent to x with bounded
        overflow.  Step 1 converts m~ x to Bsk u {m~}; step 2 (sm_mrq) adds
        Q r with r = [-x Q^-1]_{m~}, centred, and divides by m~."""
        q = self.base_q.q.view(-1, 1)
        c = self._rows("bsk", rows)
        conv = BC.base_convert(U.mul_mod(x, M_TILDE, q), c["behz"])
        x_bsk = conv[..., :-1, :]
        r = conv[..., -1:, :] * self.neg_inv_prod_q_mod_m_tilde & (M_TILDE - 1)
        b = c["q"]
        y = U.add_mod(x_bsk, U.mul_mod(c["prod_q"], r, b), b)
        # centring: r >= m~/2 means the true correction is r - m~
        y = torch.where(r >= M_TILDE // 2, U.sub_mod(y, c["prod_q_m_tilde"], b), y)
        return U.mul_mod(y, c["inv_m_tilde"], b)

    # ------------------------------------------------------------------
    # BFV multiply: floor(t * d / Q) and Shenoy-Kumaresan back to q
    # ------------------------------------------------------------------
    def fast_floor_scale_fast_b_conv_sk(self, d_q: torch.Tensor,
                                        d_bsk: torch.Tensor) -> torch.Tensor:
        """Inputs are the raw tensor-product residues d = c1*c2 (coefficient
        domain) in base q and Bsk; returns floor(t*d/Q) in base q."""
        return self._b_conv_sk(self._floor(d_q, d_bsk))

    @span("floor")
    def _floor(self, d_q: torch.Tensor, d_bsk: torch.Tensor,
               rows: tuple | None = None) -> torch.Tensor:
        """floor(t d / Q) in Bsk (or its rows `rows`; d_bsk holds those
        rows), from d in all of base q."""
        c = self._rows("bsk", rows)
        x_div = BC.base_convert(d_q, c["ff"])
        w = U.mul_mod(d_bsk, c["ff_t_qinv"], c["q"])
        return U.sub_mod(w, x_div, c["q"])

    @span("sk")
    def _b_conv_sk(self, y: torch.Tensor, rows: tuple | None = None) -> torch.Tensor:
        """Shenoy-Kumaresan exact conversion Bsk -> q (or the q rows `rows`):
        B -> q and B -> m_sk as one conversion of y's B rows, read where they
        lie (the kernel takes the strided slice)."""
        c = self._rows("q", rows)
        conv = BC.base_convert(y[..., :-1, :], c["sk"])
        u, c_msk = conv[..., :-1, :], conv[..., -1:, :]
        y_msk = y[..., -1:, :]
        msk = self.m_sk.value
        alpha = U.mul_mod(U.sub_mod(c_msk, y_msk, msk), self.inv_prod_B_mod_m_sk, msk)
        q = c["q"]
        res = U.sub_mod(u, U.mul_mod(c["prod_B"], alpha, q), q)
        # alpha centered: alpha >= m_sk/2 means the true alpha is alpha - m_sk
        return torch.where(alpha >= (msk >> 1), U.add_mod(res, c["prod_B_m_sk"], q), res)

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

    # ------------------------------------------------------------------
    # BGV mod switch and decrypt
    # ------------------------------------------------------------------
    def mod_t_and_divide_q_last_ntt(self, x: torch.Tensor, qtab: NTTTables) -> torch.Tensor:
        """(..., L, n) NTT domain -> (..., L-1, n): (x - delta) / q_last with
        delta = t [r t^-1]_{q_last}, centred, for r = [x]_{q_last}: delta is
        r mod q_last and 0 mod t, so the payload mod t survives the division
        (ref: rns_tool.cu mod_t_and_divide_q_last_ntt)."""
        down_tab, last_tab = self._split_tables(qtab)
        q_last = self.base_q.values[-1]
        last = NTT.ntt_inverse(x[..., -1:, :].contiguous(), last_tab)
        h = U.mul_mod(last, self.inv_t_mod_q_last, q_last)
        q = self.base_q.q[:-1].view(-1, 1)
        h_mod = U.barrett_reduce(h, q)
        h_c = torch.where(h > (q_last >> 1), U.sub_mod(h_mod, self.q_last_mod_q, q), h_mod)
        delta = NTT.ntt_forward(U.mul_mod(h_c, self.t.value, q), down_tab)
        return U.mul_mod(U.sub_mod(x[..., :-1, :], delta, q), self.inv_q_last_mod_q, q)

    def _exact_alpha(self, v: torch.Tensor) -> torch.Tensor:
        """round(sum_i v_i / q_i) for v (..., L, n) with v_i in [0, q_i): the
        96-bit fixed-point sum S = sum_i v_i floor(2^96 / q_i), rounded at
        bit 96 (ref: rns_base.cu exact_convey_array).  Each product of v_i
        and a 32-bit word of the reciprocal is below 2^62; its halves are
        summed by word column (at most 2L terms of 32 bits each), the carries
        propagated once, and alpha = word 3 + bit 95: the integer the JAX
        package forms with u32 words and wrap-around carries."""
        cols = [0, 0, 0, 0]
        for w, word in enumerate(self.r96_words):
            p = v * word                       # (..., L, n), each < 2^62
            cols[w] = cols[w] + (p & 0xFFFFFFFF).sum(dim=-2)
            cols[w + 1] = cols[w + 1] + (p >> 32).sum(dim=-2)
        for w in range(3):
            cols[w + 1] = cols[w + 1] + (cols[w] >> 32)
        return cols[3] + ((cols[2] & 0xFFFFFFFF) >> 31)

    def decrypt_mod_t(self, phase: torch.Tensor) -> torch.Tensor:
        """phase (..., L, n), coefficient domain -> (..., n): the centred
        phase mod t, sum_i [phase_i (Q/q_i)^-1]_{q_i} (Q/q_i) - alpha Q."""
        tv = self.t.value
        q = self.base_q.q.view(-1, 1)
        v = U.mul_mod(phase, self.inv_punctured_q, q)
        acc = None
        for i, c in enumerate(self.conv_matrix_q_to_t):
            term = U.mul_mod(v[..., i, :], c, tv)
            acc = term if acc is None else U.add_mod(acc, term, tv)
        return U.sub_mod(acc, U.mul_mod(self._exact_alpha(v), self.q_mod_t, tv), tv)

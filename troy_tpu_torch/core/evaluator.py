"""BFV evaluator: add, multiply, relinearize (counterpart of
troy_tpu/core/evaluator.py, BFV at the u32 fast width).

multiply is the BEHZ tensor product with a lift of base q to Bsk and the
t-folded fast floor.  The lift is chosen per evaluator: "hps" (the default,
the JAX package's default) or "behz", the reference-exact m~ / sm_mrq lift
that the JAX package selects with TROY_BFV_BCONV=behz.  relinearize switches
c2 with the key for s^2 over single-special-prime keys.  Per-level tables are
built on first use and cached on the ContextData.
"""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .params import SchemeType
from .ciphertext import Ciphertext
from .keys import RelinKeys
from ..ops import ntt as NTT, poly as P, u32 as U, dyadic as D
from ..utils import numth


LIFTS = ("hps", "behz")


class Evaluator:
    def __init__(self, context: HeContext, lift: str = "hps"):
        if context.scheme != SchemeType.BFV:
            raise ValueError("[Evaluator] the port supports BFV only")
        if lift not in LIFTS:
            raise ValueError(f"[Evaluator] lift={lift!r}: expected 'hps' or 'behz'")
        self.context = context
        self.lift = lift

    def _cd(self, ct: Ciphertext) -> ContextData:
        return self.context.get_context_data(ct.parms_id)

    @staticmethod
    def _check_same(ct1: Ciphertext, ct2: Ciphertext, op: str):
        if ct1.parms_id != ct2.parms_id:
            raise ValueError(f"[Evaluator.{op}] operands at different levels")
        if ct1.is_ntt_form or ct2.is_ntt_form:
            raise ValueError(f"[Evaluator.{op}] BFV operands must be coeff form")

    # ------------------------------------------------------------------
    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        self._check_same(ct1, ct2, "add")
        if ct1.size != ct2.size:
            raise ValueError("[Evaluator.add] ciphertext sizes differ")
        out = ct1.clone()
        out.data = P.add(ct1.data, ct2.data, self._cd(ct1).qtab())
        return out

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        self._check_same(ct1, ct2, "multiply")
        out = ct1.clone()
        out.data = self.bfv_multiply_impl(self._cd(ct1), ct1.data,
                                          None if ct1 is ct2 else ct2.data)
        return out

    def bfv_multiply_impl(self, cd: ContextData, x1: torch.Tensor,
                          x2: torch.Tensor | None) -> torch.Tensor:
        """BEHZ multiply on raw (..., size, L, n) tensors; x2=None squares x1."""
        tool = cd.rns_tool
        qtab = cd.qtab()
        btab = tool.bsk_ntt
        lift = (tool.fast_b_conv_hps if self.lift == "hps"
                else tool.fast_b_conv_m_tilde_sm_mrq)

        def prep(x):
            return NTT.ntt_forward(x, qtab), NTT.ntt_forward(lift(x), btab)

        a_q, a_b = prep(x1)
        if x2 is None:
            d_q, d_b = D.dyadic_square(a_q, qtab), D.dyadic_square(a_b, btab)
        else:
            b_q, b_b = prep(x2)
            d_q = D.dyadic_convolute(a_q, b_q, qtab)
            d_b = D.dyadic_convolute(a_b, b_b, btab)
        d_q = NTT.ntt_inverse(d_q, qtab)
        d_b = NTT.ntt_inverse(d_b, btab)
        return tool.fast_floor_scale_fast_b_conv_sk(d_q, d_b)

    # ------------------------------------------------------------------
    # keyswitching
    # ------------------------------------------------------------------
    def _switch_tables(self, cd: ContextData) -> dict:
        """Cached per-level tables for the (level moduli + special prime)
        output base and the special-prime division constants."""
        cache = getattr(cd, "_switch_cache", None)
        if cache is not None:
            return cache
        key_cd = self.context.key_context_data()
        L = cd.coeff_modulus_size
        L_key = key_cd.coeff_modulus_size
        idx = list(range(L)) + [L_key - 1]
        ktab = key_cd.qtab()
        q_sp = key_cd.parms.coeff_modulus[-1].value
        q_values = [m.value for m in cd.parms.coeff_modulus]

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=cd.device).view(-1, 1)

        cache = dict(
            idx=torch.tensor(idx, dtype=torch.int64, device=cd.device),
            otab=ktab.take(idx),
            sp_tab=ktab.take([L_key - 1]),
            q_sp=q_sp,
            sp_half_mod_q=col([(q_sp >> 1) % q for q in q_values]),
            inv_sp_mod_q=col([numth.invert_mod(q_sp % q, q) for q in q_values]),
        )
        cd._switch_cache = cache
        return cache

    def _switch_key_impl(self, cd: ContextData, target_coeff: torch.Tensor,
                         keys: torch.Tensor) -> torch.Tensor:
        """Keyswitch: target (..., L, n) coefficient-domain poly, keys
        (decomp_key, 2, L_key, n) in NTT form at key level ->
        (..., 2, L, n) coefficient domain."""
        sw = self._switch_tables(cd)
        L = cd.coeff_modulus_size
        otab = sw["otab"]
        n = target_coeff.shape[-1]
        lead = target_coeff.shape[:-2]
        # digits D[..., i, j, :] = [target_i] as a lazy residue mod p_j: every
        # fast-path prime lies in (2^28, 2^30), so a digit < q_i < 2 p_j is a
        # valid [0, 2q) NTT input and needs no reduction
        D_ = target_coeff[..., :, None, :].expand(*lead, L, L + 1, n).contiguous()
        D_ = NTT.ntt_forward(D_, otab)
        keys_sel = keys[:L][:, :, sw["idx"], :]                     # (L, 2, O, n)
        q = otab.q.view(-1, 1)
        acc = U.dot_mod([(D_[..., i, None, :, :], keys_sel[i]) for i in range(L)], q)
        # acc: (..., 2, O, n); divide by the special prime
        last = NTT.ntt_inverse(acc[..., :, L:, :].contiguous(), sw["sp_tab"])
        qtab = cd.qtab()
        lq = qtab.q.view(-1, 1)
        q_sp = sw["q_sp"]
        last_plus = U.add_mod(last, q_sp >> 1, q_sp)
        tmp = U.sub_mod(U.barrett_reduce(last_plus, lq), sw["sp_half_mod_q"], lq)
        body = NTT.ntt_inverse(acc[..., :, :L, :].contiguous(), qtab)
        return U.mul_mod(U.sub_mod(body, tmp, lq), sw["inv_sp_mod_q"], lq)

    def relinearize(self, ct: Ciphertext, rlk: RelinKeys) -> Ciphertext:
        """size-s -> size-2: switch every poly c_k (k >= 2) with the key for
        s^k and fold into (c0, c1)."""
        if ct.size < 3:
            raise ValueError("[Evaluator.relinearize] ciphertext size must be >= 3")
        cd = self._cd(ct)
        qtab = cd.qtab()
        acc = None
        for k in range(2, ct.size):
            sw = self._switch_key_impl(cd, ct.data[k], rlk.key(k))
            acc = sw if acc is None else P.add(acc, sw, qtab)
        out = ct.clone()
        out.data = P.add(ct.data[:2], acc, qtab)
        return out

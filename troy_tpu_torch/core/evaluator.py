"""BFV, CKKS and BGV evaluator at the u32 fast width (counterpart of
troy_tpu/core/evaluator.py).

  * translate: negate, add, sub, and add_plain / sub_plain;
  * multiply: the BEHZ tensor product with a lift of base q to Bsk and the
    t-folded fast floor, square, and multiply_plain in either form.  The lift
    is chosen per evaluator: "hps" (the default, the JAX package's default)
    or "behz", the reference-exact m~ / sm_mrq lift that the JAX package
    selects with TROY_BFV_BCONV=behz;
  * keyswitching over single-special-prime keys: relinearize,
    apply_keyswitching, apply_galois, rotate_rows (the NAF fallback where the
    keys lack the step's element) and rotate_columns;
  * mod switch (divide and round by the last prime) and the NTT transforms;
  * the rest of the surface: the plaintext transforms, Galois maps and mod
    switches, multiply_plain_accumulate and the stacked
    multiply_plain_contract, exponentiate, negacyclic_shift, and the
    *_batched forms, which stack a list into one (B, size, L, n) tensor and
    run one pass where the JAX package does (and loop where it loops);
  * LWE extraction and packing (core/lwe_ops.py, mixed in).

CKKS ciphertexts live in the NTT domain and carry a scale, with the JAX
package's rules: add / sub need equal scales (to 1e-9 relative), multiply,
square and multiply_plain multiply them, rescale_to_next divides by the
dropped prime (divide and round in the NTT domain); multiply is the
NTT-domain dyadic product; relinearize, rotate_vector and complex_conjugate
keyswitch with NTT-form output; mod_switch_to_next drops the last limb.

BGV ciphertexts live in the NTT domain and carry a correction factor cf (the
plaintext is m cf^-1 mod t): add / sub first scale each operand by the
smallest multipliers that equalise the factors; multiply (the dyadic
product) and square multiply them; a plaintext enters as the centred lift of
m cf mod t; the keyswitch subtracts, before dividing by the special prime, a
term that is 0 mod t; the mod switch does the same for the last prime
(rns_tool.mod_t_and_divide_q_last_ntt) and multiplies cf by q_last^-1 mod t.

Per-level tables are built on first use and cached on the ContextData.
"""

from __future__ import annotations

import math

import torch

from .context import HeContext, ContextData
from .params import ParmsID, SchemeType, PARMS_ID_ZERO
from .plaintext import Plaintext, is_rns_form
from .ciphertext import Ciphertext
from .keys import KSwitchKeys, RelinKeys, GaloisKeys
from .lwe_ops import LweOpsMixin
from ..ops import poly as P, rp as R, u32 as U, u64 as W
from ..ops.galois import GaloisTool
from ..rns.rns_base import RNSBase
from ..utils import numth


LIFTS = ("hps", "behz")


class Evaluator(LweOpsMixin):
    def __init__(self, context: HeContext, lift: str = "hps"):
        if context.scheme not in (SchemeType.BFV, SchemeType.CKKS, SchemeType.BGV):
            raise ValueError("[Evaluator] the port supports BFV, CKKS and BGV")
        if lift not in LIFTS:
            raise ValueError(f"[Evaluator] lift={lift!r}: expected 'hps' or 'behz'")
        self.context = context
        self.lift = lift

    def _cd(self, ct: Ciphertext | Plaintext) -> ContextData:
        return self.context.get_context_data(ct.parms_id)

    def _ckks(self) -> bool:
        return self.context.scheme == SchemeType.CKKS

    def _bgv(self) -> bool:
        return self.context.scheme == SchemeType.BGV

    @staticmethod
    def _check_same(ct1: Ciphertext, ct2: Ciphertext, op: str):
        if ct1.parms_id != ct2.parms_id:
            raise ValueError(f"[Evaluator.{op}] operands at different levels")
        if ct1.is_ntt_form != ct2.is_ntt_form:
            raise ValueError(f"[Evaluator.{op}] NTT form mismatch")

    def _check_bgv_ntt(self, ct: Ciphertext, op: str):
        """BGV products and the mod switch work in the NTT domain (the JAX
        package applies them to coefficient-form data too, and computes a
        wrong result there)."""
        if self._bgv() and not ct.is_ntt_form:
            raise ValueError(f"[Evaluator.{op}] BGV ciphertexts must be in NTT form")

    def _is_rns_plain(self, plain: Plaintext) -> bool:
        """True for an RNS-form (L, n) plaintext (bfv_scale_up,
        bfv_centralize, transform_plain_to_ntt), False for mod-t (1, n)."""
        return is_rns_form(plain, self.context.key_context_data().wide)

    def _plain_to_level(self, plain: Plaintext, cd: ContextData, ntt: bool) -> torch.Tensor:
        """A plaintext as (L, n) residues at cd's level, in the NTT domain if
        ntt: a CKKS or RNS-form plaintext as it is (transformed as needed), a
        mod-t plaintext by its centred lift."""
        qtab = cd.qtab()
        if self._ckks() or self._is_rns_plain(plain):
            data = plain.data
            if ntt and not plain.is_ntt_form:
                data = R.ntt_forward(data, qtab)
            if not ntt and plain.is_ntt_form:
                data = R.ntt_inverse(data, qtab)
            return data
        lifted = cd.scaler.centralize(plain.data[0])
        return R.ntt_forward(lifted, qtab) if ntt else lifted

    # ------------------------------------------------------------------
    # translate (ref: evaluator_translate.cu)
    # ------------------------------------------------------------------
    def negate(self, ct: Ciphertext) -> Ciphertext:
        out = ct.clone()
        out.data = P.negate(ct.data, self._cd(ct).qtab())
        return out

    @staticmethod
    def _bgv_multipliers(f1: int, f2: int, t: int) -> tuple[int, int, int]:
        """(e1, e2, f): scaling ct_i by e_i multiplies its noise by e_i, so
        the smallest exact multipliers e1 = f2/g, e2 = f1/g, g = gcd(f1, f2),
        give both the factor f = f1 e1 mod t (ref: evaluator_translate.cu
        balance_correction_factors)."""
        g = numth.gcd(f1, f2)
        return (f2 // g) % t, (f1 // g) % t, f1 * (f2 // g) % t

    def _balance_bgv(self, ct1: Ciphertext, ct2: Ciphertext, cd: ContextData):
        if ct1.correction_factor == ct2.correction_factor:
            return ct1, ct2
        e1, e2, f = self._bgv_multipliers(ct1.correction_factor, ct2.correction_factor,
                                          cd.parms.plain_modulus.value)
        a, b = ct1.clone(), ct2.clone()
        a.data = R.multiply_scalar(ct1.data, e1, cd.qtab())
        b.data = R.multiply_scalar(ct2.data, e2, cd.qtab())
        a.correction_factor = b.correction_factor = f
        return a, b

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """Sum of two ciphertexts; the smaller is padded with zero polys.
        CKKS scales must agree to 1e-9 relative; BGV factors are balanced."""
        self._check_same(ct1, ct2, "add")
        cd = self._cd(ct1)
        if self._ckks() and abs(ct1.scale - ct2.scale) > 0.5 * max(ct1.scale, ct2.scale) * 1e-9:
            raise ValueError("[Evaluator.add] CKKS scale mismatch")
        if self._bgv():
            ct1, ct2 = self._balance_bgv(ct1, ct2, cd)
        big, small = (ct1, ct2) if ct1.size >= ct2.size else (ct2, ct1)
        pad = big.size - small.size
        small_data = small.data
        if pad:  # zero polys on the poly axis, behind any leading batch axes
            shape = small_data.shape
            small_data = torch.cat([small_data, small_data.new_zeros(
                (*shape[:-3], pad, *shape[-2:]))], dim=-3)
        out = big.clone()
        out.data = P.add(big.data, small_data, cd.qtab())
        return out

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self.add(ct1, self.negate(ct2))

    def _translate_plain(self, ct: Ciphertext, plain: Plaintext,
                         subtract: bool) -> Ciphertext:
        """c0 +- scale_up(m), or +- m for an RNS-form plaintext at ct's level
        (ref: evaluator_translate_plain.cu); a CKKS plaintext goes to the NTT
        domain first; BGV adds the centred lift of m cf mod t, in ct's
        domain (the JAX package adds its NTT form to a coefficient-form ct)."""
        cd = self._cd(ct)
        rns = self._is_rns_plain(plain)
        if rns and plain.parms_id != ct.parms_id:
            raise ValueError("[Evaluator.add_plain] plaintext level mismatch")
        qtab = cd.qtab()
        if self._ckks():
            m = plain.data if plain.is_ntt_form else R.ntt_forward(plain.data, qtab)
        elif self._bgv():
            t = cd.parms.plain_modulus.value
            m = cd.scaler.centralize(U.mul_mod(plain.data[0], ct.correction_factor % t, t))
            if ct.is_ntt_form:
                m = R.ntt_forward(m, qtab)
        elif plain.is_ntt_form != ct.is_ntt_form:
            raise ValueError("[Evaluator.add_plain] NTT form mismatch")
        else:
            m = plain.data if rns else cd.scaler.scale_up(plain.data[0])
        c0 = (P.sub if subtract else P.add)(ct.data[0], m, qtab)
        out = ct.clone()
        out.data = torch.cat([c0[None], ct.data[1:]])
        return out

    def add_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._translate_plain(ct, plain, subtract=False)

    def sub_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self._translate_plain(ct, plain, subtract=True)

    # ------------------------------------------------------------------
    # multiply (ref: evaluator.cu:29-366, evaluator_multiply_plain.cu)
    # ------------------------------------------------------------------
    def multiply_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        """ct * m through the NTT: a mod-t plaintext is lifted centred; a
        coefficient-form BFV or BGV ciphertext goes to the NTT domain and
        back.  A CKKS product's scale is the product of the scales; a BGV
        factor is kept."""
        cd = self._cd(ct)
        qtab = cd.qtab()
        if self._is_rns_plain(plain) and plain.parms_id != ct.parms_id:
            raise ValueError("[Evaluator.multiply_plain] plaintext level mismatch")
        out = ct.clone()
        out.data = self._plain_product(ct.data, self._plain_to_level(plain, cd, ntt=True)[None],
                                       qtab, ct.is_ntt_form)
        if self._ckks():
            out.scale = ct.scale * plain.scale
        return out

    def _plain_product(self, data: torch.Tensor, m_ntt: torch.Tensor, qtab,
                       ntt_form: bool) -> torch.Tensor:
        """data (..., size, L, n) times NTT-form plaintexts m_ntt that
        broadcast against it; coefficient-form BFV or BGV data goes to the
        NTT domain and back."""
        if ntt_form or self._ckks():
            return R.dyadic_product(data, m_ntt, qtab)
        return R.ntt_inverse(R.dyadic_product(R.ntt_forward(data, qtab), m_ntt, qtab),
                               qtab)

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """BFV: the BEHZ multiply; CKKS and BGV: the NTT-domain dyadic
        product, at the product of the scales (CKKS) or factors (BGV)."""
        self._check_same(ct1, ct2, "multiply")
        out = ct1.clone()
        cd = self._cd(ct1)
        if self.context.scheme == SchemeType.BFV:
            if ct1.is_ntt_form:
                raise ValueError("[Evaluator.multiply] BFV operands must be coeff form")
            out.data = self.bfv_multiply_impl(cd, ct1.data,
                                              None if ct1 is ct2 else ct2.data)
            return out
        self._check_bgv_ntt(ct1, "multiply")
        out.data = R.dyadic_convolute(ct1.data, ct2.data, cd.qtab())
        if self._ckks():
            out.scale = ct1.scale * ct2.scale
        else:
            out.correction_factor = (ct1.correction_factor * ct2.correction_factor
                                     % cd.parms.plain_modulus.value)
        return out

    def square(self, ct: Ciphertext) -> Ciphertext:
        if self.context.scheme == SchemeType.BFV:
            return self.multiply(ct, ct)
        self._check_bgv_ntt(ct, "square")
        cd = self._cd(ct)
        out = ct.clone()
        out.data = R.dyadic_square(ct.data, cd.qtab())
        if self._ckks():
            out.scale = ct.scale * ct.scale
        else:
            out.correction_factor = ct.correction_factor ** 2 % cd.parms.plain_modulus.value
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
            return R.ntt_forward(x, qtab), R.ntt_forward(lift(x), btab)

        a_q, a_b = prep(x1)
        if x2 is None:
            d_q, d_b = R.dyadic_square(a_q, qtab), R.dyadic_square(a_b, btab)
        else:
            b_q, b_b = prep(x2)
            d_q = R.dyadic_convolute(a_q, b_q, qtab)
            d_b = R.dyadic_convolute(a_b, b_b, btab)
        d_q = R.ntt_inverse(d_q, qtab)
        d_b = R.ntt_inverse(d_b, btab)
        return tool.fast_floor_scale_fast_b_conv_sk(d_q, d_b)

    # ------------------------------------------------------------------
    # keyswitching (ref: evaluator_keyswitching_core.cu:757)
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
        if cd.parms.scheme == SchemeType.BGV:
            t = cd.parms.plain_modulus.value
            cache.update(inv_t_mod_sp=numth.invert_mod(t % q_sp, q_sp),
                         sp_mod_q=col([q_sp % q for q in q_values]))
        if cd.wide:
            inv = [numth.invert_mod(q_sp % q, q) for q in q_values]
            cache.update(inv_sp_mod_q_shoup=col([W.shoup62(v, q)
                                                 for v, q in zip(inv, q_values)]),
                         max_terms=W.dot_mod64_terms(cache["otab"].max_modulus))
        cd._switch_cache = cache
        return cache

    def _switch_key_impl(self, cd: ContextData, target_coeff: torch.Tensor,
                         keys: torch.Tensor, out_ntt: bool = False) -> torch.Tensor:
        """Keyswitch: target (..., L, n) coefficient-domain poly, keys
        (decomp_key, 2, L_key, n) in NTT form at key level -> (..., 2, L, n),
        in the NTT domain if out_ntt, else the coefficient domain.  A level
        below the first takes the key rows of its own primes and the special
        prime.  The division by the special prime subtracts the rounding term
        [last]_{q_sp} centred, or for BGV t [last t^-1]_{q_sp} centred, which
        is last mod q_sp and 0 mod t (ref: ski_util7's t-correction)."""
        if cd.wide:
            return self._switch_key_impl_wide(cd, target_coeff, keys, out_ntt)
        sw = self._switch_tables(cd)
        L = cd.coeff_modulus_size
        otab = sw["otab"]
        n = target_coeff.shape[-1]
        lead = target_coeff.shape[:-2]
        # digits D[..., i, j, :] = [target_i] as a lazy residue mod p_j: every
        # fast-path prime lies in (2^28, 2^30), so a digit < q_i < 2 p_j is a
        # valid [0, 2q) NTT input and needs no reduction
        D_ = target_coeff[..., :, None, :].expand(*lead, L, L + 1, n).contiguous()
        D_ = R.ntt_forward(D_, otab)
        keys_sel = keys[:L][:, :, sw["idx"], :]                     # (L, 2, O, n)
        q = otab.q.view(-1, 1)
        acc = U.dot_mod([(D_[..., i, None, :, :], keys_sel[i]) for i in range(L)], q)
        # acc: (..., 2, O, n); divide by the special prime
        last = R.ntt_inverse(acc[..., :, L:, :].contiguous(), sw["sp_tab"])
        qtab = cd.qtab()
        lq = qtab.q.view(-1, 1)
        q_sp = sw["q_sp"]
        if cd.parms.scheme == SchemeType.BGV:
            h = U.mul_mod(last, sw["inv_t_mod_sp"], q_sp)
            h_mod = U.barrett_reduce(h, lq)
            h_c = torch.where(h > (q_sp >> 1), U.sub_mod(h_mod, sw["sp_mod_q"], lq), h_mod)
            tmp = U.mul_mod(h_c, cd.parms.plain_modulus.value, lq)
        else:
            last_plus = U.add_mod(last, q_sp >> 1, q_sp)
            tmp = U.sub_mod(U.barrett_reduce(last_plus, lq), sw["sp_half_mod_q"], lq)
        if out_ntt:
            body = acc[..., :, :L, :]
            tmp = R.ntt_forward(tmp, qtab)
        else:
            body = R.ntt_inverse(acc[..., :, :L, :].contiguous(), qtab)
        return U.mul_mod(U.sub_mod(body, tmp, lq), sw["inv_sp_mod_q"], lq)

    def _switch_key_impl_wide(self, cd: ContextData, target_coeff: torch.Tensor,
                              keys: torch.Tensor, out_ntt: bool = False) -> torch.Tensor:
        """The keyswitch at the wide width, as _switch_key_impl.  The digits
        are reduced per output prime: a wide chain mixes prime sizes, so the
        fast path's q_i < 2 p_j shortcut does not hold (ref:
        fgk/switch_key.cu set_accumulate).  The inner product sums (hi, lo)
        products, one Barrett per chunk (ops/u64.dot_mod64)."""
        sw = self._switch_tables(cd)
        L = cd.coeff_modulus_size
        otab = sw["otab"]
        n = target_coeff.shape[-1]
        lead = target_coeff.shape[:-2]
        D_ = torch.remainder(target_coeff[..., :, None, :].expand(*lead, L, L + 1, n),
                             otab.q.view(-1, 1))
        D_ = R.ntt_forward(D_, otab)
        keys_sel = keys[:L][:, :, sw["idx"], :]                     # (L, 2, O, n)
        acc = W.dot_mod64([(D_[..., i, None, :, :], keys_sel[i]) for i in range(L)],
                          otab.k, sw["max_terms"])
        last = R.ntt_inverse(acc[..., :, L:, :], sw["sp_tab"])
        qtab = cd.qtab()
        lq = qtab.q.view(-1, 1)
        q_sp = sw["q_sp"]
        if cd.parms.scheme == SchemeType.BGV:
            h = W.mul_mod64(last, sw["inv_t_mod_sp"], sw["sp_tab"].k)
            h_mod = torch.remainder(h, lq)
            h_c = torch.where(h > (q_sp >> 1), W.sub_mod64(h_mod, sw["sp_mod_q"], lq), h_mod)
            tmp = W.mul_mod64(h_c, cd.parms.plain_modulus.value, qtab.k)
        else:
            last_plus = W.add_mod64(last, q_sp >> 1, q_sp)
            tmp = W.sub_mod64(torch.remainder(last_plus, lq), sw["sp_half_mod_q"], lq)
        if out_ntt:
            body = acc[..., :, :L, :]
            tmp = R.ntt_forward(tmp, qtab)
        else:
            body = R.ntt_inverse(acc[..., :, :L, :], qtab)
        return W.shoup_mul64(W.sub_mod64(body, tmp, lq), sw["inv_sp_mod_q"],
                             sw["inv_sp_mod_q_shoup"], lq)

    def relinearize(self, ct: Ciphertext, rlk: RelinKeys) -> Ciphertext:
        """size-s -> size-2: switch every poly c_k (k >= 2) with the key for
        s^k and fold into (c0, c1)."""
        if ct.size < 3:
            raise ValueError("[Evaluator.relinearize] ciphertext size must be >= 3")
        cd = self._cd(ct)
        qtab = cd.qtab()
        acc = None
        for k in range(2, ct.size):
            target = ct.data[k]
            if ct.is_ntt_form:
                target = R.ntt_inverse(target, qtab)
            sw = self._switch_key_impl(cd, target, rlk.key(k), out_ntt=ct.is_ntt_form)
            acc = sw if acc is None else P.add(acc, sw, qtab)
        out = ct.clone()
        out.data = P.add(ct.data[:2], acc, qtab)
        return out

    def apply_keyswitching(self, ct: Ciphertext, ksk: KSwitchKeys) -> Ciphertext:
        """Re-encrypt a size-2 ct to the key holder's secret
        (ref: evaluator_keyswitching.cu:11)."""
        if ct.size != 2:
            raise ValueError("[Evaluator.apply_keyswitching] needs size-2 ct")
        cd = self._cd(ct)
        qtab = cd.qtab()
        target = ct.data[1]
        if ct.is_ntt_form:
            target = R.ntt_inverse(target, qtab)
        sw = self._switch_key_impl(cd, target, ksk.get(0), out_ntt=ct.is_ntt_form)
        out = ct.clone()
        out.data = torch.stack([P.add(sw[0], ct.data[0], qtab), sw[1]])
        return out

    # -- galois / rotations (ref: evaluator_keyswitching.cu:179-285) --------
    def _apply_galois_impl(self, cd: ContextData, data: torch.Tensor,
                           keys: torch.Tensor, galois_elt: int,
                           ntt_form: bool) -> torch.Tensor:
        """x -> x^g on both polys of (..., 2, L, n), then a keyswitch of c1
        from s(x^g) back to s; leading batch axes broadcast."""
        qtab = cd.qtab()
        tool = GaloisTool.for_context(cd)
        if ntt_form:
            c0g = tool.apply_ntt(data[..., 0, :, :], galois_elt)
            target = R.ntt_inverse(tool.apply_ntt(data[..., 1, :, :], galois_elt), qtab)
        else:
            g = tool.apply_coeff(data, galois_elt, qtab)
            c0g, target = g[..., 0, :, :], g[..., 1, :, :]
        sw = self._switch_key_impl(cd, target, keys, out_ntt=ntt_form)
        return torch.stack([P.add(sw[..., 0, :, :], c0g, qtab), sw[..., 1, :, :]], dim=-3)

    def apply_galois(self, ct: Ciphertext, galois_elt: int,
                     glk: GaloisKeys) -> Ciphertext:
        if ct.size != 2:
            raise ValueError("[Evaluator.apply_galois] needs size-2 ct")
        out = ct.clone()
        out.data = self._apply_galois_impl(self._cd(ct), ct.data, glk.key(galois_elt),
                                           galois_elt, ct.is_ntt_form)
        return out

    def _rotate_internal(self, ct: Ciphertext, steps: int, glk: GaloisKeys) -> Ciphertext:
        """One round with the step's own element when the keys hold it, else
        one round per NAF component (ref: evaluator_keyswitching.cu:276-292)."""
        if steps == 0:
            return ct.clone()
        n = self._cd(ct).parms.poly_modulus_degree
        elt = GaloisTool.get_element_from_step(steps, n)
        if glk.has(elt):
            return self.apply_galois(ct, elt, glk)
        parts = numth.naf(steps)
        if parts == [steps]:
            # a power of two has no smaller decomposition; the JAX package
            # recurses here without end
            raise KeyError(f"[Evaluator.rotate_rows] no Galois key for step {steps}")
        out = ct
        for s in parts:
            out = self._rotate_internal(out, s, glk)
        return out

    def rotate_rows(self, ct: Ciphertext, steps: int, glk: GaloisKeys) -> Ciphertext:
        return self._rotate_internal(ct, steps, glk)

    def rotate_columns(self, ct: Ciphertext, glk: GaloisKeys) -> Ciphertext:
        n = self._cd(ct).parms.poly_modulus_degree
        return self.apply_galois(ct, GaloisTool.conjugate_element(n), glk)

    def rotate_vector(self, ct: Ciphertext, steps: int, glk: GaloisKeys) -> Ciphertext:
        """CKKS slot rotation (the same Galois rounds as rotate_rows)."""
        return self._rotate_internal(ct, steps, glk)

    def complex_conjugate(self, ct: Ciphertext, glk: GaloisKeys) -> Ciphertext:
        """CKKS slot conjugation: the conjugation element."""
        return self.rotate_columns(ct, glk)

    # ------------------------------------------------------------------
    # mod switch (ref: evaluator_modswitch.cu)
    # ------------------------------------------------------------------
    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        """BFV: divide and round by the level's last prime (coefficient
        form); CKKS: drop the last limb, the scale unchanged; BGV: divide by
        the last prime keeping the payload mod t (NTT form), the factor
        times q_last^-1 mod t."""
        cd = self._cd(ct)
        if cd.is_last():
            raise ValueError("[Evaluator.mod_switch_to_next] already at last level")
        out = ct.clone()
        if self._ckks():
            out.data = ct.data[..., :-1, :]
        elif self._bgv():
            self._check_bgv_ntt(ct, "mod_switch_to_next")
            t = cd.parms.plain_modulus.value
            out.data = cd.rns_tool.mod_t_and_divide_q_last_ntt(ct.data, cd.qtab())
            out.correction_factor = (ct.correction_factor * numth.invert_mod(
                cd.parms.coeff_modulus[-1].value % t, t) % t)
        else:
            out.data = cd.rns_tool.divide_and_round_q_last(ct.data)
        out.parms_id = cd.next.parms_id
        return out

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        """CKKS rescale (ref: evaluator_modswitch.cu:445): divide and round
        by the last prime in the NTT domain; the scale divides by it."""
        cd = self._cd(ct)
        if not self._ckks():
            raise ValueError("[Evaluator.rescale_to_next] CKKS only")
        if cd.is_last():
            raise ValueError("[Evaluator.rescale_to_next] already at last level")
        out = ct.clone()
        out.data = cd.rns_tool.divide_and_round_q_last_ntt(ct.data, cd.qtab())
        out.scale = ct.scale / cd.parms.coeff_modulus[-1].value
        out.parms_id = cd.next.parms_id
        return out

    def rescale_to(self, ct: Ciphertext, parms_id: ParmsID) -> Ciphertext:
        """Rescale down the chain until parms_id (ref: evaluator.h rescale_to)."""
        target = self.context.get_context_data(parms_id)
        cur = ct
        while cur.parms_id != parms_id:
            if self._cd(cur).chain_index >= target.chain_index:
                raise ValueError("[Evaluator.rescale_to] target at or above current level")
            cur = self.rescale_to_next(cur)
        return cur

    def mod_switch_plain_to_next(self, plain: Plaintext) -> Plaintext:
        """CKKS NTT-form plaintext: drop the last limb
        (ref: mod_switch_drop_to_plain)."""
        cd = self._cd(plain)
        out = plain.clone()
        out.data = plain.data[..., :-1, :]
        out.parms_id = cd.next.parms_id
        return out

    # -- drop-to family (ref: evaluator_modswitch.cu:173: copy the limb
    #    prefix, no scaling) ----------------------------------------------
    def _check_drop_target(self, cd: ContextData, parms_id: ParmsID,
                           op: str) -> ContextData:
        target = self.context.get_context_data(parms_id)
        if target.chain_index < cd.chain_index:
            raise ValueError(f"[Evaluator.{op}] target level above the ciphertext's level")
        if list(target.base_q.values) != list(cd.base_q.values[: target.base_q.size]):
            raise ValueError(f"[Evaluator.{op}] target is not on this chain")
        return target

    @staticmethod
    def _check_scale_bound(scale: float, target: ContextData, op: str):
        """(ref: evaluator_utils.h:307 is_scale_within_bounds)."""
        if target.parms.scheme == SchemeType.CKKS:
            bound = target.base_q.prod.bit_length()
        else:
            bound = target.parms.plain_modulus.value.bit_length()
        if scale <= 0 or math.log2(scale) >= bound:
            raise ValueError(f"[Evaluator.{op}] scale out of bounds for the "
                             f"target level (2^{bound})")

    def mod_switch_drop_to(self, ct: Ciphertext, parms_id: ParmsID) -> Ciphertext:
        """Drop limbs down to parms_id without scaling (CKKS mod switch;
        ref: evaluator_modswitch.cu:173)."""
        cd = self._cd(ct)
        if self._ckks() and not ct.is_ntt_form:
            raise ValueError("[Evaluator.mod_switch_drop_to] CKKS ct must be in NTT form")
        target = self._check_drop_target(cd, parms_id, "mod_switch_drop_to")
        if self._ckks():
            self._check_scale_bound(ct.scale, target, "mod_switch_drop_to")
        out = ct.clone()
        out.data = ct.data[..., : target.base_q.size, :]
        out.parms_id = parms_id
        return out

    def mod_switch_to(self, ct: Ciphertext, parms_id: ParmsID) -> Ciphertext:
        """Mod switch down the chain to parms_id (ref: evaluator_modswitch.cu:379)."""
        target = self.context.get_context_data(parms_id)
        if self._cd(ct).chain_index > target.chain_index:
            raise ValueError("[Evaluator.mod_switch_to] cannot reach target")
        cur = ct
        while cur.parms_id != parms_id:
            cur = self.mod_switch_to_next(cur)
        return cur

    # ------------------------------------------------------------------
    # NTT transforms and plaintext forms (ref: evaluator_transform_ntt.cu)
    # ------------------------------------------------------------------
    def transform_to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt_form:
            raise ValueError("[Evaluator.transform_to_ntt] already NTT form")
        out = ct.clone()
        out.data = R.ntt_forward(ct.data, self._cd(ct).qtab())
        out.is_ntt_form = True
        return out

    def transform_from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt_form:
            raise ValueError("[Evaluator.transform_from_ntt] not NTT form")
        out = ct.clone()
        out.data = R.ntt_inverse(ct.data, self._cd(ct).qtab())
        out.is_ntt_form = False
        return out

    def transform_plain_to_ntt(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Mod-t plaintext -> its centred lift in NTT form at a level; an
        RNS-form (or CKKS) plaintext is transformed as it is, its scale
        kept."""
        if plain.is_ntt_form:
            raise ValueError("[Evaluator.transform_plain_to_ntt] already NTT")
        cd = self.context.get_context_data(parms_id)
        return Plaintext(self._plain_to_level(plain, cd, ntt=True), parms_id=parms_id,
                         is_ntt_form=True, scale=plain.scale)

    def bfv_scale_up(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Mod-t plaintext -> RNS scale-up form round(m Q / t); BFV only
        (the JAX package fails there with an AttributeError)."""
        if self.context.scheme != SchemeType.BFV:
            raise ValueError("[Evaluator.bfv_scale_up] BFV only")
        cd = self.context.get_context_data(parms_id)
        return Plaintext(cd.scaler.scale_up(plain.data[0]), parms_id=parms_id)

    def bfv_centralize(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Mod-t plaintext -> RNS centred-lift form."""
        cd = self.context.get_context_data(parms_id)
        return Plaintext(cd.scaler.centralize(plain.data[0]), parms_id=parms_id)

    # ------------------------------------------------------------------
    # plaintext utilities (ref: evaluator.h transform_plain_from_ntt,
    # apply_galois_plain, mod_switch_plain_to)
    # ------------------------------------------------------------------
    def transform_plain_from_ntt(self, plain: Plaintext) -> Plaintext:
        """(ref: evaluator_transform_ntt.cu transform_plain_from_ntt)"""
        if not plain.is_ntt_form:
            raise ValueError("[Evaluator.transform_plain_from_ntt] not NTT form")
        return Plaintext(R.ntt_inverse(plain.data, self._cd(plain).qtab()),
                         parms_id=plain.parms_id, is_ntt_form=False, scale=plain.scale)

    def _plain_modulus_base(self, cd: ContextData) -> RNSBase:
        """The one-prime base of t, for permuting mod-t plaintexts."""
        base = getattr(cd, "_t_base", None)
        if base is None:
            base = cd._t_base = RNSBase([cd.parms.plain_modulus], cd.device)
        return base

    def apply_galois_plain(self, plain: Plaintext, galois_elt: int) -> Plaintext:
        """Automorphism x -> x^g of a plaintext (ref: evaluator.h
        apply_galois_plain): a mod-t plaintext permutes with sign mod t, an
        RNS plaintext per limb, in its own domain."""
        out = plain.clone()
        if plain.parms_id == PARMS_ID_ZERO or not self._is_rns_plain(plain):
            cd = self.context.first_context_data()
            out.data = GaloisTool.for_context(cd).apply_coeff(
                plain.data, galois_elt, self._plain_modulus_base(cd))
            return out
        cd = self._cd(plain)
        tool = GaloisTool.for_context(cd)
        out.data = (tool.apply_ntt(plain.data, galois_elt) if plain.is_ntt_form
                    else tool.apply_coeff(plain.data, galois_elt, cd.qtab()))
        return out

    def mod_switch_plain_to(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Walk an NTT-form (CKKS) plaintext down the chain."""
        cur = plain
        while cur.parms_id != parms_id:
            cur = self.mod_switch_plain_to_next(cur)
        return cur

    def mod_switch_drop_to_plain(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """(ref: evaluator_modswitch.cu mod_switch_drop_to_plain_internal)."""
        if not plain.is_ntt_form:
            raise ValueError("[Evaluator.mod_switch_drop_to_plain] plaintext "
                             "must be in NTT form")
        target = self._check_drop_target(self._cd(plain), parms_id,
                                         "mod_switch_drop_to_plain")
        out = plain.clone()
        out.data = plain.data[..., : target.base_q.size, :]
        out.parms_id = parms_id
        return out

    # ------------------------------------------------------------------
    # accumulation and contraction (ref: evaluator.h
    # multiply_plain_accumulate, the batched matmul inner loop)
    # ------------------------------------------------------------------
    def multiply_plain_accumulate(self, cts: list[Ciphertext], plains: list[Plaintext],
                                  accs: list[Ciphertext | None]) -> list[Ciphertext]:
        """acc_i += ct_i * plain_i."""
        out = []
        for ct, pt, acc in zip(cts, plains, accs):
            prod = self.multiply_plain(ct, pt)
            out.append(prod if acc is None else self.add(acc, prod))
        return out

    def multiply_plain_contract(self, cts: list[list[Ciphertext]],
                                plains: list[list[Plaintext]],
                                mesh=None) -> list[list[Ciphertext]]:
        """out[b][j] = sum_i cts[b][i] * plains[i][j] in one stacked pass:
        every input block goes to the NTT domain once, every product
        accumulates into one (bs, os, size, L, n) tensor (ref:
        evaluator_multiply_plain.cu:356, dyadic_broadcast_product_accumulate).
        The JAX package's mesh= sharding is not ported."""
        if mesh is not None:
            raise NotImplementedError("[Evaluator.multiply_plain_contract] mesh= "
                                      "sharding is not ported")
        bs, is_, os_ = len(cts), len(cts[0]), len(plains[0])
        if len(plains) != is_:
            raise ValueError("[Evaluator.multiply_plain_contract] "
                             f"inner dims differ: {len(plains)} vs {is_}")
        ct0, p0 = cts[0][0], plains[0][0]
        cd = self._cd(ct0)
        for row in cts:
            for ct in row:
                if (ct.parms_id != ct0.parms_id or ct.size != ct0.size
                        or ct.is_ntt_form != ct0.is_ntt_form
                        or ct.correction_factor != ct0.correction_factor):
                    raise ValueError("[Evaluator.multiply_plain_contract] "
                                     "ciphertexts must be uniform")
                if self._ckks() and ct.scale != ct0.scale:
                    raise ValueError("[Evaluator.multiply_plain_contract] "
                                     "ciphertext scales must match")
        for row in plains:
            for p in row:
                if p.is_ntt_form != p0.is_ntt_form or p.scale != p0.scale:
                    raise ValueError("[Evaluator.multiply_plain_contract] "
                                     "plaintexts must be uniform")
        qtab = cd.qtab()
        A = torch.stack([torch.stack([ct.data for ct in row]) for row in cts])
        W_raw = torch.stack([torch.stack([p.data for p in row]) for row in plains])
        if self._ckks() or self._is_rns_plain(p0):
            W = W_raw if p0.is_ntt_form else R.ntt_forward(W_raw, qtab)
        else:
            W = R.ntt_forward(cd.scaler.centralize(W_raw[..., 0, :]), qtab)
        A_ntt = A if ct0.is_ntt_form else R.ntt_forward(A, qtab)
        acc = None
        for i in range(is_):
            a_i = A_ntt[:, i, None]                   # (bs, 1, size, L, n)
            w_i = W[i][:, None]                       # (os, 1, L, n)
            acc = (R.dyadic_broadcast_product(a_i, w_i, qtab) if acc is None
                   else R.dyadic_broadcast_product_accumulate(a_i, w_i, acc, qtab))
        out_data = acc if ct0.is_ntt_form else R.ntt_inverse(acc, qtab)
        outs = []
        for b in range(bs):
            row = []
            for j in range(os_):
                o = ct0.clone()
                o.data = out_data[b, j]
                if self._ckks():
                    o.scale = ct0.scale * p0.scale
                row.append(o)
            outs.append(row)
        return outs

    # ------------------------------------------------------------------
    # misc (ref: evaluator.h inline helpers)
    # ------------------------------------------------------------------
    def translate(self, ct1: Ciphertext, ct2: Ciphertext,
                  subtract: bool = False) -> Ciphertext:
        """add or sub by flag (ref: evaluator.h translate_inplace)."""
        return self.sub(ct1, ct2) if subtract else self.add(ct1, ct2)

    def translate_plain(self, ct: Ciphertext, plain: Plaintext,
                        subtract: bool = False) -> Ciphertext:
        return self.sub_plain(ct, plain) if subtract else self.add_plain(ct, plain)

    def exponentiate(self, ct: Ciphertext, power: int, rlk: RelinKeys) -> Ciphertext:
        """ct^power by square and multiply, relinearizing each product."""
        if power < 1:
            raise ValueError("[Evaluator.exponentiate] power must be >= 1")
        result, base = None, ct
        while power:
            if power & 1:
                result = base if result is None else self.relinearize(
                    self.multiply(result, base), rlk)
            power >>= 1
            if power:
                base = self.relinearize(self.square(base), rlk)
        return result

    def negacyclic_shift(self, ct: Ciphertext, shift: int) -> Ciphertext:
        """ct * x^shift; an NTT-form ciphertext shifts in the coefficient
        domain and returns to the NTT domain."""
        if ct.is_ntt_form:
            return self.transform_to_ntt(self.negacyclic_shift(self.transform_from_ntt(ct),
                                                               shift))
        out = ct.clone()
        out.data = P.negacyclic_shift(ct.data, shift, self._cd(ct).qtab())
        return out

    # ------------------------------------------------------------------
    # batched forms (ref: the *_batched family): a list stacks into one
    # (B, size, L, n) tensor and the broadcasting ops run once
    # ------------------------------------------------------------------
    @staticmethod
    def _stack(cts: list[Ciphertext]) -> torch.Tensor:
        return torch.stack([ct.data for ct in cts])

    @staticmethod
    def _unstack(data: torch.Tensor, proto: Ciphertext,
                 metas: list[Ciphertext] | None = None) -> list[Ciphertext]:
        out = []
        for i in range(data.shape[0]):
            ct = (metas[i] if metas else proto).clone()
            ct.data = data[i]
            out.append(ct)
        return out

    def translate_batched(self, cts1, cts2, subtract: bool = False) -> list[Ciphertext]:
        """Batched add / sub with the scalar paths' rules: the CKKS scale
        check, and per element the BGV balancing, as one scalar per batch
        element (ref: evaluator_translate.cu balance_correction_factors)."""
        op = "sub_batched" if subtract else "add_batched"
        if len(cts1) != len(cts2):
            raise ValueError(f"[Evaluator.{op}] length mismatch")
        for a, b in zip(cts1, cts2):
            self._check_same(a, b, op)
            if a.size != b.size:
                raise ValueError(f"[Evaluator.{op}] size mismatch")
        cd = self._cd(cts1[0])
        qtab = cd.qtab()
        x1, x2 = self._stack(cts1), self._stack(cts2)
        metas = cts1
        if self._ckks():
            for a, b in zip(cts1, cts2):
                if abs(a.scale - b.scale) > 0.5 * max(a.scale, b.scale) * 1e-9:
                    raise ValueError(f"[Evaluator.{op}] CKKS scale mismatch")
        elif self._bgv():
            t = cd.parms.plain_modulus.value
            e1, e2, fs = zip(*(self._bgv_multipliers(a.correction_factor,
                                                     b.correction_factor, t)
                               for a, b in zip(cts1, cts2)))
            if any(v != 1 for v in e1 + e2):
                def col(values):
                    return torch.tensor(values, dtype=torch.int64,
                                        device=cd.device).view(-1, 1, 1, 1)
                x1 = R.multiply_scalar(x1, col(e1), qtab)
                x2 = R.multiply_scalar(x2, col(e2), qtab)
            metas = []
            for a, f in zip(cts1, fs):
                m = a.clone()
                m.correction_factor = f
                metas.append(m)
        res = (P.sub if subtract else P.add)(x1, x2, qtab)
        return self._unstack(res, cts1[0], metas)

    def add_batched(self, cts1, cts2) -> list[Ciphertext]:
        return self.translate_batched(cts1, cts2, subtract=False)

    def sub_batched(self, cts1, cts2) -> list[Ciphertext]:
        return self.translate_batched(cts1, cts2, subtract=True)

    def negate_batched(self, cts) -> list[Ciphertext]:
        return self._unstack(P.negate(self._stack(cts), self._cd(cts[0]).qtab()),
                             cts[0], cts)

    def _product_metas(self, out, cts1, cts2, cd: ContextData):
        for o, a, b in zip(out, cts1, cts2):
            if self._ckks():
                o.scale = a.scale * b.scale
            elif self._bgv():
                o.correction_factor = (a.correction_factor * b.correction_factor
                                       % cd.parms.plain_modulus.value)
        return out

    def multiply_batched(self, cts1, cts2) -> list[Ciphertext]:
        if len(cts1) != len(cts2):
            raise ValueError("[Evaluator.multiply_batched] length mismatch")
        for a, b in zip(cts1, cts2):
            self._check_same(a, b, "multiply_batched")
        cd = self._cd(cts1[0])
        if self.context.scheme == SchemeType.BFV:
            res = self.bfv_multiply_impl(cd, self._stack(cts1), self._stack(cts2))
        else:
            self._check_bgv_ntt(cts1[0], "multiply_batched")
            res = R.dyadic_convolute(self._stack(cts1), self._stack(cts2), cd.qtab())
        return self._product_metas(self._unstack(res, cts1[0], cts1), cts1, cts2, cd)

    def square_batched(self, cts) -> list[Ciphertext]:
        if not cts:
            return []
        cd = self._cd(cts[0])
        if self.context.scheme == SchemeType.BFV:
            res = self.bfv_multiply_impl(cd, self._stack(cts), None)
        else:
            self._check_bgv_ntt(cts[0], "square_batched")
            res = R.dyadic_square(self._stack(cts), cd.qtab())
        return self._product_metas(self._unstack(res, cts[0], cts), cts, cts, cd)

    def relinearize_batched(self, cts, rlk: RelinKeys) -> list[Ciphertext]:
        if not cts:
            return []
        size = cts[0].size
        if size < 3:
            raise ValueError("[Evaluator.relinearize_batched] ciphertext size must be >= 3")
        if any(ct.size != size for ct in cts):
            # mixed sizes cannot stack: the scalar path, one by one
            return [self.relinearize(ct, rlk) for ct in cts]
        cd = self._cd(cts[0])
        qtab = cd.qtab()
        ntt_form = cts[0].is_ntt_form
        stacked = self._stack(cts)
        acc = None
        for k in range(2, size):
            target = stacked[:, k]
            if ntt_form:
                target = R.ntt_inverse(target.contiguous(), qtab)
            sw = self._switch_key_impl(cd, target, rlk.key(k), out_ntt=ntt_form)
            acc = sw if acc is None else P.add(acc, sw, qtab)
        return self._unstack(P.add(stacked[:, :2], acc, qtab), cts[0], cts)

    def multiply_plain_batched(self, cts, plains) -> list[Ciphertext]:
        """ct_i * plain_i, the plaintexts stacked beside the ciphertexts; a
        coefficient-form BFV or BGV batch goes to the NTT domain and back."""
        cd = self._cd(cts[0])
        qtab = cd.qtab()
        m_ntt = torch.stack([self._plain_to_level(p, cd, ntt=True) for p in plains])
        res = self._plain_product(self._stack(cts), m_ntt[:, None], qtab, cts[0].is_ntt_form)
        out = self._unstack(res, cts[0], cts)
        if self._ckks():
            for o, c, p in zip(out, cts, plains):
                o.scale = c.scale * p.scale
        return out

    def mod_switch_to_next_batched(self, cts) -> list[Ciphertext]:
        return [self.mod_switch_to_next(ct) for ct in cts]

    def mod_switch_to_batched(self, cts, parms_id: ParmsID) -> list[Ciphertext]:
        return [self.mod_switch_to(ct, parms_id) for ct in cts]

    def mod_switch_drop_to_batched(self, cts, parms_id: ParmsID) -> list[Ciphertext]:
        return [self.mod_switch_drop_to(ct, parms_id) for ct in cts]

    def rescale_to_next_batched(self, cts) -> list[Ciphertext]:
        return [self.rescale_to_next(ct) for ct in cts]

    def apply_galois_batched(self, cts, galois_elt: int,
                             glk: GaloisKeys) -> list[Ciphertext]:
        """One gather and one keyswitch over the stacked batch."""
        if not cts:
            return []
        if any(ct.size != 2 for ct in cts):
            raise ValueError("[Evaluator.apply_galois_batched] needs size-2 cts")
        for ct in cts[1:]:
            self._check_same(cts[0], ct, "apply_galois_batched")
        res = self._apply_galois_impl(self._cd(cts[0]), self._stack(cts),
                                      glk.key(galois_elt), galois_elt, cts[0].is_ntt_form)
        return self._unstack(res, cts[0], cts)

    def _rotate_internal_batched(self, cts, steps: int, glk: GaloisKeys):
        if steps == 0:
            return [ct.clone() for ct in cts]
        n = self._cd(cts[0]).parms.poly_modulus_degree
        elt = GaloisTool.get_element_from_step(steps, n)
        if glk.has(elt):
            return self.apply_galois_batched(cts, elt, glk)
        parts = numth.naf(steps)
        if parts == [steps]:
            raise KeyError(f"[Evaluator.rotate_rows_batched] no Galois key for step {steps}")
        out = cts
        for s in parts:
            out = self._rotate_internal_batched(out, s, glk)
        return out

    def rotate_rows_batched(self, cts, steps: int, glk: GaloisKeys):
        return self._rotate_internal_batched(cts, steps, glk)

    def rotate_vector_batched(self, cts, steps: int, glk: GaloisKeys):
        return self._rotate_internal_batched(cts, steps, glk)

    def rotate_columns_batched(self, cts, glk: GaloisKeys):
        if not cts:
            return []
        n = self._cd(cts[0]).parms.poly_modulus_degree
        return self.apply_galois_batched(cts, GaloisTool.conjugate_element(n), glk)

    complex_conjugate_batched = rotate_columns_batched

    def apply_keyswitching_batched(self, cts, ksk: KSwitchKeys):
        if not cts:
            return []
        if any(ct.size != 2 for ct in cts):
            raise ValueError("[Evaluator.apply_keyswitching_batched] needs size-2 cts")
        cd = self._cd(cts[0])
        qtab = cd.qtab()
        stacked = self._stack(cts)
        target = stacked[:, 1]
        if cts[0].is_ntt_form:
            target = R.ntt_inverse(target.contiguous(), qtab)
        sw = self._switch_key_impl(cd, target, ksk.get(0), out_ntt=cts[0].is_ntt_form)
        res = torch.stack([P.add(sw[:, 0], stacked[:, 0], qtab), sw[:, 1]], dim=1)
        return self._unstack(res, cts[0], cts)

    def transform_to_ntt_batched(self, cts) -> list[Ciphertext]:
        if not cts:
            return []
        if any(ct.is_ntt_form for ct in cts):
            raise ValueError("[Evaluator.transform_to_ntt_batched] already NTT form")
        out = self._unstack(R.ntt_forward(self._stack(cts), self._cd(cts[0]).qtab()),
                            cts[0], cts)
        for o in out:
            o.is_ntt_form = True
        return out

    def transform_from_ntt_batched(self, cts) -> list[Ciphertext]:
        if not cts:
            return []
        if any(not ct.is_ntt_form for ct in cts):
            raise ValueError("[Evaluator.transform_from_ntt_batched] not NTT form")
        out = self._unstack(R.ntt_inverse(self._stack(cts), self._cd(cts[0]).qtab()),
                            cts[0], cts)
        for o in out:
            o.is_ntt_form = False
        return out

    def transform_plain_to_ntt_batched(self, plains, parms_id: ParmsID):
        return [self.transform_plain_to_ntt(p, parms_id) for p in plains]

    def transform_plain_from_ntt_batched(self, plains):
        return [self.transform_plain_from_ntt(p) for p in plains]

    def negacyclic_shift_batched(self, cts, shift: int) -> list[Ciphertext]:
        return [self.negacyclic_shift(ct, shift) for ct in cts]

    def bfv_scale_up_batched(self, plains, parms_id: ParmsID):
        return [self.bfv_scale_up(p, parms_id) for p in plains]

    def bfv_centralize_batched(self, plains, parms_id: ParmsID):
        return [self.bfv_centralize(p, parms_id) for p in plains]

    # -- explicit-form plain products (ref: evaluator.h multiply_plain_ntt /
    #    multiply_plain_normal: the form is checked, then multiply_plain) --
    def multiply_plain_ntt(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        if not plain.is_ntt_form:
            raise ValueError("[Evaluator.multiply_plain_ntt] plain must be NTT form")
        return self.multiply_plain(ct, plain)

    def multiply_plain_normal(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        if plain.is_ntt_form:
            raise ValueError("[Evaluator.multiply_plain_normal] plain must be "
                             "coefficient form")
        return self.multiply_plain(ct, plain)

    def multiply_plain_ntt_batched(self, cts, plains) -> list[Ciphertext]:
        if any(not p.is_ntt_form for p in plains):
            raise ValueError("[Evaluator.multiply_plain_ntt_batched] plains must be NTT form")
        return self.multiply_plain_batched(cts, plains)

    def multiply_plain_normal_batched(self, cts, plains) -> list[Ciphertext]:
        if any(p.is_ntt_form for p in plains):
            raise ValueError("[Evaluator.multiply_plain_normal_batched] plains must be "
                             "coefficient form")
        return self.multiply_plain_batched(cts, plains)

    # -- the reference's *_new names ---------------------------------------
    add_new = add
    sub_new = sub
    multiply_new = multiply
    square_new = square
    negate_new = negate
    relinearize_new = relinearize
    add_plain_new = add_plain
    sub_plain_new = sub_plain
    multiply_plain_new = multiply_plain
    mod_switch_to_next_new = mod_switch_to_next
    rescale_to_next_new = rescale_to_next
    apply_galois_new = apply_galois
    apply_keyswitching_new = apply_keyswitching
    rotate_rows_new = rotate_rows
    rotate_columns_new = rotate_columns
    rotate_vector_new = rotate_vector
    complex_conjugate_new = complex_conjugate
    negacyclic_shift_new = negacyclic_shift
    transform_to_ntt_new = transform_to_ntt
    transform_from_ntt_new = transform_from_ntt
    add_new_batched = add_batched
    sub_new_batched = sub_batched
    multiply_new_batched = multiply_batched
    negate_new_batched = negate_batched
    relinearize_new_batched = relinearize_batched
    multiply_plain_new_batched = multiply_plain_batched
    mod_switch_to_next_new_batched = mod_switch_to_next_batched
    apply_galois_new_batched = apply_galois_batched
    apply_keyswitching_new_batched = apply_keyswitching_batched
    rotate_rows_new_batched = rotate_rows_batched
    rotate_columns_new_batched = rotate_columns_batched
    rotate_vector_new_batched = rotate_vector_batched
    complex_conjugate_new_batched = complex_conjugate_batched
    transform_to_ntt_new_batched = transform_to_ntt_batched
    transform_from_ntt_new_batched = transform_from_ntt_batched

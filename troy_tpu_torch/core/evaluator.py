"""BFV and CKKS evaluator at the u32 fast width (counterpart of
troy_tpu/core/evaluator.py, its BFV and CKKS branches).

  * translate: negate, add, sub, and add_plain / sub_plain;
  * multiply: the BEHZ tensor product with a lift of base q to Bsk and the
    t-folded fast floor, square, and multiply_plain in either form.  The lift
    is chosen per evaluator: "hps" (the default, the JAX package's default)
    or "behz", the reference-exact m~ / sm_mrq lift that the JAX package
    selects with TROY_BFV_BCONV=behz;
  * keyswitching over single-special-prime keys: relinearize,
    apply_keyswitching, apply_galois, rotate_rows (the NAF fallback where the
    keys lack the step's element) and rotate_columns;
  * mod switch (divide and round by the last prime) and the NTT transforms.

CKKS ciphertexts live in the NTT domain and carry a scale, with the JAX
package's rules: add / sub need equal scales (to 1e-9 relative), multiply,
square and multiply_plain multiply them, rescale_to_next divides by the
dropped prime (divide and round in the NTT domain); multiply is the
NTT-domain dyadic product; relinearize, rotate_vector and complex_conjugate
keyswitch with NTT-form output; mod_switch_to_next drops the last limb.

Per-level tables are built on first use and cached on the ContextData.
"""

from __future__ import annotations

import math

import torch

from .context import HeContext, ContextData
from .params import ParmsID, SchemeType
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import KSwitchKeys, RelinKeys, GaloisKeys
from ..ops import ntt as NTT, poly as P, u32 as U, dyadic as D
from ..ops.galois import GaloisTool
from ..utils import numth


LIFTS = ("hps", "behz")


class Evaluator:
    def __init__(self, context: HeContext, lift: str = "hps"):
        if context.scheme not in (SchemeType.BFV, SchemeType.CKKS):
            raise ValueError("[Evaluator] the port supports BFV and CKKS")
        if lift not in LIFTS:
            raise ValueError(f"[Evaluator] lift={lift!r}: expected 'hps' or 'behz'")
        self.context = context
        self.lift = lift

    def _cd(self, ct: Ciphertext | Plaintext) -> ContextData:
        return self.context.get_context_data(ct.parms_id)

    def _ckks(self) -> bool:
        return self.context.scheme == SchemeType.CKKS

    @staticmethod
    def _check_same(ct1: Ciphertext, ct2: Ciphertext, op: str):
        if ct1.parms_id != ct2.parms_id:
            raise ValueError(f"[Evaluator.{op}] operands at different levels")
        if ct1.is_ntt_form != ct2.is_ntt_form:
            raise ValueError(f"[Evaluator.{op}] NTT form mismatch")

    @staticmethod
    def _is_rns_plain(plain: Plaintext) -> bool:
        """True for an RNS-form (L, n) plaintext (bfv_scale_up,
        bfv_centralize, transform_plain_to_ntt), False for mod-t (1, n)."""
        return plain.data.shape[-2] > 1

    # ------------------------------------------------------------------
    # translate (ref: evaluator_translate.cu)
    # ------------------------------------------------------------------
    def negate(self, ct: Ciphertext) -> Ciphertext:
        out = ct.clone()
        out.data = P.negate(ct.data, self._cd(ct).qtab())
        return out

    def add(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """Sum of two ciphertexts; the smaller is padded with zero polys.
        CKKS scales must agree to 1e-9 relative."""
        self._check_same(ct1, ct2, "add")
        if self._ckks() and abs(ct1.scale - ct2.scale) > 0.5 * max(ct1.scale, ct2.scale) * 1e-9:
            raise ValueError("[Evaluator.add] CKKS scale mismatch")
        big, small = (ct1, ct2) if ct1.size >= ct2.size else (ct2, ct1)
        pad = big.size - small.size
        small_data = small.data
        if pad:
            small_data = torch.cat([small_data, small_data.new_zeros(
                (pad, *small_data.shape[1:]))])
        out = big.clone()
        out.data = P.add(big.data, small_data, self._cd(ct1).qtab())
        return out

    def sub(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        return self.add(ct1, self.negate(ct2))

    def _translate_plain(self, ct: Ciphertext, plain: Plaintext,
                         subtract: bool) -> Ciphertext:
        """c0 +- scale_up(m), or +- m for an RNS-form plaintext at ct's level
        (ref: evaluator_translate_plain.cu); a CKKS plaintext goes to the NTT
        domain first."""
        cd = self._cd(ct)
        rns = self._is_rns_plain(plain)
        if rns and plain.parms_id != ct.parms_id:
            raise ValueError("[Evaluator.add_plain] plaintext level mismatch")
        qtab = cd.qtab()
        if self._ckks():
            m = plain.data if plain.is_ntt_form else NTT.ntt_forward(plain.data, qtab)
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
        BFV coefficient-form ciphertext goes to the NTT domain and back.  A
        CKKS product's scale is the product of the scales."""
        cd = self._cd(ct)
        qtab = cd.qtab()
        ckks = self._ckks()
        if ckks or self._is_rns_plain(plain):
            if self._is_rns_plain(plain) and plain.parms_id != ct.parms_id:
                raise ValueError("[Evaluator.multiply_plain] plaintext level mismatch")
            m_ntt = plain.data if plain.is_ntt_form else NTT.ntt_forward(plain.data, qtab)
        else:
            m_ntt = NTT.ntt_forward(cd.scaler.centralize(plain.data[0]), qtab)
        out = ct.clone()
        if ct.is_ntt_form or ckks:
            out.data = D.dyadic_broadcast_product(ct.data, m_ntt, qtab)
        else:
            out.data = NTT.ntt_inverse(D.dyadic_broadcast_product(
                NTT.ntt_forward(ct.data, qtab), m_ntt, qtab), qtab)
        if ckks:
            out.scale = ct.scale * plain.scale
        return out

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """BFV: the BEHZ multiply; CKKS: the NTT-domain dyadic product, at
        the product of the scales."""
        self._check_same(ct1, ct2, "multiply")
        out = ct1.clone()
        if self._ckks():
            out.data = D.dyadic_convolute(ct1.data, ct2.data, self._cd(ct1).qtab())
            out.scale = ct1.scale * ct2.scale
            return out
        if ct1.is_ntt_form:
            raise ValueError("[Evaluator.multiply] BFV operands must be coeff form")
        out.data = self.bfv_multiply_impl(self._cd(ct1), ct1.data,
                                          None if ct1 is ct2 else ct2.data)
        return out

    def square(self, ct: Ciphertext) -> Ciphertext:
        if self._ckks():
            out = ct.clone()
            out.data = D.dyadic_square(ct.data, self._cd(ct).qtab())
            out.scale = ct.scale * ct.scale
            return out
        return self.multiply(ct, ct)

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
        cd._switch_cache = cache
        return cache

    def _switch_key_impl(self, cd: ContextData, target_coeff: torch.Tensor,
                         keys: torch.Tensor, out_ntt: bool = False) -> torch.Tensor:
        """Keyswitch: target (..., L, n) coefficient-domain poly, keys
        (decomp_key, 2, L_key, n) in NTT form at key level -> (..., 2, L, n),
        in the NTT domain if out_ntt, else the coefficient domain.  A level
        below the first takes the key rows of its own primes and the special
        prime."""
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
        if out_ntt:
            body = acc[..., :, :L, :]
            tmp = NTT.ntt_forward(tmp, qtab)
        else:
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
            target = ct.data[k]
            if ct.is_ntt_form:
                target = NTT.ntt_inverse(target, qtab)
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
            target = NTT.ntt_inverse(target, qtab)
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
            target = NTT.ntt_inverse(tool.apply_ntt(data[..., 1, :, :], galois_elt), qtab)
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
        form); CKKS: drop the last limb, the scale unchanged."""
        cd = self._cd(ct)
        if cd.is_last():
            raise ValueError("[Evaluator.mod_switch_to_next] already at last level")
        out = ct.clone()
        out.data = (ct.data[..., :-1, :] if self._ckks()
                    else cd.rns_tool.divide_and_round_q_last(ct.data))
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
        out.data = NTT.ntt_forward(ct.data, self._cd(ct).qtab())
        out.is_ntt_form = True
        return out

    def transform_from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt_form:
            raise ValueError("[Evaluator.transform_from_ntt] not NTT form")
        out = ct.clone()
        out.data = NTT.ntt_inverse(ct.data, self._cd(ct).qtab())
        out.is_ntt_form = False
        return out

    def transform_plain_to_ntt(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Mod-t plaintext -> its centred lift in NTT form at a level; an
        RNS-form (or CKKS) plaintext is transformed as it is, its scale
        kept."""
        if plain.is_ntt_form:
            raise ValueError("[Evaluator.transform_plain_to_ntt] already NTT")
        cd = self.context.get_context_data(parms_id)
        data = plain.data if self._ckks() or self._is_rns_plain(plain) else \
            cd.scaler.centralize(plain.data[0])
        return Plaintext(NTT.ntt_forward(data, cd.qtab()), parms_id=parms_id,
                         is_ntt_form=True, scale=plain.scale)

    def bfv_scale_up(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Mod-t plaintext -> RNS scale-up form round(m Q / t)."""
        cd = self.context.get_context_data(parms_id)
        return Plaintext(cd.scaler.scale_up(plain.data[0]), parms_id=parms_id)

    def bfv_centralize(self, plain: Plaintext, parms_id: ParmsID) -> Plaintext:
        """Mod-t plaintext -> RNS centred-lift form."""
        cd = self.context.get_context_data(parms_id)
        return Plaintext(cd.scaler.centralize(plain.data[0]), parms_id=parms_id)

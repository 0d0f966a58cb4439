"""Decryption (counterpart of troy_tpu/core/decryptor.py): the phase
c0 + c1 s + c2 s^2 + ... via NTT-form secret-key powers, then per scheme

  BFV : the exact {t, gamma} rounding of the RNS tool -> m mod t;
  CKKS: the phase itself, in NTT form with the ciphertext's scale (the
        CKKS encoder decodes it);

and the BFV invariant noise budget."""

from __future__ import annotations

import numpy as np
import torch

from .context import HeContext, ContextData
from .params import SchemeType
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import SecretKey
from ..ops import poly as P, rp as R, u32 as U
from ..utils import numth


class Decryptor:
    def __init__(self, context: HeContext, sk: SecretKey):
        self.context = context
        self.sk = sk
        self._sk_powers: dict[int, torch.Tensor] = {1: sk.data}

    def _power(self, k: int) -> torch.Tensor:
        if k not in self._sk_powers:
            qtab = self.context.key_context_data().qtab()
            self._sk_powers[k] = R.dyadic_product(self._power(k - 1), self.sk.data, qtab)
        return self._sk_powers[k]

    def phase(self, cd: ContextData, data: torch.Tensor) -> torch.Tensor:
        """Coefficient-form phase of a coefficient-form (size, L, n) ciphertext."""
        qtab = cd.qtab()
        L = cd.coeff_modulus_size
        acc = None
        for i in range(1, data.shape[0]):
            term = R.dyadic_product(R.ntt_forward(data[i], qtab),
                                    self._power(i)[:L], qtab)
            acc = term if acc is None else P.add(acc, term, qtab)
        return P.add(R.ntt_inverse(acc, qtab), data[0], qtab)

    def phase_ntt(self, cd: ContextData, data: torch.Tensor) -> torch.Tensor:
        """NTT-form phase of an NTT-form (size, L, n) ciphertext."""
        qtab = cd.qtab()
        L = cd.coeff_modulus_size
        acc = data[0]
        for i in range(1, data.shape[0]):
            acc = P.add(acc, R.dyadic_product(data[i], self._power(i)[:L], qtab), qtab)
        return acc

    def phase_coeff(self, cd: ContextData, ct: Ciphertext) -> torch.Tensor:
        """Coefficient-form phase of a ciphertext in either form."""
        if ct.is_ntt_form:
            return R.ntt_inverse(self.phase_ntt(cd, ct.data), cd.qtab())
        return self.phase(cd, ct.data)

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        cd = self.context.get_context_data(ct.parms_id)
        scheme = cd.parms.scheme
        if scheme == SchemeType.CKKS:
            # the CKKS plaintext contract is NTT form (ref: decryptor.cu)
            ph = (self.phase_ntt(cd, ct.data) if ct.is_ntt_form
                  else R.ntt_forward(self.phase(cd, ct.data), cd.qtab()))
            return Plaintext(ph, parms_id=ct.parms_id, is_ntt_form=True, scale=ct.scale)
        if scheme == SchemeType.BGV:
            t = cd.parms.plain_modulus.value
            m = cd.rns_tool.decrypt_mod_t(self.phase_coeff(cd, ct))
            m = U.mul_mod(m, numth.invert_mod(ct.correction_factor % t, t), t)
            return Plaintext(m[None, :], parms_id=ct.parms_id)
        if ct.is_ntt_form:
            raise ValueError("[Decryptor] BFV ciphertexts are coefficient form")
        m = cd.rns_tool.decrypt_scale_and_round(self.phase(cd, ct.data))
        return Plaintext(m[None, :], parms_id=ct.parms_id)

    def decrypt_batched(self, cts: list[Ciphertext]) -> list[Plaintext]:
        return [self.decrypt(ct) for ct in cts]

    def bfv_decrypt_without_scaling_down(self, ct: Ciphertext) -> Plaintext:
        """The phase in RNS form, in the ciphertext's domain, at its level
        (ref: decryptor.h:62); the ring2k decrypt reads it."""
        cd = self.context.get_context_data(ct.parms_id)
        data = self.phase_ntt(cd, ct.data) if ct.is_ntt_form else self.phase(cd, ct.data)
        return Plaintext(data, parms_id=ct.parms_id)

    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        """log2(Q / 2 ||t * phase mod Q||) in bits, from a host-side CRT
        compose of the phase: a check for tests and users, not a device op."""
        cd = self.context.get_context_data(ct.parms_id)
        if ct.is_ntt_form and cd.parms.scheme != SchemeType.BGV:
            raise ValueError("[Decryptor] BFV ciphertexts are coefficient form")
        t = cd.parms.plain_modulus.value
        if not t:
            raise ValueError("[Decryptor] noise budget needs a plain modulus")
        Q = cd.base_q.prod
        ph = self.phase_coeff(cd, ct).cpu().numpy()
        w = np.array(cd.base_q.compose_array_host(ph), dtype=object) * t % Q
        norm = int(np.where(w > Q // 2, Q - w, w).max())
        if norm == 0:
            return Q.bit_length() - 1
        return max(0, Q.bit_length() - norm.bit_length() - 1)

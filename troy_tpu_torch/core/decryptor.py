"""BFV decryption (counterpart of troy_tpu/core/decryptor.py): the phase
c0 + c1 s + c2 s^2 + ... via NTT-form secret-key powers, then the exact
{t, gamma} rounding of the RNS tool."""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import SecretKey
from ..ops import ntt as NTT, poly as P


class Decryptor:
    def __init__(self, context: HeContext, sk: SecretKey):
        self.context = context
        self.sk = sk
        self._sk_powers: dict[int, torch.Tensor] = {1: sk.data}

    def _power(self, k: int) -> torch.Tensor:
        if k not in self._sk_powers:
            qtab = self.context.key_context_data().qtab()
            self._sk_powers[k] = P.dyadic_product(self._power(k - 1), self.sk.data, qtab)
        return self._sk_powers[k]

    def phase(self, cd: ContextData, data: torch.Tensor) -> torch.Tensor:
        """Coefficient-form phase of a coefficient-form (size, L, n) ciphertext."""
        qtab = cd.qtab()
        L = cd.coeff_modulus_size
        acc = None
        for i in range(1, data.shape[0]):
            term = P.dyadic_product(NTT.ntt_forward(data[i], qtab),
                                    self._power(i)[:L], qtab)
            acc = term if acc is None else P.add(acc, term, qtab)
        return P.add(NTT.ntt_inverse(acc, qtab), data[0], qtab)

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        if ct.is_ntt_form:
            raise ValueError("[Decryptor] BFV ciphertexts are coefficient form")
        cd = self.context.get_context_data(ct.parms_id)
        m = cd.rns_tool.decrypt_scale_and_round(self.phase(cd, ct.data))
        return Plaintext(m[None, :], parms_id=ct.parms_id)

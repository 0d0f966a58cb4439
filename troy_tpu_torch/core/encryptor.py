"""BFV encryption (counterpart of troy_tpu/core/encryptor.py): a zero
encryption in the coefficient domain, under the secret key (symmetric) or the
public key (asymmetric), plus scale_up(m) in c0.

With EncryptionParameters.use_special_prime_for_encryption set, a fresh
ciphertext at the first level is encrypted at the key level and divided by
the special prime (ref: encryptor.cu:264-301).
"""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .params import ParmsID
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import PublicKey, SecretKey
from .rlwe import encrypt_zero_symmetric, encrypt_zero_asymmetric
from ..ops import poly as P


class Encryptor:
    def __init__(self, context: HeContext, sk: SecretKey | None = None,
                 generator: torch.Generator | None = None, pk: PublicKey | None = None):
        if generator is None:
            raise ValueError("[Encryptor] a torch.Generator is required")
        self.context = context
        self.sk = sk
        self.pk = pk
        self.generator = generator

    def _level(self, parms_id: ParmsID | None) -> ContextData:
        return self.context.get_context_data(parms_id or self.context.first_parms_id)

    def _use_special_prime(self, cd: ContextData) -> bool:
        return (cd.parms.use_special_prime_for_encryption
                and cd.parms_id == self.context.first_parms_id
                and self.context.using_keyswitching)

    def _encrypt_zero(self, parms_id: ParmsID | None, zero) -> Ciphertext:
        """zero(cd) -> (2, L, n) at cd's level, or at the key level divided
        by the special prime when special-prime encryption applies."""
        cd = self._level(parms_id)
        if self._use_special_prime(cd):
            key_cd = self.context.key_context_data()
            data = key_cd.rns_tool.divide_and_round_q_last(zero(key_cd))
        else:
            data = zero(cd)
        return Ciphertext(data, cd.parms_id, is_ntt_form=False)

    def encrypt_zero_symmetric(self, parms_id: ParmsID | None = None) -> Ciphertext:
        if self.sk is None:
            raise ValueError("[Encryptor] no secret key set")
        return self._encrypt_zero(parms_id, lambda cd: encrypt_zero_symmetric(
            cd, self.sk.data, self.generator, ntt_form=False))

    def encrypt_zero_asymmetric(self, parms_id: ParmsID | None = None) -> Ciphertext:
        if self.pk is None:
            raise ValueError("[Encryptor] no public key set")
        return self._encrypt_zero(parms_id, lambda cd: encrypt_zero_asymmetric(
            cd, self.pk.data(), self.generator, ntt_form=False))

    def _add_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        """c0 += scale_up(m) for a mod-t plaintext (1, n)."""
        cd = self._level(ct.parms_id)
        m = cd.scaler.scale_up(plain.data[0])
        ct.data = torch.stack([P.add(ct.data[0], m, cd.qtab()), ct.data[1]])
        return ct

    def encrypt_symmetric(self, plain: Plaintext,
                          parms_id: ParmsID | None = None) -> Ciphertext:
        return self._add_plain(self.encrypt_zero_symmetric(parms_id), plain)

    def encrypt_asymmetric(self, plain: Plaintext,
                           parms_id: ParmsID | None = None) -> Ciphertext:
        return self._add_plain(self.encrypt_zero_asymmetric(parms_id), plain)

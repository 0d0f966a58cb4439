"""Encryption (counterpart of troy_tpu/core/encryptor.py) for BFV and CKKS:
a zero encryption under the secret key (symmetric) or the public key
(asymmetric), plus the message in c0:

  BFV : zero (coefficient domain) + scale_up(m)    [m mod t, coefficient form]
  CKKS: zero (NTT domain) + m, with m's scale      [m in RNS at the plaintext's
                                                    level, NTT form]

With EncryptionParameters.use_special_prime_for_encryption set, a fresh
ciphertext at the first level is encrypted at the key level and divided by
the special prime (ref: encryptor.cu:264-301), in the NTT domain for CKKS.

Randomness: a torch.Generator or a RandomGenerator (prng=), else the
context seed's AES stream with the domain "encryptor" (utils/random.py).
"""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .params import ParmsID, SchemeType
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import PublicKey, SecretKey
from .rlwe import encrypt_zero_symmetric, encrypt_zero_asymmetric
from ..ops import ntt as NTT, poly as P
from ..utils.random import RandomGenerator, stream


class Encryptor:
    def __init__(self, context: HeContext, sk: SecretKey | None = None,
                 generator: torch.Generator | None = None, pk: PublicKey | None = None,
                 prng: RandomGenerator | None = None):
        self.context = context
        self.sk = sk
        self.pk = pk
        self.generator = stream(context.seed, generator, prng, "encryptor", "Encryptor")

    def _level(self, parms_id: ParmsID | None) -> ContextData:
        return self.context.get_context_data(parms_id or self.context.first_parms_id)

    def _use_special_prime(self, cd: ContextData) -> bool:
        return (cd.parms.use_special_prime_for_encryption
                and cd.parms_id == self.context.first_parms_id
                and self.context.using_keyswitching)

    def _encrypt_zero(self, parms_id: ParmsID | None, zero) -> Ciphertext:
        """zero(cd, ntt_form) -> (2, L, n) at cd's level, or at the key level
        divided by the special prime when special-prime encryption applies;
        NTT form for CKKS."""
        cd = self._level(parms_id)
        ntt_form = cd.parms.scheme == SchemeType.CKKS
        if self._use_special_prime(cd):
            key_cd = self.context.key_context_data()
            data = zero(key_cd, ntt_form)
            tool = key_cd.rns_tool
            data = (tool.divide_and_round_q_last_ntt(data, key_cd.qtab()) if ntt_form
                    else tool.divide_and_round_q_last(data))
        else:
            data = zero(cd, ntt_form)
        return Ciphertext(data, cd.parms_id, is_ntt_form=ntt_form)

    def encrypt_zero_symmetric(self, parms_id: ParmsID | None = None) -> Ciphertext:
        if self.sk is None:
            raise ValueError("[Encryptor] no secret key set")
        return self._encrypt_zero(parms_id, lambda cd, ntt_form: encrypt_zero_symmetric(
            cd, self.sk.data, self.generator, ntt_form=ntt_form))

    def encrypt_zero_asymmetric(self, parms_id: ParmsID | None = None) -> Ciphertext:
        if self.pk is None:
            raise ValueError("[Encryptor] no public key set")
        return self._encrypt_zero(parms_id, lambda cd, ntt_form: encrypt_zero_asymmetric(
            cd, self.pk.data(), self.generator, ntt_form=ntt_form))

    def _add_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        """c0 += scale_up(m) for a BFV mod-t plaintext (1, n); c0 += m for a
        CKKS plaintext at ct's level, whose scale ct takes."""
        cd = self._level(ct.parms_id)
        if cd.parms.scheme == SchemeType.CKKS:
            if plain.parms_id != cd.parms_id:
                raise ValueError("[Encryptor] CKKS plaintext level mismatch")
            m = plain.data if plain.is_ntt_form else NTT.ntt_forward(plain.data, cd.qtab())
            ct.scale = plain.scale
        else:
            m = cd.scaler.scale_up(plain.data[0])
        ct.data = torch.stack([P.add(ct.data[0], m, cd.qtab()), ct.data[1]])
        return ct

    def _plain_level(self, plain: Plaintext, parms_id: ParmsID | None) -> ParmsID | None:
        """A CKKS plaintext is encrypted at its own level."""
        return plain.parms_id if self.context.scheme == SchemeType.CKKS else parms_id

    def encrypt_symmetric(self, plain: Plaintext,
                          parms_id: ParmsID | None = None) -> Ciphertext:
        return self._add_plain(
            self.encrypt_zero_symmetric(self._plain_level(plain, parms_id)), plain)

    def encrypt_asymmetric(self, plain: Plaintext,
                           parms_id: ParmsID | None = None) -> Ciphertext:
        return self._add_plain(
            self.encrypt_zero_asymmetric(self._plain_level(plain, parms_id)), plain)

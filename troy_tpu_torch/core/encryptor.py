"""Encryption (counterpart of troy_tpu/core/encryptor.py) for BFV, CKKS and
BGV: a zero encryption under the secret key (symmetric) or the public key
(asymmetric), plus the message in c0:

  BFV : zero (coefficient domain) + scale_up(m)    [m mod t, coefficient form]
  CKKS: zero (NTT domain) + m, with m's scale      [m in RNS at the plaintext's
                                                    level, NTT form]
  BGV : zero (NTT domain) + NTT(centralize(m cf))  [m mod t; cf the
                                                    ciphertext's correction factor]

With EncryptionParameters.use_special_prime_for_encryption set, a fresh
ciphertext at the first level is encrypted at the key level and divided by
the special prime (ref: encryptor.cu:264-301), in the NTT domain for CKKS
and BGV; BGV divides keeping the payload mod t and so takes the correction
factor q_sp^-1 mod t.

Randomness: a torch.Generator or a RandomGenerator (prng=), else the
context seed's threefry stream with the domain "encryptor"
(utils/random.py).  save_seed=True makes a seed-compressed symmetric
ciphertext: c1 is uniform_from_seed of a seed it keeps, so that it
serializes as (c0, seed).  Special-prime encryption drops the seed: its c1 is
no longer the raw PRNG output after the division.
"""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .params import ParmsID, SchemeType
from .plaintext import Plaintext, is_rns_form
from .ciphertext import Ciphertext
from .keys import PublicKey, SecretKey
from .rlwe import encrypt_zero_symmetric, encrypt_zero_asymmetric
from ..ops import poly as P, rp as R, u32 as U
from ..utils import numth
from ..utils.random import RandomGenerator, stream, new_seed


class Encryptor:
    def __init__(self, context: HeContext, sk: SecretKey | None = None,
                 generator: torch.Generator | None = None, pk: PublicKey | None = None,
                 prng: RandomGenerator | None = None):
        self.context = context
        self.sk = sk
        self.pk = pk
        self.generator = stream(context.seed, generator, prng, "encryptor")
        self.prng = self.generator  # the JAX package's name for the stream

    def _level(self, parms_id: ParmsID | None) -> ContextData:
        return self.context.get_context_data(parms_id or self.context.first_parms_id)

    def _use_special_prime(self, cd: ContextData) -> bool:
        return (cd.parms.use_special_prime_for_encryption
                and cd.parms_id == self.context.first_parms_id
                and self.context.using_keyswitching)

    def _encrypt_zero(self, parms_id: ParmsID | None, zero, save_seed: bool = False) -> Ciphertext:
        """zero(cd, ntt_form, seed) -> (2, L, n) at cd's level, or at the key
        level divided by the special prime when special-prime encryption
        applies (no seed then); NTT form for CKKS and BGV."""
        cd = self._level(parms_id)
        scheme = cd.parms.scheme
        ntt_form = scheme in (SchemeType.CKKS, SchemeType.BGV)
        if not self._use_special_prime(cd):
            seed = new_seed(self.generator) if save_seed else None
            return Ciphertext(zero(cd, ntt_form, seed), cd.parms_id, is_ntt_form=ntt_form,
                              seed=seed)
        key_cd = self.context.key_context_data()
        data = zero(key_cd, ntt_form, None)
        tool, ktab = key_cd.rns_tool, key_cd.qtab()
        cf = 1
        if scheme == SchemeType.BGV:
            t = cd.parms.plain_modulus.value
            data = tool.mod_t_and_divide_q_last_ntt(data, ktab)
            cf = numth.invert_mod(key_cd.parms.coeff_modulus[-1].value % t, t)
        elif ntt_form:
            data = tool.divide_and_round_q_last_ntt(data, ktab)
        else:
            data = tool.divide_and_round_q_last(data)
        return Ciphertext(data, cd.parms_id, is_ntt_form=ntt_form, correction_factor=cf)

    def encrypt_zero_symmetric(self, parms_id: ParmsID | None = None,
                               save_seed: bool = False) -> Ciphertext:
        if self.sk is None:
            raise ValueError("[Encryptor] no secret key set")
        return self._encrypt_zero(parms_id, lambda cd, ntt_form, seed: encrypt_zero_symmetric(
            cd, self.sk.data, self.generator, ntt_form=ntt_form, seed=seed), save_seed)

    def encrypt_zero_asymmetric(self, parms_id: ParmsID | None = None) -> Ciphertext:
        if self.pk is None:
            raise ValueError("[Encryptor] no public key set")
        return self._encrypt_zero(parms_id, lambda cd, ntt_form, seed: encrypt_zero_asymmetric(
            cd, self.pk.data(), self.generator, ntt_form=ntt_form))

    @staticmethod
    def plain_payload(cd: ContextData, plain_data: torch.Tensor, cf: int, is_rns: bool,
                      plain_ntt: bool) -> torch.Tensor:
        """The message term of c0 in the ciphertext's domain: scale_up(m)
        for a BFV mod-t plaintext (1, n), or m as given in RNS form; m (in
        NTT form) for CKKS; the NTT of the centred m cf mod t for BGV (cf the
        ciphertext's correction factor).  Shared with the device-batched
        encrypt steps (parallel/batched.py BatchedClient)."""
        scheme = cd.parms.scheme
        if scheme == SchemeType.BFV:
            return plain_data if is_rns else cd.scaler.scale_up(plain_data[0])
        if scheme == SchemeType.CKKS:
            return plain_data if plain_ntt else R.ntt_forward(plain_data, cd.qtab())
        t = cd.parms.plain_modulus.value
        return R.ntt_forward(cd.scaler.centralize(U.mul_mod(plain_data[0], cf % t, t)),
                               cd.qtab())

    def _add_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        """c0 += the plaintext's payload; a CKKS plaintext must be at ct's
        level, and ct takes its scale.  c1, and a seed, stay."""
        cd = self._level(ct.parms_id)
        if cd.parms.scheme == SchemeType.CKKS:
            if plain.parms_id != cd.parms_id:
                raise ValueError("[Encryptor] CKKS plaintext level mismatch")
            ct.scale = plain.scale
        m = self.plain_payload(cd, plain.data, ct.correction_factor,
                               is_rns_form(plain, cd.wide), plain.is_ntt_form)
        seed = ct.seed  # c1 stays the seed's expansion
        ct.data = torch.stack([P.add(ct.data[0], m, cd.qtab()), ct.data[1]])
        ct.seed = seed
        return ct

    def _plain_level(self, plain: Plaintext, parms_id: ParmsID | None) -> ParmsID | None:
        """A CKKS plaintext is encrypted at its own level."""
        return plain.parms_id if self.context.scheme == SchemeType.CKKS else parms_id

    def encrypt_symmetric(self, plain: Plaintext, parms_id: ParmsID | None = None,
                          save_seed: bool = False) -> Ciphertext:
        return self._add_plain(
            self.encrypt_zero_symmetric(self._plain_level(plain, parms_id), save_seed), plain)

    def encrypt_asymmetric(self, plain: Plaintext,
                           parms_id: ParmsID | None = None) -> Ciphertext:
        return self._add_plain(
            self.encrypt_zero_asymmetric(self._plain_level(plain, parms_id)), plain)

    def encrypt_asymmetric_batched(self, plains: list[Plaintext],
                                   parms_id: ParmsID | None = None) -> list[Ciphertext]:
        return [self.encrypt_asymmetric(p, parms_id) for p in plains]

    def encrypt_symmetric_batched(self, plains: list[Plaintext], parms_id: ParmsID | None = None,
                                  save_seed: bool = False) -> list[Ciphertext]:
        return [self.encrypt_symmetric(p, parms_id, save_seed) for p in plains]

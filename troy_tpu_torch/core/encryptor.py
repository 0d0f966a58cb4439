"""Symmetric BFV encryption (counterpart of troy_tpu/core/encryptor.py):
a zero encryption in the coefficient domain plus scale_up(m) in c0."""

from __future__ import annotations

import torch

from .context import HeContext, ContextData
from .params import ParmsID
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import SecretKey
from .rlwe import encrypt_zero_symmetric
from ..ops import poly as P


class Encryptor:
    def __init__(self, context: HeContext, sk: SecretKey, generator: torch.Generator):
        self.context = context
        self.sk = sk
        self.generator = generator

    def _level(self, parms_id: ParmsID | None) -> ContextData:
        return self.context.get_context_data(parms_id or self.context.first_parms_id)

    def encrypt_zero_symmetric(self, parms_id: ParmsID | None = None) -> Ciphertext:
        cd = self._level(parms_id)
        data = encrypt_zero_symmetric(cd, self.sk.data, self.generator, ntt_form=False)
        return Ciphertext(data, cd.parms_id, is_ntt_form=False)

    def encrypt_symmetric(self, plain: Plaintext,
                          parms_id: ParmsID | None = None) -> Ciphertext:
        ct = self.encrypt_zero_symmetric(parms_id)
        cd = self._level(ct.parms_id)
        m = cd.scaler.scale_up(plain.data[0])
        ct.data = torch.stack([P.add(ct.data[0], m, cd.qtab()), ct.data[1]])
        return ct

"""Key objects (counterpart of troy_tpu/core/keys.py).

SecretKey holds the NTT-form ternary secret s at the key level, (L_key, n);
PublicKey an NTT-form encryption of zero at the key level, (2, L_key, n).
A switching key is one stacked (decomp, 2, L_key, n) int64 tensor in NTT
form at the key level, so the keyswitch inner product runs over its leading
axis.
"""

from __future__ import annotations

import torch

from .params import ParmsID
from .ciphertext import Ciphertext


class SecretKey:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID):
        self.data = data
        self.parms_id = parms_id

    def clone(self) -> "SecretKey":
        return SecretKey(self.data, self.parms_id)


class PublicKey:
    """pk = (-(a s + e), a) in NTT form at the key level (ref: key.h:90)."""

    def __init__(self, ciphertext: Ciphertext):
        self.ciphertext = ciphertext

    @property
    def parms_id(self) -> ParmsID:
        return self.ciphertext.parms_id

    def data(self) -> torch.Tensor:
        return self.ciphertext.data


class KSwitchKeys:
    """keys[k] is one switching key, a (decomp, 2, L_key, n) tensor."""

    def __init__(self, keys: dict[int, torch.Tensor], parms_id: ParmsID):
        self.keys = keys
        self.parms_id = parms_id

    def has(self, index: int) -> bool:
        return index in self.keys

    def get(self, index: int) -> torch.Tensor:
        if index not in self.keys:
            raise KeyError(f"[KSwitchKeys] no key at index {index}")
        return self.keys[index]


class RelinKeys(KSwitchKeys):
    """Key index k holds the switching key for s^(k+2)."""

    def key(self, power: int) -> torch.Tensor:
        return self.get(power - 2)


class GaloisKeys(KSwitchKeys):
    """Key index g holds the switching key for x -> x^g (ref:
    kswitch_keys.h:310)."""

    @staticmethod
    def get_index(galois_elt: int) -> int:
        return galois_elt

    def key(self, galois_elt: int) -> torch.Tensor:
        return self.get(galois_elt)

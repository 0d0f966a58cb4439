"""Key objects (counterpart of troy_tpu/core/keys.py).

SecretKey holds the NTT-form ternary secret s at the key level, (L_key, n).
A switching key is one stacked (decomp, 2, L_key, n) int64 tensor in NTT
form at the key level, so the keyswitch inner product runs over its leading
axis.
"""

from __future__ import annotations

import torch

from .params import ParmsID


class SecretKey:
    def __init__(self, data: torch.Tensor, parms_id: ParmsID):
        self.data = data
        self.parms_id = parms_id


class KSwitchKeys:
    """keys[k] is one switching key, a (decomp, 2, L_key, n) tensor."""

    def __init__(self, keys: dict[int, torch.Tensor], parms_id: ParmsID):
        self.keys = keys
        self.parms_id = parms_id

    def get(self, index: int) -> torch.Tensor:
        if index not in self.keys:
            raise KeyError(f"[KSwitchKeys] no key at index {index}")
        return self.keys[index]


class RelinKeys(KSwitchKeys):
    """Key index k holds the switching key for s^(k+2)."""

    def key(self, power: int) -> torch.Tensor:
        return self.get(power - 2)

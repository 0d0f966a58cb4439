"""RNS base and fast base conversion, on int64 residue tensors.

Counterpart of troy_tpu/rns/rns_base.py.  The host keeps Python-int CRT
constants; the device holds (L,) int64 tensors.  The base-change

    y_j = sum_i [x_i * (Q/q_i)^-1]_{q_i} * [(Q/q_i)]_{p_j}  mod p_j

runs through ops/bconv.base_convert: the Hopper kernel (csrc/bconv.cu, the
counterpart of the JAX package's Pallas K3) on a CUDA tensor, an exact int64
dot on a CPU tensor.  Both give the JAX package's residues bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..ops import bconv as BC


class RNSBase:
    """An ordered set of pairwise-coprime moduli, with its tables on `device`."""

    def __init__(self, moduli: list[Modulus], device):
        if not moduli:
            raise ValueError("[RNSBase] empty base")
        vals = [m.value for m in moduli]
        for i in range(len(vals)):
            for j in range(i + 1, len(vals)):
                if not numth.are_coprime(vals[i], vals[j]):
                    raise ValueError("[RNSBase] moduli must be pairwise coprime")
        self.moduli = list(moduli)
        self.values = vals
        self.size = len(vals)
        self.device = torch.device(device)
        self.prod: int = 1
        for v in vals:
            self.prod *= v
        # punctured products Q/q_i and their inverses mod q_i
        self.punctured = [self.prod // v for v in vals]
        self.inv_punctured = [
            numth.invert_mod(p % v, v) for p, v in zip(self.punctured, vals)
        ]
        self.q = torch.tensor(vals, dtype=torch.int64, device=self.device)

    def compose_array_host(self, arr: np.ndarray) -> list[int]:
        """(L, n) residues -> list of Python ints in [0, Q), by the CRT over
        object-dtype numpy rows."""
        acc = np.zeros(arr.shape[1], dtype=object)
        for i in range(self.size):
            row = np.asarray(arr[i]).astype(object)
            acc += (row * self.inv_punctured[i] % self.values[i]) * self.punctured[i]
        return list(acc % self.prod)


class BaseConverter:
    """Fast (approximate) base conversion ibase -> obase: the output equals
    the input integer plus alpha * prod(ibase) for some 0 <= alpha < |ibase|."""

    def __init__(self, ibase: RNSBase, obase: RNSBase):
        self.ibase = ibase
        self.obase = obase
        # tables.mat[j, i] = (Q/q_i) mod p_j
        self.tables = BC.BConvTables(
            ibase.values, ibase.inv_punctured, obase.values,
            [[punc % p for punc in ibase.punctured] for p in obase.values],
            obase.device)

    def convert(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L_in, n) residues in ibase -> (..., L_out, n) in obase."""
        return BC.base_convert(x, self.tables)

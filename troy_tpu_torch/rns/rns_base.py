"""RNS base and fast base conversion, on int64 residue tensors.

Counterpart of troy_tpu/rns/rns_base.py.  The host keeps Python-int CRT
constants; the device holds (L,) int64 tensors.  The base-change

    y_j = sum_i [x_i * (Q/q_i)^-1]_{q_i} * [(Q/q_i)]_{p_j}  mod p_j

runs as an exact int64 dot (ops/u32.dot_mod), the counterpart of the JAX
package's VPU dot path.
"""

from __future__ import annotations

import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..ops import u32 as U


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
        self.inv_punctured_t = torch.tensor(self.inv_punctured, dtype=torch.int64,
                                            device=self.device)


class BaseConverter:
    """Fast (approximate) base conversion ibase -> obase: the output equals
    the input integer plus alpha * prod(ibase) for some 0 <= alpha < |ibase|."""

    def __init__(self, ibase: RNSBase, obase: RNSBase):
        self.ibase = ibase
        self.obase = obase
        # mat[j, i] = (Q/q_i) mod p_j
        mat = [[punc % p for punc in ibase.punctured] for p in obase.values]
        self._mat = torch.tensor(mat, dtype=torch.int64, device=obase.device)

    def convert(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L_in, n) residues in ibase -> (..., L_out, n) in obase."""
        ib = self.ibase
        tmp = U.mul_mod(x, ib.inv_punctured_t.view(-1, 1), ib.q.view(-1, 1))
        pairs = [(tmp[..., i:i + 1, :], self._mat[:, i:i + 1])
                 for i in range(ib.size)]
        return U.dot_mod(pairs, self.obase.q.view(-1, 1))

"""BFV and BGV SIMD batch encoder (counterpart of
troy_tpu/core/batch_encoder.py).  It keys on simd_supported only (t prime,
t = 1 mod 2n), so it serves BGV unchanged: a BGV plaintext is the same mod-t
coefficient polynomial, which the encryptor lifts centred.

Slots form a 2 x (n/2) matrix; slot (r, c) is the evaluation of the
plaintext polynomial at psi_t^e with e = (+-1) * 3^c mod 2n.  The NTT puts
the evaluation at psi^(2*brv(p)+1) at position p, so the slot -> position
map is p = reverse_bits((e-1)/2, log n).  encode scatters slots to NTT
positions and runs the inverse NTT mod t; decode runs the forward NTT and
gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import HeContext
from .plaintext import Plaintext
from ..ops import ntt as NTT
from ..utils import numth


class BatchEncoder:
    def __init__(self, context: HeContext):
        self.context = context
        cd = context.first_context_data()
        if not cd.simd_supported:
            raise ValueError("[BatchEncoder] t does not support batching")
        self.t = cd.parms.plain_modulus
        self.n = n = cd.parms.poly_modulus_degree
        self.device = cd.device
        self.tables = NTT.NTTTables(cd.log_n, [self.t], cd.device)
        m = 2 * n
        pos = np.empty(n, dtype=np.int64)
        e = 1
        for c in range(n // 2):
            pos[c] = numth.reverse_bits((e - 1) // 2, cd.log_n)
            pos[c + n // 2] = numth.reverse_bits((m - e - 1) // 2, cd.log_n)
            e = e * 3 % m
        self._slot_to_pos = torch.from_numpy(pos).to(cd.device)

    def encode(self, values) -> Plaintext:
        """SIMD-encode up to n integers (reduced mod t)."""
        v = torch.as_tensor(np.asarray(values, dtype=np.uint64).astype(np.int64)
                            % self.t.value, device=self.device)
        slots = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        slots[self._slot_to_pos[:v.shape[0]]] = v
        return Plaintext(NTT.ntt_inverse(slots[None, :], self.tables))

    def decode(self, plain: Plaintext) -> torch.Tensor:
        """(n,) int64 slot values mod t."""
        evals = NTT.ntt_forward(plain.data.contiguous(), self.tables)[0]
        return evals[self._slot_to_pos]

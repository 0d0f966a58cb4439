"""BFV and BGV batch encoder (counterpart of troy_tpu/core/batch_encoder.py).
SIMD encoding keys on simd_supported only (t prime, t = 1 mod 2n), so it
serves BGV unchanged: a BGV plaintext is the same mod-t coefficient
polynomial, which the encryptor lifts centred.

Slots form a 2 x (n/2) matrix; slot (r, c) is the evaluation of the
plaintext polynomial at psi_t^e with e = (+-1) * 3^c mod 2n.  The NTT puts
the evaluation at psi^(2*brv(p)+1) at position p, so the slot -> position
map is p = reverse_bits((e-1)/2, log n).  encode scatters slots to NTT
positions and runs the inverse NTT mod t; decode runs the forward NTT and
gathers.

Without SIMD support the raw coefficient encoding (encode_polynomial /
decode_polynomial) and the RNS form conversions still work: scale_up
(round(m Q / t), the encryption form), scale_down (its inverse, by the RNS
tool's decrypt rounding), centralize (the centred lift, the operand form)
and decentralize.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import HeContext, ContextData
from .params import ParmsID
from .plaintext import Plaintext
from ..ops import ntt as NTT
from ..utils import numth


class BatchEncoder:
    def __init__(self, context: HeContext):
        self.context = context
        cd = context.first_context_data()
        self.t = cd.parms.plain_modulus
        self.n = n = cd.parms.poly_modulus_degree
        self.device = cd.device
        self.simd = cd.simd_supported
        if not self.simd:
            return
        self.tables = NTT.NTTTables(cd.log_n, [self.t], cd.device)
        m = 2 * n
        pos = np.empty(n, dtype=np.int64)
        e = 1
        for c in range(n // 2):
            pos[c] = numth.reverse_bits((e - 1) // 2, cd.log_n)
            pos[c + n // 2] = numth.reverse_bits((m - e - 1) // 2, cd.log_n)
            e = e * 3 % m
        self._slot_to_pos = torch.from_numpy(pos).to(cd.device)

    @property
    def slot_count(self) -> int:
        return self.n

    @property
    def simd_encoding_supported(self) -> bool:
        return self.simd

    def _check_simd(self):
        if not self.simd:
            raise ValueError("[BatchEncoder] t does not support batching")

    def encode(self, values) -> Plaintext:
        """SIMD-encode up to n integers (reduced mod t)."""
        self._check_simd()
        v = torch.as_tensor(np.asarray(values, dtype=np.uint64).astype(np.int64)
                            % self.t.value, device=self.device)
        slots = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        slots[self._slot_to_pos[:v.shape[0]]] = v
        return Plaintext(NTT.ntt_inverse(slots[None, :], self.tables), coeff_count=self.n)

    def decode(self, plain: Plaintext) -> np.ndarray:
        """(n,) slot values mod t, numpy uint64 on the host as the JAX
        package's (the forward NTT mod t runs on the plaintext's device)."""
        self._check_simd()
        evals = NTT.ntt_forward(plain.data.contiguous(), self.tables)[0]
        return evals[self._slot_to_pos].cpu().numpy().astype(np.uint64)

    # ------------------------------------------------------------------
    def encode_polynomial(self, coeffs) -> Plaintext:
        """Raw coefficient encoding, no SIMD: a (1, n) mod-t plaintext whose
        coeff_count is the number of coefficients given."""
        arr = np.asarray(coeffs, dtype=np.uint64)
        v = np.zeros(self.n, dtype=np.int64)
        v[: len(arr)] = (arr % self.t.value).astype(np.int64)
        return Plaintext(torch.from_numpy(v[None, :]).to(self.device), coeff_count=len(arr))

    def decode_polynomial(self, plain: Plaintext) -> np.ndarray:
        """The (n,) coefficients of a mod-t plaintext, numpy uint64."""
        return plain.data[0].cpu().numpy().astype(np.uint64)

    # ------------------------------------------------------------------
    # RNS form conversions: mod-t plaintext <-> RNS forms at a level
    # ------------------------------------------------------------------
    def _cd(self, parms_id: ParmsID | None) -> ContextData:
        return self.context.get_context_data(parms_id or self.context.first_parms_id)

    def scale_up(self, plain: Plaintext, parms_id: ParmsID | None = None) -> Plaintext:
        """Mod-t coefficients -> round(m Q / t) in RNS (the encryption form)."""
        cd = self._cd(parms_id)
        return Plaintext(cd.scaler.scale_up(plain.data[0]), parms_id=cd.parms_id,
                         coeff_count=plain.coeff_count)

    def scale_down(self, plain: Plaintext) -> Plaintext:
        """Inverse of scale_up: round(m t / Q) mod t, by the RNS tool's
        {t, gamma} decrypt rounding."""
        cd = self.context.get_context_data(plain.parms_id)
        m = cd.rns_tool.decrypt_scale_and_round(plain.data)
        return Plaintext(m[None, :], coeff_count=plain.coeff_count)

    def centralize(self, plain: Plaintext, parms_id: ParmsID | None = None) -> Plaintext:
        """Mod-t coefficients -> their centred lift in RNS (the operand form)."""
        cd = self._cd(parms_id)
        return Plaintext(cd.scaler.centralize(plain.data[0]), parms_id=cd.parms_id,
                         coeff_count=plain.coeff_count)

    def decentralize(self, plain: Plaintext) -> Plaintext:
        """Inverse of centralize."""
        cd = self.context.get_context_data(plain.parms_id)
        m = cd.scaler.decentralize(plain.data)
        return Plaintext(m[None, :], coeff_count=plain.coeff_count)

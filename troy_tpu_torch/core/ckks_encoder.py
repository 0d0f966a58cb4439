"""CKKS encoder: the canonical-embedding encode and decode (counterpart of
troy_tpu/core/ckks_encoder.py, its host path).

Slot k (k < n/2) is the evaluation at zeta^(e_k), e_k = 3^k mod 2n (zeta =
exp(i pi / n)), with the conjugate value at -e_k.  Evaluations at all odd
powers relate to the coefficients by a twisted size-n FFT,

    p(zeta^(2j+1)) = sum_i (c_i zeta^i) omega^(i j),  omega = exp(2 i pi / n),

so encode scatters the slots to the odd-power evaluations, runs the FFT over
n, untwists, rounds scale * c to integers, decomposes them centred into the
level's RNS base and runs the forward NTT.  The floating-point part runs on
the host in numpy complex128 with the JAX package's operations in its order,
so the integers, and hence the residues, equal the JAX package's bit for
bit, and decode (the host CRT of rns_base.compose_centered_f64_host, then
the inverse FFT) gives the same floats.  The NTTs go through the port's
dispatch (ops/ntt.py), so on the card they run the NTT kernel.

The JAX package's device encode and decode (the double-float FFT of
ops/ddfft.py) are not ported; ROADMAP A lists them.
"""

from __future__ import annotations

import numpy as np
import torch

from .context import HeContext, ContextData
from .params import ParmsID
from .plaintext import Plaintext
from ..ops import ntt as NTT


def _round_ints(scaled: np.ndarray):
    """Round float64 coefficients to integers: int64 lanes when they fit
    (float64 has 53 mantissa bits, so always exact), object otherwise."""
    if np.max(np.abs(scaled)) < 2.0 ** 62:
        return np.round(scaled).astype(np.int64)
    return np.array([int(round(x)) for x in scaled], dtype=object)


class CKKSEncoder:
    def __init__(self, context: HeContext):
        self.context = context
        cd = context.first_context_data()
        n = cd.parms.poly_modulus_degree
        self.n = n
        self.slots = n // 2
        # slot k <-> odd-power index j = (e_k - 1) / 2 and its conjugate
        m = 2 * n
        e = 1
        idx = np.empty(self.slots, dtype=np.int64)
        idx_conj = np.empty(self.slots, dtype=np.int64)
        for k in range(self.slots):
            idx[k] = (e - 1) // 2
            idx_conj[k] = (m - e - 1) // 2
            e = e * 3 % m
        self._idx, self._idx_conj = idx, idx_conj
        i = np.arange(n)
        self._twist = np.exp(1j * np.pi * i / n)        # zeta^i
        self._untwist = np.conj(self._twist)

    @property
    def slot_count(self) -> int:
        return self.slots

    def _level(self, parms_id: ParmsID | None) -> ContextData:
        return self.context.get_context_data(parms_id or self.context.first_parms_id)

    @staticmethod
    def _to_ntt(coeffs, cd: ContextData) -> torch.Tensor:
        """Centred integers (n,) -> their (L, n) residues in NTT form on the
        context's device."""
        rns = torch.from_numpy(cd.base_q.decompose_array_host(coeffs)).to(cd.device)
        return NTT.ntt_forward(rns, cd.qtab())

    @staticmethod
    def _centered(plain: Plaintext, cd: ContextData) -> np.ndarray:
        """The plaintext's coefficients, centred, as float64 (host CRT)."""
        data = NTT.ntt_inverse(plain.data, cd.qtab()) if plain.is_ntt_form else plain.data
        return cd.base_q.compose_centered_f64_host(data.cpu().numpy())

    def encode(self, values, parms_id: ParmsID | None = None,
               scale: float = 2.0 ** 40) -> Plaintext:
        """SIMD-encode complex values (ref: ckks_encoder.h:84 encode_complex64_simd)."""
        cd = self._level(parms_id)
        v = np.zeros(self.slots, dtype=np.complex128)
        arr = np.asarray(values, dtype=np.complex128)
        v[: len(arr)] = arr
        ev = np.zeros(self.n, dtype=np.complex128)
        ev[self._idx] = v
        ev[self._idx_conj] = np.conj(v)
        coeffs = (np.fft.fft(ev) / self.n) * self._untwist
        scaled = coeffs.real * scale
        if np.max(np.abs(scaled)) >= cd.total_coeff_modulus / 2:
            raise ValueError("[CKKSEncoder.encode] scaled values exceed q/2")
        return Plaintext(self._to_ntt(_round_ints(scaled), cd), cd.parms_id,
                         is_ntt_form=True, scale=scale)

    def encode_float64_polynomial(self, coeffs, parms_id: ParmsID | None = None,
                                  scale: float = 2.0 ** 40) -> Plaintext:
        """Encode raw real coefficients, no embedding
        (ref: ckks_encoder.h encode_float64_polynomial)."""
        cd = self._level(parms_id)
        c = np.zeros(self.n)
        arr = np.asarray(coeffs, dtype=np.float64)
        c[: len(arr)] = arr
        return Plaintext(self._to_ntt(_round_ints(c * scale), cd), cd.parms_id,
                         is_ntt_form=True, scale=scale)

    def encode_float64_single(self, value: float, parms_id: ParmsID | None = None,
                              scale: float = 2.0 ** 40) -> Plaintext:
        """A constant: value in every slot = constant coefficient c_0."""
        return self.encode_float64_polynomial([value], parms_id, scale)

    def encode_complex64_single(self, value: complex, parms_id: ParmsID | None = None,
                                scale: float = 2.0 ** 40) -> Plaintext:
        """A complex constant in every slot (ref: ckks_encoder.h
        encode_complex64_single)."""
        return self.encode(np.full(self.slots, value, dtype=np.complex128), parms_id, scale)

    def encode_integer64_single(self, value: int,
                                parms_id: ParmsID | None = None) -> Plaintext:
        """An exact integer constant at scale 1 (ref: ckks_encoder.h
        encode_integer64_single): multiplying by it scales without noise."""
        cd = self._level(parms_id)
        ints = np.array([value] + [0] * (self.n - 1), dtype=object)
        return Plaintext(self._to_ntt(ints, cd), cd.parms_id, is_ntt_form=True, scale=1.0)

    def decode_float64_polynomial(self, plain: Plaintext) -> np.ndarray:
        """Raw coefficient decode (the inverse of encode_float64_polynomial)."""
        cd = self.context.get_context_data(plain.parms_id)
        return self._centered(plain, cd) / plain.scale

    def decode(self, plain: Plaintext) -> np.ndarray:
        """(ref: ckks_encoder.cu:1092 decode)"""
        cd = self.context.get_context_data(plain.parms_id)
        coeffs = self._centered(plain, cd) / plain.scale
        ev = np.fft.ifft(coeffs * self._twist) * self.n
        return ev[self._idx]

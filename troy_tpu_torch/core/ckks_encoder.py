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

encode_device and decode_device run the same pipeline on the context's
device: torch.fft in complex128 (the H100 has FP64; the JAX package's device
path computes in double-float32 because the TPU has none, ops/ddfft.py,
which is not ported), with the JAX device path's gates and messages:

  * encode_device rounds scale * c from float64.  Below 2^52 the rounding
    is exact (round half to even, as numpy's); above, the float64 is an
    integer M 2^E with |M| < 2^53, so its residues are (M mod q)(2^E mod q).
    Tiers as the JAX package's: C = scale max(|v|, 1) needs W 24-bit words,
    W <= 5 (C < 2^117); past that, or at C >= Q/2 ("exceed q/2"), it raises.
    The FFT rounds as the host's does not, so a coefficient next to a .5
    boundary may round the other way: residues equal the host encode's but
    at such coefficients, one unit apart, and above 2^53 the coefficients
    carry the float64's 53 bits (error <= C 2^-52).
  * decode_device composes by the exact fixed-point fractional CRT: acc =
    sum_i y_i floor(2^(32K)/q_i) mod 2^(32K), y_i = [x_i (Q/q_i)^-1]_{q_i},
    summed by 32-bit word columns in int64 and carried once, negated in
    integers when its top bit is set, and only then converted to float64
    and times Q/scale: the precision is relative (a float64 CRT would cancel
    the fraction away, the JAX package's round-2 fault).  It raises past
    log2(Q/scale) = 120 bits, as the JAX package's does.
  A leading batch axis passes through both.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from .context import HeContext, ContextData
from .params import ParmsID
from .plaintext import Plaintext
from ..ops import rp as R, u64 as W


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
        self._dev_tabs: dict = {}     # device -> the tables above on it
        self._frac_cache: dict = {}   # (parms_id, K) -> _frac_words

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
        return R.ntt_forward(rns, cd.qtab())

    @staticmethod
    def _centered(plain: Plaintext, cd: ContextData) -> np.ndarray:
        """The plaintext's coefficients, centred, as float64 (host CRT)."""
        data = R.ntt_inverse(plain.data, cd.qtab()) if plain.is_ntt_form else plain.data
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

    # ------------------------------------------------------------------
    # The device path (counterpart of encode_device / decode_device,
    # troy_tpu/core/ckks_encoder.py:138-354)
    # ------------------------------------------------------------------
    def _device_tables(self, device) -> dict:
        key = str(device)
        if key not in self._dev_tabs:
            self._dev_tabs[key] = {
                "idx": torch.from_numpy(self._idx).to(device),
                "idx_conj": torch.from_numpy(self._idx_conj).to(device),
                "twist": torch.from_numpy(self._twist).to(device),
                "untwist": torch.from_numpy(self._untwist).to(device)}
        return self._dev_tabs[key]

    def encode_device(self, values, parms_id: ParmsID | None = None,
                      scale: float = 2.0 ** 40) -> Plaintext:
        """SIMD-encode on the context's device; values (..., k) with k <=
        slot_count give a plaintext whose data keeps the leading axes."""
        cd = self._level(parms_id)
        arr = np.atleast_1d(np.asarray(values, dtype=np.complex128))
        vmax = float(np.max(np.abs(arr))) if arr.size else 0.0
        C = scale * max(vmax, 1.0)
        W = 2
        while (1 << (24 * (W - 1) + 21)) <= C:  # 4x headroom under the shift
            W += 1
        if W > 5:
            raise ValueError(
                "[CKKSEncoder.encode_device] scale * max|value| = "
                f"{C:.3g} exceeds the 2^117 device bound; "
                "use encode() (host big-int path)")
        if C * 2 >= math.ldexp(1.0, cd.total_coeff_modulus.bit_length() - 1):
            raise ValueError("[CKKSEncoder.encode_device] scaled values exceed q/2")
        lead = arr.shape[:-1]
        if arr.shape[-1] > self.slots:
            raise ValueError("[CKKSEncoder.encode_device] too many values")
        dev = cd.device
        tabs = self._device_tables(dev)
        v = torch.zeros(lead + (self.slots,), dtype=torch.complex128, device=dev)
        v[..., :arr.shape[-1]] = torch.from_numpy(arr).to(dev)
        ev = torch.zeros(lead + (self.n,), dtype=torch.complex128, device=dev)
        ev[..., tabs["idx"]] = v
        ev[..., tabs["idx_conj"]] = v.conj()
        coeffs = (torch.fft.fft(ev) / self.n) * tabs["untwist"]
        rns = self._round_to_rns(coeffs.real * scale, cd, big=C >= 2.0 ** 52)
        return Plaintext(R.ntt_forward(rns, cd.qtab()), cd.parms_id, is_ntt_form=True,
                         scale=scale)

    @staticmethod
    def _round_to_rns(x: torch.Tensor, cd: ContextData, big: bool) -> torch.Tensor:
        """(..., n) float64 -> (..., L, n) residues of its rounded integers."""
        q = cd.base_q.q.view(-1, 1)
        small = torch.round(x).clamp(-2.0 ** 62, 2.0 ** 62).to(torch.int64)
        res = torch.remainder(small[..., None, :], q)
        if not big:
            return res
        m, e = torch.frexp(x)
        mant = (m * 2.0 ** 53).to(torch.int64)           # exact: |m| in [0.5, 1)
        shift = (e.to(torch.int64) - 53).clamp(min=0)
        pow2 = torch.tensor([[pow(2, k, v) for k in range(128)] for v in cd.base_q.values],
                            dtype=torch.int64, device=x.device)   # (L, 128): 2^E mod q
        m_q = torch.remainder(mant[..., None, :], q)
        p2 = pow2[:, shift].movedim(0, -2)
        big_res = W.mul_mod64(m_q, p2, cd.qtab().k) if cd.wide else m_q * p2 % q
        return torch.where((x.abs() < 2.0 ** 52)[..., None, :], res, big_res)

    def _frac_words(self, cd: ContextData, K: int) -> torch.Tensor:
        """(L, K) int64: the 32-bit words of floor(2^(32K) / q_i)."""
        cache = self._frac_cache
        key = (cd.parms_id, K)
        if key not in cache:
            rows = [[((1 << (32 * K)) // v >> (32 * w)) & 0xFFFFFFFF for w in range(K)]
                    for v in cd.base_q.values]
            cache[key] = torch.tensor(rows, dtype=torch.int64, device=cd.device)
        return cache[key]

    def decode_device(self, plain: Plaintext) -> np.ndarray:
        """Decode on the context's device at any level and scale with
        log2(Q / scale) <= 120; a leading batch axis passes through."""
        cd = self.context.get_context_data(plain.parms_id)
        Q = cd.total_coeff_modulus
        margin = max(0.0, Q.bit_length() - math.log2(plain.scale))
        if margin > 120:
            raise ValueError(
                "[CKKSEncoder.decode_device] log2(Q/scale) = "
                f"{margin:.0f} exceeds the 120-bit device envelope; "
                "use decode() (host path) at this level/scale")
        K = max(5, 4 + math.ceil((margin + 40) / 32))
        x = R.ntt_inverse(plain.data, cd.qtab()) if plain.is_ntt_form else plain.data
        q = cd.base_q.q.view(-1, 1)
        inv = torch.tensor(cd.base_q.inv_punctured, dtype=torch.int64, device=x.device)
        words = self._frac_words(cd, K)
        cols = [0] * (K + 1)
        if cd.wide:
            # y < 2^61: its 16-bit digits d_j times the 32-bit words (< 2^48),
            # each placed at bit 16 j + 32 w; columns from K on are dropped
            y = W.mul_mod64(x, inv.view(-1, 1), cd.qtab().k)
            for j in range(4):
                d = (y >> (16 * j)) & 0xFFFF
                for w in range(K - j // 2):
                    p = d * words[:, w:w + 1]
                    c = w + j // 2
                    lo, hi = ((p & 0xFFFFFFFF, p >> 32) if j % 2 == 0
                              else ((p & 0xFFFF) << 16, p >> 16))
                    cols[c] = cols[c] + lo.sum(dim=-2)
                    cols[c + 1] = cols[c + 1] + hi.sum(dim=-2)
        else:
            y = x * inv.view(-1, 1) % q
            for w in range(K):
                p = y * words[:, w:w + 1]                # (..., L, n), each < 2^62
                cols[w] = cols[w] + (p & 0xFFFFFFFF).sum(dim=-2)
                cols[w + 1] = cols[w + 1] + (p >> 32).sum(dim=-2)
        acc, carry = [], 0
        for w in range(K):                               # mod 2^(32K): drop the last carry
            c = cols[w] + carry
            acc.append(c & 0xFFFFFFFF)
            carry = c >> 32
        neg = acc[-1] >= 1 << 31                         # fraction in [1/2, 1): negative
        mag, carry = [], 1
        for w in range(K):                               # two's complement where negative
            c = (0xFFFFFFFF - acc[w]) + carry
            mag.append(torch.where(neg, c & 0xFFFFFFFF, acc[w]))
            carry = c >> 32
        frac = torch.zeros_like(mag[0], dtype=torch.float64)
        for w in range(K):
            frac = frac + mag[w].to(torch.float64) * 2.0 ** (32 * (w - K))
        ratio = float(Fraction(Q) / Fraction(plain.scale))
        coeffs = torch.where(neg, -frac, frac) * ratio
        tabs = self._device_tables(x.device)
        ev = torch.fft.ifft(coeffs * tabs["twist"]) * self.n
        return ev[..., tabs["idx"]].cpu().numpy()

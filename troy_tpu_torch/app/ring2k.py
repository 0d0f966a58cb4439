"""Ring2k polynomial encoder: BFV with plain modulus t = 2^k.

Counterpart of troy_tpu/app/ring2k.py (ref: src/app/bfv_ring2k.{h,cu},
PolynomialEncoderRing2k<T> with a per-level helper).  Messages live in
Z_{2^k}; the context's own plain modulus is bypassed, and each level carries
its own scaling with an auxiliary prime gamma for the exact {t = 2^k, gamma}
decrypt rounding:

  scale_up   : m -> round(m Q / 2^k) in RNS (the add-to-c0 / encrypt form);
               the power-of-two t makes the rounding fix a shift;
  centralize : the centred lift of m mod 2^k (the multiply_plain operand);
  scale_down : the BEHZ {t, gamma} rounding of t phase / Q, masked to k bits.

k <= 31 (_Ring2kLevelHelper) works on int64 values directly: its {t, gamma}
conversion is rns_base.BaseConverter, the K3 kernel on a CUDA tensor, with
t = 2^k as an output modulus (to 2^31; the kernel and the plain version
size their sums for it).  31 < k <= 128 (_Ring2kWideLevelHelper, the
reference's u64/u128 instantiations) decomposes a message into 16-bit limb
planes and runs the same pipeline in ops/limb.py's multiword arithmetic; its
t side is limb arithmetic mod 2^k.  Messages with k > 64 travel as Python
ints or object arrays, never as uint64.  The *_host methods are the
big-integer oracle the tests hold the device path to.  The chain is the
fast path's (primes below 2^30); the residues' products are exact in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.context import HeContext, ContextData
from ..core.params import ParmsID
from ..core.plaintext import Plaintext
from ..core.modulus import Modulus
from ..core.decryptor import Decryptor
from ..core.ciphertext import Ciphertext
from ..utils import numth
from ..ops import limb as LB, u32 as U
from ..rns.rns_base import RNSBase, BaseConverter
from ..rns.rns_tool import _aux_primes, _col

_M32 = 0xFFFFFFFF


class _Ring2kLevelHelper:
    """Per-level constants for k <= 31 (ref: bfv_ring2k.h:24-78
    PolynomialEncoderRNSHelper)."""

    def __init__(self, cd: ContextData, k: int):
        self.k = k
        self.cd = cd
        dev = cd.device
        t = 1 << k
        Q = cd.base_q.prod
        qv = cd.base_q.values
        gamma = _aux_primes(cd.parms.poly_modulus_degree, set(qv), 1, need_ntt=False)[0]
        self.gamma = Modulus(gamma)
        self.t_mask = t - 1
        self.half = 1 << (k - 1)
        self.q = cd.base_q.q.view(-1, 1)
        self.inv_punctured = _col(cd.base_q.inv_punctured, dev)
        # scale_up: round(m Q / t) = m floor(Q / t) + (m (Q mod t) + t/2) >> k
        self.delta_mod_q = _col([(Q >> k) % q for q in qv], dev)
        self.q_mod_t = Q & (t - 1)
        # centralize: [-t]_{q_i} added to upper-half messages
        self.neg_t_mod_q = _col([(-t) % q for q in qv], dev)
        # decentralize: the CRT terms mod 2^32, masked to k bits at the end
        self.punc_mod_2_32 = [p & _M32 for p in cd.base_q.punctured]
        self.q_mod_2_32 = Q & _M32
        # {t, gamma} decrypt
        self.base_t_gamma = RNSBase([Modulus(t), Modulus(gamma)], dev)
        self.conv_q_to_t_gamma = BaseConverter(cd.base_q, self.base_t_gamma)
        self.prod_t_gamma_mod_q = _col([(t * gamma) % q for q in qv], dev)
        self.neg_inv_q_mod_t_gamma = _col(
            [(-numth.invert_mod(Q % m, m)) % m for m in (t, gamma)], dev)
        self.tg = self.base_t_gamma.q.view(-1, 1)
        self.inv_gamma_mod_t = numth.invert_mod(gamma % t, t)
        self.gamma_mod_t = gamma & (t - 1)

    def scale_up(self, m: torch.Tensor) -> torch.Tensor:
        """m: (..., n) in [0, 2^k) -> (..., L, n) = round(m Q / 2^k) mod q."""
        fix = (m * self.q_mod_t + self.half) >> self.k
        prod = U.mul_mod(m[..., None, :], self.delta_mod_q, self.q)
        return U.add_mod(prod, U.barrett_reduce(fix[..., None, :], self.q), self.q)

    def centralize(self, m: torch.Tensor) -> torch.Tensor:
        """The centred lift of m in [0, 2^k) into (..., L, n)."""
        mm = m[..., None, :]
        return U.barrett_reduce(torch.where(mm >= self.half, mm + self.neg_t_mod_q, mm),
                                self.q)

    def decentralize(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of centralize: (..., L, n) -> (..., n) mod 2^k, by the exact
        CRT mod 2^32 with the 96-bit fixed-point alpha (exact because the
        centred value is far below Q / 2)."""
        v = U.mul_mod(x, self.inv_punctured, self.q)
        alpha = self.cd.rns_tool._exact_alpha(v)
        s = None
        for i, p in enumerate(self.punc_mod_2_32):
            term = v[..., i, :] * p & _M32
            s = term if s is None else s + term
        return (s - alpha * self.q_mod_2_32) & self.t_mask

    def scale_down(self, phase: torch.Tensor) -> torch.Tensor:
        """(..., L, n) phase -> (..., n) = round(t phase / Q) mod 2^k (BEHZ
        {t, gamma}, mod t by masking)."""
        mask = self.t_mask
        s = self.conv_q_to_t_gamma.convert(U.mul_mod(phase, self.prod_t_gamma_mod_q, self.q))
        s = U.mul_mod(s, self.neg_inv_q_mod_t_gamma, self.tg)
        s_t, s_g = s[..., 0, :], s[..., 1, :]
        corrected = torch.where(s_g > (self.gamma.value >> 1),
                                (s_t + (self.gamma_mod_t - s_g)) & mask, (s_t - s_g) & mask)
        return corrected * self.inv_gamma_mod_t & mask


class _Ring2kWideLevelHelper:
    """Per-level constants for 31 < k <= 128 (ref: bfv_ring2k.cu u64/u128
    instantiations): a k-bit word is W = ceil(k/16) 16-bit limb planes."""

    def __init__(self, cd: ContextData, k: int):
        self.k = k
        self.cd = cd
        dev = cd.device
        self.W = LB.width(k)
        t = 1 << k
        Q = cd.base_q.prod
        qv = cd.base_q.values
        if Q >> k < (1 << 16):
            raise ValueError(
                f"[PolynomialEncoderRing2k] k={k} leaves under 16 bits of "
                f"noise margin at this level (log Q = {Q.bit_length()})")
        gamma = _aux_primes(cd.parms.poly_modulus_degree, set(qv), 1, need_ntt=False)[0]
        self.gamma = Modulus(gamma)
        self.q = cd.base_q.q.view(-1, 1)
        self.inv_punctured = _col(cd.base_q.inv_punctured, dev)
        # scale_up: round(m Q / t) = m (Q >> k) + (m (Q mod t) + t/2) >> k
        self.delta_mod_q = _col([(Q >> k) % q for q in qv], dev)
        self.r_limbs = LB.const_limbs(Q & (t - 1), self.W)
        # 2^(16 w) mod q_i columns, folding limbs into residues
        self.pow16 = [_col([pow(2, 16 * i, q) for q in qv], dev) for i in range(self.W)]
        self.neg_t_mod_q = _col([(-t) % q for q in qv], dev)
        # {t, gamma} decrypt: the t side in limbs, the gamma side in int64
        self.prod_t_gamma_mod_q = _col([(t * gamma) % q for q in qv], dev)
        self.mat_gamma = [p % gamma for p in cd.base_q.punctured]
        self.mat_t = [LB.const_limbs(p & (t - 1), self.W) for p in cd.base_q.punctured]
        self.neg_inv_q_mod_gamma = (-numth.invert_mod(Q % gamma, gamma)) % gamma
        self.neg_inv_q_mod_t = LB.const_limbs((-numth.invert_mod(Q % t, t)) % t, self.W)
        self.gamma_limbs = LB.const_limbs(gamma, self.W)
        self.inv_gamma_mod_t = LB.const_limbs(numth.invert_mod(gamma, t), self.W)
        self.half_gamma = gamma >> 1

    def scale_up(self, m: torch.Tensor) -> torch.Tensor:
        """m: (..., W, n) limbs in [0, 2^k) -> (..., L, n) round(m Q / 2^k)
        mod q."""
        q = self.q
        prod = U.mul_mod(LB.fold_mod_q(m, self.pow16, q), self.delta_mod_q, q)
        fix = LB.shift_right(LB.add_bit(LB.mul_const_full(m, self.r_limbs), self.k - 1),
                             self.k)
        return U.add_mod(prod, LB.fold_mod_q(fix[..., :self.W, :], self.pow16, q), q)

    def centralize(self, m: torch.Tensor) -> torch.Tensor:
        """The centred lift of (..., W, n) limbs."""
        m_mod = LB.fold_mod_q(m, self.pow16, self.q)
        upper = LB.get_bit(m, self.k - 1)[..., None, :] != 0
        return torch.where(upper, U.add_mod(m_mod, self.neg_t_mod_q, self.q), m_mod)

    def decentralize(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of centralize: (..., L, n) -> (..., W, n) k-bit limbs, the
        exact CRT in limb arithmetic with the 96-bit fixed-point alpha."""
        k = self.k
        v = U.mul_mod(x, self.inv_punctured, self.q)
        alpha = self.cd.rns_tool._exact_alpha(v)
        s = LB.dot_const_low([v[..., i, :] for i in range(v.shape[-2])], self.mat_t, k)
        return LB.sub_low(s, LB.mul_const_low(LB.u32_split(alpha), self.r_limbs, k), k)

    def scale_down(self, phase: torch.Tensor) -> torch.Tensor:
        """(..., L, n) phase -> (..., W, n) limbs of round(2^k phase / Q) mod
        2^k (BEHZ {t, gamma}; mod-t arithmetic is limb masking)."""
        k = self.k
        g = self.gamma.value
        v = U.mul_mod(U.mul_mod(phase, self.prod_t_gamma_mod_q, self.q),
                      self.inv_punctured, self.q)
        L = v.shape[-2]
        s_g = U.dot_mod([(v[..., i, :], self.mat_gamma[i]) for i in range(L)], g)
        s_g = U.mul_mod(s_g, self.neg_inv_q_mod_gamma, g)
        s_t = LB.mul_const_low(
            LB.dot_const_low([v[..., i, :] for i in range(L)], self.mat_t, k),
            self.neg_inv_q_mod_t, k)
        sg_limbs = LB.u32_split(s_g)
        upper = LB.sub_low(LB.add_const_low(s_t, self.gamma_limbs, k), sg_limbs, k)
        lower = LB.sub_low(s_t, sg_limbs, k)
        res = torch.where((s_g > self.half_gamma)[..., None, :], upper, lower)
        return LB.mul_const_low(res, self.inv_gamma_mod_t, k)


class PolynomialEncoderRing2k:
    """ref: bfv_ring2k.h PolynomialEncoderRing2k<T>.  k <= 31: int64 values
    (_Ring2kLevelHelper); 31 < k <= 128: 16-bit limb planes
    (_Ring2kWideLevelHelper)."""

    def __init__(self, context: HeContext, k: int):
        if not 2 <= k <= 128:
            raise ValueError("[PolynomialEncoderRing2k] need 2 <= k <= 128")
        self.context = context
        self.k = k
        self.n = context.first_context_data().parms.poly_modulus_degree
        self._helpers: dict = {}

    def helper(self, parms_id: ParmsID | None = None):
        pid = parms_id or self.context.first_parms_id
        if pid not in self._helpers:
            cls = _Ring2kLevelHelper if self.k <= 31 else _Ring2kWideLevelHelper
            self._helpers[pid] = cls(self.context.get_context_data(pid), self.k)
        return self._helpers[pid]

    def _device(self):
        return self.context.first_context_data().device

    def _vec(self, values) -> torch.Tensor:
        """k <= 31: the messages masked to k bits and zero-padded to n."""
        v = np.zeros(self.n, dtype=np.int64)
        arr = np.asarray(values, dtype=np.uint64) & np.uint64((1 << self.k) - 1)
        v[:len(arr)] = arr.astype(np.int64)
        return torch.from_numpy(v).to(self._device())

    def _vec_int(self, values) -> list[int]:
        mask = (1 << self.k) - 1
        out = [0] * self.n
        for i, v in enumerate(values):
            out[i] = int(v) & mask
        return out

    def _vec_limbs(self, values) -> torch.Tensor:
        """The messages padded and masked to n and split into (W, n) limbs."""
        return torch.from_numpy(LB.from_ints(self._vec_int(values), self.k)).to(self._device())

    def _message(self, values) -> torch.Tensor:
        return self._vec(values) if self.k <= 31 else self._vec_limbs(values)

    def scale_up(self, values, parms_id: ParmsID | None = None) -> Plaintext:
        h = self.helper(parms_id)
        return Plaintext(h.scale_up(self._message(values)), parms_id=h.cd.parms_id,
                         is_ntt_form=False)

    def centralize(self, values, parms_id: ParmsID | None = None) -> Plaintext:
        h = self.helper(parms_id)
        return Plaintext(h.centralize(self._message(values)), parms_id=h.cd.parms_id,
                         is_ntt_form=False)

    def _out(self, x: torch.Tensor) -> np.ndarray:
        if self.k <= 31:
            return x.cpu().numpy().astype(np.uint64)
        return LB.to_ints(x, self.k)

    def scale_down(self, phase: Plaintext) -> np.ndarray:
        """The messages mod 2^k of an RNS phase: uint64, or Python ints (an
        object array) for k > 64."""
        return self._out(self.helper(phase.parms_id).scale_down(phase.data))

    def decentralize(self, pt: Plaintext) -> np.ndarray:
        """Inverse of centralize (ref: bfv_ring2k.h:223 decentralize_slice)."""
        return self._out(self.helper(pt.parms_id).decentralize(pt.data))

    # -- the host big-integer oracle (ref semantics: bfv_ring2k.cu) -----------
    def scale_up_host(self, values, parms_id: ParmsID | None = None) -> Plaintext:
        pid = parms_id or self.context.first_parms_id
        cd = self.context.get_context_data(pid)
        Q, t = cd.base_q.prod, 1 << self.k
        scaled = [(m * Q + t // 2) // t for m in self._vec_int(values)]
        return Plaintext(torch.from_numpy(cd.base_q.decompose_array_host(scaled)).to(cd.device),
                         parms_id=pid, is_ntt_form=False)

    def scale_down_host(self, phase: Plaintext) -> np.ndarray:
        cd = self.context.get_context_data(phase.parms_id)
        Q, t = cd.base_q.prod, 1 << self.k
        out = [((v * t + Q // 2) // Q) % t
               for v in cd.base_q.compose_array_host(phase.data.cpu().numpy())]
        return np.array(out, dtype=np.uint64 if self.k <= 64 else object)

    def decrypt_scale_down(self, decryptor: Decryptor, ct: Ciphertext) -> np.ndarray:
        return self.scale_down(decryptor.bfv_decrypt_without_scaling_down(ct))

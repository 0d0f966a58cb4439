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
from ..ops import bconv as BC, u64 as W


def _int_lanes(values) -> np.ndarray:
    """An int iterable as the widest exact numpy array: integer ndarrays pass
    through, Python ints become int64 lanes when they fit, object otherwise."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        return values
    try:
        return np.asarray(values, dtype=np.int64)
    except (OverflowError, TypeError):
        return np.asarray(values, dtype=object)


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

    # -- host CRT of single values (ref: rns_base compose/decompose_single) --
    def decompose(self, value: int) -> list[int]:
        value %= self.prod
        return [value % v for v in self.values]

    def compose(self, residues: list[int]) -> int:
        acc = 0
        for r, p, ip, v in zip(residues, self.punctured, self.inv_punctured, self.values):
            acc += (int(r) * ip % v) * p
        return acc % self.prod

    def compose_centered(self, residues: list[int]) -> int:
        """Compose, then centre into (-Q/2, Q/2]."""
        v = self.compose(residues)
        return v - self.prod if v > self.prod // 2 else v

    def residues_host(self, values) -> np.ndarray:
        """An int iterable -> (L, n) residues at full modulus width (uint64
        rows)."""
        arr = _int_lanes(values)
        return np.stack([np.asarray(arr % q, dtype=np.uint64) for q in self.values])

    def compose_array_host(self, arr: np.ndarray) -> list[int]:
        """(L, n) residues -> list of Python ints in [0, Q), by the CRT over
        object-dtype numpy rows."""
        acc = np.zeros(arr.shape[1], dtype=object)
        for i in range(self.size):
            row = np.asarray(arr[i]).astype(object)
            acc += (row * self.inv_punctured[i] % self.values[i]) * self.punctured[i]
        return list(acc % self.prod)

    def decompose_array_host(self, values) -> np.ndarray:
        """An int iterable of length n (int64 lanes, or Python ints of any
        size) -> (L, n) int64 residues, one numpy mod per prime (the CKKS
        encoder's decomposition, troy_tpu/rns/rns_base.py:81)."""
        arr = _int_lanes(values)
        return np.stack([(arr % q).astype(np.int64) for q in self.values])

    def _compose_centered_big(self, arr: np.ndarray) -> np.ndarray:
        comp = np.array(self.compose_array_host(arr), dtype=object)
        return np.where(comp > self.prod // 2, comp - self.prod, comp).astype(np.float64)

    def compose_centered_f64_host(self, arr: np.ndarray) -> np.ndarray:
        """(L, n) residues -> the centred coefficients as float64, by the JAX
        package's fixed-point fractional CRT (troy_tpu/rns/rns_base.py:109),
        copied operation for operation so that the floats are the same:

            frac = sum_i (r_i inv_punc_i mod q_i) floor(2^(32K) / q_i)
                   mod 2^(32K)   (exact, in 16-bit words held in float64)
            value = centred(frac) Q

        with 32K >= bits(Q) + 128.  Every intermediate is an integer below
        2^53, so the float64 matrix products are exact in any summation
        order.  Falls back to the big-integer compose where float64 cannot
        hold Q (over 900 bits) or the sums could round (over 30 limbs)."""
        arr = np.asarray(arr)
        n = arr.shape[-1]
        if self.prod.bit_length() > 900 or self.size > 30:
            return self._compose_centered_big(arr)
        cache = getattr(self, "_fcrt_cache", None)
        if cache is None:
            K = (self.prod.bit_length() + 128 + 31) // 32
            W16 = 2 * K
            r16 = np.zeros((self.size, W16), dtype=np.uint64)
            for i, q in enumerate(self.values):
                r = (1 << (32 * K)) // q
                for w in range(W16):
                    r16[i, w] = (r >> (16 * w)) & 0xFFFF
            r16f = r16.astype(np.float64)
            G = (W16 + 2) // 3
            gmat = np.zeros((G, W16), dtype=np.float64)
            for w in range(W16):
                gmat[w // 3, w] = 2.0 ** (16.0 * (w - 3 * (w // 3)))
            gscale = np.power(2.0, 48.0 * np.arange(G) - 32.0 * K)
            cache = (K, W16, r16f, gmat, gscale)
            self._fcrt_cache = cache
        K, W16, r16f, gmat, gscale = cache
        ctil = np.empty((self.size, n), dtype=np.uint64)
        for i, q in enumerate(self.values):
            if q < (1 << 31):
                ctil[i] = (arr[i].astype(np.uint64)
                           * np.uint64(self.inv_punctured[i])) % np.uint64(q)
            else:  # wide primes: the wide path's Shoup multiply (the same residue)
                w = self.inv_punctured[i]
                ctil[i] = W.shoup_mul64(torch.from_numpy(arr[i].astype(np.int64)), w,
                                        W.shoup62(w, q), q).numpy()
        c_lo = (ctil & np.uint64(0xFFFFFFFF)).astype(np.float64)
        c_hi = (ctil >> np.uint64(32)).astype(np.float64)
        acc = np.zeros((W16 + 2, n), dtype=np.float64)
        acc[:W16] += r16f.T @ c_lo
        acc[2:W16 + 2] += r16f.T @ c_hi
        s16 = 1.0 / 65536.0
        for w in range(W16 - 1):
            cr = np.floor(acc[w] * s16)
            acc[w] -= cr * 65536.0
            acc[w + 1] += cr
        acc[W16 - 1] -= np.floor(acc[W16 - 1] * s16) * 65536.0  # mod 2^(32K)
        negb = acc[W16 - 1] >= 32768.0
        comp16 = 65535.0 - acc[:W16]
        carry = np.ones(n, dtype=np.float64)
        for w in range(W16):
            comp16[w] += carry
            carry = np.floor(comp16[w] * s16)
            comp16[w] -= carry * 65536.0

        def to_f64(words):
            g = gmat @ words
            val = np.zeros(n, dtype=np.float64)
            comp = np.zeros(n, dtype=np.float64)
            for k in range(g.shape[0] - 1, -1, -1):
                x = g[k] * gscale[k]
                t = val + x
                comp += np.where(val >= x, (val - t) + x, (x - t) + val)
                val = t
            return val + comp

        frac = np.where(negb, -to_f64(comp16), to_f64(acc[:W16]))
        return frac * float(self.prod)


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

    def convert_single_limb(self, x: torch.Tensor) -> torch.Tensor:
        """The conversion into a one-modulus base: (..., 1, n)."""
        return self.convert(x)


class BaseConverter64:
    """Fast base conversion at the wide width (input or output primes up to
    2^61; ref: rns_base.h:158-207 fast_convert_array at the reference's
    native width): a Shoup multiply by (Q/q_i)^-1 per input limb, then the
    dot with (Q/q_i) mod p_j in (hi, lo) sums, one Barrett per chunk of
    ops/u64.dot_mod64.  int64 PyTorch on both devices: the fast path's K3
    kernel takes no wide modulus."""

    def __init__(self, ibase: RNSBase, obase: RNSBase):
        self.ibase = ibase
        self.obase = obase
        dev = obase.device

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=dev).view(-1, 1)
        self.inv_punc = col(ibase.inv_punctured)
        self.inv_punc_shoup = col([W.shoup62(ip, v) for ip, v
                                   in zip(ibase.inv_punctured, ibase.values)])
        self.iq = col(ibase.values)
        self.ok = W.barrett_consts(obase.values, dev)
        self.mat = [col([punc % p for p in obase.values]) for punc in ibase.punctured]
        # each product is below max(q_i) p_j: the chunk bound takes both bases
        self.max_terms = W.dot_mod64_terms(max(ibase.values + obase.values))

    def _shoup_terms(self, x: torch.Tensor) -> torch.Tensor:
        """[x_i (Q/q_i)^-1]_{q_i}, (..., L_in, n)."""
        return W.shoup_mul64(x, self.inv_punc, self.inv_punc_shoup, self.iq)

    def convert(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., L_in, n) residues in ibase -> (..., L_out, n) in obase."""
        tmp = self._shoup_terms(x)
        pairs = [(tmp[..., i:i + 1, :], self.mat[i]) for i in range(self.ibase.size)]
        return W.dot_mod64(pairs, self.ok, self.max_terms)

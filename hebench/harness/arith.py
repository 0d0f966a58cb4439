"""Plain modular arithmetic of the benchmark's reference: primes, roots,
residues, the negacyclic NTT, CRT and exact integer polynomial products.

Everything here is plain PyTorch on int64 tensors (any device) or Python
integers in numpy object arrays.  It imports nothing of the program under
test.  A residue polynomial of L primes is an int64 tensor (..., L, n).

Products of residues below 2^31 are exact in int64.  Wider residues (up to
2^61) multiply in four 31-bit partial products, each reduced on its own, and
the shifts by 2^31 reduce with a float64 quotient and a wrap-around
remainder (`_shl31`).  `Ring(..., exact=False)` rounds every product to
float64's 53-bit mantissa instead: the control that the correctness check
must fail (PERF.md, "How correct is decided").

The NTT order is the usual negacyclic one: position p holds the evaluation
at psi^(2 brv(p) + 1) for psi the least primitive 2n-th root of unity, as
Microsoft SEAL lays it out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M31 = (1 << 31) - 1
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(v: int) -> bool:
    """Deterministic Miller-Rabin below 3.3e24."""
    if v < 2:
        return False
    for p in _MR_BASES:
        if v % p == 0:
            return v == p
    d, s = v - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in _MR_BASES:
        x = pow(a, d, v)
        if x in (1, v - 1):
            continue
        for _ in range(s - 1):
            x = x * x % v
            if x == v - 1:
                break
        else:
            return False
    return True


def ntt_primes(bits: int, count: int, two_n: int, exclude=()) -> list[int]:
    """The `count` largest primes below 2^bits that are 1 mod two_n."""
    out, v = [], ((1 << bits) - 1) // two_n * two_n + 1
    while len(out) < count:
        if is_prime(v) and v not in exclude:
            out.append(v)
        v -= two_n
    return out


def least_root(two_n: int, q: int) -> int:
    """The least primitive two_n-th root of unity mod the prime q."""
    if (q - 1) % two_n:
        raise ValueError(f"{q} is not 1 mod {two_n}")
    g = 2
    while True:
        w = pow(g, (q - 1) // two_n, q)
        if pow(w, two_n // 2, q) == q - 1:
            break
        g += 1
    best, cur, w2 = w, w, w * w % q
    for _ in range(two_n // 2 - 1):
        cur = cur * w2 % q
        best = min(best, cur)
    return best


def bitrev(n: int) -> np.ndarray:
    log_n = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        out |= ((idx >> b) & 1) << (log_n - 1 - b)
    return out


def _shl31(x, q, qf):
    """x 2^31 mod q for x in [0, q) and q < 2^61: the quotient from float64
    (off by at most one), the remainder in int64 modulo 2^64, corrected."""
    k = torch.floor(x.double() * 2.0 ** 31 / qf).long()
    r = (x << 31) - k * q
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def centered(x: np.ndarray, m: int) -> np.ndarray:
    """Object array of integers mod m -> representatives in (-m/2, m/2]."""
    x = x % m
    return np.where(x > m // 2, x - m, x)


class Ring:
    """Z_q[X]/(X^n + 1) over the primes `primes`, on `device`."""

    def __init__(self, n: int, primes: list[int], device, exact: bool = True):
        self.n, self.primes = n, [int(p) for p in primes]
        self.device = torch.device(device)
        self.exact = exact
        self.wide = max(self.primes) >= 1 << 31
        if max(self.primes) >= 1 << 61:
            raise ValueError("primes must lie below 2^61")
        self.q = torch.tensor(self.primes, dtype=torch.int64, device=self.device).view(-1, 1)
        self.qf = self.q.double()
        self.modulus = math.prod(self.primes)
        self._tables = None

    def sub_ring(self, idx: list[int]) -> "Ring":
        return Ring(self.n, [self.primes[i] for i in idx], self.device, self.exact)

    # -- elementwise ----------------------------------------------------------
    def add(self, a, b):
        return torch.remainder(a + b, self.q)

    def sub(self, a, b):
        return torch.remainder(a - b, self.q)

    def neg(self, a):
        return torch.remainder(-a, self.q)

    def mul(self, a, b):
        """a * b mod q for residues a, b in [0, q) (b broadcasts)."""
        return self._mulq(a, b, self.q, self.qf)

    def _mulq(self, a, b, q, qf):
        if not self.exact:
            return torch.remainder(torch.round(a.double() * b.double()), qf).long()
        if not self.wide:
            return torch.remainder(a * b, q)
        a1, a0 = a >> 31, a & M31
        b1, b0 = b >> 31, b & M31
        hh = torch.remainder(a1 * b1, q)
        mid = torch.remainder(torch.remainder(a1 * b0, q) + torch.remainder(a0 * b1, q), q)
        ll = torch.remainder(a0 * b0, q)
        return torch.remainder(_shl31(_shl31(hh, q, qf), q, qf) + _shl31(mid, q, qf) + ll, q)

    def scalar(self, values: list[int]) -> torch.Tensor:
        """One constant a prime, as a column."""
        return torch.tensor(values, dtype=torch.int64, device=self.device).view(-1, 1)

    # -- transforms ----------------------------------------------------------
    def tables(self):
        if self._tables is None:
            n, br = self.n, bitrev(self.n)
            fwd, inv, ninv = [], [], []
            for q in self.primes:
                psi = least_root(2 * n, q)
                ipsi = pow(psi, -1, q)
                pw = [0] * n
                ipw = [0] * n
                a = b = 1
                for i in range(n):
                    pw[i], ipw[i] = a, b
                    a, b = a * psi % q, b * ipsi % q
                fwd.append([pw[j] for j in br])
                inv.append([ipw[j] for j in br])
                ninv.append(pow(n, -1, q))
            t = lambda v: torch.tensor(v, dtype=torch.int64, device=self.device)
            self._tables = (t(fwd), t(inv), t(ninv).view(-1, 1))
        return self._tables

    def ntt(self, x):
        """(..., L, n) coefficients in [0, q) -> NTT order."""
        fwd, _, _ = self.tables()
        n, lead = self.n, x.shape[:-1]
        m, t = 1, n
        while m < n:
            t //= 2
            y = x.reshape(*lead, m, 2, t)
            w = fwd[:, m:2 * m].reshape(-1, m, 1)
            u, v = y[..., 0, :], self._mul_tw(y[..., 1, :], w)
            x = torch.stack([self._addw(u, v), self._subw(u, v)], dim=-2).reshape(*lead, n)
            m *= 2
        return x

    def intt(self, x):
        _, inv, ninv = self.tables()
        n, lead = self.n, x.shape[:-1]
        m, t = n // 2, 1
        while m >= 1:
            y = x.reshape(*lead, m, 2, t)
            w = inv[:, m:2 * m].reshape(-1, m, 1)
            u, v = y[..., 0, :], y[..., 1, :]
            x = torch.stack([self._addw(u, v), self._mul_tw(self._subw(u, v), w)],
                            dim=-2).reshape(*lead, n)
            m //= 2
            t *= 2
        return self.mul(x, ninv)

    # per-limb ops on the (..., L, m, t) view of a transform stage
    def _addw(self, a, b):
        return torch.remainder(a + b, self.q.view(-1, 1, 1))

    def _subw(self, a, b):
        return torch.remainder(a - b, self.q.view(-1, 1, 1))

    def _mul_tw(self, a, w):
        return self._mulq(a, w, self.q.view(-1, 1, 1), self.qf.view(-1, 1, 1))

    def negacyclic(self, a, b):
        """a * b in the coefficient domain, both (..., L, n) in [0, q)."""
        return self.intt(self.mul(self.ntt(a), self.ntt(b)))

    # -- integers ------------------------------------------------------------
    def residues(self, ints: np.ndarray) -> torch.Tensor:
        """Object array (..., n) of integers -> (..., L, n) residues."""
        out = np.stack([(ints % q).astype(np.int64) for q in self.primes], axis=-2)
        return torch.from_numpy(out).to(self.device)

    def small(self, ints: torch.Tensor) -> torch.Tensor:
        """int64 tensor (..., n) of small signed integers -> (..., L, n)."""
        return torch.remainder(ints.unsqueeze(-2), self.q)

    def crt(self, res: torch.Tensor, center: bool = True) -> np.ndarray:
        """(..., L, n) residues -> object array (..., n) of integers mod the
        product, centred when `center`."""
        r = res.cpu().numpy()
        acc = np.zeros(r.shape[:-2] + r.shape[-1:], dtype=object)
        for i, q in enumerate(self.primes):
            mi = self.modulus // q
            yi = pow(mi % q, -1, q)
            term = r[..., i, :].astype(object) * yi % q if self.wide else \
                (r[..., i, :] * yi % q).astype(object)
            acc = acc + term * mi
        acc = acc % self.modulus
        return centered(acc, self.modulus) if center else acc


def aux_ring(n: int, bound_bits: int, device, exact: bool = True) -> Ring:
    """A ring of 30-bit NTT primes whose product exceeds 2^(bound_bits + 2):
    wide enough to hold, centred, any integer of magnitude below
    2^bound_bits."""
    count = (bound_bits + 2) // 29 + 1
    return Ring(n, ntt_primes(30, count, 2 * n), device, exact)


def int_negacyclic(pairs, n: int, bound_bits: int, device, exact: bool = True) -> np.ndarray:
    """sum_k a_k * b_k in Z[X]/(X^n + 1) for object arrays a_k, b_k (..., n)
    of integers, exactly, where every result coefficient is below
    2^bound_bits: residues in an auxiliary ring, the product there, CRT."""
    ring = aux_ring(n, bound_bits, device, exact)
    acc = None
    for a, b in pairs:
        p = ring.mul(ring.ntt(ring.residues(a)), ring.ntt(ring.residues(b)))
        acc = p if acc is None else ring.add(acc, p)
    return ring.crt(ring.intt(acc))


def log_err(x) -> float:
    """log2(1 + |x|) for an integer x."""
    return math.log2(1 + abs(int(x)))


def bits_of(values: np.ndarray) -> int:
    """The largest bit length of |v| over an object array."""
    return max((abs(int(v)).bit_length() for v in values.reshape(-1)), default=0)

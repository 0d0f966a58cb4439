"""Negacyclic NTT/INTT for the wide path (primes in (2^30, 2^61)).

Counterpart of troy_tpu/ops/ntt64.py, with the same output order as the fast
path (ops/ntt.py): position p holds the evaluation at psi^(2 brv(p) + 1).
In the JAX package this transform is jnp code outside any Pallas kernel, so
here it is int64 PyTorch passes on both devices: the radix-2 Harvey schedule
(reshape-only Cooley-Tukey / Gentleman-Sande stages, as ops/ntt.py's plain
version) with each twiddle product a Shoup multiply of ops/u64.py.  The
six-step form of the JAX package is a TPU lane layout and is not ported.
The fast path's kernels (ops/ntt_cuda.py, ops/fused_mul_cuda.py) refuse
these moduli; ops/rp.py sends a wide table here by its `words`, never by
catching a refusal.

Tables are built on the host with Python ints (the JAX package's rows:
psi^brv(i) for the minimal primitive 2n-th root) and moved to the device
as int64 tensors.
"""

from __future__ import annotations

import torch

from ..core.modulus import Modulus
from ..utils import numth
from ..utils.timer import span
from . import u64 as W


class NTT64Tables:
    """Per-(n, prime list) twiddle tables of the wide path on one device.

    q (L,), psi_br / inv_psi_br (L, n) psi^brv(i) and its inverse with their
    Shoup companions floor(w 2^62 / q) (psi_br_shoup, inv_psi_br_shoup),
    n_inv and n_inv_shoup (L,), the Barrett tuple k of (L, 1) columns, and
    words = 2, the width marker ops/rp.py dispatches on."""

    words = 2
    _row_cache: dict = {}  # (log_n, q) -> host rows

    @classmethod
    def _rows(cls, log_n: int, q: int) -> dict:
        key = (log_n, q)
        if key in cls._row_cache:
            return cls._row_cache[key]
        n = 1 << log_n
        psi = numth.try_minimal_primitive_root(2 * n, q)
        if psi is None:
            raise ValueError(f"[NTT64Tables] modulus {q} does not support NTT degree {n}")
        ipsi = numth.invert_mod(psi, q)
        fwd, inv = [0] * n, [0] * n
        p, ip = 1, 1
        for i in range(n):
            b = numth.reverse_bits(i, log_n)
            fwd[b], inv[b] = p, ip
            p = p * psi % q
            ip = ip * ipsi % q
        nv = numth.invert_mod(n, q)
        rows = dict(psi_br=fwd, psi_br_shoup=[W.shoup62(w, q) for w in fwd],
                    inv_psi_br=inv, inv_psi_br_shoup=[W.shoup62(w, q) for w in inv],
                    n_inv=nv, n_inv_shoup=W.shoup62(nv, q))
        cls._row_cache[key] = rows
        return rows

    def __init__(self, log_n: int, primes, device):
        self.log_n = log_n
        self.n = 1 << log_n
        self.primes = [int(getattr(q, "value", q)) for q in primes]
        for q in self.primes:
            if q >= W.WIDE_BOUND:
                raise ValueError("[NTT64Tables] q must be < 2^61")
        self.moduli = [Modulus(q) for q in self.primes]
        self.device = torch.device(device)
        rows = [self._rows(log_n, q) for q in self.primes]

        def t(x):
            return torch.tensor(x, dtype=torch.int64, device=self.device)
        self.q = t(self.primes)
        for name in ("psi_br", "psi_br_shoup", "inv_psi_br", "inv_psi_br_shoup"):
            setattr(self, name, t([r[name] for r in rows]))
        self.n_inv = t([r["n_inv"] for r in rows])
        self.n_inv_shoup = t([r["n_inv_shoup"] for r in rows])
        self.k = W.barrett_consts(self.primes, self.device)

    @property
    def size(self) -> int:
        return len(self.primes)

    @property
    def max_modulus(self) -> int:
        return max(self.primes)

    def take(self, idx: list[int]) -> "NTT64Tables":
        """Tables for the limb rows idx."""
        out = object.__new__(NTT64Tables)
        out.log_n, out.n, out.device = self.log_n, self.n, self.device
        out.primes = [self.primes[i] for i in idx]
        out.moduli = [self.moduli[i] for i in idx]
        ix = torch.tensor(idx, dtype=torch.int64, device=self.device)
        for name in ("q", "psi_br", "psi_br_shoup", "inv_psi_br", "inv_psi_br_shoup",
                     "n_inv", "n_inv_shoup"):
            setattr(out, name, getattr(self, name)[ix])
        out.k = tuple(c[ix] for c in self.k)
        return out


class WideScalarTables:
    """The moduli and Barrett tuple of a wide base that needs no NTT (the
    counterpart of the JAX package's wide_scalar_pack)."""

    words = 2

    def __init__(self, values, device):
        self.primes = [int(v) for v in values]
        self.device = torch.device(device)
        self.q = torch.tensor(self.primes, dtype=torch.int64, device=self.device)
        self.k = W.barrett_consts(self.primes, self.device)

    @property
    def size(self) -> int:
        return len(self.primes)


def wide_scalar_pack(values, device="cpu") -> WideScalarTables:
    """Tables {q, Barrett tuple, words = 2} for a base without an NTT."""
    return WideScalarTables(values, device)


@span("ntt")
def ntt_forward64(x: torch.Tensor, t: NTT64Tables) -> torch.Tensor:
    """Forward negacyclic NTT along the last axis of (..., L, n) wide
    residues.  In: [0, 2q) natural order; out: [0, q) NTT order."""
    n, L = x.shape[-1], x.shape[-2]
    lead = x.shape[:-2]
    q = t.q.view(L, 1, 1)
    x = W.cond_sub64(x, t.q.view(L, 1))
    m = 1
    while m < n:
        xr = x.reshape(*lead, L, m, 2, n // (2 * m))
        u, v = xr[..., 0, :], xr[..., 1, :]
        tv = W.shoup_mul64(v, t.psi_br[:, m:2 * m, None],
                           t.psi_br_shoup[:, m:2 * m, None], q)
        x = torch.stack([W.add_mod64(u, tv, q), W.sub_mod64(u, tv, q)],
                        dim=-2).reshape(*lead, L, n)
        m *= 2
    return x


@span("ntt")
def ntt_inverse64(x: torch.Tensor, t: NTT64Tables) -> torch.Tensor:
    """Inverse negacyclic NTT along the last axis, scaled by n^-1.  In:
    [0, q) NTT order; out: [0, q) natural order."""
    n, L = x.shape[-1], x.shape[-2]
    lead = x.shape[:-2]
    q = t.q.view(L, 1, 1)
    m = n // 2
    while m >= 1:
        xr = x.reshape(*lead, L, m, 2, n // (2 * m))
        u, v = xr[..., 0, :], xr[..., 1, :]
        x1 = W.shoup_mul64(u + q - v, t.inv_psi_br[:, m:2 * m, None],
                           t.inv_psi_br_shoup[:, m:2 * m, None], q)
        x = torch.stack([W.add_mod64(u, v, q), x1], dim=-2).reshape(*lead, L, n)
        m //= 2
    qc = t.q.view(L, 1)
    return W.shoup_mul64(x, t.n_inv.view(L, 1), t.n_inv_shoup.view(L, 1), qc)


def dyadic_product64(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Elementwise NTT-domain product of wide residues."""
    return W.mul_mod64(a, b, t.k)

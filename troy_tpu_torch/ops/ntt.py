"""Negacyclic NTT/INTT over RNS limbs, for int64 residue tensors.

Counterpart of troy_tpu/ops/ntt.py.  Input is natural (coefficient) order;
output is the standard NTT order: position p holds the evaluation at
psi^(2*brv(p)+1), which the batch encoder's index map relies on.  Outputs are
canonical residues in [0, q), so they equal the JAX package's radix-2,
six-step and Pallas transforms bit for bit.

Two implementations of one function:

  * ntt_forward_plain / ntt_inverse_plain: vectorised radix-2 in PyTorch over
    int64 with `%` (reshape-only Cooley-Tukey / Gentleman-Sande stages, as in
    the JAX radix-2 path).  It serves CPU tensors, and is the reference that
    the CUDA kernel is held to.
  * ops/ntt_cuda.py: the hand-written Hopper kernel pair (csrc/ntt.cu), which
    serves CUDA tensors.

ntt_forward / ntt_inverse dispatch on the tensor's device alone.  Callers use
them through this module's attributes (NTT.ntt_forward), never by name import.

Tables are built on the host with Python ints (NTTTables._rows copies the
JAX table builder) and moved to the context's device.  The forward transform
accepts lazy inputs in [0, 2q): keyswitch digits arrive unreduced.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import numth
from ..core.modulus import Modulus


def _shoup(values: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) as u32 for residues w < q < 2^30."""
    return ((values.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


class NTTTables:
    """Per-(n, modulus-list) twiddle tables on one device.

    Plain-version tensors (int64):
      q (L,), psi_br / inv_psi_br (L, n) psi^brv(i) and their inverses,
      n_inv (L,).
    Kernel tensors (u32 bit patterns stored as int32):
      kernel_rows (4, L, n): psi_br, its Shoup companion, inv_psi_br, its
        Shoup companion;
      kernel_scalars (3, L): q, n^-1, the Shoup companion of n^-1.
    """

    _row_cache: dict = {}  # (log_n, q) -> per-modulus host rows

    @classmethod
    def _rows(cls, log_n: int, mod: Modulus) -> dict:
        key = (log_n, mod.value)
        if key in cls._row_cache:
            return cls._row_cache[key]
        n = 1 << log_n
        q = mod.value
        psi = numth.try_minimal_primitive_root(2 * n, q)
        if psi is None:
            raise ValueError(
                f"[NTTTables] modulus {q} does not support NTT of degree {n}")
        ipsi = numth.invert_mod(psi, q)
        brv = [numth.reverse_bits(i, log_n) for i in range(n)]
        fwd = np.zeros(n, dtype=np.uint32)
        inv = np.zeros(n, dtype=np.uint32)
        p, ip = 1, 1
        for i in range(n):
            fwd[brv[i]] = p
            inv[brv[i]] = ip
            p = p * psi % q
            ip = ip * ipsi % q
        ninv = numth.invert_mod(n, q)
        rows = dict(psi_br=fwd, psi_br_shoup=_shoup(fwd, q),
                    inv_psi_br=inv, inv_psi_br_shoup=_shoup(inv, q),
                    n_inv=ninv, n_inv_shoup=(ninv << 32) // q)
        cls._row_cache[key] = rows
        return rows

    def __init__(self, log_n: int, moduli: list[Modulus], device):
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = list(moduli)
        self.device = torch.device(device)
        rows = [self._rows(log_n, m) for m in moduli]
        q = np.array([m.value for m in moduli], dtype=np.int64)
        kernel_rows = np.stack([
            np.stack([r[k] for r in rows])
            for k in ("psi_br", "psi_br_shoup", "inv_psi_br", "inv_psi_br_shoup")])
        kernel_scalars = np.array(
            [q, [r["n_inv"] for r in rows], [r["n_inv_shoup"] for r in rows]],
            dtype=np.uint64).astype(np.uint32)
        self._set(
            q=torch.from_numpy(q),
            psi_br=torch.from_numpy(kernel_rows[0].astype(np.int64)),
            inv_psi_br=torch.from_numpy(kernel_rows[2].astype(np.int64)),
            n_inv=torch.tensor([r["n_inv"] for r in rows], dtype=torch.int64),
            kernel_rows=torch.from_numpy(kernel_rows.view(np.int32)),
            kernel_scalars=torch.from_numpy(kernel_scalars.view(np.int32)),
        )

    def _set(self, **tensors):
        for k, v in tensors.items():
            setattr(self, k, v.to(self.device).contiguous())

    @property
    def size(self) -> int:
        return len(self.moduli)

    @property
    def max_modulus(self) -> int:
        return max(m.value for m in self.moduli)

    def take(self, idx: list[int]) -> "NTTTables":
        """Tables for the limb rows idx (e.g. a level's moduli plus the
        special prime, for the keyswitch output base)."""
        out = object.__new__(NTTTables)
        out.log_n, out.n, out.device = self.log_n, self.n, self.device
        out.moduli = [self.moduli[i] for i in idx]
        ix = torch.tensor(idx, dtype=torch.int64, device=self.device)
        out._set(q=self.q[ix], psi_br=self.psi_br[ix],
                 inv_psi_br=self.inv_psi_br[ix], n_inv=self.n_inv[ix],
                 kernel_rows=self.kernel_rows[:, ix],
                 kernel_scalars=self.kernel_scalars[:, ix])
        return out


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  x has shape (..., L, n); t is an NTTTables.
# ---------------------------------------------------------------------------

def ntt_forward_plain(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT along the last axis: Cooley-Tukey stages with
    m groups each, the flat (..., n) axis viewed as (..., m, 2, n/2m).
    In: [0, 2q) natural order, the kernel's contract: one conditional
    subtract brings it to [0, q), so input of 2q or more comes out wrong here
    as it may on the card.  Out: [0, q) NTT order."""
    n, L = x.shape[-1], x.shape[-2]
    lead = x.shape[:-2]
    q = t.q.view(L, 1, 1)
    x = torch.where(x >= t.q.view(L, 1), x - t.q.view(L, 1), x)
    m, tt = 1, n // 2
    while m < n:
        xr = x.reshape(*lead, L, m, 2, tt)
        u, v = xr[..., 0, :], xr[..., 1, :]
        tv = v * t.psi_br[:, m:2 * m, None] % q
        x0 = u + tv
        x0 = torch.where(x0 >= q, x0 - q, x0)
        x1 = u - tv
        x1 = torch.where(x1 < 0, x1 + q, x1)
        x = torch.stack([x0, x1], dim=-2).reshape(*lead, L, n)
        m *= 2
        tt //= 2
    return x


def ntt_inverse_plain(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT along the last axis (Gentleman-Sande stages),
    scaled by n^-1.  In: [0, q) NTT order; out: [0, q) natural order."""
    n, L = x.shape[-1], x.shape[-2]
    lead = x.shape[:-2]
    q = t.q.view(L, 1, 1)
    m, tt = n // 2, 1
    while m >= 1:
        xr = x.reshape(*lead, L, m, 2, tt)
        u, v = xr[..., 0, :], xr[..., 1, :]
        x0 = u + v
        x0 = torch.where(x0 >= q, x0 - q, x0)
        x1 = (u + q - v) * t.inv_psi_br[:, m:2 * m, None] % q
        x = torch.stack([x0, x1], dim=-2).reshape(*lead, L, n)
        m //= 2
        tt *= 2
    return x * t.n_inv.view(L, 1) % t.q.view(L, 1)


# ---------------------------------------------------------------------------
# Dispatch: a CPU tensor takes the plain version, a CUDA tensor the kernel.
# ---------------------------------------------------------------------------

def ntt_forward(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Forward NTT of (..., L, n) residues in [0, 2q) -> [0, q) NTT order."""
    if x.is_cuda:
        from . import ntt_cuda

        return ntt_cuda.ntt_forward(x, t)
    return ntt_forward_plain(x, t)


def ntt_inverse(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Inverse NTT of (..., L, n) residues in [0, q) -> [0, q) natural order."""
    if x.is_cuda:
        from . import ntt_cuda

        return ntt_cuda.ntt_inverse(x, t)
    return ntt_inverse_plain(x, t)

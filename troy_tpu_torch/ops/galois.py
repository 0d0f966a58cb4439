"""Galois automorphisms x -> x^g on R = Z_q[X]/(X^n + 1), for int64 tensors.

Counterpart of troy_tpu/ops/galois.py.  Per-element permutation tables are
built on the host with vectorised numpy, kept on the device, and applied as
one gather along the coefficient axis (the same for every RNS limb):

  * coefficient domain: X^i -> X^(i g mod 2n), negated when i g mod 2n >= n
    (X^(n+r) = -X^r), so out[j] = +-in[perm[j]];
  * NTT domain: position p holds the evaluation at psi^(2 brv(p) + 1)
    (ops/ntt.py order), and applying g permutes the evaluation points:
    out[p] = in[p'] with 2 brv(p') + 1 = (2 brv(p) + 1) g mod 2n, a pure
    gather.

The JAX package applies the permutation with jnp.take, outside any Pallas
kernel; here it is torch.index_select on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import numth
from . import u32 as U

GENERATOR = 3  # rotation group generator (ref: galois.h:12)


def _reverse_bits(values: np.ndarray, bit_count: int) -> np.ndarray:
    """numth.reverse_bits over an int64 array."""
    out = np.zeros_like(values)
    for b in range(bit_count):
        out |= ((values >> b) & 1) << (bit_count - 1 - b)
    return out


class GaloisTool:
    """Permutation tables for one degree on one device, built per element on
    first use."""

    _instances: dict[tuple[int, str], "GaloisTool"] = {}

    def __init__(self, log_n: int, device):
        self.log_n = log_n
        self.n = 1 << log_n
        self.device = torch.device(device)
        self._coeff_tables: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._ntt_tables: dict[int, torch.Tensor] = {}

    @classmethod
    def for_context(cls, cd) -> "GaloisTool":
        key = (cd.log_n, str(cd.device))
        if key not in cls._instances:
            cls._instances[key] = cls(cd.log_n, cd.device)
        return cls._instances[key]

    # ------------------------------------------------------------------
    @staticmethod
    def get_element_from_step(step: int, n: int) -> int:
        """Rotation step -> Galois element 3^step mod 2n
        (ref: galois.h get_element_from_step)."""
        if step == 0:
            return 1
        m = 2 * n
        if step > 0:
            return pow(GENERATOR, step, m)
        return pow(numth.invert_mod(GENERATOR, m), -step, m)

    @staticmethod
    def conjugate_element(n: int) -> int:
        return 2 * n - 1

    # ------------------------------------------------------------------
    def _build_coeff(self, g: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather form of the coefficient automorphism: (perm, neg), with
        out[j] = -in[perm[j]] where neg[j], else in[perm[j]]."""
        n, m = self.n, 2 * self.n
        src = np.arange(n, dtype=np.int64)
        dst = src * g % m
        perm = np.empty(n, dtype=np.int64)
        neg = np.empty(n, dtype=bool)
        perm[dst % n] = src
        neg[dst % n] = dst >= n
        return (torch.from_numpy(perm).to(self.device),
                torch.from_numpy(neg).to(self.device))

    def _build_ntt(self, g: int) -> torch.Tensor:
        e = 2 * _reverse_bits(np.arange(self.n, dtype=np.int64), self.log_n) + 1
        e2 = e * g % (2 * self.n)
        perm = _reverse_bits((e2 - 1) // 2, self.log_n)
        return torch.from_numpy(perm).to(self.device)

    def coeff_table(self, g: int) -> tuple[torch.Tensor, torch.Tensor]:
        if g not in self._coeff_tables:
            self._coeff_tables[g] = self._build_coeff(g)
        return self._coeff_tables[g]

    def ntt_table(self, g: int) -> torch.Tensor:
        if g not in self._ntt_tables:
            self._ntt_tables[g] = self._build_ntt(g)
        return self._ntt_tables[g]

    # ------------------------------------------------------------------
    def apply_coeff(self, x: torch.Tensor, g: int, qtab) -> torch.Tensor:
        """Coefficient-domain automorphism of (..., L, n) residues
        (ref: galois.cu apply_ps)."""
        perm, neg = self.coeff_table(g)
        gathered = x.index_select(-1, perm)
        return torch.where(neg, U.neg_mod(gathered, qtab.q.view(-1, 1)), gathered)

    def apply_ntt(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """NTT-domain automorphism: a pure gather (ref: galois.cu apply_ntt_ps)."""
        return x.index_select(-1, self.ntt_table(g))

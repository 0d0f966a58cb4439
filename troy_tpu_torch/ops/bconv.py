"""Fast RNS base conversion on int64 residue tensors.

Counterpart of the base-conversion dot of troy_tpu/rns/rns_base.py
(BaseConverter.convert) and of its Pallas kernel
troy_tpu/ops/ntt_pallas.py:bconv_pallas (K3):

    y_o = sum_i [x_i * ip_i]_{q_i} * M[o, i]  mod p_o

for x of shape (..., L_in, n) in base {q_i} and y of shape (..., L_out, n)
in base {p_o}.  A BaseConverter uses ip_i = (Q/q_i)^-1 mod q_i and
M[o, i] = (Q/q_i) mod p_o; the BFV fast floor uses folded tables of the same
form (rns/rns_tool.py).

Two implementations of one function:

  * base_convert_plain: int64 PyTorch (ops/u32.mul_mod and dot_mod).  It
    serves CPU tensors, and is the reference the CUDA kernel is held to.
  * ops/bconv_cuda.py: the hand-written Hopper kernel (csrc/bconv.cu), which
    serves CUDA tensors.

base_convert dispatches on the tensor's device alone.  Callers use it through
this module's attribute (bconv.base_convert), never by name import.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u32 as U
from ..utils.timer import span


_W64 = 1 << 64


def mat_vecs(l_in: int) -> int:
    """16-byte vectors a matrix row takes in the kernel's tables."""
    return (l_in + 3) // 4


def check_cadence(every: int, term: int, p: int) -> int:
    """`every` itself where `every` products below term + 1 plus a value
    reduced mod p stay below 2^64, the bound under which the kernel's
    Barrett step (csrc/ntt_common.cuh barrett_reduce64) needs its one
    correction; raises where they do not."""
    if every < 1 or every * term + p - 1 >= _W64:
        raise ValueError(f"[BConvTables] a cadence of {every} products below {term + 1} "
                         f"overflows 64 bits at p = {p}")
    return every


class BConvTables:
    """The tables of one conversion {q_i} -> {p_o} on one device.

    Plain-version tensors (int64): q_in and ip (L_in,), p_out (L_out,),
    mat (L_out, L_in).
    Kernel constants, built and checked here so that the kernel divides
    nothing: ratio[o] = floor((2^64 - 1) / p_o), Barrett's constant, and
    cadence[o], the products summed between two reductions of output o: the
    most for which they (each below max(q_in) max(mat[o])) plus a reduced
    value stay below 2^64, at most L_in (one reduction at the end only),
    checked by check_cadence.
    Kernel tensor (u32 bit patterns stored as int32), in 16-byte vectors:
    L_in of [q_i, ip_i, Shoup companion floor(ip_i 2^32 / q_i), 0], L_out of
    [p_o, ratio_o low, ratio_o high, cadence_o], then mat, each row padded
    with zeros to mat_vecs(L_in) vectors (csrc/bconv.cu).
    """

    def __init__(self, q_in: list[int], ip: list[int], p_out: list[int],
                 mat: list[list[int]], device):
        self.L_in = len(q_in)
        self.L_out = len(p_out)
        self.max_modulus = max(q_in + p_out)
        self.max_in_modulus = max(q_in)
        self.max_out_modulus = max(p_out)
        self.device = torch.device(device)
        shoup = [(w << 32) // q for w, q in zip(ip, q_in)]
        if max(q_in + ip + shoup + p_out + [m for row in mat for m in row]) >= 1 << 32:
            raise ValueError("[BConvTables] table values must fit 32 bits")
        if min(p_out) < 2:
            raise ValueError("[BConvTables] output moduli must be at least 2")
        self.ratio = [(_W64 - 1) // p for p in p_out]
        self.cadence = [self._cadence(p, max(row)) for p, row in zip(p_out, mat)]
        self.q_in = torch.tensor(q_in, dtype=torch.int64, device=self.device)
        self.ip = torch.tensor(ip, dtype=torch.int64, device=self.device)
        self.p_out = torch.tensor(p_out, dtype=torch.int64, device=self.device)
        self.mat = torch.tensor(mat, dtype=torch.int64, device=self.device)
        lv = 4 * mat_vecs(self.L_in)
        words = [w for q, w, ws in zip(q_in, ip, shoup) for w in (q, w, ws, 0)]
        words += [w for p, r, c in zip(p_out, self.ratio, self.cadence)
                  for w in (p, r & 0xFFFFFFFF, r >> 32, c)]
        words += [w for row in mat for w in list(row) + [0] * (lv - self.L_in)]
        self.kernel_tables = torch.from_numpy(
            np.array(words, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(self.device)

    def _cadence(self, p: int, m_max: int) -> int:
        """Output p's reduction cadence (see the class)."""
        term = (self.max_in_modulus - 1) * m_max
        return check_cadence(self.L_in if term == 0 else min(self.L_in, (_W64 - p) // term),
                             term, p)


def take_outputs(tabs: BConvTables, idx) -> BConvTables:
    """The conversion into the output rows idx of tabs only (a limb shard's
    rows, parallel/partition.py)."""
    idx = [int(j) for j in idx]
    p_out, mat = tabs.p_out.tolist(), tabs.mat.tolist()
    return BConvTables(tabs.q_in.tolist(), tabs.ip.tolist(), [p_out[j] for j in idx],
                       [mat[j] for j in idx], tabs.device)


def join_outputs(a: BConvTables, b: BConvTables) -> BConvTables:
    """One conversion into a's output rows followed by b's, from the input
    base they share (the Shenoy-Kumaresan pair, rns/rns_tool.py)."""
    if not (torch.equal(a.q_in, b.q_in) and torch.equal(a.ip, b.ip)):
        raise ValueError("[bconv] joined conversions must share their input base")
    return BConvTables(a.q_in.tolist(), a.ip.tolist(), a.p_out.tolist() + b.p_out.tolist(),
                       a.mat.tolist() + b.mat.tolist(), a.device)


def base_convert_plain(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """x: (..., L_in, n) residues in [0, q_i) -> (..., L_out, n) in [0, p_o).
    The dot's chunk is sized by the products' own bound (inputs below 2^30,
    outputs below 2^32: ring2k converts into t = 2^k)."""
    tmp = U.mul_mod(x, tabs.ip.view(-1, 1), tabs.q_in.view(-1, 1))
    pairs = [(tmp[..., i:i + 1, :], tabs.mat[:, i:i + 1]) for i in range(tabs.L_in)]
    return U.dot_mod(pairs, tabs.p_out.view(-1, 1),
                     U.dot_terms(tabs.max_in_modulus, tabs.max_out_modulus))


@span("bconv")
def base_convert(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """Fast base conversion of (..., L_in, n) residues: the kernel for a CUDA
    tensor, read where it lies when the kernel can address it (copied,
    and the copy counted, when not), the plain version for a CPU tensor."""
    if x.is_cuda:
        from . import bconv_cuda

        return bconv_cuda.base_convert(bconv_cuda.addressable(x, tabs.L_in), tabs)
    return base_convert_plain(x, tabs)

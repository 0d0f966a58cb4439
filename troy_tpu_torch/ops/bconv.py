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


class BConvTables:
    """The tables of one conversion {q_i} -> {p_o} on one device.

    Plain-version tensors (int64): q_in and ip (L_in,), p_out (L_out,),
    mat (L_out, L_in).
    Kernel tensor (u32 bit patterns stored as int32): kernel_tables =
    [q_in, ip, Shoup companion floor(ip * 2^32 / q_in), p_out, mat row-major].
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
        words = np.array(q_in + ip + shoup + p_out + [m for row in mat for m in row],
                         dtype=np.uint64)
        if words.max() >= (1 << 32):
            raise ValueError("[BConvTables] table values must fit 32 bits")
        self.q_in = torch.tensor(q_in, dtype=torch.int64, device=self.device)
        self.ip = torch.tensor(ip, dtype=torch.int64, device=self.device)
        self.p_out = torch.tensor(p_out, dtype=torch.int64, device=self.device)
        self.mat = torch.tensor(mat, dtype=torch.int64, device=self.device)
        self.kernel_tables = torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).to(self.device)


def take_outputs(tabs: BConvTables, idx) -> BConvTables:
    """The conversion into the output rows idx of tabs only (a limb shard's
    rows, parallel/partition.py)."""
    idx = [int(j) for j in idx]
    p_out, mat = tabs.p_out.tolist(), tabs.mat.tolist()
    return BConvTables(tabs.q_in.tolist(), tabs.ip.tolist(), [p_out[j] for j in idx],
                       [mat[j] for j in idx], tabs.device)


def base_convert_plain(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """x: (..., L_in, n) residues in [0, q_i) -> (..., L_out, n) in [0, p_o).
    The dot's chunk is sized by the products' own bound (inputs below 2^30,
    outputs below 2^32: ring2k converts into t = 2^k)."""
    tmp = U.mul_mod(x, tabs.ip.view(-1, 1), tabs.q_in.view(-1, 1))
    pairs = [(tmp[..., i:i + 1, :], tabs.mat[:, i:i + 1]) for i in range(tabs.L_in)]
    return U.dot_mod(pairs, tabs.p_out.view(-1, 1),
                     U.dot_terms(tabs.max_in_modulus, tabs.max_out_modulus))


def base_convert(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """Fast base conversion of (..., L_in, n) residues: the kernel for a CUDA
    tensor (made contiguous), the plain version for a CPU tensor."""
    if x.is_cuda:
        from . import bconv_cuda

        return bconv_cuda.base_convert(x.contiguous(), tabs)
    return base_convert_plain(x, tabs)

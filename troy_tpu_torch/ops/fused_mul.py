"""The tensor-product stage of a BFV multiply over one base, as one function:
NTT -> dyadic convolute -> INTT.

Counterpart of troy_tpu/ops/fused_mul.py:fused_negacyclic_multiply (K4):

    a (..., 2, L, n), b (..., 2, L, n)  ->  (..., 3, L, n)

all in the coefficient domain, with (c0, c1, c2) = (a0 b0, a0 b1 + a1 b0,
a1 b1) as negacyclic products mod q.  As in the JAX package, the evaluator
does not call it: it stands at its own entry point until a measurement
decides whether the multiply uses it.

  * fused_negacyclic_multiply_plain: the port's unfused ops, the reference
    the CUDA kernel is held to.  It serves CPU tensors.
  * ops/fused_mul_cuda.py: the hand-written Hopper kernel
    (csrc/fused_mul.cu), which serves CUDA tensors.
"""

from __future__ import annotations

import torch

from . import dyadic as D, ntt as NTT
from .ntt import NTTTables


def fused_negacyclic_multiply_plain(a: torch.Tensor, b: torch.Tensor,
                                    t: NTTTables) -> torch.Tensor:
    """a, b: (..., 2, L, n) residues in [0, q) -> (..., 3, L, n) in [0, q)."""
    return NTT.ntt_inverse_plain(
        D.dyadic_convolute(NTT.ntt_forward_plain(a, t),
                           NTT.ntt_forward_plain(b, t), t), t)


def fused_negacyclic_multiply(a: torch.Tensor, b: torch.Tensor,
                              t: NTTTables) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if a.is_cuda:
        from . import fused_mul_cuda

        return fused_mul_cuda.fused_negacyclic_multiply(a, b, t)
    return fused_negacyclic_multiply_plain(a, b, t)

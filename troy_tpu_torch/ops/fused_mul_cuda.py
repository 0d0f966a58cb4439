"""Wrapper of the Hopper fused tensor-product kernel (csrc/fused_mul.cu).

Counterpart of troy_tpu/ops/fused_mul.py:fused_negacyclic_multiply (K4).
The plain PyTorch version is ops/fused_mul.py:fused_negacyclic_multiply_plain.
The kernel is compiled at first use with the port's other kernels
(ops/_cuda_build.py); a failed build or launch raises, and nothing falls back
to the plain version.

It takes every degree the NTT kernel takes, n <= 32768: up to n = 8192 the
four operand polynomials stay in shared memory together, above it the kernel
stages NTT-domain rows in its own output tensor (see the source note).

LAUNCHES counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt import NTTTables
from .ntt_cuda import MAX_LOG_N, MODULUS_BOUND

LAUNCHES = {"fused_negacyclic_multiply": 0}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(a: torch.Tensor, b: torch.Tensor, t: NTTTables):
    for x in (a, b):
        if not x.is_cuda:
            raise ValueError("[fused_mul_cuda] inputs must be CUDA tensors")
        if x.device != t.kernel_rows.device:
            raise ValueError(f"[fused_mul_cuda] input on {x.device}, tables on "
                             f"{t.kernel_rows.device}")
        if x.dtype != torch.int64:
            raise TypeError(f"[fused_mul_cuda] residues must be int64, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("[fused_mul_cuda] inputs must be contiguous")
    if a.shape != b.shape:
        raise ValueError(f"[fused_mul_cuda] shapes differ: {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dim() < 3 or tuple(a.shape[-3:]) != (2, t.size, t.n):
        raise ValueError(f"[fused_mul_cuda] shape {tuple(a.shape)} does not end "
                         f"in (2, L, n) = (2, {t.size}, {t.n})")
    n = t.n
    if n & (n - 1) or n < 2 or n > (1 << MAX_LOG_N):
        raise ValueError(f"[fused_mul_cuda] n = {n} must be a power of two in "
                         f"[2, {1 << MAX_LOG_N}]")
    if t.max_modulus >= MODULUS_BOUND:
        raise ValueError(f"[fused_mul_cuda] modulus {t.max_modulus} >= 2^30")


def fused_negacyclic_multiply(a: torch.Tensor, b: torch.Tensor,
                              t: NTTTables) -> torch.Tensor:
    """Kernel tensor product: a, b (..., 2, L, n) int64 residues in [0, 2q),
    coefficient domain -> (..., 3, L, n) in [0, q), coefficient domain."""
    _check(a, b, t)
    fn = _cuda_build.function("troy_fused_mul", _ARGTYPES)
    out = torch.empty((*a.shape[:-3], 3, t.size, t.n), dtype=torch.int64,
                      device=a.device)
    n_batch = a.numel() // (2 * t.size * t.n)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 t.kernel_rows.data_ptr(), t.kernel_scalars.data_ptr(),
                 n_batch, t.size, t.log_n, stream)
    if err != 0:
        raise RuntimeError(f"[fused_mul_cuda] launch failed: CUDA error {err}")
    LAUNCHES["fused_negacyclic_multiply"] += 1
    return out


def reset_launches():
    LAUNCHES["fused_negacyclic_multiply"] = 0

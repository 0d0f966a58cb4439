"""Wrapper of the Hopper NTT kernel pair (csrc/ntt.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py (K1 and K2: the VPU and MXU
Pallas NTT kernels, which compute the same transform).  The plain PyTorch
version is ops/ntt.py:ntt_forward_plain / ntt_inverse_plain.

The kernels are compiled at first use with the port's other kernels
(ops/_cuda_build.py).  A failed build or launch raises: nothing falls back
to the plain version.

LAUNCHES counts the launches of each kernel; a run reads it to show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt import NTTTables

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0}

MAX_LOG_N = 15      # one polynomial of n <= 32768 u32 values in shared memory
MODULUS_BOUND = 1 << 30  # lazy stage values below 4q must fit 32 bits
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, t: NTTTables):
    if not x.is_cuda:
        raise ValueError("[ntt_cuda] input must be a CUDA tensor")
    if x.device != t.kernel_rows.device:
        raise ValueError(f"[ntt_cuda] input on {x.device}, tables on "
                         f"{t.kernel_rows.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"[ntt_cuda] residues must be int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("[ntt_cuda] input must be contiguous")
    if x.dim() < 2 or x.shape[-2] != t.size or x.shape[-1] != t.n:
        raise ValueError(f"[ntt_cuda] shape {tuple(x.shape)} does not end in "
                         f"(L, n) = ({t.size}, {t.n})")
    n = t.n
    if n & (n - 1) or n < 2 or n > (1 << MAX_LOG_N):
        raise ValueError(f"[ntt_cuda] n = {n} must be a power of two in "
                         f"[2, {1 << MAX_LOG_N}]")
    if t.max_modulus >= MODULUS_BOUND:
        raise ValueError(f"[ntt_cuda] modulus {t.max_modulus} >= 2^30")


def _launch(name: str, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    _check(x, t)
    fn = _cuda_build.function("troy_" + name, _ARGTYPES)
    out = torch.empty_like(x)
    rows = x.numel() // t.n
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), out.data_ptr(), t.kernel_rows.data_ptr(),
            t.kernel_scalars.data_ptr(), rows, t.size, t.log_n, stream)
    if err != 0:
        raise RuntimeError(f"[ntt_cuda] {name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def ntt_forward(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Kernel forward NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch("ntt_forward", x, t)


def ntt_inverse(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Kernel inverse NTT of (..., L, n) int64 residues in [0, q)."""
    return _launch("ntt_inverse", x, t)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

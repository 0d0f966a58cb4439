"""Wrapper of the Hopper base-conversion kernel (csrc/bconv.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py:bconv_pallas (K3).  The plain
PyTorch version is ops/bconv.py:base_convert_plain.  The kernel is compiled
at first use with the port's other kernels (ops/_cuda_build.py); a failed
build or launch raises, and nothing falls back to the plain version.

LAUNCHES counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .bconv import BConvTables

LAUNCHES = {"base_convert": 0}

MAX_LIMBS = 64           # shared-memory tables and the (L_in, 128) tile
MODULUS_BOUND = 1 << 30  # input moduli: the Shoup step's u32 lanes
OUTPUT_BOUND = 1 << 32   # output moduli: a u32 table word (ring2k's t = 2^31)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _check(x: torch.Tensor, tabs: BConvTables):
    if not x.is_cuda:
        raise ValueError("[bconv_cuda] input must be a CUDA tensor")
    if x.device != tabs.kernel_tables.device:
        raise ValueError(f"[bconv_cuda] input on {x.device}, tables on "
                         f"{tabs.kernel_tables.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"[bconv_cuda] residues must be int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("[bconv_cuda] input must be contiguous")
    if x.dim() < 2 or x.shape[-2] != tabs.L_in or x.shape[-1] < 1:
        raise ValueError(f"[bconv_cuda] shape {tuple(x.shape)} does not end in "
                         f"(L_in, n) with L_in = {tabs.L_in}")
    if tabs.L_in > MAX_LIMBS or tabs.L_out > MAX_LIMBS:
        raise ValueError(f"[bconv_cuda] {tabs.L_in} -> {tabs.L_out} limbs: at "
                         f"most {MAX_LIMBS} each")
    if tabs.max_in_modulus >= MODULUS_BOUND:
        raise ValueError(f"[bconv_cuda] input modulus {tabs.max_in_modulus} >= 2^30")
    if tabs.max_out_modulus >= OUTPUT_BOUND:
        raise ValueError(f"[bconv_cuda] output modulus {tabs.max_out_modulus} >= 2^32")


def base_convert(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """Kernel base conversion of (..., L_in, n) int64 residues in [0, q_i)
    -> (..., L_out, n) in [0, p_o)."""
    _check(x, tabs)
    fn = _cuda_build.function("troy_bconv", _ARGTYPES)
    n = x.shape[-1]
    out = torch.empty((*x.shape[:-2], tabs.L_out, n), dtype=torch.int64,
                      device=x.device)
    rows = x.numel() // (tabs.L_in * n)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), tabs.kernel_tables.data_ptr(),
                 rows, tabs.L_in, tabs.L_out, n, stream)
    if err != 0:
        raise RuntimeError(f"[bconv_cuda] launch failed: CUDA error {err}")
    LAUNCHES["base_convert"] += 1
    return out


def reset_launches():
    LAUNCHES["base_convert"] = 0

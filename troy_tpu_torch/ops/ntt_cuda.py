"""Wrapper of the Hopper NTT kernels (csrc/ntt.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py (K1 and K2: the VPU and MXU
Pallas NTT kernels, which compute the same transform).  The plain PyTorch
version is ops/ntt.py:ntt_forward_plain / ntt_inverse_plain.

Two routes, chosen by the tables' split (ops/ntt.py:default_split):
  * n from 2 to 32768 (split 0): the register-radix kernel troy_ntt_forward /
    troy_ntt_inverse, one launch, one CTA per polynomial, which copies its
    limb's twiddles (NTTTables.kernel_phases) into shared memory beside the
    polynomial;
  * n = 65536 and 131072 (split = log2 n1 > 0, n = n1 n2): two launches.
    The forward runs the column kernel (troy_ntt_columns_forward: the first
    log2 n1 stages over the columns x[i n2 + j]) and then the block kernel
    (troy_ntt_blocks_forward: the other stages on each block of n2 values,
    one CTA a block); the inverse the block kernel, then the column kernel
    with the n^-1 scale.  Every launch leaves [0, q), so each meets the next
    one's input contract, and each equals a plain partial transform
    (ops/ntt.py:forward_stages_plain / inverse_stages_plain).
The first, radix-2 pair (troy_ntt_*_radix2) stays in the library as a timing
yardstick: run_radix2 launches it for chip_smoke.py's comparison, and no
route of this wrapper takes it.

The kernels are compiled at first use with the port's other kernels
(ops/_cuda_build.py).  A failed build or launch raises: nothing falls back
to the plain version, at any degree.

LAUNCHES counts each kernel's launches (ntt_forward / ntt_inverse: the
one-launch kernel; *_columns and *_blocks: the two launches of the large
route); a run reads it to show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt import BLOCK_MAX_LOG_N, MAX_LOG_N, NTTTables, phase_entries

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0,
            "ntt_forward_columns": 0, "ntt_inverse_columns": 0,
            "ntt_forward_blocks": 0, "ntt_inverse_blocks": 0}

MODULUS_BOUND = 1 << 30  # lazy stage values below 4q must fit 32 bits
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BLOCK_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_COLUMN_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
_RADIX2_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, t: NTTTables):
    if getattr(t, "words", 1) != 1:
        raise ValueError("[ntt_cuda] wide (40-60-bit) moduli: their NTT is ops/ntt64.py")
    if not x.is_cuda:
        raise ValueError("[ntt_cuda] input must be a CUDA tensor")
    if x.device != t.kernel_phases.device:
        raise ValueError(f"[ntt_cuda] input on {x.device}, tables on "
                         f"{t.kernel_phases.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"[ntt_cuda] residues must be int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("[ntt_cuda] input must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("[ntt_cuda] input must be 16-byte aligned")
    if x.dim() < 2 or x.shape[-2] != t.size or x.shape[-1] != t.n:
        raise ValueError(f"[ntt_cuda] shape {tuple(x.shape)} does not end in "
                         f"(L, n) = ({t.size}, {t.n})")
    n = t.n
    if n & (n - 1) or n < 2 or n > (1 << MAX_LOG_N):
        raise ValueError(f"[ntt_cuda] n = {n} must be a power of two in "
                         f"[2, {1 << MAX_LOG_N}]")
    if t.block_log_n > BLOCK_MAX_LOG_N:
        raise ValueError(f"[ntt_cuda] blocks of 2^{t.block_log_n} values do not "
                         f"fit a CTA: the tables need a split (ops/ntt.py:default_split)")
    if t.max_modulus >= MODULUS_BOUND:
        raise ValueError(f"[ntt_cuda] modulus {t.max_modulus} >= 2^30")


def _call(name: str, argtypes: list, x: torch.Tensor, t: NTTTables, *args) -> torch.Tensor:
    fn = _cuda_build.function(name, argtypes)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"[ntt_cuda] {name} launch failed: CUDA error {err}")
    return out


def _launch(name: str, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """The one-launch kernel (split 0)."""
    out = _call("troy_" + name, _ARGTYPES, x, t, t.kernel_phases.data_ptr(),
                t.kernel_scalars.data_ptr(), x.numel() // t.n, t.size, t.log_n,
                t.plan_code, t.entries)
    LAUNCHES[name] += 1
    return out


def blocks(inverse: bool, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the block kernel (a split's stages from log2 n1 on), as
    ntt_forward / ntt_inverse launch it; its plain version is
    forward_stages_plain(x, t, split, log_n) (inverse_stages_plain, unscaled)."""
    _check(x, t)
    if not t.split:
        raise ValueError("[ntt_cuda] the block kernel needs tables with a split")
    name = "ntt_inverse_blocks" if inverse else "ntt_forward_blocks"
    scalars = t.block_scalars if inverse else t.kernel_scalars
    out = _call(f"troy_ntt_blocks_{'inverse' if inverse else 'forward'}",
                _BLOCK_ARGTYPES, x, t, t.kernel_phases.data_ptr(), scalars.data_ptr(),
                (x.numel() // t.n) << t.split, t.size, t.block_log_n, t.split,
                t.plan_code, t.entries)
    LAUNCHES[name] += 1
    return out


def columns(inverse: bool, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the column kernel (a split's first log2 n1 stages, the
    inverse's last ones with the n^-1 scale); its plain version is
    forward_stages_plain(x, t, 0, split) (inverse_stages_plain, scaled)."""
    _check(x, t)
    if not t.split:
        raise ValueError("[ntt_cuda] the column kernel needs tables with a split")
    name = "ntt_inverse_columns" if inverse else "ntt_forward_columns"
    out = _call(f"troy_ntt_columns_{'inverse' if inverse else 'forward'}",
                _COLUMN_ARGTYPES, x, t, t.column_phases.data_ptr(),
                t.kernel_scalars.data_ptr(), x.numel() // t.n, t.size, t.block_log_n,
                t.split)
    LAUNCHES[name] += 1
    return out


def run_radix2(inverse: bool, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the first, radix-2 kernel (the timing yardstick), not
    counted in LAUNCHES and never a route of ntt_forward / ntt_inverse."""
    _check(x, t)
    if t.split:
        raise ValueError("[ntt_cuda] the radix-2 yardstick runs up to n = 32768 only")
    name = "troy_ntt_inverse_radix2" if inverse else "troy_ntt_forward_radix2"
    return _call(name, _RADIX2_ARGTYPES, x, t, t.kernel_rows.data_ptr(),
                 t.kernel_scalars.data_ptr(), x.numel() // t.n, t.size, t.log_n)


def ntt_forward(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Kernel forward NTT of (..., L, n) int64 residues in [0, 2q)."""
    _check(x, t)
    if t.split:
        return blocks(False, columns(False, x, t), t)
    return _launch("ntt_forward", x, t)


def ntt_inverse(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Kernel inverse NTT of (..., L, n) int64 residues in [0, 2q)."""
    _check(x, t)
    if t.split:
        return columns(True, blocks(True, x, t), t)
    return _launch("ntt_inverse", x, t)


def kernel_info(which: int, log_n: int) -> dict:
    """Threads, dynamic shared bytes, registers and local (spill) bytes a
    thread, and CTAs resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    of one kernel at degree 2^log_n: which 0 forward, 1 inverse, 2 / 3 the
    radix-2 yardstick's forward / inverse."""
    fn = _cuda_build.function("troy_ntt_kernel_info", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * 5)()
    err = fn(which, log_n, phase_entries(log_n), info)
    if err != 0:
        raise RuntimeError(f"[ntt_cuda] kernel info failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "regs", "local_bytes", "ctas_per_sm"), info))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

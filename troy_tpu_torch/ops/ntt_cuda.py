"""Wrapper of the Hopper NTT kernel pair (csrc/ntt.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py (K1 and K2: the VPU and MXU
Pallas NTT kernels, which compute the same transform).  The plain PyTorch
version is ops/ntt.py:ntt_forward_plain / ntt_inverse_plain.

One route for every n from 2 to 32768: the register-radix kernel
troy_ntt_forward / troy_ntt_inverse, one CTA per polynomial, which copies
its limb's twiddles (NTTTables.kernel_phases) into shared memory beside the
polynomial.  The first, radix-2 pair
(troy_ntt_*_radix2) stays in the library as a timing yardstick:
run_radix2 launches it for chip_smoke.py's comparison, and no route of this
wrapper takes it.

The kernels are compiled at first use with the port's other kernels
(ops/_cuda_build.py).  A failed build or launch raises: nothing falls back
to the plain version.

LAUNCHES counts the launches of ntt_forward and ntt_inverse; a run reads it
to show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt import NTTTables, phase_entries

LAUNCHES = {"ntt_forward": 0, "ntt_inverse": 0}

MAX_LOG_N = 15      # one polynomial of n <= 32768 u32 values in shared memory
MODULUS_BOUND = 1 << 30  # lazy stage values below 4q must fit 32 bits
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_RADIX2_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, t: NTTTables):
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
    if t.max_modulus >= MODULUS_BOUND:
        raise ValueError(f"[ntt_cuda] modulus {t.max_modulus} >= 2^30")


def _call(name: str, argtypes: list, x: torch.Tensor, t: NTTTables,
          table: torch.Tensor, *extra) -> torch.Tensor:
    fn = _cuda_build.function(name, argtypes)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), table.data_ptr(),
                 t.kernel_scalars.data_ptr(), x.numel() // t.n, t.size, t.log_n,
                 *extra, stream)
    if err != 0:
        raise RuntimeError(f"[ntt_cuda] {name} launch failed: CUDA error {err}")
    return out


def _launch(name: str, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    _check(x, t)
    out = _call("troy_" + name, _ARGTYPES, x, t, t.kernel_phases, t.plan_code,
                t.kernel_phases.shape[-1] // 2)
    LAUNCHES[name] += 1
    return out


def run_radix2(inverse: bool, x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the first, radix-2 kernel (the timing yardstick), not
    counted in LAUNCHES and never a route of ntt_forward / ntt_inverse."""
    _check(x, t)
    name = "troy_ntt_inverse_radix2" if inverse else "troy_ntt_forward_radix2"
    return _call(name, _RADIX2_ARGTYPES, x, t, t.kernel_rows)


def ntt_forward(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Kernel forward NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch("ntt_forward", x, t)


def ntt_inverse(x: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """Kernel inverse NTT of (..., L, n) int64 residues in [0, 2q)."""
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

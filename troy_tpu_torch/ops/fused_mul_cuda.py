"""Wrapper of the Hopper fused tensor-product kernel (csrc/fused_mul.cu).

Counterpart of troy_tpu/ops/fused_mul.py:fused_negacyclic_multiply (K4).
The plain PyTorch version is ops/fused_mul.py:fused_negacyclic_multiply_plain.
The kernel is compiled at first use with the port's other kernels
(ops/_cuda_build.py); a failed build or launch raises, and nothing falls back
to the plain version.

One route for every n from 2 to 32768: troy_fused_mul, a kernel
instantiated per degree.  From n = 64 it is a thread-block cluster of four
CTAs per (batch, limb), one per operand polynomial, each running the NTT
kernel's register-radix phases (csrc/ntt_phases.cuh) on
NTTTables.kernel_phases; the products are formed across the cluster's shared
memory, by Montgomery reduction (see the source note).  At n <= 32, the
plans of one phase, one CTA holds the four operands.  A cluster the card
cannot schedule is refused at launch, and this wrapper raises.  The first
kernel (troy_fused_mul_radix2) stays in the library as a timing yardstick:
run_radix2 launches it for chip_smoke.py's comparison, and no route of this
wrapper takes it.

LAUNCHES counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt import NTTTables, kernel_phase_plan, phase_entries
from .ntt_cuda import MAX_LOG_N, MODULUS_BOUND

LAUNCHES = {"fused_negacyclic_multiply": 0}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_RADIX2_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
CLUSTER = 4  # CTAs a (batch, limb): one per operand polynomial a0, a1, b0, b1


def shared_bytes(log_n: int) -> int:
    """Dynamic shared memory of one CTA, as csrc/fused_mul.cu:variant_shape
    sizes it.  With a cluster (csrc/ntt_phases.cuh:ntt_shape): the n values
    padded by one word in 32 (rounded to 16 bytes), then one limb's table of
    phase_entries pairs, which the inverse table replaces after the forward
    phases (226 560 bytes at n = 32768).  At a plan of one phase (n <= 32):
    four polynomials of n u32 and both tables."""
    n = 1 << log_n
    if len(kernel_phase_plan(log_n)) == 1:
        return 16 * n + 16 * phase_entries(log_n)
    return 4 * ((n + (n >> 5) + 3) & ~3) + 8 * phase_entries(log_n)


def _check(a: torch.Tensor, b: torch.Tensor, t: NTTTables):
    for x in (a, b):
        if not x.is_cuda:
            raise ValueError("[fused_mul_cuda] inputs must be CUDA tensors")
        if x.device != t.kernel_phases.device:
            raise ValueError(f"[fused_mul_cuda] input on {x.device}, tables on "
                             f"{t.kernel_phases.device}")
        if x.dtype != torch.int64:
            raise TypeError(f"[fused_mul_cuda] residues must be int64, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("[fused_mul_cuda] inputs must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("[fused_mul_cuda] inputs must be 16-byte aligned")
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


def _call(name: str, argtypes: list, a: torch.Tensor, b: torch.Tensor,
          t: NTTTables, table: torch.Tensor, *extra) -> torch.Tensor:
    fn = _cuda_build.function(name, argtypes)
    out = torch.empty((*a.shape[:-3], 3, t.size, t.n), dtype=torch.int64,
                      device=a.device)
    n_batch = a.numel() // (2 * t.size * t.n)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), table.data_ptr(),
                 t.kernel_scalars.data_ptr(), n_batch, t.size, t.log_n, *extra,
                 stream)
    if err != 0:
        raise RuntimeError(f"[fused_mul_cuda] {name} launch failed: CUDA error {err}")
    return out


def fused_negacyclic_multiply(a: torch.Tensor, b: torch.Tensor,
                              t: NTTTables) -> torch.Tensor:
    """Kernel tensor product: a, b (..., 2, L, n) int64 residues in [0, 2q),
    coefficient domain -> (..., 3, L, n) in [0, q), coefficient domain."""
    _check(a, b, t)
    out = _call("troy_fused_mul", _ARGTYPES, a, b, t, t.kernel_phases,
                t.plan_code, t.kernel_phases.shape[-1] // 2)
    LAUNCHES["fused_negacyclic_multiply"] += 1
    return out


def run_radix2(a: torch.Tensor, b: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the first, radix-2 kernel (the timing yardstick), not
    counted in LAUNCHES and never a route of fused_negacyclic_multiply."""
    _check(a, b, t)
    return _call("troy_fused_mul_radix2", _RADIX2_ARGTYPES, a, b, t, t.kernel_rows)


def kernel_info(which: int, log_n: int) -> dict:
    """Threads, dynamic shared bytes, registers and local (spill) bytes a
    thread, CTAs resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    and clusters the card holds at once (cudaOccupancyMaxActiveClusters; 0
    for the yardstick and at n <= 32) of one kernel at degree 2^log_n:
    which 0 the kernel, 1 the radix-2 yardstick."""
    fn = _cuda_build.function("troy_fused_mul_kernel_info", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * 6)()
    err = fn(which, log_n, phase_entries(log_n), info)
    if err != 0:
        raise RuntimeError(f"[fused_mul_cuda] kernel info failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "regs", "local_bytes", "ctas_per_sm",
                     "clusters"), info))


def reset_launches():
    LAUNCHES["fused_negacyclic_multiply"] = 0

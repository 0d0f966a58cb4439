"""Wrapper of the Hopper fused tensor-product kernel (csrc/fused_mul.cu).

Counterpart of troy_tpu/ops/fused_mul.py:fused_negacyclic_multiply (K4).
The plain PyTorch version is ops/fused_mul.py:fused_negacyclic_multiply_plain.
The kernel is compiled at first use with the port's other kernels
(ops/_cuda_build.py); a failed build or launch raises, and nothing falls back
to the plain version.

Two routes, chosen by the tables' split (ops/ntt.py:default_split).  For n
from 2 to 32768 (split 0): troy_fused_mul, a kernel instantiated per degree.  From n = 64 it is a thread-block cluster of four
CTAs per (batch, limb), one per operand polynomial, each running the NTT
kernel's register-radix phases (csrc/ntt_phases.cuh) on
NTTTables.kernel_phases; the products are formed across the cluster's shared
memory, by Montgomery reduction (see the source note).  At n <= 32, the
plans of one phase, one CTA holds the four operands.  A cluster the card
cannot schedule is refused at launch, and this wrapper raises.  The first
kernel (troy_fused_mul_radix2) stays in the library as a timing yardstick:
run_radix2 launches it for chip_smoke.py's comparison, and no route of this
wrapper takes it.

For n = 65536 and 131072 (a split, n = C n2), where one operand polynomial
does not fit a CTA: troy_fused_mul_large (csrc/fused_mul_large.cu), one
launch, a (batch, limb) a cluster of C CTAs, CTA r holding block r of all
four operands, so the products are local; the NTT's column stages cross
the cluster through distributed shared memory, as in the NTT's cluster
route.  It takes clusters of 16 (LARGE_SHAPES: the fastest at 65536, and
at 131072 the only size whose four operand blocks fit a CTA).  The route
it replaced stays as its timing yardstick, run_five_launch: the NTT's
two-launch yardstick forward of (a, b) as one (..., 4, L, n) call, the
tensor-product kernel troy_tensor_product (csrc/tensor_product.cu: a0 b0,
a0 b1 + a1 b0, a1 b1 mod q in the NTT domain; tensor_product launches it
alone), and the two-launch inverse.

LAUNCHES counts the launches of the one-CTA-an-operand kernel
(fused_negacyclic_multiply), of the large cluster kernel (fused_mul_large)
and of the tensor-product kernel (tensor_product), so it says which route
ran; the yardstick's NTT launches count in ntt_cuda.LAUNCHES.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt import NTTTables, kernel_phase_plan, phase_entries
from .ntt import BLOCK_MAX_LOG_N, MAX_LOG_N
from .ntt_cuda import MODULUS_BOUND, check_cluster

LAUNCHES = {"fused_negacyclic_multiply": 0, "fused_mul_large": 0, "tensor_product": 0}
LARGE_SHAPES = ((16, 4), (17, 4))  # (log2 n, split) of the large kernel: clusters of 16

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_LARGE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
_PRODUCT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
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


def large_shared_bytes(log_b: int) -> int:
    """Dynamic shared memory of one CTA of the large kernel, as
    csrc/fused_mul_large.cu:large_shape sizes it: four operand blocks of
    2^log_b values padded (ntt_shape's layout), then both block tables."""
    n = 1 << log_b
    return 16 * ((n + (n >> 5) + 3) & ~3) + 16 * phase_entries(log_b)


def _check(a: torch.Tensor, b: torch.Tensor, t: NTTTables, polys: int = 2,
           large: bool = True):
    """a and b: contiguous, 16-byte aligned int64 CUDA tensors on the tables'
    device, of one shape ending in (polys, L, n), at a degree and moduli the
    kernels take; with a split, a shape of the large kernel, unless `large`
    is off (the yardstick route)."""
    if getattr(t, "words", 1) != 1:
        raise ValueError("[fused_mul_cuda] wide (40-60-bit) moduli: the wide path has no "
                         "fused kernel (ops/rp.py)")
    if large and t.split:
        check_cluster(t, "fused_mul_cuda")
        if (t.log_n, t.split) not in LARGE_SHAPES:
            raise ValueError(f"[fused_mul_cuda] the large kernel takes (log2 n, split) in "
                             f"{LARGE_SHAPES}, not ({t.log_n}, {t.split})")
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
    if a.dim() < 3 or tuple(a.shape[-3:]) != (polys, t.size, t.n):
        raise ValueError(f"[fused_mul_cuda] shape {tuple(a.shape)} does not end "
                         f"in ({polys}, L, n) = ({polys}, {t.size}, {t.n})")
    n = t.n
    if n & (n - 1) or n < 2 or n > (1 << MAX_LOG_N):
        raise ValueError(f"[fused_mul_cuda] n = {n} must be a power of two in "
                         f"[2, {1 << MAX_LOG_N}]")
    if t.block_log_n > BLOCK_MAX_LOG_N:
        raise ValueError(f"[fused_mul_cuda] n = {n} needs tables with a larger split")
    if t.max_modulus >= MODULUS_BOUND:
        raise ValueError(f"[fused_mul_cuda] modulus {t.max_modulus} >= 2^30")


def _call(name: str, argtypes: list, a: torch.Tensor, b: torch.Tensor,
          t: NTTTables, *args) -> torch.Tensor:
    """fn(a, b, out, *args, stream) into a new (..., 3, L, n) output."""
    fn = _cuda_build.function(name, argtypes)
    out = torch.empty((*a.shape[:-3], 3, t.size, t.n), dtype=torch.int64,
                      device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"[fused_mul_cuda] {name} launch failed: CUDA error {err}")
    return out


def _batches(a: torch.Tensor, t: NTTTables) -> int:
    return a.numel() // (2 * t.size * t.n)


def fused_negacyclic_multiply(a: torch.Tensor, b: torch.Tensor,
                              t: NTTTables) -> torch.Tensor:
    """Kernel tensor product: a, b (..., 2, L, n) int64 residues in [0, 2q),
    coefficient domain -> (..., 3, L, n) in [0, q), coefficient domain."""
    _check(a, b, t)
    if t.split:
        out = _call("troy_fused_mul_large", _LARGE_ARGTYPES, a, b, t,
                    t.kernel_phases.data_ptr(), t.column_phases.data_ptr(),
                    t.kernel_scalars.data_ptr(), _batches(a, t), t.size, t.block_log_n,
                    t.split, t.plan_code, t.entries)
        LAUNCHES["fused_mul_large"] += 1
        return out
    out = _call("troy_fused_mul", _ARGTYPES, a, b, t, t.kernel_phases.data_ptr(),
                t.kernel_scalars.data_ptr(), _batches(a, t), t.size, t.log_n,
                t.plan_code, t.kernel_phases.shape[-1] // 2)
    LAUNCHES["fused_negacyclic_multiply"] += 1
    return out


def run_five_launch(a: torch.Tensor, b: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """The large kernel's yardstick, the route it replaced: the NTT's
    two-launch forward of (a, b) as one (..., 4, L, n) call, the
    tensor-product kernel, the two-launch inverse (each launch counted under
    its own name; never a route of fused_negacyclic_multiply)."""
    from . import ntt_cuda

    _check(a, b, t, large=False)
    y = ntt_cuda.two_launch(False, torch.cat([a, b], dim=-3), t)
    return ntt_cuda.two_launch(True, tensor_product(y, t), t)


def tensor_product(y: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the tensor-product kernel: y (..., 4, L, n) = NTT-domain
    (a0, a1, b0, b1) in [0, q) -> (..., 3, L, n) = (a0 b0, a0 b1 + a1 b0,
    a1 b1) mod q.  Its plain version is ops/dyadic.py:dyadic_convolute."""
    _check(y, y, t, polys=4, large=False)
    fn = _cuda_build.function("troy_tensor_product", _PRODUCT_ARGTYPES)
    out = torch.empty((*y.shape[:-3], 3, t.size, t.n), dtype=torch.int64, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), out.data_ptr(), t.kernel_scalars.data_ptr(),
                 t.barrett_ratio.data_ptr(), y.numel() // (4 * t.size * t.n), t.size,
                 t.log_n, stream)
    if err != 0:
        raise RuntimeError(f"[fused_mul_cuda] troy_tensor_product launch failed: "
                           f"CUDA error {err}")
    LAUNCHES["tensor_product"] += 1
    return out


def run_radix2(a: torch.Tensor, b: torch.Tensor, t: NTTTables) -> torch.Tensor:
    """One launch of the first, radix-2 kernel (the timing yardstick), not
    counted in LAUNCHES and never a route of fused_negacyclic_multiply."""
    _check(a, b, t)
    return _call("troy_fused_mul_radix2", _RADIX2_ARGTYPES, a, b, t, t.kernel_rows.data_ptr(),
                 t.kernel_scalars.data_ptr(), _batches(a, t), t.size, t.log_n)


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


def large_info(log_n: int, split: int) -> dict:
    """kernel_info's fields of the large kernel at degree 2^log_n in
    clusters of 2^split CTAs."""
    fn = _cuda_build.function("troy_fused_mul_large_info", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * 6)()
    err = fn(log_n - split, split, phase_entries(log_n - split), info)
    if err != 0:
        raise RuntimeError(f"[fused_mul_cuda] large kernel info failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "regs", "local_bytes", "ctas_per_sm",
                     "clusters"), info))

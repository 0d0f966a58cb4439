"""Wrapper of the Hopper matrix-product NTT kernels (csrc/ntt_mxu_wg.cu and
csrc/ntt_mxu.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py's K2 (_fwd_kernel_mxu /
_inv_kernel_mxu): the negacyclic NTT as two modular matrix products on 8-bit
tensor cores.  The plain PyTorch version is ops/ntt_mxu.py:ntt_forward_mxu /
ntt_inverse_mxu; ops/ntt.py:ntt_forward / ntt_inverse route here for CUDA
tensors when the tables carry the route (set_ntt_backend("mxu") or
("pallas_mxu")).

The route (ntt_forward / ntt_inverse), by degree:
  * n <= 2^WG_MAX_LOG_N (16384): the redesigned kernel troy_ntt_*_mxu_wg,
    one launch a transform, wgmma on unsigned byte planes, a persistent
    CTA a limb and a run of its polynomials (MxuNTTTables.wg_*);
  * n = 32768: the first form's one-CTA kernel (troy_ntt_*_mxu, a CTA a
    polynomial, mma.sync on balanced planes);
  * n = 65536, 131072: the first form's two launches of its stage kernel
    through a scratch tensor.
The first form's one-CTA kernel is also the yardstick of the redesigned one
at every degree it serves (mma_forward / mma_inverse, launched only by
chip_smoke.py's A/B there).  The kernels are compiled at first use with the
port's other kernels (ops/_cuda_build.py).  A failed build or launch raises:
nothing falls back.

LAUNCHES counts each kernel's launches: ntt_forward_mxu / ntt_inverse_mxu
the redesigned kernel, *_mma the first form's one-CTA kernel, *_stages its
stage kernel (two a transform).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt_mxu import MAX_LOG_N, MIN_LOG_N, MODULUS_BOUND, WG_MAX_LOG_N, MxuNTTTables

LAUNCHES = {"ntt_forward_mxu": 0, "ntt_inverse_mxu": 0,
            "ntt_forward_mxu_mma": 0, "ntt_inverse_mxu_mma": 0,
            "ntt_forward_mxu_stages": 0, "ntt_inverse_mxu_stages": 0}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
_WG_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
WG_INFO = ("threads", "smem", "regs", "local_bytes", "ctas_per_sm", "resident", "t1", "t2",
           "b1", "b2", "staging")


def plan_words(t: MxuNTTTables) -> list[int]:
    """The first form's six plan ints: kc_left, kc_right, block_left,
    block_right, smem_left, smem_right."""
    left, right = t.plan["left"], t.plan["right"]
    return [left["kc"], right["kc"], left["block"], right["block"], left["smem"],
            right["smem"]]


def _check(x: torch.Tensor, t: MxuNTTTables):
    if not isinstance(t, MxuNTTTables):
        raise TypeError("[ntt_mxu_cuda] tables must be MxuNTTTables (NTTTables.mxu)")
    if not x.is_cuda:
        raise ValueError("[ntt_mxu_cuda] input must be a CUDA tensor")
    if x.device != t.kernel_scalars.device:
        raise ValueError(f"[ntt_mxu_cuda] input on {x.device}, tables on "
                         f"{t.kernel_scalars.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"[ntt_mxu_cuda] residues must be int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("[ntt_mxu_cuda] input must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("[ntt_mxu_cuda] input must be 16-byte aligned")
    if x.dim() < 2 or x.shape[-2] != t.size or x.shape[-1] != t.n:
        raise ValueError(f"[ntt_mxu_cuda] shape {tuple(x.shape)} does not end in "
                         f"(L, n) = ({t.size}, {t.n})")
    if not MIN_LOG_N <= t.log_n <= MAX_LOG_N:
        raise ValueError(f"[ntt_mxu_cuda] n = {t.n} outside [{1 << MIN_LOG_N}, "
                         f"{1 << MAX_LOG_N}]")
    if t.max_modulus >= MODULUS_BOUND:
        raise ValueError(f"[ntt_mxu_cuda] modulus {t.max_modulus} >= 2^30")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _call_wg(name: str, x: torch.Tensor, out: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor,
             twiddle: torch.Tensor, t: MxuNTTTables) -> int:
    """The redesigned kernel's C call troy_<name> on the current stream;
    returns its CUDA error."""
    fn = _cuda_build.function(f"troy_{name}", _WG_ARGTYPES)
    with torch.cuda.device(x.device):
        return fn(x.data_ptr(), out.data_ptr(), t1.data_ptr(), t2.data_ptr(), twiddle.data_ptr(),
                  t.wg_scalars.data_ptr(), x.numel() // t.n, t.size, t.a, t.b, _stream(x))


def _call(name: str, x: torch.Tensor, out: torch.Tensor, mid: torch.Tensor,
          w_left: torch.Tensor, w_right: torch.Tensor, t: MxuNTTTables) -> int:
    """The first form's C call troy_<name> on the current stream; returns
    its CUDA error."""
    fn = _cuda_build.function(f"troy_{name}", _ARGTYPES)
    plan = (ctypes.c_int * 6)(*plan_words(t))
    with torch.cuda.device(x.device):
        return fn(x.data_ptr(), out.data_ptr(), mid.data_ptr(), w_left.data_ptr(),
                  w_right.data_ptr(), t.kernel_twiddle.data_ptr(), t.kernel_scalars.data_ptr(),
                  x.numel() // t.n, t.size, t.a, t.b, t.plan["launches"], plan, _stream(x))


def _launch_wg(inverse: bool, x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """The redesigned kernel, one launch a transform (n <= 2^WG_MAX_LOG_N)."""
    _check(x, t)
    if t.wg_w is None:
        raise ValueError(f"[ntt_mxu_cuda] n = {t.n}: the redesigned kernel serves n <= "
                         f"{1 << WG_MAX_LOG_N}")
    name = "ntt_inverse_mxu" if inverse else "ntt_forward_mxu"
    out = torch.empty_like(x)
    t1, t2 = t.wg_w[2:] if inverse else t.wg_w[:2]
    err = _call_wg(f"{name}_wg", x, out, t1, t2, t.wg_twiddle[int(inverse)], t)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] troy_{name}_wg launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _launch_mma(inverse: bool, x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """The first form: one launch to n = 32768, two of the stage kernel above."""
    _check(x, t)
    name = "ntt_inverse_mxu" if inverse else "ntt_forward_mxu"
    launches = t.plan["launches"]
    out = torch.empty_like(x)
    mid = torch.empty_like(x) if launches == 2 else out
    w_left, w_right = t.kernel_w[2:] if inverse else t.kernel_w[:2]
    err = _call(name, x, out, mid, w_left, w_right, t)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] troy_{name} launch failed: CUDA error {err}")
    if launches == 1:
        LAUNCHES[name + "_mma"] += 1
    else:
        LAUNCHES[name + "_stages"] += 2
    return out


def _wg_route(t) -> bool:
    """The degrees the redesigned kernel serves."""
    return getattr(t, "log_n", MAX_LOG_N) <= WG_MAX_LOG_N


def ntt_forward(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Kernel forward NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch_wg(False, x, t) if _wg_route(t) else _launch_mma(False, x, t)


def ntt_inverse(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Kernel inverse NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch_wg(True, x, t) if _wg_route(t) else _launch_mma(True, x, t)


def mma_forward(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """The first form's forward kernel at any degree (the yardstick)."""
    return _launch_mma(False, x, t)


def mma_inverse(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """The first form's inverse kernel at any degree (the yardstick)."""
    return _launch_mma(True, x, t)


def kernel_info(which: int, smem: int) -> dict:
    """Threads, dynamic shared bytes, registers and local (spill) bytes a
    thread, and CTAs resident per SM of the first form's one-CTA kernel
    (which 0 forward, 1 inverse) or its stage kernel (2) at `smem` bytes."""
    fn = _cuda_build.function("troy_ntt_mxu_info", [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * 5)()
    err = fn(which, smem, info)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] kernel info failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "regs", "local_bytes", "ctas_per_sm"), info))


def wg_info(inverse: bool, log_n: int) -> dict:
    """The redesigned kernel at degree 2^log_n: threads, dynamic shared
    bytes, registers and local (spill) bytes a thread, CTAs per SM, whether
    the tables stay resident, and its plan's t1, t2, b1, b2, staging bytes
    (ops/ntt_mxu.py:wg_plan)."""
    fn = _cuda_build.function("troy_ntt_mxu_wg_info", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * len(WG_INFO))()
    a = log_n // 2
    err = fn(int(inverse), a, log_n - a, info)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] wg kernel info failed: CUDA error {err}")
    return dict(zip(WG_INFO, info))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

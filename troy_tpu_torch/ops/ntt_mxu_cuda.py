"""Wrapper of the Hopper matrix-product NTT kernel (csrc/ntt_mxu.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py's K2 (_fwd_kernel_mxu /
_inv_kernel_mxu): the negacyclic NTT as two modular matrix products on int8
tensor cores.  The plain PyTorch version is ops/ntt_mxu.py:ntt_forward_mxu /
ntt_inverse_mxu; ops/ntt.py:ntt_forward / ntt_inverse route here for CUDA
tensors when the tables carry the route (set_ntt_backend("mxu") or
("pallas_mxu")).

Two launch shapes, by ops/ntt_mxu.py:kernel_plan: up to n = 32768 one
launch a transform (troy_ntt_mxu_kernel, a CTA a polynomial); at 65536 and
131072 two launches of the stage kernel, a stage each, through a scratch
tensor.  The kernel is compiled at first use with the port's other kernels
(ops/_cuda_build.py).  A failed build or launch raises: nothing falls back.

LAUNCHES counts each kernel's launches: ntt_forward_mxu / ntt_inverse_mxu
the one-CTA kernel, *_stages the stage kernel (two a transform).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .ntt_mxu import MAX_LOG_N, MIN_LOG_N, MODULUS_BOUND, MxuNTTTables

LAUNCHES = {"ntt_forward_mxu": 0, "ntt_inverse_mxu": 0,
            "ntt_forward_mxu_stages": 0, "ntt_inverse_mxu_stages": 0}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def plan_words(t: MxuNTTTables) -> list[int]:
    """The kernel's six plan ints: kc_left, kc_right, block_left,
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


def _call(name: str, x: torch.Tensor, out: torch.Tensor, mid: torch.Tensor,
          w_left: torch.Tensor, w_right: torch.Tensor, t: MxuNTTTables) -> int:
    """The C call troy_<name> on the current stream; returns its CUDA error."""
    fn = _cuda_build.function(f"troy_{name}", _ARGTYPES)
    plan = (ctypes.c_int * 6)(*plan_words(t))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return fn(x.data_ptr(), out.data_ptr(), mid.data_ptr(), w_left.data_ptr(),
                  w_right.data_ptr(), t.kernel_twiddle.data_ptr(), t.kernel_scalars.data_ptr(),
                  x.numel() // t.n, t.size, t.a, t.b, t.plan["launches"], plan, stream)


def _launch(inverse: bool, x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
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
        LAUNCHES[name] += 1
    else:
        LAUNCHES[name + "_stages"] += 2
    return out


def ntt_forward(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Kernel forward NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch(False, x, t)


def ntt_inverse(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Kernel inverse NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch(True, x, t)


def kernel_info(which: int, smem: int) -> dict:
    """Threads, dynamic shared bytes, registers and local (spill) bytes a
    thread, and CTAs resident per SM of the one-CTA kernel (which 0 forward,
    1 inverse) or the stage kernel (2) at `smem` shared bytes."""
    fn = _cuda_build.function("troy_ntt_mxu_info", [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * 5)()
    err = fn(which, smem, info)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] kernel info failed: CUDA error {err}")
    return dict(zip(("threads", "smem", "regs", "local_bytes", "ctas_per_sm"), info))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

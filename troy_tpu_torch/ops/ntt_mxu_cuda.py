"""Wrapper of the Hopper matrix-product NTT kernels (csrc/ntt_mxu_wg.cu,
csrc/ntt_mxu_cluster.cu and csrc/ntt_mxu.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py's K2 (_fwd_kernel_mxu /
_inv_kernel_mxu): the negacyclic NTT as two modular matrix products on 8-bit
tensor cores.  The plain PyTorch version is ops/ntt_mxu.py:ntt_forward_mxu /
ntt_inverse_mxu; ops/ntt.py:ntt_forward / ntt_inverse route here for CUDA
tensors when the tables carry the route (set_ntt_backend("mxu") or
("pallas_mxu")).

The route (ntt_forward / ntt_inverse), one launch a transform at every
degree:
  * n <= 2^WG_MAX_LOG_N (16384): troy_ntt_*_mxu_wg, wgmma on unsigned byte
    planes, a persistent CTA a limb and a run of its polynomials
    (MxuNTTTables.wg_*);
  * n = 32768, 65536, 131072: troy_ntt_*_mxu_cluster, the same planes and
    tables (cl_w, wg_twiddle, wg_scalars), a polynomial a thread-block
    cluster (ops/ntt_mxu.py:cl_plan), persistent clusters over the rows.
    The cluster size is route_log_c's: the largest the kernel takes at the
    degree where the card holds a cluster for every row at once, else the
    smallest (at 65536: 16 CTAs for up to 7 rows on an H100, else 8).
    Where the card holds no such cluster the launch is refused and this
    raises.
The first form (troy_ntt_*_mxu: a CTA a polynomial, mma.sync on balanced
planes, to 32768; above, two launches of its stage kernel through a scratch
tensor) is the yardstick of both at every degree (mma_forward /
mma_inverse, launched only by chip_smoke.py's A/B); no route takes it.
The kernels are compiled at first use with the port's other kernels
(ops/_cuda_build.py).  A failed build or launch raises: nothing falls back.

LAUNCHES counts each kernel's launches: ntt_forward_mxu / ntt_inverse_mxu
the kernel to 16384, *_mxu_cluster the cluster kernel, *_mma the first
form's one-CTA kernel, *_stages its stage kernel (two a transform).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _cuda_build, ntt_mxu as MX
from .ntt_mxu import MAX_LOG_N, MIN_LOG_N, MODULUS_BOUND, WG_MAX_LOG_N, MxuNTTTables

LAUNCHES = {"ntt_forward_mxu": 0, "ntt_inverse_mxu": 0,
            "ntt_forward_mxu_cluster": 0, "ntt_inverse_mxu_cluster": 0,
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
_CL_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
CL_INFO = ("threads", "smem", "regs", "local_bytes", "clusters", "cluster", "R1", "R2", "slots",
           "kc", "v1", "v2", "out")


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


def _call_cluster(name: str, x: torch.Tensor, out: torch.Tensor, t1: torch.Tensor,
                  t2: torch.Tensor, twiddle: torch.Tensor, t: MxuNTTTables, log_c: int) -> int:
    """The cluster kernel's C call troy_<name> on the current stream, a
    polynomial a cluster of 2^log_c CTAs; returns its CUDA error."""
    fn = _cuda_build.function(f"troy_{name}", _CL_ARGTYPES)
    with torch.cuda.device(x.device):
        return fn(x.data_ptr(), out.data_ptr(), t1.data_ptr(), t2.data_ptr(), twiddle.data_ptr(),
                  t.wg_scalars.data_ptr(), x.numel() // t.n, t.size, t.a, t.b, log_c, _stream(x))


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
    if t.log_n > WG_MAX_LOG_N:
        raise ValueError(f"[ntt_mxu_cuda] n = {t.n}: the kernel ntt_mxu_wg serves n <= "
                         f"{1 << WG_MAX_LOG_N}")
    name = "ntt_inverse_mxu" if inverse else "ntt_forward_mxu"
    out = torch.empty_like(x)
    t1, t2 = t.wg_w[2:] if inverse else t.wg_w[:2]
    err = _call_wg(f"{name}_wg", x, out, t1, t2, t.wg_twiddle[int(inverse)], t)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] troy_{name}_wg launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def cluster_plan(t: MxuNTTTables, inverse: bool, log_c: int | None = None) -> dict:
    """The cluster kernel's cut of t's degree in clusters of 2^log_c CTAs
    (ops/ntt_mxu.py:cl_plan); raises where the kernel takes none."""
    log_n = getattr(t, "log_n", None)
    if log_n is None or not WG_MAX_LOG_N < log_n <= MAX_LOG_N:
        raise ValueError(f"[ntt_mxu_cuda] the cluster kernel serves 2^{WG_MAX_LOG_N + 1} <= n "
                         f"<= 2^{MAX_LOG_N}, not n = 2^{log_n}")
    plan = MX.cl_plan(log_n, inverse, log_c)
    if not plan["ok"]:
        raise ValueError(f"[ntt_mxu_cuda] n = {t.n}: no cut in clusters of {plan['C']} CTAs "
                         f"(R1 = {plan['R1']}, R2 = {plan['R2']}, {plan['slots']} slots a "
                         f"warpgroup)")
    return plan


_ACTIVE: dict = {}  # (device, inverse, log_n, log_c) -> clusters the card holds at once


def route_log_c(x: torch.Tensor, t: MxuNTTTables, inverse: bool) -> int:
    """The route's cluster size (log2 C) for x's rows: the largest of
    CL_SWEEP[log_n] whose clusters the card holds for every row at once
    (one row a cluster, no second round), else the smallest (more rows a
    round, each cluster reading the tables once a row)."""
    sizes = MX.CL_SWEEP[t.log_n]
    rows = x.numel() // t.n
    key = (x.device, inverse, t.log_n, sizes[-1])
    if len(sizes) > 1 and key not in _ACTIVE:
        with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():
            _ACTIVE[key] = cluster_info(inverse, t.log_n, sizes[-1])["clusters"]
    return sizes[-1] if len(sizes) == 1 or rows <= _ACTIVE[key] else sizes[0]


def _launch_cluster(inverse: bool, x: torch.Tensor, t: MxuNTTTables,
                    log_c: int | None = None) -> torch.Tensor:
    """The cluster kernel, one launch a transform (n > 2^WG_MAX_LOG_N), in
    clusters of 2^log_c CTAs (default route_log_c's)."""
    _check(x, t)
    if log_c is None:
        cluster_plan(t, inverse)  # the degree's refusal, before the card is asked
        log_c = route_log_c(x, t, inverse)
    plan = cluster_plan(t, inverse, log_c)
    name = "ntt_inverse_mxu" if inverse else "ntt_forward_mxu"
    out = torch.empty_like(x)
    t1, t2 = t.cl_w[2:] if inverse else t.cl_w[:2]
    err = _call_cluster(f"{name}_cluster", x, out, t1, t2, t.wg_twiddle[int(inverse)], t,
                        plan["C"].bit_length() - 1)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] troy_{name}_cluster launch failed (clusters of "
                           f"{plan['C']} CTAs): CUDA error {err}")
    LAUNCHES[name + "_cluster"] += 1
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
    """The degrees the kernel to 16384 serves; the cluster kernel the rest."""
    return getattr(t, "log_n", MAX_LOG_N) <= WG_MAX_LOG_N


def ntt_forward(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Kernel forward NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch_wg(False, x, t) if _wg_route(t) else _launch_cluster(False, x, t)


def ntt_inverse(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Kernel inverse NTT of (..., L, n) int64 residues in [0, 2q)."""
    return _launch_wg(True, x, t) if _wg_route(t) else _launch_cluster(True, x, t)


def cluster_forward(x: torch.Tensor, t: MxuNTTTables, log_c: int) -> torch.Tensor:
    """The cluster kernel's forward in clusters of 2^log_c CTAs (the sweep
    of chip_smoke.py; the route takes route_log_c's)."""
    return _launch_cluster(False, x, t, log_c)


def cluster_inverse(x: torch.Tensor, t: MxuNTTTables, log_c: int) -> torch.Tensor:
    """The cluster kernel's inverse in clusters of 2^log_c CTAs."""
    return _launch_cluster(True, x, t, log_c)


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


def cluster_info(inverse: bool, log_n: int, log_c: int | None = None) -> dict:
    """The cluster kernel at degree 2^log_n in clusters of 2^log_c CTAs
    (default the smallest of CL_SWEEP): threads, dynamic shared bytes, registers and local
    (spill) bytes a thread, the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters), the cluster size, each stage's data
    rows a CTA (R1, R2), a warpgroup's slots, a chunk's K bytes and the
    bytes of the two operand plane sets and of the outgoing tiles
    (ops/ntt_mxu.py:cl_plan)."""
    log_c = MX.CL_SWEEP[log_n][0] if log_c is None else log_c
    fn = _cuda_build.function("troy_ntt_mxu_cluster_info", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * len(CL_INFO))()
    a = log_n // 2
    err = fn(int(inverse), a, log_n - a, log_c, info)
    if err != 0:
        raise RuntimeError(f"[ntt_mxu_cuda] cluster kernel info failed: CUDA error {err}")
    return dict(zip(CL_INFO, info))

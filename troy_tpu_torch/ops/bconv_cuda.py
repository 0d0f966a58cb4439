"""Wrapper of the Hopper base-conversion kernel (csrc/bconv.cu).

Counterpart of troy_tpu/ops/ntt_pallas.py:bconv_pallas (K3).  The plain
PyTorch version is ops/bconv.py:base_convert_plain.  The kernel is compiled
at first use with the port's other kernels (ops/_cuda_build.py); a failed
build or launch raises, and nothing falls back to the plain version or to
the yardstick.

The kernel reads (..., L_in, n) input with the limbs n apart and the rows
(the leading axes, flattened) at any one stride of at least L_in n, so a
slice such as y[..., :-1, :] goes in where it lies.  addressable() copies
only input it cannot read so, and counts each copy.

LAUNCHES counts the kernel's launches ("base_convert"), the first kernel's
(csrc/bconv_first.cu, "base_convert_first": a timing yardstick, launched only by
chip_smoke.py through run_first) and addressable()'s copies
("base_convert_copy", not a kernel).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda_build
from .bconv import BConvTables

LAUNCHES = {"base_convert": 0, "base_convert_first": 0, "base_convert_copy": 0}

MAX_LIMBS = 64           # csrc/bconv.cu kMaxLimbs: the shared-memory tables
MODULUS_BOUND = 1 << 30  # input moduli: the port's fast width (the first kernel's cadence)
OUTPUT_BOUND = 1 << 32   # output moduli: a u32 table word (ring2k's t = 2^31)
_ARGTYPES = {  # each C entry's arguments: x, y, tables, rows, ..., stream
    "troy_bconv": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "troy_bconv_first": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def row_stride(x: torch.Tensor, l_in: int) -> int | None:
    """Elements between two rows where the kernel can read x as (rows, L_in,
    n): coefficients at stride 1, limbs n apart, the leading axes one stride
    of at least L_in n once flattened; None where it cannot."""
    n = x.shape[-1]
    if (n > 1 and x.stride(-1) != 1) or (l_in > 1 and x.stride(-2) != n):
        return None
    lead = [(size, stride) for size, stride in zip(x.shape[:-2], x.stride()[:-2]) if size != 1]
    if not lead:
        return l_in * n
    step = lead[-1][1]
    expect = step
    for size, stride in reversed(lead):
        if stride != expect:
            return None
        expect = stride * size
    return step if step >= l_in * n else None


def addressable(x: torch.Tensor, l_in: int) -> torch.Tensor:
    """x where the kernel can read it as it lies, else a contiguous copy
    (counted in LAUNCHES["base_convert_copy"])."""
    if x.dim() >= 2 and row_stride(x, l_in) is not None:
        return x
    LAUNCHES["base_convert_copy"] += 1
    return x.contiguous()


def _check_device(x: torch.Tensor, tabs: BConvTables):
    if not x.is_cuda:
        raise ValueError("[bconv_cuda] input must be a CUDA tensor")
    if x.device != tabs.kernel_tables.device:
        raise ValueError(f"[bconv_cuda] input on {x.device}, tables on "
                         f"{tabs.kernel_tables.device}")


def _check(x: torch.Tensor, tabs: BConvTables) -> int:
    """Raises on input the kernel cannot take; returns its row stride."""
    _check_device(x, tabs)
    if x.dtype != torch.int64:
        raise TypeError(f"[bconv_cuda] residues must be int64, got {x.dtype}")
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
    step = row_stride(x, tabs.L_in)
    if step is None:
        raise ValueError(f"[bconv_cuda] strides {x.stride()} of shape {tuple(x.shape)}: the "
                         "kernel reads coefficients at stride 1, limbs n apart and rows at "
                         "one stride of at least L_in n (bconv_cuda.addressable copies)")
    return step


def _call(name: str, x: torch.Tensor, out: torch.Tensor, tabs: BConvTables, *args) -> int:
    """C entry `name` on x, out and tabs' table words for that kernel, then
    args, on x's device and its current stream; its CUDA error."""
    table = tabs.kernel_tables if name == "troy_bconv" else first_tables(tabs)
    fn = _cuda_build.function(name, _ARGTYPES[name])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return fn(x.data_ptr(), out.data_ptr(), table.data_ptr(), *args, stream)


def base_convert(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """Kernel base conversion of (..., L_in, n) int64 residues in [0, q_i)
    -> (..., L_out, n) in [0, p_o), contiguous; x as addressable() leaves
    it."""
    step = _check(x, tabs)
    n = x.shape[-1]
    out = torch.empty((*x.shape[:-2], tabs.L_out, n), dtype=torch.int64, device=x.device)
    err = _call("troy_bconv", x, out, tabs, x.numel() // (tabs.L_in * n), step, tabs.L_in,
                tabs.L_out, n)
    if err != 0:
        raise RuntimeError(f"[bconv_cuda] launch failed: CUDA error {err}")
    LAUNCHES["base_convert"] += 1
    return out


def first_tables(tabs: BConvTables) -> torch.Tensor:
    """The first kernel's table words [q_in, ip, Shoup companions, p_out, mat
    row-major] (u32 stored as int32), kept on tabs."""
    if getattr(tabs, "_first_tables", None) is None:
        q, ip = tabs.q_in.tolist(), tabs.ip.tolist()
        words = (q + ip + [(w << 32) // m for w, m in zip(ip, q)] + tabs.p_out.tolist()
                 + tabs.mat.flatten().tolist())
        tabs._first_tables = torch.from_numpy(np.array(words, dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(tabs.device)
    return tabs._first_tables


def run_first(x: torch.Tensor, tabs: BConvTables) -> torch.Tensor:
    """The first kernel (csrc/bconv_first.cu) on contiguous x: the timing
    yardstick of base_convert, on no path."""
    _check(x, tabs)
    if not x.is_contiguous():
        raise ValueError("[bconv_cuda] the first kernel takes contiguous input")
    n = x.shape[-1]
    out = torch.empty((*x.shape[:-2], tabs.L_out, n), dtype=torch.int64, device=x.device)
    err = _call("troy_bconv_first", x, out, tabs, x.numel() // (tabs.L_in * n), tabs.L_in,
                tabs.L_out, n)
    if err != 0:
        raise RuntimeError(f"[bconv_cuda] first kernel launch failed: CUDA error {err}")
    LAUNCHES["base_convert_first"] += 1
    return out


def kernel_info(l_in: int) -> dict:
    """The launch shape of the kernel's form for L_in input limbs: threads
    (columns) a CTA, registers, spill bytes, the most dynamic shared bytes a
    CTA, CTAs an SM at that, and SMs."""
    out = (ctypes.c_int * 6)()
    err = _cuda_build.function("troy_bconv_info", [ctypes.c_int, ctypes.c_void_p])(
        l_in, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"[bconv_cuda] troy_bconv_info failed: CUDA error {err}")
    keys = ("threads", "regs", "local_bytes", "smem", "ctas_per_sm", "sms")
    return dict(zip(keys, out))

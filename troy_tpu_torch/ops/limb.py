"""Multiword integer arithmetic on device: little-endian 16-bit limbs, limb
axis at -2 (shape (..., W, n)).

Counterpart of troy_tpu/ops/limb.py, the stand-in for the reference's
u64/u128 template instantiations of the ring2k encoder (ref:
src/app/bfv_ring2k.cu): a k-bit ring element (31 < k <= 128) is W =
ceil(k/16) limbs.  The limbs are int64 tensors with values in [0, 2^16), so
each helper's output compares with the JAX package's u32 limbs directly; a
product of two limbs is below 2^32 and a column sum below 2^48, both exact
in int64, so the JAX package's (hi, lo) column pairs are one int64 here.

Conventions:
- x is an int64 tensor (..., W, n), each limb in [0, 2^16).
- constants are Python ints, converted with const_limbs().
- "low k" results keep ceil(k/16) limbs with the top limb masked to k%16
  bits, i.e. the value mod 2^k.
- messages with k > 64 travel as Python ints or object arrays at the API
  (from_ints / to_ints), never as uint64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u32 as U

LIMB_BITS = 16
MASK = 0xFFFF


def width(k: int) -> int:
    """Number of 16-bit limbs covering k bits."""
    return -(-k // LIMB_BITS)


def const_limbs(v: int, w: int) -> list[int]:
    """Host: split a nonnegative int into w 16-bit limbs (little-endian)."""
    if v < 0 or v >> (LIMB_BITS * w):
        raise ValueError(f"[limb.const_limbs] {v} does not fit {w} limbs")
    return [(v >> (LIMB_BITS * i)) & MASK for i in range(w)]


def from_ints(values, k: int) -> np.ndarray:
    """Host: a sequence of ints (already reduced mod 2^k) -> (W, n) int64
    limbs."""
    w = width(k)
    if k <= 64:
        arr = np.asarray(values, dtype=np.uint64)
        return np.stack([((arr >> np.uint64(LIMB_BITS * i)) & np.uint64(MASK))
                         .astype(np.int64) for i in range(w)])
    arr = np.asarray([int(v) for v in values], dtype=object)
    return np.stack([((arr >> (LIMB_BITS * i)) & MASK).astype(np.int64) for i in range(w)])


def to_ints(arr, k: int):
    """Host: (..., W, n) limbs -> a uint64 array (k <= 64) or an object
    array of Python ints."""
    arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if k <= 64:
        acc = np.zeros(arr.shape[:-2] + arr.shape[-1:], dtype=np.uint64)
        for i in range(arr.shape[-2]):
            acc |= arr[..., i, :].astype(np.uint64) << np.uint64(LIMB_BITS * i)
        return acc
    acc = np.zeros(arr.shape[:-2] + arr.shape[-1:], dtype=object)
    for i in range(arr.shape[-2]):
        acc += arr[..., i, :].astype(object) << (LIMB_BITS * i)
    return acc


def u32_split(x: torch.Tensor) -> torch.Tensor:
    """(..., n) values below 2^32 -> (..., 2, n) 16-bit limbs."""
    return torch.stack([x & MASK, x >> LIMB_BITS], dim=-2)


def _carry(cols, out_limbs: int) -> torch.Tensor:
    """cols: int64 column sums (below 2^48) -> (..., out_limbs, n) limbs by
    one ripple; columns past the list carry only."""
    out = []
    carry = 0
    for j in range(out_limbs):
        c = cols[j] + carry if j < len(cols) else carry
        out.append(c & MASK)
        carry = c >> LIMB_BITS
    return torch.stack(out, dim=-2)


def mul_const_full(x: torch.Tensor, c: list[int]) -> torch.Tensor:
    """Full product of (..., W, n) limbs by a constant given as limbs:
    (..., W + len(c), n)."""
    w, wc = x.shape[-2], len(c)
    zero = torch.zeros_like(x[..., 0, :])
    cols = []
    for j in range(w + wc - 1):
        col = zero
        for a in range(max(0, j - wc + 1), min(w, j + 1)):
            if c[j - a]:
                col = col + x[..., a, :] * c[j - a]
        cols.append(col)
    return _carry(cols, w + wc)


def low(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the value mod 2^k: ceil(k/16) limbs, top limb masked."""
    w = width(k)
    x = x[..., :w, :]
    r = k % LIMB_BITS
    if r == 0:
        return x
    return torch.cat([x[..., :w - 1, :], x[..., w - 1:, :] & ((1 << r) - 1)], dim=-2)


def mul_const_low(x: torch.Tensor, c: list[int], k: int) -> torch.Tensor:
    """(x * c) mod 2^k for a constant c (limbs)."""
    w_out, w = width(k), x.shape[-2]
    zero = torch.zeros_like(x[..., 0, :])
    cols = []
    for j in range(w_out):
        col = zero
        for a in range(max(0, j - len(c) + 1), min(w, j + 1)):
            if c[j - a]:
                col = col + x[..., a, :] * c[j - a]
        cols.append(col)
    return low(_carry(cols, w_out), k)


def dot_const_low(vals: list[torch.Tensor], consts: list[list[int]], k: int) -> torch.Tensor:
    """sum_i vals[i] * consts[i] mod 2^k.  vals[i]: (..., n) values below
    2^32; consts[i]: limb lists.  One shared carry pass."""
    w_out = width(k)
    zero = torch.zeros_like(vals[0])
    cols = [zero] * w_out
    for v, c in zip(vals, consts):
        vl = (v & MASK, v >> LIMB_BITS)
        for j in range(w_out):
            for a in (0, 1):
                b = j - a
                if 0 <= b < len(c) and c[b]:
                    cols[j] = cols[j] + vl[a] * c[b]
    return low(_carry(cols, w_out), k)


def add_const_low(x: torch.Tensor, c: list[int], k: int) -> torch.Tensor:
    """(x + c) mod 2^k for a constant c (limbs)."""
    w_out = width(k)
    zero = torch.zeros_like(x[..., 0, :])
    cols = []
    for j in range(w_out):
        col = x[..., j, :] if j < x.shape[-2] else zero
        cols.append(col + c[j] if j < len(c) and c[j] else col)
    return low(_carry(cols, w_out), k)


def sub_low(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """(a - b) mod 2^k by the two's complement of b; b may have fewer limbs."""
    w_out = width(k)
    zero = torch.zeros_like(a[..., 0, :])
    cols = []
    for j in range(w_out):
        av = a[..., j, :] if j < a.shape[-2] else zero
        bv = b[..., j, :] if j < b.shape[-2] else zero
        cols.append(av + (MASK - bv) + (1 if j == 0 else 0))
    return low(_carry(cols, w_out), k)


def add_bit(x: torch.Tensor, bit: int) -> torch.Tensor:
    """x + 2^bit, keeping x's limb count (no overflow past the top limb)."""
    cols = [x[..., j, :] + ((1 << (bit % LIMB_BITS)) if j == bit // LIMB_BITS else 0)
            for j in range(x.shape[-2])]
    return _carry(cols, x.shape[-2])


def shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """floor(x / 2^k): drops k//16 limbs, then shifts bits across limbs."""
    s, r = divmod(k, LIMB_BITS)
    x = x[..., s:, :]
    if r == 0:
        return x
    w = x.shape[-2]
    zero = torch.zeros_like(x[..., 0, :])
    out = []
    for j in range(w):
        nxt = x[..., j + 1, :] if j + 1 < w else zero
        out.append(((x[..., j, :] >> r) | (nxt << (LIMB_BITS - r))) & MASK)
    return torch.stack(out, dim=-2)


def get_bit(x: torch.Tensor, bit: int) -> torch.Tensor:
    """(..., n) 0/1: bit `bit` of each value."""
    return (x[..., bit // LIMB_BITS, :] >> (bit % LIMB_BITS)) & 1


def fold_mod_q(x: torch.Tensor, pow_cols: list, q) -> torch.Tensor:
    """(..., W, n) limbs -> (..., L, n) value mod q_i, as sum_w limb_w
    (2^(16w) mod q_i) reduced once per chunk (u32.dot_mod).  pow_cols[w] is
    the (L, 1) column of 2^(16w) mod q_i (below 2^30)."""
    return U.dot_mod([(x[..., w, :][..., None, :], pow_cols[w]) for w in range(x.shape[-2])],
                     q)

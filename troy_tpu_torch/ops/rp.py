"""Width-polymorphic residue-polynomial ops: the layer the schemes call.

Counterpart of troy_tpu/ops/rp.py.  Both widths share one layout here,
(..., size, L, n) int64 with the poly axis at -3: a fast-path residue is
below 2^30, a wide one below 2^61 (the JAX package's wide path puts a (hi,
lo) u32 word axis at -3 instead; that layout exists in the port only at the
interop and serialize boundaries, through hi_lo / pair).  So additions,
subtractions, negations and shifts are the fast path's own code, and this
module's job is to send products and transforms to ops/u64.py and
ops/ntt64.py when the tables say `words == 2` (NTT64Tables,
WideScalarTables), and to ops/poly, ops/dyadic and ops/ntt (whose CUDA
dispatch stays as it is) otherwise.  Every call reads ops/ntt's dispatch
attributes at call time, so a patched ntt.ntt_forward reaches the fast path
here too.
"""

from __future__ import annotations

import torch

from . import dyadic as D, ntt as NTT, ntt64 as N64, poly as P, u64 as W

_M32 = (1 << 32) - 1


def words(t) -> int:
    return int(getattr(t, "words", 1))


def hi_lo(x: torch.Tensor):
    """The (hi, lo) 32-bit words of int64 wide residues."""
    return x >> 32, x & _M32


def pair(h: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """int64 residues from their (hi, lo) 32-bit words."""
    return (h.to(torch.int64) << 32) | l.to(torch.int64)


def poly_axis(t) -> int:
    """Axis of the ciphertext poly index counted from the end (one layout
    for both widths)."""
    return -3


# ---------------------------------------------------------------------------
# elementwise modular ops
# ---------------------------------------------------------------------------

add = P.add
sub = P.sub
negate = P.negate
negacyclic_shift = P.negacyclic_shift


def mul_mod(x, y, t):
    """x * y mod q per limb for residues x, y (y broadcasts: a column of
    constants or a tensor)."""
    if words(t) == 2:
        return W.mul_mod64(x, y, t.k)
    return P.dyadic_product(x, y, t)


def dyadic_product(x, y, t):
    if words(t) == 2:
        return N64.dyadic_product64(x, y, t)
    return P.dyadic_product(x, y, t)


def multiply_scalar(x, scalar, t):
    """x * scalar mod q; scalar is a host integer or a tensor of non-negative
    scalars that broadcasts against x."""
    if words(t) == 2:
        return W.mul_mod64(x, torch.remainder(scalar, t.q.view(-1, 1)), t.k)
    return P.multiply_scalar(x, scalar, t)


def multiply_operand(x, w, w_shoup, t):
    """x * w mod q with per-limb constants w (L,); w_shoup is the Shoup
    companion at the table's width (floor(w 2^32 / q) fast, floor(w 2^62 /
    q) wide; poly.multiply_operand and u64.shoup62)."""
    if words(t) == 2:
        return W.shoup_mul64(x, w.view(-1, 1), w_shoup.view(-1, 1), t.q.view(-1, 1))
    return P.multiply_operand(x, w, w_shoup, t)


def modulo(x, t):
    """Reduce arbitrary non-negative residues into [0, q) per limb."""
    return P.modulo(x, t)


# ---------------------------------------------------------------------------
# NTT transforms
# ---------------------------------------------------------------------------

def ntt_forward(x, t):
    if words(t) == 2:
        return N64.ntt_forward64(x, t)
    return NTT.ntt_forward(x, t)


def ntt_inverse(x, t):
    if words(t) == 2:
        return N64.ntt_inverse64(x, t)
    return NTT.ntt_inverse(x, t)


slice_tables = NTT.slice_tables
take_tables = NTT.take_tables


# ---------------------------------------------------------------------------
# dyadic composites (NTT-domain ciphertext products)
# ---------------------------------------------------------------------------

def dyadic_convolute(a, b, t):
    """result[k] = sum_{i+j=k} a_i * b_j pointwise."""
    if words(t) == 1:
        return D.dyadic_convolute(a, b, t)
    s1, s2 = a.shape[-3], b.shape[-3]
    q = t.q.view(-1, 1)
    out = [None] * (s1 + s2 - 1)
    for i in range(s1):
        for j in range(s2):
            prod = dyadic_product(a[..., i, :, :], b[..., j, :, :], t)
            out[i + j] = prod if out[i + j] is None else W.add_mod64(out[i + j], prod, q)
    return torch.stack(out, dim=-3)


def dyadic_square(a, t):
    if words(t) == 1:
        return D.dyadic_square(a, t)
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    cross = dyadic_product(a0, a1, t)
    return torch.stack([dyadic_product(a0, a0, t), W.add_mod64(cross, cross, t.q.view(-1, 1)),
                        dyadic_product(a1, a1, t)], dim=-3)


def dyadic_broadcast_product(a, plain, t):
    """Every poly of a (..., s, L, n) times one NTT-form plaintext (L, n)."""
    if words(t) == 1:
        return D.dyadic_broadcast_product(a, plain, t)
    return dyadic_product(a, plain[None], t)


def dyadic_broadcast_product_accumulate(a, plain, acc, t):
    if words(t) == 1:
        return D.dyadic_broadcast_product_accumulate(a, plain, acc, t)
    return W.add_mod64(acc, dyadic_product(a, plain[None], t), t.q.view(-1, 1))

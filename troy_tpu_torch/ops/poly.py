"""Elementwise RNS-polynomial operations on int64 residue tensors.

Counterpart of troy_tpu/ops/poly.py: polynomials are (..., L, n) tensors,
moduli come from a table object with a (L,) int64 `q` (ops/ntt.NTTTables or
rns/rns_base.RNSBase), broadcast as an (L, 1) column.  Outputs are fully
reduced in [0, q).
"""

from __future__ import annotations

import torch

from . import u32 as U


def _bq(t) -> torch.Tensor:
    """The (L,) moduli of t as a column against (..., L, n) data."""
    return t.q.view(-1, 1)


def add(x, y, t):
    return U.add_mod(x, y, _bq(t))


def sub(x, y, t):
    return U.sub_mod(x, y, _bq(t))


def negate(x, t):
    return U.neg_mod(x, _bq(t))


def multiply_scalar(x, scalar, t):
    """x * scalar mod q for a host integer scalar, or for a tensor of
    non-negative scalars that broadcasts against x (one per batch element:
    shape (B, 1, 1, 1) against (B, size, L, n))."""
    q = _bq(t)
    return U.mul_mod(x, scalar % q, q)


def dyadic_product(x, y, t):
    """Pointwise x * y mod q (NTT-domain products)."""
    return U.mul_mod(x, y, _bq(t))


def negacyclic_shift(x, shift: int, t):
    """x * X^shift in Z_q[X]/(X^n + 1): the coefficients rotate by shift and
    those that wrap past X^n change sign (ref: negacyclic_shift_ps)."""
    n = x.shape[-1]
    k = shift % (2 * n)
    neg_all = k >= n
    k %= n
    out = torch.roll(x, k, dims=-1)
    if k:
        wrapped = torch.arange(n, device=x.device) < k
        out = torch.where(wrapped, negate(out, t), out)
    return negate(out, t) if neg_all else out


def multiply_operand(x, w, w_shoup, t):
    """x * w mod q with per-limb constants w (L,) (ref:
    multiply_uint64operand_ps).  w_shoup, the JAX package's Shoup companion
    floor(w 2^32 / q), is accepted for the same signature: the int64 product
    is exact, so the port reduces it with `%`."""
    return U.mul_mod(x, w.view(-1, 1), _bq(t))


def negacyclic_multiply_monomial(x, coeff: int, degree: int, t):
    """x * (coeff * X^degree) (ref: negacyclic_multiply_mononomials_ps)."""
    return multiply_scalar(negacyclic_shift(x, degree, t), coeff, t)


def modulo(x, t):
    """Reduce arbitrary non-negative values into [0, q) per limb (ref:
    modulo_ps); exact at either width."""
    return U.barrett_reduce(x, _bq(t))


def reduce_from_limb(src, t):
    """A single-limb polynomial (..., n) reduced into every limb of base t:
    (..., L, n) (ref: fgk/switch_key.cu set_accumulate)."""
    return modulo(src[..., None, :], t)

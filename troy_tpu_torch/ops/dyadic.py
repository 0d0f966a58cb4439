"""NTT-domain ciphertext polynomial convolution.

Counterpart of troy_tpu/ops/dyadic.py: for ciphertexts with s1 and s2 polys
in NTT form, result[k] = sum_{i+j=k} a_i * b_j pointwise mod q, and the
broadcast product of every poly by one plaintext poly (multiply_plain).  The
poly axis is -3, so leading batch axes broadcast.
"""

from __future__ import annotations

import torch

from . import u32 as U, poly as P


def dyadic_convolute(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """a: (..., s1, L, n), b: (..., s2, L, n) -> (..., s1+s2-1, L, n)."""
    s1, s2 = a.shape[-3], b.shape[-3]
    q = t.q.view(-1, 1)
    out = [None] * (s1 + s2 - 1)
    for i in range(s1):
        for j in range(s2):
            prod = P.dyadic_product(a[..., i, :, :], b[..., j, :, :], t)
            k = i + j
            out[k] = prod if out[k] is None else U.add_mod(out[k], prod, q)
    return torch.stack(out, dim=-3)


def dyadic_square(a: torch.Tensor, t) -> torch.Tensor:
    """Square of a 2-poly ciphertext: (c0^2, 2 c0 c1, c1^2)."""
    q = t.q.view(-1, 1)
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    cross = P.dyadic_product(a0, a1, t)
    return torch.stack([P.dyadic_product(a0, a0, t), U.add_mod(cross, cross, q),
                        P.dyadic_product(a1, a1, t)], dim=-3)


def dyadic_broadcast_product(a: torch.Tensor, plain: torch.Tensor, t) -> torch.Tensor:
    """Every poly of a (..., s, L, n) times one NTT-form plaintext (L, n)
    (ref: dyadic_convolute.cu broadcast product, for multiply_plain)."""
    return P.dyadic_product(a, plain[None], t)


def dyadic_broadcast_product_accumulate(a: torch.Tensor, plain: torch.Tensor,
                                        acc: torch.Tensor, t) -> torch.Tensor:
    """acc + a * plain (ref: dyadic_broadcast_product_accumulate)."""
    return U.add_mod(acc, P.dyadic_product(a, plain[None], t), t.q.view(-1, 1))

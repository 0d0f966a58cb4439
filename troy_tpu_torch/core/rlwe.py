"""RLWE encryption of zero (counterpart of troy_tpu/core/rlwe.py).

  symmetric : c = (-(a*s + e), a), a uniform (sampled in NTT form);
  asymmetric: c = (pk0*u + e0, pk1*u + e1), u ternary;

e, e0, e1 centered binomial noise, times t for BGV (ref: rlwe.cu noise
sampling), drawn first and then scaled so that the streams match the JAX
package's.  The caller picks the domain: the coefficient domain for BFV, the
NTT domain for CKKS and BGV.

Under a threefry RandomGenerator each draw takes the next counter, so the
draws are those of the JAX package's fused kernels (troy_tpu/core/rlwe.py:
91-173): a symmetric encryption takes a then e (2 counters), or e alone (1)
when seeded, an asymmetric one u, e0, e1 (3).  A seeded symmetric
encryption takes a = uniform_from_seed(seed) in NTT form, in every mode.
"""

from __future__ import annotations

import torch

from .context import ContextData
from .params import SchemeType
from ..ops import poly as P, rp as R
from ..utils.random import sample_uniform, sample_cbd, sample_ternary, uniform_from_seed


def _noise(cd: ContextData, shape_n, qtab, generator) -> torch.Tensor:
    """CBD noise of shape (..., n) lifted to (..., L, n); BGV scales it by t."""
    e = sample_cbd(shape_n, qtab, generator)
    if cd.parms.scheme == SchemeType.BGV:
        e = R.multiply_scalar(e, cd.parms.plain_modulus.value, qtab)
    return e


def _symmetric_combine(cd: ContextData, sk_data: torch.Tensor, a_ntt: torch.Tensor,
                       e: torch.Tensor, ntt_form: bool) -> torch.Tensor:
    """c = (-(a*s + e), a) from given a (NTT form) and e (coefficient form)."""
    qtab = cd.qtab()
    L = cd.coeff_modulus_size
    as_ntt = R.dyadic_product(a_ntt, sk_data[..., :L, :], qtab)
    if ntt_form:
        c0 = P.negate(P.add(as_ntt, R.ntt_forward(e, qtab), qtab), qtab)
        c1 = a_ntt
    else:
        c0 = P.negate(P.add(R.ntt_inverse(as_ntt, qtab), e, qtab), qtab)
        c1 = R.ntt_inverse(a_ntt, qtab)
    return torch.stack([c0, c1])


def _asymmetric_combine(cd: ContextData, pk_data: torch.Tensor, u_coeff: torch.Tensor,
                        e0: torch.Tensor, e1: torch.Tensor, ntt_form: bool) -> torch.Tensor:
    """c = (pk0*u + e0, pk1*u + e1) from given u, e0, e1 (coefficient form);
    pk_data (2, L_key, n) in NTT form, cut to this level's limbs."""
    qtab = cd.qtab()
    L = cd.coeff_modulus_size
    u_ntt = R.ntt_forward(u_coeff, qtab)
    # pk (2, L, n) against u's leading batch axes
    pk = pk_data[..., :L, :].reshape(2, *(1,) * (u_ntt.dim() - 2), L, -1)
    c = R.dyadic_product(pk, u_ntt[None], qtab)
    e = torch.stack([e0, e1])
    if ntt_form:
        return P.add(c, R.ntt_forward(e, qtab), qtab)
    return P.add(R.ntt_inverse(c, qtab), e, qtab)


def encrypt_zero_symmetric(cd: ContextData, sk_data: torch.Tensor, generator,
                           ntt_form: bool, seed: int | None = None) -> torch.Tensor:
    """(2, L, n) encryption of zero under s at cd's level; with a seed, c1
    is regenerated from it (the compressed-ciphertext contract,
    ciphertext.h:255)."""
    qtab = cd.qtab()
    n = cd.parms.poly_modulus_degree
    shape = (cd.coeff_modulus_size, n)
    a_ntt = (sample_uniform(shape, qtab, generator) if seed is None
             else uniform_from_seed(seed, shape, qtab))
    e = _noise(cd, (n,), qtab, generator)
    return _symmetric_combine(cd, sk_data, a_ntt, e, ntt_form)


def encrypt_zero_asymmetric(cd: ContextData, pk_data: torch.Tensor, generator,
                            ntt_form: bool) -> torch.Tensor:
    """(2, L, n) encryption of zero under pk at cd's level; draws u, then e0,
    then e1, in the JAX package's order."""
    qtab = cd.qtab()
    n = cd.parms.poly_modulus_degree
    u = sample_ternary((n,), qtab, generator)
    e0 = _noise(cd, (n,), qtab, generator)
    e1 = _noise(cd, (n,), qtab, generator)
    return _asymmetric_combine(cd, pk_data, u, e0, e1, ntt_form)

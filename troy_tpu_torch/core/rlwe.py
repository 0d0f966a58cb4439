"""RLWE encryption of zero (counterpart of troy_tpu/core/rlwe.py).

  symmetric : c = (-(a*s + e), a), a uniform (sampled in NTT form);
  asymmetric: c = (pk0*u + e0, pk1*u + e1), u ternary;

e, e0, e1 centered binomial noise, times t for BGV (ref: rlwe.cu noise
sampling), drawn first and then scaled so that the streams match the JAX
package's.  The caller picks the domain: the coefficient domain for BFV, the
NTT domain for CKKS and BGV.
"""

from __future__ import annotations

import torch

from .context import ContextData
from .params import SchemeType
from ..ops import ntt as NTT, poly as P
from ..utils.random import sample_uniform, sample_cbd, sample_ternary


def _noise(cd: ContextData, shape_n, qtab, generator) -> torch.Tensor:
    """CBD noise of shape (..., n) lifted to (..., L, n); BGV scales it by t."""
    e = sample_cbd(shape_n, qtab, generator)
    if cd.parms.scheme == SchemeType.BGV:
        e = P.multiply_scalar(e, cd.parms.plain_modulus.value, qtab)
    return e


def _symmetric_combine(cd: ContextData, sk_data: torch.Tensor, a_ntt: torch.Tensor,
                       e: torch.Tensor, ntt_form: bool) -> torch.Tensor:
    """c = (-(a*s + e), a) from given a (NTT form) and e (coefficient form)."""
    qtab = cd.qtab()
    L = cd.coeff_modulus_size
    as_ntt = P.dyadic_product(a_ntt, sk_data[..., :L, :], qtab)
    if ntt_form:
        c0 = P.negate(P.add(as_ntt, NTT.ntt_forward(e, qtab), qtab), qtab)
        c1 = a_ntt
    else:
        c0 = P.negate(P.add(NTT.ntt_inverse(as_ntt, qtab), e, qtab), qtab)
        c1 = NTT.ntt_inverse(a_ntt, qtab)
    return torch.stack([c0, c1])


def _asymmetric_combine(cd: ContextData, pk_data: torch.Tensor, u_coeff: torch.Tensor,
                        e0: torch.Tensor, e1: torch.Tensor, ntt_form: bool) -> torch.Tensor:
    """c = (pk0*u + e0, pk1*u + e1) from given u, e0, e1 (coefficient form);
    pk_data (2, L_key, n) in NTT form, cut to this level's limbs."""
    qtab = cd.qtab()
    pk = pk_data[..., :cd.coeff_modulus_size, :]
    u_ntt = NTT.ntt_forward(u_coeff, qtab)
    c = P.dyadic_product(pk, u_ntt[None], qtab)
    e = torch.stack([e0, e1])
    if ntt_form:
        return P.add(c, NTT.ntt_forward(e, qtab), qtab)
    return P.add(NTT.ntt_inverse(c, qtab), e, qtab)


def encrypt_zero_symmetric(cd: ContextData, sk_data: torch.Tensor,
                           generator: torch.Generator, ntt_form: bool) -> torch.Tensor:
    """(2, L, n) encryption of zero under s at cd's level."""
    qtab = cd.qtab()
    n = cd.parms.poly_modulus_degree
    a_ntt = sample_uniform((cd.coeff_modulus_size, n), qtab, generator)
    e = _noise(cd, (n,), qtab, generator)
    return _symmetric_combine(cd, sk_data, a_ntt, e, ntt_form)


def encrypt_zero_asymmetric(cd: ContextData, pk_data: torch.Tensor,
                            generator: torch.Generator, ntt_form: bool) -> torch.Tensor:
    """(2, L, n) encryption of zero under pk at cd's level; draws u, then e0,
    then e1, in the JAX package's order."""
    qtab = cd.qtab()
    n = cd.parms.poly_modulus_degree
    u = sample_ternary((n,), qtab, generator)
    e0 = _noise(cd, (n,), qtab, generator)
    e1 = _noise(cd, (n,), qtab, generator)
    return _asymmetric_combine(cd, pk_data, u, e0, e1, ntt_form)

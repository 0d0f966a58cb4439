"""RLWE symmetric encryption of zero (counterpart of troy_tpu/core/rlwe.py).

c = (-(a*s + e), a) with a uniform (sampled in NTT form) and e centered
binomial noise; BFV ciphertexts are returned in the coefficient domain.
"""

from __future__ import annotations

import torch

from .context import ContextData
from ..ops import ntt as NTT, poly as P
from ..utils.random import sample_uniform, sample_cbd


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


def encrypt_zero_symmetric(cd: ContextData, sk_data: torch.Tensor,
                           generator: torch.Generator, ntt_form: bool) -> torch.Tensor:
    """(2, L, n) encryption of zero under s at cd's level."""
    qtab = cd.qtab()
    n = cd.parms.poly_modulus_degree
    a_ntt = sample_uniform((cd.coeff_modulus_size, n), qtab, generator)
    e = sample_cbd((n,), qtab, generator)
    return _symmetric_combine(cd, sk_data, a_ntt, e, ntt_form)

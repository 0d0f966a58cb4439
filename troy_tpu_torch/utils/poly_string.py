"""Polynomial pretty-printing (counterpart of troy_tpu/utils/poly_string.py;
ref: src/utils/poly_to_string.{h,cu}).

SEAL-style debug rendering: a polynomial prints as
``"Ax^i + Bx^j + ..."`` with uppercase-hex coefficients, highest degree
first, zero terms skipped, and ``"0"`` for the zero polynomial.  Host-side
by nature (string building); accepts a torch tensor on any device at either
residue width (one int64 word a coefficient), a numpy array or Python ints.
"""

from __future__ import annotations

import numpy as np
import torch


def uint_to_hex_string(value: int) -> str:
    """Uppercase hex without a 0x prefix (ref: poly_to_string.cu
    uint_to_hex_string); '0' for zero."""
    if value < 0:
        raise ValueError("[uint_to_hex_string] value must be non-negative")
    return format(int(value), "X")


def uint_to_dec_string(value: int) -> str:
    if value < 0:
        raise ValueError("[uint_to_dec_string] value must be non-negative")
    return str(int(value))


def _coeffs(poly) -> list[int]:
    if isinstance(poly, torch.Tensor):
        if poly.dim() != 1:
            raise ValueError("[poly_to_hex_string] expected a 1-D coefficient "
                             f"array, got shape {tuple(poly.shape)}")
        return [int(c) for c in poly.detach().cpu().tolist()]
    arr = np.asarray(poly)
    if arr.ndim != 1:
        raise ValueError("[poly_to_hex_string] expected a 1-D coefficient "
                         f"array, got shape {arr.shape}")
    return [int(c) for c in arr]


def _render(coeffs: list[int], fmt) -> str:
    terms = []
    for power in range(len(coeffs) - 1, -1, -1):
        c = coeffs[power]
        if c == 0:
            continue
        s = fmt(c)
        terms.append(f"{s}x^{power}" if power else s)
    return " + ".join(terms) if terms else "0"


def poly_to_hex_string(poly) -> str:
    """Coefficient array (degree-0 first) -> 'Ax^2 + B' hex rendering
    (ref: poly_to_string.h poly_to_hex_string)."""
    return _render(_coeffs(poly), uint_to_hex_string)


def poly_to_dec_string(poly) -> str:
    """Decimal variant (ref: poly_to_string.h poly_to_dec_string)."""
    return _render(_coeffs(poly), uint_to_dec_string)

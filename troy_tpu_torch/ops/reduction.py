"""Device reductions over polynomial data (counterpart of
troy_tpu/ops/reduction.py; ref: src/utils/reduction.{cu,h}, the generic
max / min / sum / nonzero_count used by noise inspection).

Plain torch reductions over int64 tensors.  sum_values wraps mod 2^32 as
the JAX package's u32 accumulation does; sum_values_wide is the exact sum
as one int64 word, the port's convention for a 64-bit value (ops/u64.py),
where the JAX package returns a (hi, lo) u32 pair: its inputs are below
2^32 and fewer than 2^31, so the sum stays below 2^63.
"""

from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1


def _nonempty(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.numel() == 0:
        raise ValueError(f"[{name}] zero-size array has no {name.split('_')[0]}")
    return x


def max_value(x: torch.Tensor) -> torch.Tensor:
    return torch.max(_nonempty(x, "max_value"))


def min_value(x: torch.Tensor) -> torch.Tensor:
    return torch.min(_nonempty(x, "min_value"))


def nonzero_count(x: torch.Tensor) -> torch.Tensor:
    return torch.count_nonzero(x)


def sum_values(x: torch.Tensor) -> torch.Tensor:
    """Sum modulo 2^32 (wrapping, like u32 accumulation): each value taken
    mod 2^32 first, as the JAX package's cast to u32 does."""
    return torch.sum(x.to(torch.int64) & _MASK32) & _MASK32


def sum_values_wide(x: torch.Tensor) -> torch.Tensor:
    """Exact sum as one int64 word, for values below 2^32 and arrays of
    fewer than 2^31 elements (the JAX package's (hi, lo) pair as
    hi * 2^32 + lo)."""
    if x.numel() >= 1 << 31:
        raise ValueError("[sum_values_wide] at most 2^31 - 1 elements")
    return torch.sum(x.to(torch.int64) & _MASK32)


def max_centered_magnitude(x: torch.Tensor, q) -> torch.Tensor:
    """max |centered(x)| where x in [0, q): the noise-norm primitive."""
    x = _nonempty(x, "max_centered_magnitude")
    return torch.max(torch.minimum(x, q - x))

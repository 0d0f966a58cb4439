"""Samplers for RLWE, driven by an explicit torch.Generator.

Counterpart of troy_tpu/utils/random.py.  The distributions are the JAX
package's (uniform mod q, ternary secret, centered binomial noise of 21 + 21
bits); the bits are the generator's, not threefry's or AES-CTR's, so the two
packages agree in distribution and not bit for bit.  Every sample lands on
the generator's device; a sampled small polynomial is lifted to every limb.
"""

from __future__ import annotations

import torch

_CBD_BITS = 21  # noise in [-21, 21], sigma ~ 3.2


def sample_uniform(shape, t, generator: torch.Generator) -> torch.Tensor:
    """shape = (..., L, n): residues uniform mod each q of t (a table object
    with a (L,) `q`), from 62 random bits each (bias below 2^-32)."""
    r = torch.randint(0, 1 << 62, tuple(shape), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return r % t.q.view(-1, 1)


def _lift(e: torch.Tensor, t) -> torch.Tensor:
    """Small signed values (..., n) -> residues (..., L, n)."""
    return torch.remainder(e[..., None, :], t.q.view(-1, 1))


def sample_ternary(shape_n, t, generator: torch.Generator) -> torch.Tensor:
    """Ternary {-1, 0, 1} polynomial(s) of shape (..., n), lifted to (..., L, n)."""
    r = torch.randint(0, 3, tuple(shape_n), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return _lift(r - 1, t)


def sample_cbd(shape_n, t, generator: torch.Generator) -> torch.Tensor:
    """Centered binomial noise (sum of 21 bits minus sum of 21 bits) of shape
    (..., n), lifted to (..., L, n)."""
    bits = torch.randint(0, 2, (2, *shape_n, _CBD_BITS), generator=generator,
                         dtype=torch.uint8, device=generator.device)
    counts = bits.sum(dim=-1, dtype=torch.int64)
    return _lift(counts[0] - counts[1], t)

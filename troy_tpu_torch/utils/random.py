"""Samplers for RLWE: uniform residues, the ternary secret and centered
binomial noise (counterpart of troy_tpu/utils/random.py).

Each sampler takes its randomness from `generator`, which is either

  * a torch.Generator: the distributions of the JAX package (uniform mod q,
    ternary, centered binomial of 21 + 21 bits), with the generator's own
    bits, so the two packages agree in distribution, not bit for bit; or
  * a RandomGenerator(seed, mode="aes", domain): the JAX package's AES-CTR
    mode, bit for bit.  Its AES-128 key is derived from (seed, domain) by
    the JAX package's blake2b chain (persons "troyseed", "troy-aes"), the
    keystream comes from the port's host library (troy_tpu_torch/native),
    its block counter advances by the blocks each call consumes, and the
    words are laid out per sampler as the JAX package lays them out.  The
    JAX default mode, threefry, is not ported (ROADMAP A15).

Every sample lands on the device of the tables it is drawn for (t.q), a
sampled small polynomial lifted to every limb.
"""

from __future__ import annotations

import hashlib
import math
import secrets

import numpy as np
import torch

_CBD_BITS = 21  # noise in [-21, 21], sigma ~ 3.2
_MASK21 = (1 << _CBD_BITS) - 1
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)



def _popcount21(words: np.ndarray) -> np.ndarray:
    """Set bits of w & (2^21 - 1), by a byte table (numpy's bitwise_count
    is not in every numpy)."""
    w = words.astype(np.int64) & _MASK21
    return _POPCOUNT8[w & 255] + _POPCOUNT8[(w >> 8) & 255] + _POPCOUNT8[w >> 16]


class RandomGenerator:
    """A deterministic sampler stream (ref: random_generator.h:42-95), keyed
    one-way by (seed, domain) as the JAX package keys it; the objects that
    draw from it set the domain ("keygen", "encryptor")."""

    def __init__(self, seed: int | None = None, mode: str = "aes", domain: str = ""):
        if mode != "aes":
            raise ValueError(f"[RandomGenerator] mode {mode!r}: the port has the 'aes' "
                             "mode only (threefry is not ported)")
        self.seed = int(secrets.randbits(128) if seed is None else seed)
        self.mode = mode
        self.domain = domain
        seed_bytes = hashlib.blake2b(str(self.seed).encode(), digest_size=32,
                                     person=b"troyseed").digest()
        self._aes_key = hashlib.blake2b(seed_bytes + domain.encode(), digest_size=16,
                                        person=b"troy-aes").digest()
        self.counter = 0  # AES blocks consumed

    def aes_words(self, count: int) -> np.ndarray:
        """count u32 words of the AES-CTR stream; the block counter advances
        by the blocks consumed (troy_tpu/utils/random.py:_aes_words)."""
        from .. import native

        nbytes = 4 * count
        blocks = -(-nbytes // 16)
        raw = native.aes128_ctr_bytes(self._aes_key, self.counter, 16 * blocks)
        self.counter += blocks
        return np.frombuffer(raw[:nbytes], dtype="<u4")

    def sample_uniform(self, shape, t) -> torch.Tensor:
        """(..., L, n) residues: 2 words each, hi = words[:c] and lo =
        words[c:], reduced as (hi 2^32 + lo) mod q =
        ((hi mod q)(2^32 mod q) + lo) mod q, exact in int64."""
        count = math.prod(shape)
        words = torch.from_numpy(self.aes_words(2 * count).astype(np.int64)).to(t.q.device)
        hi, lo = words[:count].view(shape), words[count:].view(shape)
        q = t.q.view(-1, 1)
        return ((hi % q) * ((1 << 32) % q) + lo) % q

    def sample_ternary(self, shape_n, t) -> torch.Tensor:
        """(..., n) ternary values lifted to (..., L, n): words % 3, with 2
        standing for -1."""
        r = (self.aes_words(math.prod(shape_n)) % 3).astype(np.int64).reshape(shape_n)
        return _lift(torch.from_numpy(np.where(r == 2, -1, r)).to(t.q.device), t)

    def sample_cbd(self, shape_n, t) -> torch.Tensor:
        """(..., n) centered binomial noise lifted to (..., L, n): a - b with
        a = popcount(words[:c] & MASK21), b = popcount(words[c:] & MASK21)."""
        count = math.prod(shape_n)
        words = self.aes_words(2 * count)
        e = (_popcount21(words[:count]) - _popcount21(words[count:])).reshape(shape_n)
        return _lift(torch.from_numpy(e).to(t.q.device), t)


def stream(seed: int | None, generator: torch.Generator | None,
           prng: RandomGenerator | None, domain: str, who: str):
    """The randomness an object draws from: prng, else generator, else the
    context seed's AES stream for `domain` (as the JAX package keys its
    objects from context.seed); raises without any of them."""
    if prng is not None:
        return prng
    if generator is not None:
        return generator
    if seed is not None:
        return RandomGenerator(seed, "aes", domain)
    raise ValueError(f"[{who}] a torch.Generator or a RandomGenerator (prng=) is "
                     "required, or a context created with a seed")


def sample_uniform(shape, t, generator) -> torch.Tensor:
    """shape = (..., L, n): residues uniform mod each q of t (a table object
    with a (L,) `q`); from a torch.Generator, 62 random bits each (bias below
    2^-32)."""
    if isinstance(generator, RandomGenerator):
        return generator.sample_uniform(shape, t)
    r = torch.randint(0, 1 << 62, tuple(shape), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return r % t.q.view(-1, 1)


def _lift(e: torch.Tensor, t) -> torch.Tensor:
    """Small signed values (..., n) -> residues (..., L, n)."""
    return torch.remainder(e[..., None, :], t.q.view(-1, 1))


def sample_ternary(shape_n, t, generator) -> torch.Tensor:
    """Ternary {-1, 0, 1} polynomial(s) of shape (..., n), lifted to (..., L, n)."""
    if isinstance(generator, RandomGenerator):
        return generator.sample_ternary(shape_n, t)
    r = torch.randint(0, 3, tuple(shape_n), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return _lift(r - 1, t)


def sample_cbd(shape_n, t, generator) -> torch.Tensor:
    """Centered binomial noise (sum of 21 bits minus sum of 21 bits) of shape
    (..., n), lifted to (..., L, n)."""
    if isinstance(generator, RandomGenerator):
        return generator.sample_cbd(shape_n, t)
    bits = torch.randint(0, 2, (2, *shape_n, _CBD_BITS), generator=generator,
                         dtype=torch.uint8, device=generator.device)
    counts = bits.sum(dim=-1, dtype=torch.int64)
    return _lift(counts[0] - counts[1], t)

"""Samplers for RLWE: uniform residues, the ternary secret and centered
binomial noise (counterpart of troy_tpu/utils/random.py).

Each sampler takes its randomness from `generator`, which is either

  * a RandomGenerator(seed, mode, domain), bit for bit the JAX package's
    stream of the same (seed, mode, domain).  Both modes derive their keys
    one-way from (seed, domain) by the JAX package's blake2b chain (persons
    "troyseed", "troy-prf", "troy-aes").
      - mode="threefry" (the default, as in the JAX package): jax.random's
        threefry2x32-20 counter stream written out in int64 torch ops on the
        samples' device.  The k-th draw is keyed by fold_in(key, k) of each
        of the two per-generator keys, and a sample is the XOR of the two
        keys' bit streams (_bits2).
      - mode="aes": the AES-128-CTR keystream of the port's host library
        (troy_tpu_torch/native); its block counter advances by the blocks
        each call consumes, and the words are laid out per sampler as the
        JAX package lays them out.
  * a torch.Generator: the same distributions (uniform mod q, ternary,
    centered binomial of 21 + 21 bits) from the generator's own bits, so
    the two packages agree in distribution, not bit for bit.

jax.random as the JAX package runs it (x64 off, jax_threefry_partitionable
on):
  * key(v) holds the words (0, v mod 2^32): a seed is cut to its low 32 bits
    (the reference's "32-bit seed cut", matched here, not fixed);
  * fold_in(key, c) = threefry2x32(key, (0, c)), the output pair the new key;
  * bits(key, shape) numbers the elements by their row-major flat index i
    and takes y0 ^ y1 of threefry2x32(key, (i >> 32, i mod 2^32)).
Torch has no u32 arithmetic, so each word is an int64 in [0, 2^32), masked
after every add and left shift.  Keys are pairs of Python ints, or of
0-d tensors once a device tensor was folded in (BatchedClient's probe of the
chained state): nothing here reads a device value back to the host.

At the wide width (tables with words == 2, 40-60-bit primes) a uniform
residue takes 128 random bits, word i at bit 32 i, reduced exactly mod q;
the small samplers draw the same words as at the fast width and lift a
negative value e to q + e, as the JAX package's wide branches do.  Every
sample lands on the device of the tables it is drawn for (t.q), a sampled
small polynomial lifted to every limb.
"""

from __future__ import annotations

import hashlib
import math
import secrets

import numpy as np
import torch

_CBD_BITS = 21  # noise in [-21, 21], sigma ~ 3.2
_MASK21 = (1 << _CBD_BITS) - 1
_M32 = 0xFFFFFFFF
_M63 = (1 << 63) - 1
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _popcount21(words: np.ndarray) -> np.ndarray:
    """Set bits of w & (2^21 - 1), by a byte table (numpy's bitwise_count
    is not in every numpy)."""
    w = words.astype(np.int64) & _MASK21
    return _POPCOUNT8[w & 255] + _POPCOUNT8[(w >> 8) & 255] + _POPCOUNT8[w >> 16]


# ---------------------------------------------------------------------------
# threefry2x32-20 and the key, fold_in and bits of jax.random
# ---------------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as jax.random runs
    it) of the key (k0, k1) on the counter words (x0, x1).  Every argument
    is a Python int or an int64 tensor of 32-bit words; they broadcast, and
    the output words are of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """jax.random.key(seed) with x64 off: the words (0, seed mod 2^32)."""
    return 0, int(seed) & _M32


def fold_in(k, counter):
    """jax.random.fold_in(k, counter): counter a Python int or a 0-d int64
    tensor of a 32-bit word (read on its device, never on the host)."""
    return threefry2x32(k[0], k[1], 0, counter)


def bits(k, shape, device) -> torch.Tensor:
    """jax.random.bits(k, shape, uint32) in the partitionable layout: an
    int64 tensor of 32-bit words on device."""
    count = math.prod(shape)
    i = torch.arange(count, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k[0], k[1], i >> 32, i & _M32)
    return (y0 ^ y1).view(tuple(shape))


def _bits2(keys, shape, device) -> torch.Tensor:
    """XOR of the bit streams of the two keys (a 128-bit keyspace from two
    64-bit threefry keys, troy_tpu/utils/random.py:_bits2)."""
    return bits(keys[0], shape, device) ^ bits(keys[1], shape, device)


def fold_in_keys(base_keys, counter):
    """Both keys folded with one counter (an int or a 0-d device tensor):
    the key pair of the counter-th draw."""
    return fold_in(base_keys[0], counter), fold_in(base_keys[1], counter)


def _popcount21_t(w: torch.Tensor) -> torch.Tensor:
    """Set bits of w & (2^21 - 1) for an int64 tensor, by SWAR halving."""
    w = w & _MASK21
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (w * 0x01010101 & _M32) >> 24


def _lift(e: torch.Tensor, t) -> torch.Tensor:
    """Small signed values (..., n) -> residues (..., L, n)."""
    return torch.remainder(e[..., None, :], t.q.view(-1, 1))


def _wide(t) -> bool:
    return getattr(t, "words", 1) == 2


def uniform_from_bits(b: torch.Tensor, t) -> torch.Tensor:
    """(2, ..., L, n) words -> residues (hi 2^32 + lo) mod q per limb, exact
    in int64 as ((hi mod q)(2^32 mod q) + lo) mod q: the canonical residue
    the JAX package's Barrett reduction gives.  Wide tables: (4, ..., L, n)
    words, the 128-bit value sum_i b[i] 2^(32 i) mod q by Horner steps of
    the wide multiply."""
    q = t.q.view(-1, 1)
    if _wide(t):
        from ..ops import u64 as W

        c32 = torch.remainder(torch.full_like(q, 1 << 32), q)
        r = b[3] % q
        for w in (2, 1, 0):
            r = torch.remainder(W.mul_mod64(r, c32, t.k) + b[w], q)
        return r
    return ((b[0] % q) * ((1 << 32) % q) + b[1]) % q


def ternary_from_bits(r: torch.Tensor, t) -> torch.Tensor:
    """(..., n) words -> ternary values r % 3 (2 standing for -1) lifted to
    (..., L, n)."""
    r = r % 3
    return _lift(torch.where(r == 2, -1, r), t)


def cbd_from_bits(b: torch.Tensor, t) -> torch.Tensor:
    """(2, ..., n) words -> popcount(b0 & MASK21) - popcount(b1 & MASK21)
    lifted to (..., L, n)."""
    return _lift(_popcount21_t(b[0]) - _popcount21_t(b[1]), t)


def _uniform_words(shape, t) -> tuple:
    """The word shape of a uniform draw of shape (..., L, n): (2, ..., L, n),
    or (4, ..., L, n) for wide tables."""
    return (4 if _wide(t) else 2, *shape[:-2], t.q.shape[0], shape[-1])


def uniform_from_keys(keys, shape, t) -> torch.Tensor:
    """shape = (..., L, n): the threefry draw of sample_uniform."""
    return uniform_from_bits(_bits2(keys, _uniform_words(shape, t), t.q.device), t)


def ternary_from_keys(keys, shape_n, t) -> torch.Tensor:
    """shape_n = (..., n): the threefry draw of sample_ternary."""
    return ternary_from_bits(_bits2(keys, tuple(shape_n), t.q.device), t)


def cbd_from_keys(keys, shape_n, t) -> torch.Tensor:
    """shape_n = (..., n): the threefry draw of sample_cbd."""
    return cbd_from_bits(_bits2(keys, (2, *shape_n), t.q.device), t)


def uniform_from_seed(seed: int, shape, t) -> torch.Tensor:
    """The uniform polynomial of a stored ciphertext seed, one key and no
    XOR (ref: ciphertext.h:255 expand_seed): key(seed) keeps only the seed's
    low 32 bits."""
    return uniform_from_bits(bits(key(seed), _uniform_words(shape, t), t.q.device), t)


class RandomGenerator:
    """A deterministic sampler stream (ref: random_generator.h:42-95), keyed
    one-way by (seed, domain) as the JAX package keys it; the objects that
    draw from it set the domain ("keygen", "encryptor").  counter counts the
    threefry draws, or the AES blocks consumed."""

    def __init__(self, seed: int | None = None, mode: str = "threefry", domain: str = ""):
        if mode not in ("threefry", "aes"):
            raise ValueError(f"[RandomGenerator] unknown mode {mode}")
        self.seed = int(secrets.randbits(128) if seed is None else seed)
        self.mode = mode
        self.domain = domain
        self._seed_bytes = hashlib.blake2b(str(self.seed).encode(), digest_size=32,
                                           person=b"troyseed").digest()
        dk = hashlib.blake2b(self._seed_bytes + domain.encode(), digest_size=16,
                             person=b"troy-prf").digest()
        self._keys = (key(int.from_bytes(dk[:8], "little") & _M63),
                      key(int.from_bytes(dk[8:], "little") & _M63))
        self.counter = 0
        self._seed_counter = 0
        if mode == "aes":
            self._aes_key = hashlib.blake2b(self._seed_bytes + domain.encode(),
                                            digest_size=16, person=b"troy-aes").digest()

    # -- threefry counters --------------------------------------------------
    def _threefry(self, what: str):
        if self.mode != "threefry":
            raise ValueError(f"[RandomGenerator] {what} requires threefry")

    @property
    def base_keys(self):
        """The generator's two threefry keys, for fold_in_keys."""
        return self._keys

    def _next_keys(self):
        c = self.counter
        self.counter += 1
        return fold_in_keys(self._keys, c)

    def next_key_pairs(self, k: int) -> list:
        """k key pairs, advancing the counter as k sample_* calls would."""
        self._threefry("next_key_pairs")
        return [self._next_keys() for _ in range(k)]

    def reserve_counters(self, k: int) -> int:
        """Reserve k draws and return the first counter: draw i is keyed by
        fold_in_keys(base_keys, first + i)."""
        self._threefry("reserve_counters")
        c = self.counter
        self.counter += k
        return c

    def aes_words(self, count: int) -> np.ndarray:
        """count u32 words of the AES-CTR stream; the block counter advances
        by the blocks consumed (troy_tpu/utils/random.py:_aes_words)."""
        from .. import native

        nbytes = 4 * count
        blocks = -(-nbytes // 16)
        raw = native.aes128_ctr_bytes(self._aes_key, self.counter, 16 * blocks)
        self.counter += blocks
        return np.frombuffer(raw[:nbytes], dtype="<u4")

    # -- samplers -------------------------------------------------------------
    def sample_uniform(self, shape, t) -> torch.Tensor:
        """(..., L, n) residues.  AES: 2 words each, hi = words[:c] and lo =
        words[c:]; wide tables: 4 words each, word i = words[i c:(i+1) c]."""
        if self.mode == "threefry":
            return uniform_from_keys(self._next_keys(), shape, t)
        count = math.prod(shape)
        nw = 4 if _wide(t) else 2
        words = torch.from_numpy(self.aes_words(nw * count).astype(np.int64)).to(t.q.device)
        return uniform_from_bits(words.view(nw, *shape), t)

    def sample_ternary(self, shape_n, t) -> torch.Tensor:
        """(..., n) ternary values lifted to (..., L, n)."""
        if self.mode == "threefry":
            return ternary_from_keys(self._next_keys(), shape_n, t)
        r = (self.aes_words(math.prod(shape_n)) % 3).astype(np.int64).reshape(shape_n)
        return _lift(torch.from_numpy(np.where(r == 2, -1, r)).to(t.q.device), t)

    def sample_cbd(self, shape_n, t) -> torch.Tensor:
        """(..., n) centered binomial noise lifted to (..., L, n)."""
        if self.mode == "threefry":
            return cbd_from_keys(self._next_keys(), shape_n, t)
        count = math.prod(shape_n)
        words = self.aes_words(2 * count)
        e = (_popcount21(words[:count]) - _popcount21(words[count:])).reshape(shape_n)
        return _lift(torch.from_numpy(e).to(t.q.device), t)

    def sample_cbd_signed(self, shape_n, device) -> torch.Tensor:
        """Raw centered-binomial integers (..., n), not lifted (threefry)."""
        self._threefry("sample_cbd_signed")
        b = _bits2(self._next_keys(), (2, *shape_n), device)
        return _popcount21_t(b[0]) - _popcount21_t(b[1])

    def new_seed(self) -> int:
        """A fresh nonzero 63-bit seed for a seed-compressed ciphertext,
        one-way in (seed, domain, a counter), in either mode."""
        while True:
            self._seed_counter += 1
            digest = hashlib.blake2b(
                self._seed_bytes + self.domain.encode()
                + self._seed_counter.to_bytes(8, "little"),
                digest_size=8, person=b"troyseed").digest()
            s = int.from_bytes(digest, "little") & _M63
            if s != 0:
                return s


def stream(seed: int | None, generator: torch.Generator | None,
           prng: RandomGenerator | None, domain: str):
    """The randomness an object draws from: prng, else generator, else the
    context seed's threefry stream for `domain`, a fresh 128-bit seed when
    the context has none (as the JAX package keys its objects)."""
    if prng is not None:
        return prng
    if generator is not None:
        return generator
    return RandomGenerator(seed, "threefry", domain)


def new_seed(generator) -> int:
    """A nonzero 63-bit ciphertext seed: RandomGenerator.new_seed, or drawn
    from a torch.Generator."""
    if isinstance(generator, RandomGenerator):
        return generator.new_seed()
    return int(torch.randint(1, _M63, (1,), generator=generator,
                             device=generator.device).item())


def sample_uniform(shape, t, generator) -> torch.Tensor:
    """shape = (..., L, n): residues uniform mod each q of t (a table object
    with a (L,) `q`); from a torch.Generator, 62 random bits each (bias below
    2^-32)."""
    if isinstance(generator, RandomGenerator):
        return generator.sample_uniform(shape, t)
    r = torch.randint(0, 1 << 62, tuple(shape), generator=generator,
                      dtype=torch.int64, device=generator.device)
    return r % t.q.view(-1, 1)


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
    b = torch.randint(0, 2, (2, *shape_n, _CBD_BITS), generator=generator,
                      dtype=torch.uint8, device=generator.device)
    counts = b.sum(dim=-1, dtype=torch.int64)
    return _lift(counts[0] - counts[1], t)

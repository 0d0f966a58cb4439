"""Keys made from the seed, in plain PyTorch, in the layout the program
takes (int64 residues, (..., size, L, n)); each scheme's messages and fresh
encryptions are in its file under schemes/.

The secret s is ternary; noise is a rounded normal of deviation 3.2 clipped
at 19 (SEAL's classic distribution).  Switching keys use the single special
prime P (the last prime of the configuration): key i of a (L, 2, L + 1, n)
NTT-form key is (-(a_i s + e_i) + [j = i] (P mod q_i) T, a_i) for the
target T (s^2 to relinearize, s(x^g) for a Galois element g).

Everything is drawn from one torch.Generator on the device, in a few large
calls and in a fixed order, so one seed gives the same keys and inputs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .arith import Ring

NOISE_STD, NOISE_BOUND = 3.2, 19
GENERATOR = 3  # the rotation group's generator: rotate_rows(k) is x -> x^(3^k)


@dataclass
class Config:
    name: str
    scheme: str
    n: int
    primes: list[int]          # data primes, then the special prime
    plain_modulus: int = 0     # BFV
    message_bits: int = 0      # CKKS: |m| < 2^message_bits
    lift: str = "hps"
    raw: dict = field(default_factory=dict)

    @property
    def data_primes(self) -> list[int]:
        return self.primes[:-1]

    @property
    def special(self) -> int:
        return self.primes[-1]

    @staticmethod
    def load(path: Path, overrides: dict | None = None) -> "Config":
        raw = json.loads(Path(path).read_text())
        raw.update(overrides or {})
        return Config(name=raw["name"], scheme=raw["scheme"], n=raw["poly_modulus_degree"],
                      primes=list(raw["coeff_modulus"]),
                      plain_modulus=raw.get("plain_modulus", 0),
                      message_bits=raw.get("message_bits", 0),
                      lift=raw.get("lift", "hps"), raw=raw)


def galois_apply(x: torch.Tensor, g: int, modulus=None) -> torch.Tensor:
    """x(X^g) for (..., n) integers (or residues mod `modulus`, a column
    that broadcasts): coefficient i moves to i g mod 2n, negated past n."""
    n = x.shape[-1]
    src = torch.arange(n, device=x.device)
    dst = src * g % (2 * n)
    vals = torch.where(dst >= n, -x, x)
    out = torch.empty_like(x)
    out[..., dst % n] = vals
    return out if modulus is None else torch.remainder(out, modulus)


class Sampler:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 64))

    def uniform(self, ring: Ring, lead: tuple) -> torch.Tensor:
        """Uniform residues (*lead, L, n)."""
        return torch.stack([torch.randint(0, q, (*lead, ring.n), generator=self.gen,
                                          device=self.device) for q in ring.primes], dim=-2)

    def noise(self, shape: tuple) -> torch.Tensor:
        e = torch.normal(0.0, NOISE_STD, shape, generator=self.gen, device=self.device)
        return torch.round(e).clamp_(-NOISE_BOUND, NOISE_BOUND).long()

    def ternary(self, n: int) -> torch.Tensor:
        return torch.randint(-1, 2, (n,), generator=self.gen, device=self.device)

    def integers(self, low: int, high: int, shape: tuple) -> torch.Tensor:
        return torch.randint(low, high, shape, generator=self.gen, device=self.device)


class Keys:
    """The secret and the switching keys of one configuration."""

    def __init__(self, cfg: Config, smp: Sampler):
        self.cfg = cfg
        self.key_ring = Ring(cfg.n, cfg.primes, smp.device)
        self.ring = self.key_ring.sub_ring(list(range(len(cfg.primes) - 1)))
        self.smp = smp
        self.s = smp.ternary(cfg.n)
        self.s_ntt_key = self.key_ring.ntt(self.key_ring.small(self.s))
        self.s_ntt = self.s_ntt_key[:-1]

    def switching_key(self, target_ntt: torch.Tensor) -> torch.Tensor:
        """(L, 2, L + 1, n) key for the NTT-form target at the key level."""
        kr, n = self.key_ring, self.cfg.n
        L = len(kr.primes) - 1
        a = self.smp.uniform(kr, (L,))
        e = kr.ntt(kr.small(self.smp.noise((L, n))))
        c0 = kr.neg(kr.add(kr.mul(a, self.s_ntt_key), e))
        factor = kr.scalar([self.cfg.special % q for q in kr.primes])
        term = kr.mul(target_ntt, factor)
        for i in range(L):
            c0[i, i] = torch.remainder(c0[i, i] + term[i], kr.primes[i])
        return torch.stack([c0, a], dim=1)

    def relin_key(self) -> torch.Tensor:
        kr = self.key_ring
        return self.switching_key(kr.mul(self.s_ntt_key, self.s_ntt_key))

    def galois_key(self, g: int) -> torch.Tensor:
        kr = self.key_ring
        return self.switching_key(kr.ntt(kr.small(galois_apply(self.s, g))))

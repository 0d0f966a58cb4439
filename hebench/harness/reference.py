"""The plain reference: a plain evaluator of the timed operations.  What
each operation's output must decrypt to (`expected`) is in its file under
ops/, which the correctness check (judge.py) holds the program's outputs
to.

`Evaluator` computes the operations themselves from the ciphertexts and the
keys the benchmark made, in plain PyTorch and Python integers: the BFV
tensor product exactly over the integers, then round(t d / Q); the keyswitch
over the special prime with the division rounded to nearest; the CKKS
rescale.  Built with exact=False it computes every modular product in
float64: the control that the check has to refuse (control.py).
"""

from __future__ import annotations

import torch

from .arith import Ring, int_negacyclic
from .scheme import GENERATOR, Config, Keys, galois_apply


def rotation_element(steps: int, n: int) -> int:
    """rotate_rows(steps) is x -> x^(3^steps mod 2n)."""
    m = 2 * n
    return pow(GENERATOR, steps, m) if steps >= 0 else pow(pow(GENERATOR, -1, m), -steps, m)


class Evaluator:
    """The operations in plain arithmetic on (B, size, L, n) residues at the
    first data level."""

    def __init__(self, keys: Keys, exact: bool = True):
        cfg = keys.cfg
        self.cfg = cfg
        self.kr = Ring(cfg.n, cfg.primes, keys.key_ring.device, exact)
        L = len(cfg.primes) - 1
        self.r = self.kr.sub_ring(list(range(L)))
        self.sp = self.kr.sub_ring([L])
        self.inv_sp = self.r.scalar([pow(cfg.special % q, -1, q) for q in self.r.primes])

    def keyswitch(self, target: torch.Tensor, key: torch.Tensor, out_ntt: bool) -> torch.Tensor:
        """target (B, L, n) coefficients -> (B, 2, L, n): sum_i [target]_{q_i}
        key_i, divided by the special prime P and rounded."""
        r, kr, L = self.r, self.kr, self.r.q.shape[0]
        digits = torch.remainder(target[:, :, None, :], kr.q)         # (B, L, L+1, n)
        dn = kr.ntt(digits)
        acc = None
        for i in range(L):
            term = kr.mul(dn[:, i, None], key[i])                       # (B, 2, L+1, n)
            acc = term if acc is None else kr.add(acc, term)
        last = self.sp.intt(acc[:, :, L:])                              # (B, 2, 1, n)
        P = self.cfg.special
        rc = torch.where(last > P // 2, last - P, last)
        rr = torch.remainder(rc, r.q)
        if out_ntt:
            body, rr = acc[:, :, :L], r.ntt(rr)
        else:
            body = r.intt(acc[:, :, :L].contiguous())
        return r.mul(r.sub(body, rr), self.inv_sp)

    def bfv_mul_relin(self, c1: torch.Tensor, c2: torch.Tensor, rlk: torch.Tensor):
        r, cfg = self.r, self.cfg
        a, b = r.crt(c1), r.crt(c2)                                     # (B, 2, n) ints
        bound = 2 * r.modulus.bit_length() + cfg.n.bit_length() + 1
        ring_args = (cfg.n, bound, r.device, r.exact)
        d = [int_negacyclic([(a[:, 0], b[:, 0])], *ring_args),
             int_negacyclic([(a[:, 0], b[:, 1]), (a[:, 1], b[:, 0])], *ring_args),
             int_negacyclic([(a[:, 1], b[:, 1])], *ring_args)]
        Q, t = r.modulus, cfg.plain_modulus
        scaled = [(2 * t * x + Q) // (2 * Q) for x in d]                # round(t d / Q)
        res = torch.stack([r.residues(x) for x in scaled], dim=1)       # (B, 3, L, n)
        ks = self.keyswitch(res[:, 2], rlk, out_ntt=False)
        return r.add(res[:, :2], ks)

    def rotate(self, c: torch.Tensor, g: int, glk: torch.Tensor):
        r = self.r
        cg = galois_apply(c, g, r.q)
        ks = self.keyswitch(cg[:, 1], glk, out_ntt=False)
        return torch.stack([r.add(cg[:, 0], ks[:, 0]), ks[:, 1]], dim=1)

    def ckks_mul_relin_rescale(self, c1, c2, rlk):
        r = self.r
        d0 = r.mul(c1[:, 0], c2[:, 0])
        d1 = r.add(r.mul(c1[:, 0], c2[:, 1]), r.mul(c1[:, 1], c2[:, 0]))
        d2 = r.mul(c1[:, 1], c2[:, 1])
        ks = self.keyswitch(r.intt(d2), rlk, out_ntt=True)
        c = torch.stack([r.add(d0, ks[:, 0]), r.add(d1, ks[:, 1])], dim=1)
        return self.rescale(c)

    def rescale(self, c: torch.Tensor) -> torch.Tensor:
        """NTT-form (B, 2, L, n) -> (B, 2, L - 1, n): divide by the last
        prime and round."""
        r, L = self.r, self.r.q.shape[0]
        down, lastr = r.sub_ring(list(range(L - 1))), r.sub_ring([L - 1])
        ql = r.primes[-1]
        last = lastr.intt(c[:, :, L - 1:])
        rc = torch.where(last > ql // 2, last - ql, last)
        rr = down.ntt(torch.remainder(rc, down.q))
        inv = down.scalar([pow(ql % q, -1, q) for q in down.primes])
        return down.mul(down.sub(c[:, :, :L - 1], rr), inv)


def out_ring(cfg: Config, levels_dropped: int, device) -> Ring:
    """The ring of the step's outputs: the first data level, less the
    levels the operation drops (a rescale drops one)."""
    L = len(cfg.primes) - 1 - levels_dropped
    return Ring(cfg.n, cfg.primes[:L], device)

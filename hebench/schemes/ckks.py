"""CKKS: integer messages |m| < 2^message_bits (the scaled message's
coefficients), fresh encryptions (m + e - a s, a) in the NTT domain, and
the number the check compares for each judged output:

  * err_bits: log2(1 + |e|), e = phase - num / den, the distance from the
    exact product at the output's scale, the largest over every
    coefficient.
"""

import torch

from harness.arith import log_err

NTT_FORM = True
AGGREGATE = {"err_bits": max}


def messages(keys, batch):
    bound = 1 << keys.cfg.message_bits
    return keys.smp.integers(-bound + 1, bound, (batch, keys.cfg.n))


def encrypt(keys, m):
    """(B, n) messages -> (B, 2, L, n) fresh secret-key encryptions."""
    r = keys.ring
    a = keys.smp.uniform(r, (m.shape[0],))
    e = keys.smp.noise((m.shape[0], keys.cfg.n))
    return torch.stack([r.sub(r.ntt(r.small(m + e)), r.mul(a, keys.s_ntt)), a], dim=1)


def numbers(ph, Q, expect, cfg):
    num, den = expect
    X = den * ph - num
    return [{"err_bits": log_err(max(abs(int(v)) for v in X[i]) // den)}
            for i in range(ph.shape[0])]

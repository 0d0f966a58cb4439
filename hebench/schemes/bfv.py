"""BFV: messages mod t, fresh encryptions (Delta m + e - a s, a) in the
coefficient domain with Delta = floor(Q / t), and the numbers the check
compares for each judged output:

  * err_bits: log2(1 + |e|), e = (t phase - Q m) / t taken centred mod Q,
    the phase's distance from Q m / t (decryption is exact while |e| <
    Q / 2t), the largest over every coefficient;
  * wrong_coeffs: coefficients whose decryption round(t phase / Q) mod t
    differs from the expected message; summed over the outputs.
"""

import numpy as np
import torch

from harness.arith import centered, log_err

NTT_FORM = False
AGGREGATE = {"err_bits": max, "wrong_coeffs": sum}


def messages(keys, batch):
    return keys.smp.integers(0, keys.cfg.plain_modulus, (batch, keys.cfg.n))


def encrypt(keys, m):
    """(B, n) messages -> (B, 2, L, n) fresh secret-key encryptions."""
    r, t = keys.ring, keys.cfg.plain_modulus
    a = keys.smp.uniform(r, (m.shape[0],))
    e = keys.smp.noise((m.shape[0], keys.cfg.n))
    delta = r.scalar([(r.modulus // t) % q for q in r.primes])
    body = r.add(r.mul(r.small(m), delta), r.small(e))
    return torch.stack([r.sub(body, r.negacyclic(a, r.small(keys.s))), a], dim=1)


def numbers(ph, Q, expect, cfg):
    t = cfg.plain_modulus
    m = expect.cpu().numpy().astype(object)
    X = centered(t * ph - Q * m, t * Q)
    dec = ((t * (ph % Q) + Q // 2) // Q) % t
    return [{"err_bits": log_err(max(abs(int(v)) for v in X[i]) // t),
             "wrong_coeffs": int(np.count_nonzero(dec[i] != m[i]))}
            for i in range(ph.shape[0])]

"""The correctness check: decrypt each sampled output with the benchmark's
own secret and hold it to the message the reference expects.

The phase c0 + c1 s is computed in plain arithmetic (arith.Ring) and lifted
to integers by CRT; nothing of the program is used.  The configuration's
scheme file (schemes/<scheme>.py) turns the phases and the expected
messages into the numbers compared, each with the limit of the workload's
file under limits/ (PERF.md gives the readings each was set from).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .arith import Ring


@dataclass
class Verdict:
    numbers: dict
    limits: dict
    judged: int
    failed: int

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in self.limits)


def phase(ring: Ring, s: torch.Tensor, s_ntt: torch.Tensor, cts: torch.Tensor,
          ntt_form: bool) -> np.ndarray:
    """(k, 2, L, n) ciphertexts -> (k, n) centred integers c0 + c1 s mod Q."""
    L = ring.q.shape[0]
    if ntt_form:
        p = ring.intt(ring.add(cts[:, 0], ring.mul(cts[:, 1], s_ntt[:L])))
    else:
        p = ring.add(cts[:, 0], ring.negacyclic(cts[:, 1], ring.small(s)))
    return ring.crt(p)


def judge(scheme, ring: Ring, keys, cts: torch.Tensor, expect, limits: dict) -> Verdict:
    """`scheme` is the configuration's scheme file; `keys` the benchmark's."""
    ph = phase(ring, keys.s, keys.s_ntt, cts, scheme.NTT_FORM)
    per_ct = scheme.numbers(ph, ring.modulus, expect, keys.cfg)
    numbers = {k: agg(c[k] for c in per_ct) for k, agg in scheme.AGGREGATE.items()}
    failed = sum(any(c[k] > limits[k] for k in limits if k in c) for c in per_ct)
    return Verdict(numbers, dict(limits), len(per_ct), failed)

"""Batched BFV operations on stacked tensors (counterpart of
troy_tpu/parallel/batched.py).

A batch of ciphertexts is one (B, size, L, n) int64 tensor and every op
broadcasts over the leading axis.
"""

from __future__ import annotations

import torch

from ..core.context import ContextData
from ..core.evaluator import Evaluator
from ..ops import poly as P


class BatchedEvaluator:
    """Operates on raw stacked ciphertext tensors (B, size, L, n) at one
    chain level, with the evaluator's lift."""

    def __init__(self, evaluator: Evaluator, cd: ContextData):
        self.ev = evaluator
        self.cd = cd
        # build the level's tables now, outside any timed step
        cd.qtab()
        cd.rns_tool
        if evaluator.context.using_keyswitching:
            evaluator._switch_tables(cd)

    def multiply(self, d1: torch.Tensor, d2: torch.Tensor | None = None) -> torch.Tensor:
        return self.ev.bfv_multiply_impl(self.cd, d1, d2)

    def relinearize(self, d3: torch.Tensor, rlk_key: torch.Tensor) -> torch.Tensor:
        """d3: (..., 3, L, n) -> (..., 2, L, n)."""
        sw = self.ev._switch_key_impl(self.cd, d3[..., 2, :, :], rlk_key)
        return P.add(d3[..., :2, :, :], sw, self.cd.qtab())

    def build_mul_relin_step(self, rlk_key: torch.Tensor):
        """Returns fn (d1, d2, keys) -> (..., 2, L, n): the flagship
        multiply + relinearize step."""

        def step(d1, d2, keys):
            return self.relinearize(self.multiply(d1, d2), keys)

        return step

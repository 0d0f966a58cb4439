"""Batched BFV operations on stacked tensors (counterpart of
troy_tpu/parallel/batched.py).

A batch of ciphertexts is one (B, size, L, n) int64 tensor and every op
broadcasts over the leading axis.  The step builders return plain functions
of tensors: multiply + relinearize, square + relinearize, Galois rotations
(one keyswitch round per Galois element) and the mod switch.
"""

from __future__ import annotations

import torch

from ..core.context import ContextData
from ..core.evaluator import Evaluator
from ..ops import poly as P
from ..ops.galois import GaloisTool
from ..utils.numth import naf


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

    def add(self, d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        return P.add(d1, d2, self.cd.qtab())

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

    def build_square_relin_step(self, rlk_key: torch.Tensor):
        """Returns fn (d, keys) -> (..., 2, L, n): square + relinearize."""

        def step(d, keys):
            return self.relinearize(self.multiply(d, None), keys)

        return step

    # -- galois rotations ----------------------------------------------------
    def galois_elements_for_steps(self, steps: int) -> list[int]:
        """Galois elements of rotate_rows(steps), one per keyswitch round: a
        positive power of two directly, anything else split by NAF, as the
        object API does (ref: evaluator_keyswitching.cu:276-292)."""
        if steps == 0:
            raise ValueError("[BatchedEvaluator] rotation step must be nonzero")
        n = self.cd.parms.poly_modulus_degree
        comps = [steps] if steps > 0 and steps & (steps - 1) == 0 else naf(steps)
        return [GaloisTool.get_element_from_step(s, n) for s in comps]

    def build_galois_step(self, elts: list[int]):
        """Returns fn (d, keys) -> d applying the Galois elements in turn;
        keys is a tuple of per-element switching keys (glk.key(elt))."""
        tool = GaloisTool.for_context(self.cd)
        for elt in elts:  # build the permutation tables outside the step
            tool.coeff_table(elt)

        def step(d, keys):
            for elt, k in zip(elts, keys):
                d = self.ev._apply_galois_impl(self.cd, d, k, elt, ntt_form=False)
            return d

        return step

    def build_rotate_rows_step(self, steps: int):
        """(step, elts): batched rotate_rows(steps); pass
        keys = tuple(glk.key(e) for e in elts)."""
        elts = self.galois_elements_for_steps(steps)
        return self.build_galois_step(elts), elts

    def build_rotate_columns_step(self):
        """(step, elts): batched rotate_columns, the conjugation element."""
        elts = [GaloisTool.conjugate_element(self.cd.parms.poly_modulus_degree)]
        return self.build_galois_step(elts), elts

    # -- mod switch ------------------------------------------------------------
    def build_mod_switch_step(self):
        """Returns fn d -> d at the next level: divide and round by the last
        prime (ref: evaluator_modswitch.cu:14)."""
        if self.cd.is_last():
            raise ValueError("[BatchedEvaluator.build_mod_switch_step] last level")
        return self.cd.rns_tool.divide_and_round_q_last

"""Batched BFV, CKKS and BGV operations on stacked tensors (counterpart of
troy_tpu/parallel/batched.py).

A batch of ciphertexts is one (B, size, L, n) int64 tensor and every op
broadcasts over the leading axis.  The step builders return plain functions
of tensors: multiply + relinearize, square + relinearize, Galois rotations
(one keyswitch round per Galois element), the mod switch and the CKKS
rescale.  CKKS and BGV steps stay in the NTT domain: the multiply is the
dyadic product, relinearization and the Galois rounds keyswitch with
NTT-form output; the CKKS mod switch drops the last limb, the BGV one
divides by it keeping the payload mod t.  Scales, correction factors and
levels are the object API's concern; the steps return raw residues.
"""

from __future__ import annotations

import torch

from ..core.context import ContextData
from ..core.evaluator import Evaluator
from ..core.params import SchemeType
from ..ops import dyadic as D, ntt as NTT, poly as P
from ..ops.galois import GaloisTool
from ..utils.numth import naf


class BatchedEvaluator:
    """Operates on raw stacked ciphertext tensors (B, size, L, n) at one
    chain level, with the evaluator's lift (BFV)."""

    def __init__(self, evaluator: Evaluator, cd: ContextData):
        self.ev = evaluator
        self.cd = cd
        self.ntt_form = cd.parms.scheme in (SchemeType.CKKS, SchemeType.BGV)
        # build the level's tables now, outside any timed step
        cd.qtab()
        cd.rns_tool
        if evaluator.context.using_keyswitching:
            evaluator._switch_tables(cd)

    def add(self, d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        return P.add(d1, d2, self.cd.qtab())

    def multiply(self, d1: torch.Tensor, d2: torch.Tensor | None = None) -> torch.Tensor:
        if self.ntt_form:
            qtab = self.cd.qtab()
            return (D.dyadic_square(d1, qtab) if d2 is None
                    else D.dyadic_convolute(d1, d2, qtab))
        return self.ev.bfv_multiply_impl(self.cd, d1, d2)

    def relinearize(self, d3: torch.Tensor, rlk_key: torch.Tensor) -> torch.Tensor:
        """d3: (..., 3, L, n) -> (..., 2, L, n), in d3's domain."""
        qtab = self.cd.qtab()
        target = d3[..., 2, :, :]
        if self.ntt_form:
            target = NTT.ntt_inverse(target.contiguous(), qtab)
        sw = self.ev._switch_key_impl(self.cd, target, rlk_key, out_ntt=self.ntt_form)
        return P.add(d3[..., :2, :, :], sw, qtab)

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
            if self.ntt_form:
                tool.ntt_table(elt)
            else:
                tool.coeff_table(elt)

        def step(d, keys):
            for elt, k in zip(elts, keys):
                d = self.ev._apply_galois_impl(self.cd, d, k, elt, ntt_form=self.ntt_form)
            return d

        return step

    def build_rotate_rows_step(self, steps: int):
        """(step, elts): batched rotate_rows(steps) (BFV, BGV) or
        rotate_vector(steps) (CKKS); pass keys = tuple(glk.key(e) for e in elts)."""
        elts = self.galois_elements_for_steps(steps)
        return self.build_galois_step(elts), elts

    def build_rotate_columns_step(self):
        """(step, elts): batched rotate_columns / complex_conjugate, the
        conjugation element."""
        elts = [GaloisTool.conjugate_element(self.cd.parms.poly_modulus_degree)]
        return self.build_galois_step(elts), elts

    # -- mod switch / rescale ---------------------------------------------------
    def build_rescale_step(self):
        """Returns fn d -> d at the next level: the CKKS divide and round by
        the last prime in the NTT domain (ref: evaluator_modswitch.cu:445)."""
        if self.cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("[BatchedEvaluator.build_rescale_step] CKKS only")
        if self.cd.is_last():
            raise ValueError("[BatchedEvaluator.build_rescale_step] last level")
        cd, qtab = self.cd, self.cd.qtab()
        return lambda d: cd.rns_tool.divide_and_round_q_last_ntt(d, qtab)

    def build_mod_switch_step(self):
        """Returns fn d -> d at the next level (ref: evaluator_modswitch.cu:14):
        BFV divides and rounds by the last prime, CKKS drops the last limb,
        BGV divides by it keeping the payload mod t (the correction factor's
        q_last^-1 stays with the object API)."""
        if self.cd.is_last():
            raise ValueError("[BatchedEvaluator.build_mod_switch_step] last level")
        scheme, cd = self.cd.parms.scheme, self.cd
        if scheme == SchemeType.CKKS:
            return lambda d: d[..., :-1, :]
        if scheme == SchemeType.BGV:
            qtab = cd.qtab()
            return lambda d: cd.rns_tool.mod_t_and_divide_q_last_ntt(d, qtab)
        return cd.rns_tool.divide_and_round_q_last

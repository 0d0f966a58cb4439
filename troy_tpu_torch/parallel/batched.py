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

BatchedClient builds the client's steps on the same layout: a batch of
encryptions under the public or the secret key, a batch decrypt, and the
BFV/BGV batch encode and decode (an NTT mod t).
"""

from __future__ import annotations

import torch

from ..core.context import ContextData, HeContext
from ..core.encryptor import Encryptor
from ..core.evaluator import Evaluator
from ..core.ciphertext import Ciphertext
from ..core.params import SchemeType
from ..core.rlwe import _asymmetric_combine, _symmetric_combine
from ..ops import poly as P, rp as R, u32 as U
from ..ops.galois import GaloisTool
from ..utils.numth import naf
from ..utils.random import (cbd_from_keys, fold_in_keys, ternary_from_keys,
                            uniform_from_keys)


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

    @staticmethod
    def stack(cts: list[Ciphertext]) -> torch.Tensor:
        """Ciphertexts of one level -> their (B, size, L, n) stack."""
        return torch.stack([ct.data for ct in cts])

    def unstack(self, data: torch.Tensor, proto: Ciphertext) -> list[Ciphertext]:
        """A (B, size, L, n) stack -> B ciphertexts with proto's metadata and
        no seed."""
        out = []
        for i in range(data.shape[0]):
            ct = proto.clone()
            ct.data = data[i]
            out.append(ct)
        return out

    def add(self, d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        return P.add(d1, d2, self.cd.qtab())

    def multiply(self, d1: torch.Tensor, d2: torch.Tensor | None = None) -> torch.Tensor:
        if self.ntt_form:
            qtab = self.cd.qtab()
            return (R.dyadic_square(d1, qtab) if d2 is None
                    else R.dyadic_convolute(d1, d2, qtab))
        return self.ev.bfv_multiply_impl(self.cd, d1, d2)

    def relinearize(self, d3: torch.Tensor, rlk_key: torch.Tensor) -> torch.Tensor:
        """d3: (..., 3, L, n) -> (..., 2, L, n), in d3's domain."""
        qtab = self.cd.qtab()
        target = d3[..., 2, :, :]
        if self.ntt_form:
            target = R.ntt_inverse(target.contiguous(), qtab)
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


class BatchedClient:
    """The client's operations as step functions on stacked (B, ...)
    tensors (counterpart of troy_tpu/parallel/batched.py:210-375; ref:
    test/bench/he_operations.cu:15-50, rlwe.cu, batch_encoder.cu:169-228).

    An encrypt step draws fresh randomness each call by folding a probe of
    the chained state (its first word, read on the device: no host sync)
    into the threefry base keys, then the counters 0, 1, 2 of that key pair,
    as the JAX package's step does: so a chain of steps times fresh
    encryptions and equals the JAX package's chain bit for bit."""

    def __init__(self, context: HeContext, cd: ContextData):
        self.context = context
        self.cd = cd
        self.ntt_form = cd.parms.scheme in (SchemeType.CKKS, SchemeType.BGV)
        # build the level's tables now, outside any timed step
        cd.qtab()
        if cd.parms.scheme != SchemeType.CKKS:
            cd.rns_tool
            cd.scaler

    def _probe(self, cur: torch.Tensor) -> torch.Tensor:
        """One 32-bit word of the chained state, a 0-d device tensor: the
        first residue, or at the wide width its high word (the first word of
        the JAX package's (hi, lo) layout)."""
        p = cur.reshape(-1)[0]
        return p >> 32 if self.cd.wide else p

    def _noise(self, keys, shape_n) -> torch.Tensor:
        e = cbd_from_keys(keys, shape_n, self.cd.qtab())
        if self.cd.parms.scheme == SchemeType.BGV:
            e = R.multiply_scalar(e, self.cd.parms.plain_modulus.value, self.cd.qtab())
        return e

    def _payload(self, plain_data, plain_ntt: bool, is_rns: bool):
        return (None if plain_data is None
                else Encryptor.plain_payload(self.cd, plain_data, 1, is_rns, plain_ntt))

    def _add_payload(self, out: torch.Tensor, m) -> torch.Tensor:
        if m is None:
            return out
        return torch.stack([P.add(out[:, 0], m, self.cd.qtab()), out[:, 1]], dim=1)

    def build_encrypt_asymmetric_step(self, base_keys, plain_data=None,
                                      plain_ntt: bool = False, is_rns: bool = False):
        """Returns fn (cur, pk_data) -> (B, 2, L, n): B = cur.shape[0] fresh
        encryptions under the public key of plain_data (or of zero)."""
        n = self.cd.parms.poly_modulus_degree
        m = self._payload(plain_data, plain_ntt, is_rns)

        def step(cur, pk):
            B = cur.shape[0]
            kc = fold_in_keys(base_keys, self._probe(cur))
            u = ternary_from_keys(fold_in_keys(kc, 0), (B, n), self.cd.qtab())
            e0 = self._noise(fold_in_keys(kc, 1), (B, n))
            e1 = self._noise(fold_in_keys(kc, 2), (B, n))
            out = _asymmetric_combine(self.cd, pk, u, e0, e1, self.ntt_form)
            return self._add_payload(out.transpose(0, 1), m)

        return step

    def build_encrypt_symmetric_step(self, base_keys, plain_data=None,
                                     plain_ntt: bool = False, is_rns: bool = False):
        """Returns fn (cur, sk_data) -> (B, 2, L, n): fresh encryptions under
        the secret key."""
        L, n = self.cd.coeff_modulus_size, self.cd.parms.poly_modulus_degree
        m = self._payload(plain_data, plain_ntt, is_rns)

        def step(cur, sk):
            B = cur.shape[0]
            kc = fold_in_keys(base_keys, self._probe(cur))
            a = uniform_from_keys(fold_in_keys(kc, 0), (B, L, n), self.cd.qtab())
            e = self._noise(fold_in_keys(kc, 1), (B, n))
            out = _symmetric_combine(self.cd, sk, a, e, self.ntt_form)
            return self._add_payload(out.transpose(0, 1), m)

        return step

    def build_decrypt_step(self, sk_pows, size: int = 2, inv_cf: int = 1):
        """Returns fn cur -> plaintexts: cur (B, size, L, n) at this level,
        sk_pows [s, s^2, ...] at the key level.  BFV and BGV give (B, n)
        mod t (BGV times inv_cf), CKKS the (B, L, n) NTT-form phase."""
        cd, qtab = self.cd, self.cd.qtab()
        L = cd.coeff_modulus_size
        scheme = cd.parms.scheme

        def phase(cur):
            if self.ntt_form:
                acc = cur[:, 0]
                for i in range(1, size):
                    acc = P.add(acc, R.dyadic_product(cur[:, i], sk_pows[i - 1][..., :L, :],
                                                      qtab), qtab)
                return acc
            acc = None
            for i in range(1, size):
                term = R.dyadic_product(R.ntt_forward(cur[:, i].contiguous(), qtab),
                                        sk_pows[i - 1][..., :L, :], qtab)
                acc = term if acc is None else P.add(acc, term, qtab)
            return P.add(R.ntt_inverse(acc, qtab), cur[:, 0], qtab)

        if scheme == SchemeType.BFV:
            return lambda cur: cd.rns_tool.decrypt_scale_and_round(phase(cur))
        if scheme == SchemeType.CKKS:
            return phase
        t = cd.parms.plain_modulus.value

        def bgv_step(cur):
            m = cd.rns_tool.decrypt_mod_t(R.ntt_inverse(phase(cur), qtab))
            return U.mul_mod(m, inv_cf, t)

        return bgv_step

    @staticmethod
    def build_batch_encode_step(encoder):
        """Returns fn vals -> coefficients: (B, n) slot values mod t to the
        (B, n) coefficients, the slots scattered to their NTT positions and
        an inverse NTT mod t (ref: batch_encoder.cu:169)."""
        pos = encoder._slot_to_pos

        def step(vals):
            slots = torch.zeros_like(vals)
            slots[..., pos] = vals
            return R.ntt_inverse(slots[..., None, :], encoder.tables)[..., 0, :]

        return step

    @staticmethod
    def build_batch_decode_step(encoder):
        """Returns fn coeffs -> slot values: the forward NTT mod t, then the
        gather."""
        pos = encoder._slot_to_pos

        def step(coeffs):
            return R.ntt_forward(coeffs[..., None, :].contiguous(),
                                   encoder.tables)[..., 0, :][..., pos]

        return step

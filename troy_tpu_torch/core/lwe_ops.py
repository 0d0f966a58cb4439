"""LWE extraction and packing, mixed into the Evaluator (counterpart of
troy_tpu/core/lwe_ops.py): coefficient extraction to LWE samples,
re-assembly into RLWE, the field trace, and the Chen-Dai-Kim-Song (2020)
PackLWEs tree that merges up to n LWE ciphertexts into one RLWE ciphertext.

One merge level j uses sigma_g with g = 2^j + 1, the identity on the
coefficients that are multiples of n/2^(j-1) and a negation on those
congruent to n/2^j, so (c_e + x^(n/2^j) c_o) + sigma(c_e - x^(n/2^j) c_o)
doubles both payload sets while cancelling each other's garbage there.
After packing 2^l inputs the remaining field trace (levels j > l) zeroes
every coefficient that is not a multiple of n/2^l; the combined factor n is
divided out before the merge (divide_by_poly_modulus_degree), so the
surviving noise is the extraction's own.

Every Galois round is the evaluator's keyswitch, whose NTTs go through the
ops/ntt.py dispatch (the NTT kernel on the card).  The batched packers stack
G groups in front of the poly axis, (G, 2, L, n), the port's batched layout:
each merge round runs once for all groups.

Automorphism keys needed: the elements 2^j + 1, 1 <= j <= log2 n
(KeyGenerator.create_automorphism_keys).
"""

from __future__ import annotations

import torch

from .params import SchemeType
from .ciphertext import Ciphertext
from .lwe import LWECiphertext
from .keys import GaloisKeys
from ..ops import rp as R, u32 as U
from ..utils import numth


class LweOpsMixin:
    """Mixed into Evaluator (uses self.context, self._cd and its operations)."""

    # ------------------------------------------------------------------
    def extract_lwe(self, ct: Ciphertext, term: int) -> LWECiphertext:
        """Coefficient `term` of a size-2 ciphertext as an LWE sample
        (ref: evaluator_lwes.cu extract_lwe_new)."""
        if ct.size != 2:
            raise ValueError("[Evaluator.extract_lwe] needs size-2 ct")
        cd = self._cd(ct)
        n = cd.parms.poly_modulus_degree
        work = self.transform_from_ntt(ct) if ct.is_ntt_form else ct
        q = cd.qtab().q.view(-1, 1)
        c0 = work.data[0, :, term]
        # a_i = c1[(term - i) mod n], negated where i > term
        i = torch.arange(n, device=cd.device)
        gathered = work.data[1].index_select(-1, (term - i) % n)
        a = torch.where(i > term, U.neg_mod(gathered, q), gathered)
        return LWECiphertext(c0, a, ct.parms_id, ct.scale, ct.correction_factor)

    def _assemble(self, c0s: torch.Tensor, c1s: torch.Tensor, cd) -> torch.Tensor:
        """(..., L) scalars and (..., L, n) masks -> (..., 2, L, n): c0 the
        scalar at coefficient 0, c1 = (a_0, -a_{n-1}, ..., -a_1)."""
        n = c1s.shape[-1]
        q = cd.qtab().q.view(-1, 1)
        c0 = torch.zeros_like(c1s)
        c0[..., 0] = c0s
        rolled = torch.roll(torch.flip(c1s, dims=(-1,)), 1, dims=-1)
        c1 = torch.where(torch.arange(n, device=c1s.device) > 0, U.neg_mod(rolled, q), rolled)
        return torch.stack([c0, c1], dim=-3)

    def assemble_lwe(self, lwe: LWECiphertext) -> Ciphertext:
        """RLWE ciphertext whose constant coefficient carries the LWE payload
        (ref: lwe_ciphertext.h assemble_lwe), in coefficient form for every
        scheme."""
        cd = self.context.get_context_data(lwe.parms_id)
        return Ciphertext(self._assemble(lwe.c0, lwe.c1, cd), lwe.parms_id, is_ntt_form=False,
                          scale=lwe.scale, correction_factor=lwe.correction_factor)

    def _assemble_lwe_stack(self, lwes: list[LWECiphertext]) -> torch.Tensor:
        """M LWE samples assembled in one batched computation -> (M, 2, L, n)."""
        cd = self.context.get_context_data(lwes[0].parms_id)
        return self._assemble(torch.stack([l.c0 for l in lwes]),
                              torch.stack([l.c1 for l in lwes]), cd)

    # ------------------------------------------------------------------
    def field_trace(self, ct: Ciphertext, glk: GaloisKeys, logn_stop: int = 0) -> Ciphertext:
        """(1 + sigma_{2^j+1}) for j = log n down to logn_stop + 1: zeroes
        every coefficient that is not a multiple of n / 2^logn_stop
        (ref: evaluator_lwes.cu field_trace_inplace)."""
        out = ct
        for j in range(self._cd(ct).log_n, logn_stop, -1):
            out = self.add(out, self.apply_galois(out, (1 << j) + 1, glk))
        return out

    def divide_by_poly_modulus_degree(self, ct: Ciphertext,
                                      factor: int | None = None) -> Ciphertext:
        """ct times factor^-1 mod q_i per limb, factor defaulting to n."""
        cd = self._cd(ct)
        k = cd.parms.poly_modulus_degree if factor is None else factor
        cache = getattr(cd, "_inverse_factors", None)
        if cache is None:
            cache = cd._inverse_factors = {}
        if k not in cache:
            cache[k] = torch.tensor([numth.invert_mod(k, q) for q in cd.base_q.values],
                                    dtype=torch.int64, device=cd.device).view(-1, 1)
        out = ct.clone()
        out.data = R.mul_mod(ct.data, cache[k], cd.qtab())
        return out

    # ------------------------------------------------------------------
    def pack_lwe_ciphertexts(self, lwes: list[LWECiphertext],
                             glk: GaloisKeys) -> Ciphertext:
        """Merge up to n LWE samples into one RLWE ciphertext whose
        coefficient i (n / 2^l) holds payload i, 2^l >= len(lwes)
        (ref: evaluator_lwes.cu pack_lwe_ciphertexts)."""
        if not lwes:
            raise ValueError("[Evaluator.pack_lwe_ciphertexts] empty input")
        n = self.context.get_context_data(lwes[0].parms_id).parms.poly_modulus_degree
        m = len(lwes)
        ell = max(1, (m - 1).bit_length()) if m > 1 else 0
        if (1 << ell) > n:
            raise ValueError("[Evaluator.pack_lwe_ciphertexts] too many LWEs")
        return self.pack_rlwe_ciphertexts([self.assemble_lwe(lwe) for lwe in lwes],
                                          glk, 0, n, n >> ell)

    def pack_rlwe_ciphertexts(self, ciphers: list[Ciphertext | None], glk: GaloisKeys,
                              shift: int, input_interval: int, output_interval: int,
                              apply_field_trace: bool = True) -> Ciphertext:
        """Interleave up to input_interval / output_interval RLWE ciphertexts
        whose payload coefficients sit at stride input_interval (after the
        inherent `shift`) into one ciphertext with payload stride
        output_interval (ref: evaluator_lwes.cu pack_rlwe_ciphertexts).

        Each input is divided by input_interval first: the merge tree
        (x input_interval / output_interval) and the trailing field trace
        (x output_interval) multiply each surviving coefficient by exactly
        input_interval.  The inputs are placed in bit-reversed order; CKKS
        and BGV results return to the NTT form before the trace."""
        live = [c for c in ciphers if c is not None]
        if not live:
            raise ValueError("[Evaluator.pack_rlwe_ciphertexts] empty input")
        cd = self._cd(live[0])
        n = cd.parms.poly_modulus_degree
        if input_interval & (input_interval - 1) or output_interval & (output_interval - 1):
            raise ValueError("[Evaluator.pack_rlwe_ciphertexts] intervals must be powers of 2")
        m_max = input_interval // output_interval
        if len(ciphers) > m_max:
            raise ValueError("[Evaluator.pack_rlwe_ciphertexts] too many ciphertexts")
        layers = m_max.bit_length() - 1
        ntt_form = cd.parms.scheme in (SchemeType.CKKS, SchemeType.BGV)

        def prepare(ct: Ciphertext | None) -> Ciphertext | None:
            if ct is None:
                return None
            if ct.is_ntt_form:
                ct = self.transform_from_ntt(ct)
            ct = self.divide_by_poly_modulus_degree(ct, input_interval)
            return self.negacyclic_shift(ct, shift) if shift else ct

        padded = list(ciphers) + [None] * (m_max - len(ciphers))
        arranged: list[Ciphertext | None] = [None] * m_max
        for k in range(m_max):
            arranged[numth.reverse_bits(k, layers) if layers else 0] = prepare(padded[k])

        def merge(sub: list, j: int) -> Ciphertext | None:
            if len(sub) == 1:
                return sub[0]
            half = len(sub) // 2
            c_e, c_o = merge(sub[:half], j - 1), merge(sub[half:], j - 1)
            if c_e is None and c_o is None:
                return None
            g = (n // input_interval) * (1 << j) + 1
            if c_o is None:
                return self.add(c_e, self.apply_galois(c_e, g, glk))
            shifted = self.negacyclic_shift(c_o, input_interval >> j)
            if c_e is None:
                return self.sub(shifted, self.apply_galois(shifted, g, glk))
            s, d = self.add(c_e, shifted), self.sub(c_e, shifted)
            return self.add(s, self.apply_galois(d, g, glk))

        ret = merge(arranged, layers)
        if ntt_form:
            ret = self.transform_to_ntt(ret)
        if output_interval != 1 and apply_field_trace:
            ret = self.field_trace(ret, glk, (n // output_interval).bit_length() - 1)
        return ret

    # ------------------------------------------------------------------
    def pack_rlwe_ciphertexts_batched(
            self, groups: list[list[Ciphertext | None]], glk: GaloisKeys, shift: int,
            input_interval: int, output_interval: int, apply_field_trace: bool = True,
            mesh=None) -> list[Ciphertext]:
        """Pack G groups at once: the same merge tree runs once on
        group-stacked (G, 2, L, n) ciphertexts, so every round is one
        batched gather and keyswitch for all groups (ref: evaluator_lwes.cu
        pack_lwe_ciphertexts_batched, at the RLWE layer).  Missing slots
        (None, ragged groups) pack as zero ciphertexts.  The JAX package's
        mesh= sharding is not ported."""
        if mesh is not None:
            raise NotImplementedError("[Evaluator.pack_rlwe_ciphertexts_batched] mesh= "
                                      "sharding is not ported")
        if not groups:
            raise ValueError("[Evaluator.pack_rlwe_ciphertexts_batched] empty")
        if len(groups) == 1:
            return [self.pack_rlwe_ciphertexts(groups[0], glk, shift, input_interval,
                                               output_interval, apply_field_trace)]
        proto = next((c for g in groups for c in g if c is not None), None)
        if proto is None:
            raise ValueError("[Evaluator.pack_rlwe_ciphertexts_batched] empty input")
        for g in groups:
            for c in g:
                if c is not None and (c.parms_id != proto.parms_id
                                      or c.is_ntt_form != proto.is_ntt_form
                                      or c.size != proto.size):
                    raise ValueError("[Evaluator.pack_rlwe_ciphertexts_batched] "
                                     "ciphertexts must be uniform")
        zero = torch.zeros_like(proto.data)
        positions = []
        for k in range(max(len(g) for g in groups)):
            v = proto.clone()
            v.data = torch.stack([g[k].data if k < len(g) and g[k] is not None else zero
                                  for g in groups])              # (G, 2, L, n)
            positions.append(v)
        packed = self.pack_rlwe_ciphertexts(positions, glk, shift, input_interval,
                                            output_interval, apply_field_trace)
        outs = []
        for gi in range(len(groups)):
            o = packed.clone()
            o.data = packed.data[gi]
            outs.append(o)
        return outs

    def pack_lwe_ciphertexts_batched(self, groups: list[list[LWECiphertext]],
                                     glk: GaloisKeys) -> list[Ciphertext]:
        """Batched PackLWEs: G groups of up to n LWE samples -> G RLWE
        ciphertexts, the assembly and the whole merge and trace tree run as
        batched operations."""
        if not groups or any(not g for g in groups):
            raise ValueError("[Evaluator.pack_lwe_ciphertexts_batched] empty input")
        n = self.context.get_context_data(groups[0][0].parms_id).parms.poly_modulus_degree
        m = max(len(g) for g in groups)
        ell = max(1, (m - 1).bit_length()) if m > 1 else 0
        if (1 << ell) > n:
            raise ValueError("[Evaluator.pack_lwe_ciphertexts_batched] too many LWEs")
        flat = [l for g in groups for l in g]
        datas = self._assemble_lwe_stack(flat)                   # (M, 2, L, n)
        cts, off = [], 0
        for g in groups:
            cts.append([Ciphertext(datas[off + i], flat[0].parms_id, is_ntt_form=False,
                                   scale=flat[0].scale,
                                   correction_factor=flat[0].correction_factor)
                        for i in range(len(g))])
            off += len(g)
        return self.pack_rlwe_ciphertexts_batched(cts, glk, 0, n, max(1, n >> ell))

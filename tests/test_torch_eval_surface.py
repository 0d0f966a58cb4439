"""The rest of the port's evaluator surface against the JAX package, bit for
bit, for BFV, CKKS and BGV: the plaintext transforms, Galois maps and mod
switches, multiply_plain_accumulate and multiply_plain_contract, translate,
exponentiate, negacyclic_shift, the explicit-form plaintext products and the
whole *_batched family.

Each scheme's pair is keyed by RandomGenerator(seed, mode="aes") streams in
both packages (BFV and BGV through test_torch_bgv.BothBGV, CKKS through
test_torch_ckks.BothCKKS, all at n = 1024 on 4 x 30-bit primes), so the
ciphertexts the operations start from are equal too; every result must give
the same residues, level, form, scale and correction factor.  CKKS is held
with tolerance 0 like the others: none of these operations has a float
path."""

import numpy as np
import pytest

from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.core.keygen import KeyGenerator as JKeyGen
from troy_tpu.core.lwe_ops import LweOpsMixin
from troy_tpu.ops.galois import GaloisTool as JGalois
from troy_tpu.utils.random import RandomGenerator as JRandom
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.lwe_ops import LweOpsMixin as TLweOpsMixin
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_bgv import BothBGV
from .test_torch_ckks import BothCKKS, SCALE
from .test_torch_client import same

N = 1024
SCHEMES = ["BFV", "CKKS", "BGV"]
RNG = np.random.default_rng(23)


def same_ct(jct, ct):
    same(jct.data, ct.data)
    assert ct.parms_id == jct.parms_id and ct.is_ntt_form == bool(jct.is_ntt_form)
    assert ct.scale == jct.scale and ct.correction_factor == jct.correction_factor


def same_cts(jcts, cts):
    assert len(jcts) == len(cts)
    for j, t in zip(jcts, cts):
        same_ct(j, t)


def same_pt(jpt, pt):
    same(jpt.data, pt.data)
    assert pt.parms_id == jpt.parms_id and pt.is_ntt_form == bool(jpt.is_ntt_form)
    assert pt.scale == jpt.scale


class Scheme:
    """One scheme's pair of packages, three symmetric encryptions, relin,
    Galois and keyswitching keys, and plaintext pairs."""

    def __init__(self, scheme: str):
        self.scheme = scheme
        self.both = both = BothCKKS() if scheme == "CKKS" else BothBGV(scheme=scheme)
        (jpk, pk), (self.jrlk, self.rlk), (self.jglk, self.glk), _ = both.keys()
        seed = 0x5EC
        jnew = JKeyGen(both.jc, prng=JRandom(seed, mode="aes", domain="new")).secret_key
        new = KeyGenerator(both.tc, prng=RandomGenerator(seed, "aes", "new")).secret_key
        self.jksk = both.jkg.create_keyswitching_key(jnew)
        self.ksk = both.kg.create_keyswitching_key(new)
        same(self.jksk.get(0), self.ksk.get(0))
        jencr, encr = both.encryptors(jpk, pk)
        self.cts = []
        for _ in range(3):
            jpt, pt = self.plains()
            self.cts.append((jencr.encrypt_symmetric(jpt), encr.encrypt_symmetric(pt)))
        for j, t in self.cts:
            same_ct(j, t)
        self.jev, self.ev = both.jev, both.ev

    def plains(self):
        """A fresh plaintext pair: mod t for BFV and BGV, NTT-form CKKS at
        scale 2^25 on the first level."""
        b = self.both
        if self.scheme == "CKKS":
            v = RNG.uniform(-1, 1, N // 2) + 1j * RNG.uniform(-1, 1, N // 2)
            jpt, pt = b.jenc.encode(v, scale=SCALE), b.enc.encode(v, scale=SCALE)
        else:
            m = RNG.integers(0, b.t, size=N, dtype=np.uint64)
            jpt, pt = b.jenc.encode(m), b.enc.encode(m)
        same_pt(jpt, pt)
        return jpt, pt

    def ntt_plains(self):
        """An NTT-form RNS plaintext pair at the first level."""
        jpt, pt = self.plains()
        if self.scheme == "CKKS":
            return jpt, pt
        pid = self.both.jc.first_parms_id
        return (self.jev.transform_plain_to_ntt(jpt, pid),
                self.ev.transform_plain_to_ntt(pt, pid))

    def lists(self, k: int = 3):
        return [j for j, _ in self.cts[:k]], [t for _, t in self.cts[:k]]


@pytest.fixture(scope="module", params=SCHEMES)
def S(request):
    return Scheme(request.param)


def test_plain_transforms_and_galois_plain(S):
    jn, tn = S.ntt_plains()
    jc, tc = S.jev.transform_plain_from_ntt(jn), S.ev.transform_plain_from_ntt(tn)
    same_pt(jc, tc)
    with pytest.raises(ValueError, match="not NTT form"):
        S.ev.transform_plain_from_ntt(tc)
    elt = JGalois.get_element_from_step(3, N)
    cases = [(jn, tn), (jc, tc)]
    if S.scheme != "CKKS":
        cases.append(S.plains())  # mod t: the permutation with sign mod t
    for jp, tp in cases:
        same_pt(S.jev.apply_galois_plain(jp, elt), S.ev.apply_galois_plain(tp, elt))
    pid = S.both.jc.first_parms_id
    jps, tps = zip(*[S.plains() for _ in range(2)])
    if S.scheme == "CKKS":
        jps = [S.jev.transform_plain_from_ntt(p) for p in jps]
        tps = [S.ev.transform_plain_from_ntt(p) for p in tps]
    jto = S.jev.transform_plain_to_ntt_batched(list(jps), pid)
    tto = S.ev.transform_plain_to_ntt_batched(list(tps), pid)
    for j, t in zip(jto, tto):
        same_pt(j, t)
    for j, t in zip(S.jev.transform_plain_from_ntt_batched(jto),
                    S.ev.transform_plain_from_ntt_batched(tto)):
        same_pt(j, t)


def test_plain_mod_switch(S):
    jn, tn = S.ntt_plains()
    last = S.both.jc.last_parms_id
    nxt = S.both.jc.first_context_data().next.parms_id
    same_pt(S.jev.mod_switch_plain_to(jn, last), S.ev.mod_switch_plain_to(tn, last))
    same_pt(S.jev.mod_switch_drop_to_plain(jn, nxt), S.ev.mod_switch_drop_to_plain(tn, nxt))
    with pytest.raises(ValueError, match="NTT form"):
        S.ev.mod_switch_drop_to_plain(S.ev.transform_plain_from_ntt(tn), nxt)
    low = S.ev.mod_switch_drop_to_plain(tn, last)
    with pytest.raises(ValueError, match="above"):
        S.ev.mod_switch_drop_to_plain(low, nxt)


def test_multiply_plain_accumulate_and_contract(S):
    jcts, tcts = S.lists(2)
    (jp1, tp1), (jp2, tp2) = S.plains(), S.plains()
    jacc, tacc = S.jev.multiply_plain(jcts[0], jp1), S.ev.multiply_plain(tcts[0], tp1)
    same_cts(S.jev.multiply_plain_accumulate(jcts, [jp1, jp2], [None, jacc]),
             S.ev.multiply_plain_accumulate(tcts, [tp1, tp2], [None, tacc]))
    jw, tw = zip(*[S.plains() for _ in range(4)])
    jgrid = [[jcts[0], jcts[1]], [jcts[1], jcts[0]]]
    tgrid = [[tcts[0], tcts[1]], [tcts[1], tcts[0]]]
    jout = S.jev.multiply_plain_contract(jgrid, [[jw[0], jw[1]], [jw[2], jw[3]]])
    tout = S.ev.multiply_plain_contract(tgrid, [[tw[0], tw[1]], [tw[2], tw[3]]])
    for jrow, trow in zip(jout, tout):
        same_cts(jrow, trow)
    # out[0][1] = ct0 w1 + ct1 w3, through the scalar ops
    want = S.ev.add(S.ev.multiply_plain(tcts[0], tw[1]), S.ev.multiply_plain(tcts[1], tw[3]))
    same(want.data, tout[0][1].data)
    with pytest.raises(NotImplementedError, match="mesh"):
        S.ev.multiply_plain_contract(tgrid, [[tw[0], tw[1]], [tw[2], tw[3]]], mesh=object())
    with pytest.raises(ValueError, match="inner dims"):
        S.ev.multiply_plain_contract(tgrid, [[tw[0], tw[1]]])


def test_translate_exponentiate_shift(S):
    (j1, t1), (j2, t2), _ = S.cts
    jp, tp = S.plains()
    for sub in (False, True):
        same_ct(S.jev.translate(j1, j2, sub), S.ev.translate(t1, t2, sub))
        same_ct(S.jev.translate_plain(j1, jp, sub), S.ev.translate_plain(t1, tp, sub))
    same_ct(S.jev.exponentiate(j1, 3, S.jrlk), S.ev.exponentiate(t1, 3, S.rlk))
    with pytest.raises(ValueError, match="power"):
        S.ev.exponentiate(t1, 0, S.rlk)
    other = (S.jev.transform_to_ntt(j1) if not j1.is_ntt_form
             else S.jev.transform_from_ntt(j1))
    for jct, tct in ((j1, t1), (other, S.both.port(other))):
        for shift in (5, N + 3):
            same_ct(S.jev.negacyclic_shift(jct, shift), S.ev.negacyclic_shift(tct, shift))


def test_batched_translate_and_products(S):
    jcts, tcts = S.lists()
    jrev, trev = jcts[::-1], tcts[::-1]
    if S.scheme == "BGV":  # one pair with unequal factors: balanced per element
        jrev[1], trev[1] = jrev[1].clone(), trev[1].clone()
        jrev[1].correction_factor = trev[1].correction_factor = 777
    same_cts(S.jev.add_batched(jcts, jrev), S.ev.add_batched(tcts, trev))
    same_cts(S.jev.sub_batched(jcts, jrev), S.ev.sub_batched(tcts, trev))
    same_cts(S.jev.translate_batched(jcts, jrev, True), S.ev.translate_batched(tcts, trev, True))
    same_cts(S.jev.negate_batched(jcts), S.ev.negate_batched(tcts))
    jprod, tprod = S.jev.multiply_batched(jcts, jrev), S.ev.multiply_batched(tcts, trev)
    same_cts(jprod, tprod)
    same_cts(S.jev.square_batched(jcts), S.ev.square_batched(tcts))
    same_cts(S.jev.relinearize_batched(jprod, S.jrlk),
             S.ev.relinearize_batched(tprod, S.rlk))
    jps, tps = zip(*[S.plains() for _ in range(3)])
    jns, tns = zip(*[S.ntt_plains() for _ in range(3)])
    if S.scheme != "CKKS":
        same_cts(S.jev.multiply_plain_normal_batched(jcts, list(jps)),
                 S.ev.multiply_plain_normal_batched(tcts, list(tps)))
        same_ct(S.jev.multiply_plain_normal(jcts[0], jps[0]),
                S.ev.multiply_plain_normal(tcts[0], tps[0]))
    same_cts(S.jev.multiply_plain_ntt_batched(jcts, list(jns)),
             S.ev.multiply_plain_ntt_batched(tcts, list(tns)))
    same_cts(S.jev.multiply_plain_batched(jcts, list(jns)),
             S.ev.multiply_plain_batched(tcts, list(tns)))
    same_ct(S.jev.multiply_plain_ntt(jcts[0], jns[0]), S.ev.multiply_plain_ntt(tcts[0], tns[0]))
    with pytest.raises(ValueError, match="must be NTT form"):
        S.ev.multiply_plain_ntt_batched(tcts, list(tps) if S.scheme != "CKKS" else
                                        [S.ev.transform_plain_from_ntt(p) for p in tns])
    with pytest.raises(ValueError, match="coefficient form"):
        S.ev.multiply_plain_normal(tcts[0], tns[0])


def test_batched_keyswitching(S):
    jcts, tcts = S.lists()
    elt = JGalois.get_element_from_step(1, N)
    same_cts(S.jev.apply_galois_batched(jcts, elt, S.jglk),
             S.ev.apply_galois_batched(tcts, elt, S.glk))
    rot = "rotate_vector_batched" if S.scheme == "CKKS" else "rotate_rows_batched"
    same_cts(getattr(S.jev, rot)(jcts, 3, S.jglk), getattr(S.ev, rot)(tcts, 3, S.glk))
    same_cts(S.jev.rotate_columns_batched(jcts, S.jglk),
             S.ev.rotate_columns_batched(tcts, S.glk))
    same_cts(S.jev.complex_conjugate_batched(jcts, S.jglk),
             S.ev.complex_conjugate_batched(tcts, S.glk))
    same_cts(S.jev.apply_keyswitching_batched(jcts, S.jksk),
             S.ev.apply_keyswitching_batched(tcts, S.ksk))
    same_ct(S.jev.apply_keyswitching(jcts[0], S.jksk), S.ev.apply_keyswitching(tcts[0], S.ksk))
    # row 0 of each batched form equals the object call
    same(S.ev.rotate_rows(tcts[0], 3, S.glk).data, getattr(S.ev, rot)(tcts, 3, S.glk)[0].data)
    with pytest.raises(KeyError, match="no Galois key"):
        S.ev.rotate_rows_batched(tcts, 2, S.glk)
    with pytest.raises(ValueError, match="size-2"):
        S.ev.apply_galois_batched(S.ev.multiply_batched(tcts, tcts), elt, S.glk)


def test_batched_transforms_and_mod_switch(S):
    jcts, tcts = S.lists()
    if jcts[0].is_ntt_form:
        jx, tx = S.jev.transform_from_ntt_batched(jcts), S.ev.transform_from_ntt_batched(tcts)
        same_cts(jx, tx)
        same_cts(S.jev.transform_to_ntt_batched(jx), S.ev.transform_to_ntt_batched(tx))
    else:
        jx, tx = S.jev.transform_to_ntt_batched(jcts), S.ev.transform_to_ntt_batched(tcts)
        same_cts(jx, tx)
        same_cts(S.jev.transform_from_ntt_batched(jx), S.ev.transform_from_ntt_batched(tx))
    with pytest.raises(ValueError, match="NTT form"):
        S.ev.transform_from_ntt_batched(tx) if not tx[0].is_ntt_form else \
            S.ev.transform_to_ntt_batched(tx)
    last = S.both.jc.last_parms_id
    nxt = S.both.jc.first_context_data().next.parms_id
    same_cts(S.jev.mod_switch_to_next_batched(jcts), S.ev.mod_switch_to_next_batched(tcts))
    same_cts(S.jev.mod_switch_to_batched(jcts, last), S.ev.mod_switch_to_batched(tcts, last))
    same_cts(S.jev.mod_switch_drop_to_batched(jcts, nxt),
             S.ev.mod_switch_drop_to_batched(tcts, nxt))
    same_cts(S.jev.negacyclic_shift_batched(jcts, 7), S.ev.negacyclic_shift_batched(tcts, 7))
    if S.scheme == "CKKS":
        same_cts(S.jev.rescale_to_next_batched(jcts), S.ev.rescale_to_next_batched(tcts))
        return
    pid = S.both.jc.first_parms_id
    jps, tps = zip(*[S.plains() for _ in range(2)])
    names = ["bfv_centralize_batched"]
    if S.scheme == "BFV":
        names.append("bfv_scale_up_batched")
    else:  # the JAX package's BGV contexts have no scaler
        with pytest.raises(ValueError, match="BFV only"):
            S.ev.bfv_scale_up_batched(list(tps), pid)
    for name in names:
        for j, t in zip(getattr(S.jev, name)(list(jps), pid), getattr(S.ev, name)(list(tps), pid)):
            same_pt(j, t)


def test_surface_and_aliases_match_jax():
    """Every public Evaluator name of the JAX package, its LWE mixin's
    included, is on the port, and no other; each *_new alias names the same
    operation as there."""
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(JEvaluator) == public(Evaluator)
    assert public(LweOpsMixin) == public(TLweOpsMixin) <= public(Evaluator)
    for name in public(Evaluator):
        jfn, tfn = getattr(JEvaluator, name), getattr(Evaluator, name)
        if "_new" in name or name in ("complex_conjugate_batched", "translate_batched"):
            assert jfn.__name__.lstrip("_") == tfn.__name__.lstrip("_"), name

"""The port's LWE slice (troy_tpu_torch/core/lwe.py, core/lwe_ops.py,
KeyGenerator.create_automorphism_keys, the BatchEncoder's polynomial and RNS
forms, Ciphertext.size on stacked data, interop.lwe_ciphertext) against the
JAX package, bit for bit, for BFV, CKKS and BGV.

Pair holds the same parameters in both packages (n = 32 on 3 x 30-bit
primes, the last special, as tests/core/test_lwe.py; t =
PlainModulus.batching(n, 20) for BFV and BGV) and draws every key and
encryption from RandomGenerator(seed, mode="aes") streams with the same
seed and domains, so the automorphism keys, the ciphertexts and every
extracted, assembled, traced and packed result must agree, with tolerance
0.  Decrypts are also held to the encrypted coefficients: exactly for BFV
and BGV, within 1e-3 for CKKS at scale 2^20 (its fresh noise is about 2^-14
there)."""

import numpy as np
import pytest
import torch

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                         SecurityLevel as JSec)
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.core.keygen import KeyGenerator as JKeyGen
from troy_tpu.core.encryptor import Encryptor as JEncryptor
from troy_tpu.core.decryptor import Decryptor as JDecryptor
from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.core.batch_encoder import BatchEncoder as JBatchEncoder
from troy_tpu.core.ckks_encoder import CKKSEncoder as JCKKSEncoder
from troy_tpu.utils.random import RandomGenerator as JRandom
from troy_tpu_torch import interop
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.core.plaintext import Plaintext
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_client import same

N, BITS, SEED, SCALE = 32, [30, 30, 30], 0x1E, 2.0 ** 20
SCHEMES = ["BFV", "CKKS", "BGV"]
CKKS_ATOL = 1e-3


class Pair:
    """One scheme's parameters in both packages, keyed by AES streams: the
    keygens (secret, public and automorphism keys), encryptors holding both
    keys, decryptors, evaluators and encoders (the BatchEncoder, or the
    CKKSEncoder at `scale`)."""

    def __init__(self, scheme: str, n: int = N, bits=BITS, seed: int = SEED,
                 scale: float = SCALE, log_t: int = 20):
        self.scheme, self.n, self.scale = scheme, n, scale
        self.ckks = scheme == "CKKS"
        jp = JParams(JScheme[scheme]).set_poly_modulus_degree(n)
        jp.set_coeff_modulus(JCoeff.create(n, bits))
        tp = EncryptionParameters(SchemeType[scheme]).set_poly_modulus_degree(n)
        tp.set_coeff_modulus(CoeffModulus.create(n, bits))
        if not self.ckks:
            jp.set_plain_modulus(JPlain.batching(n, log_t))
            tp.set_plain_modulus(PlainModulus.batching(n, log_t))
            self.t = jp.plain_modulus.value
        self.jc = JContext.create(jp, True, JSec.Nil, seed)
        self.tc = HeContext.create(tp, "cpu", SecurityLevel.Nil, seed=seed)
        self.jkg = JKeyGen(self.jc, prng=JRandom(seed, mode="aes", domain="keygen"))
        self.kg = KeyGenerator(self.tc, prng=RandomGenerator(seed, "aes", "keygen"))
        self.jpk, self.pk = self.jkg.create_public_key(), self.kg.create_public_key()
        self.jencr = JEncryptor(self.jc, pk=self.jpk, sk=self.jkg.secret_key,
                                prng=JRandom(seed, mode="aes", domain="encryptor"))
        self.encr = Encryptor(self.tc, sk=self.kg.secret_key, pk=self.pk,
                              prng=RandomGenerator(seed, "aes", "encryptor"))
        self.jdec = JDecryptor(self.jc, self.jkg.secret_key)
        self.dec = Decryptor(self.tc, self.kg.secret_key)
        self.jev, self.ev = JEvaluator(self.jc), Evaluator(self.tc)
        if self.ckks:
            self.jenc, self.enc = JCKKSEncoder(self.jc), CKKSEncoder(self.tc)
        else:
            self.jenc, self.enc = JBatchEncoder(self.jc), BatchEncoder(self.tc)

    def automorphism_keys(self):
        jglk, glk = self.jkg.create_automorphism_keys(), self.kg.create_automorphism_keys()
        assert sorted(glk.keys) == sorted(jglk.keys)
        for g in jglk.keys:
            same(jglk.keys[g], glk.keys[g])
        return jglk, glk

    def coefficients(self, rng, count=None) -> np.ndarray:
        k = count or self.n
        if self.ckks:
            return rng.uniform(-1, 1, k)
        return rng.integers(0, self.t, size=k, dtype=np.uint64)

    def encode(self, coeffs):
        """A coefficient-encoded plaintext pair."""
        if self.ckks:
            return (self.jenc.encode_float64_polynomial(coeffs, scale=self.scale),
                    self.enc.encode_float64_polynomial(coeffs, scale=self.scale))
        return self.jenc.encode_polynomial(coeffs), self.enc.encode_polynomial(coeffs)

    def encrypt(self, coeffs, asymmetric: bool = True):
        jpt, pt = self.encode(coeffs)
        if asymmetric:
            jct, ct = self.jencr.encrypt_asymmetric(jpt), self.encr.encrypt_asymmetric(pt)
        else:
            jct, ct = self.jencr.encrypt_symmetric(jpt), self.encr.encrypt_symmetric(pt)
        same_ct(jct, ct)
        return jct, ct

    def decode(self, ct) -> np.ndarray:
        plain = self.dec.decrypt(ct)
        if self.ckks:
            return self.enc.decode_float64_polynomial(plain)
        return self.enc.decode_polynomial(plain)

    def check_coeffs(self, got, want):
        if self.ckks:
            np.testing.assert_allclose(got, want, rtol=0, atol=CKKS_ATOL)
        else:
            np.testing.assert_array_equal(np.asarray(got, np.uint64), np.asarray(want, np.uint64))

    def other_form(self, jct, ct):
        """The pair in the other domain (NTT <-> coefficient)."""
        if ct.is_ntt_form:
            return self.jev.transform_from_ntt(jct), self.ev.transform_from_ntt(ct)
        return self.jev.transform_to_ntt(jct), self.ev.transform_to_ntt(ct)


def same_ct(jct, ct):
    same(jct.data, ct.data)
    assert ct.parms_id == jct.parms_id and ct.is_ntt_form == bool(jct.is_ntt_form)
    assert ct.scale == jct.scale and ct.correction_factor == jct.correction_factor


def same_lwe(jl, l):
    same(jl.c0, l.c0)
    same(jl.c1, l.c1)
    assert l.parms_id == jl.parms_id and l.scale == jl.scale
    assert l.correction_factor == jl.correction_factor
    assert (l.coeff_modulus_size, l.poly_modulus_degree) == (jl.coeff_modulus_size,
                                                            jl.poly_modulus_degree)


class LweCase:
    """A Pair with its automorphism keys and one asymmetric encryption of
    random coefficients."""

    def __init__(self, scheme: str):
        self.p = Pair(scheme)
        self.rng = np.random.default_rng(99)
        self.jglk, self.glk = self.p.automorphism_keys()
        self.coeffs = self.p.coefficients(self.rng)
        self.jct, self.ct = self.p.encrypt(self.coeffs)

    def lwes(self, terms):
        jl = [self.p.jev.extract_lwe(self.jct, i) for i in terms]
        tl = [self.p.ev.extract_lwe(self.ct, i) for i in terms]
        return jl, tl


@pytest.fixture(scope="module", params=SCHEMES)
def C(request):
    return LweCase(request.param)


def test_automorphism_keys_are_the_trace_elements(C):
    assert sorted(C.glk.keys) == [(1 << j) + 1 for j in range(1, C.p.n.bit_length())]
    assert C.glk.parms_id == C.p.tc.key_parms_id


@pytest.mark.parametrize("term", [0, 1, 7, N - 1])
def test_extract_and_assemble(C, term):
    p = C.p
    for jct, ct in ((C.jct, C.ct), p.other_form(C.jct, C.ct)):
        jl, l = p.jev.extract_lwe(jct, term), p.ev.extract_lwe(ct, term)
        same_lwe(jl, l)
        jback, back = p.jev.assemble_lwe(jl), p.ev.assemble_lwe(l)
        same_ct(jback, back)
        assert not back.is_ntt_form
        p.check_coeffs(p.decode(back)[:1], C.coeffs[term:term + 1])
        # interop carries the sample across and back
        carried = interop.lwe_ciphertext(np.asarray(jl.c0), np.asarray(jl.c1), jl.parms_id,
                                         "cpu", jl.scale, jl.correction_factor)
        same_lwe(jl, carried)
        np.testing.assert_array_equal(interop.to_numpy(l.c1), np.asarray(jl.c1))
    clone = l.clone()
    assert clone.c1 is l.c1 and clone.scale == l.scale


@pytest.mark.parametrize("logn_stop", [0, 2])
def test_field_trace(C, logn_stop):
    p = C.p
    jx, x = p.jev.divide_by_poly_modulus_degree(C.jct), p.ev.divide_by_poly_modulus_degree(C.ct)
    jtr = p.jev.field_trace(jx, C.jglk, logn_stop=logn_stop)
    tr = p.ev.field_trace(x, C.glk, logn_stop=logn_stop)
    same_ct(jtr, tr)
    if logn_stop == 0:  # only coefficient 0 survives, where the x n undoes the division
        got = p.decode(tr)
        p.check_coeffs(got[:1], C.coeffs[:1])
        p.check_coeffs(got[1:], np.zeros(p.n - 1, C.coeffs.dtype))


@pytest.mark.parametrize("factor", [None, 8, 12345])
def test_divide_by_poly_modulus_degree(C, factor):
    p = C.p
    same_ct(p.jev.divide_by_poly_modulus_degree(C.jct, factor),
            p.ev.divide_by_poly_modulus_degree(C.ct, factor))


@pytest.mark.parametrize("m", [1, 3, 8, N])
def test_pack_lwe_ciphertexts(C, m):
    p = C.p
    terms = [(5 * i) % p.n for i in range(m)] if m < p.n else list(range(m))
    jl, tl = C.lwes(terms)
    jpk, pk = p.jev.pack_lwe_ciphertexts(jl, C.jglk), p.ev.pack_lwe_ciphertexts(tl, C.glk)
    same_ct(jpk, pk)
    assert pk.is_ntt_form == (p.scheme != "BFV")
    stride = p.n >> (max(1, (m - 1).bit_length()) if m > 1 else 0)
    got = p.decode(pk)
    p.check_coeffs(got[::stride][:m], C.coeffs[terms])
    if m == 1:
        p.check_coeffs(got[1:], np.zeros(p.n - 1, C.coeffs.dtype))


@pytest.mark.parametrize("trace", [True, False])
def test_pack_rlwe_with_shift_and_output_interval(C, trace):
    """Two ciphertexts and a missing slot, payloads at stride 8 behind the
    shift 3, packed to stride 2: merge rounds g = 9, 17, then (with the
    trace) g = 33."""
    p = C.p
    jb, b = p.encrypt(p.coefficients(C.rng))
    args = (3, 8, 2, trace)
    jout = p.jev.pack_rlwe_ciphertexts([C.jct, None, jb], C.jglk, *args)
    out = p.ev.pack_rlwe_ciphertexts([C.ct, None, b], C.glk, *args)
    same_ct(jout, out)


def test_pack_lwe_batched_odd_groups_equal_sequential(C):
    """G = 3 groups of 4 as one (3, 2, L, n) tree: each equals the JAX
    package's and the port's own pack of that group alone (an odd G would
    catch groups read as polys)."""
    p = C.p
    groups = [C.lwes([g * 4 + i for i in range(4)]) for g in range(3)]
    jb = p.jev.pack_lwe_ciphertexts_batched([j for j, _ in groups], C.jglk)
    tb = p.ev.pack_lwe_ciphertexts_batched([t for _, t in groups], C.glk)
    assert len(tb) == 3
    for g, (j, t) in enumerate(zip(jb, tb)):
        same_ct(j, t)
        assert t.size == 2 and t.data.dim() == 3
        same(p.ev.pack_lwe_ciphertexts(groups[g][1], C.glk).data, t.data)
        p.check_coeffs(p.decode(t)[::p.n // 4], C.coeffs[g * 4:g * 4 + 4])


def test_pack_lwe_batched_ragged_and_two_groups(C):
    """Groups of 3 and 4 (the short one packs a zero ciphertext in its last
    slot), and the G = 2, m = 2 case of tests/core/test_lwe.py, in NTT form
    for CKKS and BGV."""
    p = C.p
    ragged = [C.lwes(range(3)), C.lwes(range(10, 14))]
    jb = p.jev.pack_lwe_ciphertexts_batched([j for j, _ in ragged], C.jglk)
    tb = p.ev.pack_lwe_ciphertexts_batched([t for _, t in ragged], C.glk)
    for j, t in zip(jb, tb):
        same_ct(j, t)
    got = p.decode(tb[0])[::p.n // 4]
    p.check_coeffs(got[:3], C.coeffs[:3])
    p.check_coeffs(got[3:], np.zeros(1, C.coeffs.dtype))
    p.check_coeffs(p.decode(tb[1])[::p.n // 4], C.coeffs[10:14])
    pairs = [C.lwes([2 * g, 2 * g + 1]) for g in range(2)]
    jb = p.jev.pack_lwe_ciphertexts_batched([j for j, _ in pairs], C.jglk)
    tb = p.ev.pack_lwe_ciphertexts_batched([t for _, t in pairs], C.glk)
    for g, (j, t) in enumerate(zip(jb, tb)):
        same_ct(j, t)
        assert t.is_ntt_form == (p.scheme != "BFV")
        p.check_coeffs(p.decode(t)[::p.n // 2], C.coeffs[2 * g:2 * g + 2])


def test_pack_rlwe_batched_with_missing_slots(C):
    """Ragged groups with None slots at the RLWE layer, the shift and
    intervals of the matmul helper's pack (input interval 4 -> 1), equal to
    the JAX package's.  Both stack a zero ciphertext where a group lacks one,
    so a group with gaps need not equal its own sequential pack, which skips
    the gaps' merges (the keyswitch of -x is not the negated keyswitch of x
    in its noise); a full group does, as the odd-groups test shows."""
    p = C.p
    cts = [p.encrypt(p.coefficients(C.rng)) for _ in range(4)]
    jc, tc = [j for j, _ in cts], [t for _, t in cts]
    shape = [[0, None, 1], [2], [None, 3, None, None]]
    jgroups = [[None if k is None else jc[k] for k in g] for g in shape]
    tgroups = [[None if k is None else tc[k] for k in g] for g in shape]
    args = (2 * p.n - 3, 4, 1)
    jout = p.jev.pack_rlwe_ciphertexts_batched(jgroups, C.jglk, *args)
    out = p.ev.pack_rlwe_ciphertexts_batched(tgroups, C.glk, *args)
    for j, t in zip(jout, out):
        same_ct(j, t)
    single = p.ev.pack_rlwe_ciphertexts_batched(tgroups[:1], C.glk, *args)
    same(out[0].data, single[0].data)


def test_errors(C):
    p = C.p
    ev, glk = p.ev, C.glk
    _, tl = C.lwes([0])
    with pytest.raises(ValueError, match="empty input"):
        ev.pack_lwe_ciphertexts([], glk)
    with pytest.raises(ValueError, match="too many LWEs"):
        ev.pack_lwe_ciphertexts(tl * (p.n + 1), glk)
    with pytest.raises(ValueError, match="empty input"):
        ev.pack_rlwe_ciphertexts([None, None], glk, 0, 4, 1)
    with pytest.raises(ValueError, match="powers of 2"):
        ev.pack_rlwe_ciphertexts([C.ct], glk, 0, 6, 1)
    with pytest.raises(ValueError, match="powers of 2"):
        ev.pack_rlwe_ciphertexts([C.ct], glk, 0, 8, 3)
    with pytest.raises(ValueError, match="too many ciphertexts"):
        ev.pack_rlwe_ciphertexts([C.ct] * 3, glk, 0, 4, 2)
    with pytest.raises(ValueError, match="empty"):
        ev.pack_rlwe_ciphertexts_batched([], glk, 0, 4, 1)
    with pytest.raises(ValueError, match="empty input"):
        ev.pack_rlwe_ciphertexts_batched([[None], [None]], glk, 0, 4, 1)
    other = p.other_form(C.jct, C.ct)[1]
    with pytest.raises(ValueError, match="uniform"):
        ev.pack_rlwe_ciphertexts_batched([[C.ct], [other]], glk, 0, 4, 1)
    with pytest.raises(NotImplementedError, match="mesh"):
        ev.pack_rlwe_ciphertexts_batched([[C.ct], [C.ct]], glk, 0, 4, 1, mesh=object())
    with pytest.raises(ValueError, match="empty input"):
        ev.pack_lwe_ciphertexts_batched([tl, []], glk)
    with pytest.raises(ValueError, match="empty input"):
        ev.pack_lwe_ciphertexts_batched([], glk)
    with pytest.raises(ValueError, match="too many LWEs"):
        ev.pack_lwe_ciphertexts_batched([tl, tl * (p.n + 1)], glk)
    size3 = Ciphertext(torch.cat([C.ct.data, C.ct.data[:1]]), C.ct.parms_id, C.ct.is_ntt_form)
    with pytest.raises(ValueError, match="size-2"):
        ev.extract_lwe(size3, 0)
    # the JAX package raises the same types at the same inputs
    with pytest.raises(ValueError):
        p.jev.pack_lwe_ciphertexts([], C.jglk)
    with pytest.raises(ValueError):
        p.jev.pack_rlwe_ciphertexts([C.jct], C.jglk, 0, 6, 1)


def test_stacked_add_and_galois_read_the_poly_axis():
    """Ciphertexts stacked in front, (G, size, L, n) with G = 3: size reads
    axis -3, add pads a (G, 2, L, n) operand with zero polys on that axis,
    and apply_galois maps each group as it maps that group alone."""
    p = Pair("BFV")
    rng = np.random.default_rng(4)
    jglk, glk = p.automorphism_keys()
    q = torch.tensor(p.tc.first_context_data().base_q.values).view(-1, 1)
    pid = p.tc.first_parms_id

    def stack(size):
        x = torch.from_numpy(rng.integers(0, 2 ** 30, (3, size, q.shape[0], p.n)))
        return Ciphertext(x % q, pid)

    a, b, c = stack(2), stack(2), stack(3)
    assert (a.size, c.size) == (2, 3)
    s = p.ev.add(p.ev.add(a, b), c)
    assert tuple(s.data.shape) == (3, 3, q.shape[0], p.n)
    s2 = p.ev.add(c, a)
    for g in range(3):
        ag, bg, cg = (Ciphertext(x.data[g], pid) for x in (a, b, c))
        same(p.ev.add(p.ev.add(ag, bg), cg).data, s.data[g])
        same(p.ev.add(cg, ag).data, s2.data[g])
        same(p.ev.apply_galois(ag, 5, glk).data, p.ev.apply_galois(a, 5, glk).data[g])
    with pytest.raises(ValueError, match="size-2"):
        p.ev.apply_galois(c, 5, glk)


def test_batch_encoder_polynomial_and_rns_forms():
    """encode_polynomial / decode_polynomial, scale_up / scale_down and
    centralize / decentralize, coeff_count, slot_count and
    simd_encoding_supported against the JAX package's BatchEncoder."""
    p = Pair("BFV")
    rng = np.random.default_rng(6)
    coeffs = rng.integers(0, p.t, size=p.n - 5, dtype=np.uint64)
    jpt, pt = p.jenc.encode_polynomial(coeffs), p.enc.encode_polynomial(coeffs)
    same(jpt.data, pt.data)
    assert pt.coeff_count == jpt.coeff_count == p.n - 5
    assert pt.clone().coeff_count == p.n - 5
    assert p.enc.slot_count == p.jenc.slot_count == p.n
    assert p.enc.simd_encoding_supported and p.jenc.simd_encoding_supported
    dec = p.enc.decode_polynomial(pt)
    assert dec.dtype == np.uint64
    np.testing.assert_array_equal(dec, p.jenc.decode_polynomial(jpt))
    assert p.enc.encode(coeffs).coeff_count == p.n
    assert Plaintext(pt.data).coeff_count == p.n
    nxt = p.tc.first_context_data().next.parms_id
    for pid in (None, nxt):
        jup, up = p.jenc.scale_up(jpt, pid), p.enc.scale_up(pt, pid)
        same(jup.data, up.data)
        assert up.parms_id == jup.parms_id and up.coeff_count == p.n - 5
        jdown, down = p.jenc.scale_down(jup), p.enc.scale_down(up)
        same(jdown.data, down.data)
        same(pt.data, down.data)
        jcen, cen = p.jenc.centralize(jpt, pid), p.enc.centralize(pt, pid)
        same(jcen.data, cen.data)
        assert cen.parms_id == jcen.parms_id
        jde, de = p.jenc.decentralize(jcen), p.enc.decentralize(cen)
        same(jde.data, de.data)
        same(pt.data, de.data)


def test_batch_encoder_without_simd():
    """A plain modulus that does not batch (1031, prime, 7 mod 2n) still
    encodes polynomials."""
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
    tp.set_coeff_modulus(CoeffModulus.create(N, BITS)).set_plain_modulus(1031)
    enc = BatchEncoder(HeContext.create(tp, "cpu", SecurityLevel.Nil))
    assert not enc.simd_encoding_supported
    pt = enc.encode_polynomial([1, 2, 3])
    np.testing.assert_array_equal(enc.decode_polynomial(pt)[:4], [1, 2, 3, 0])
    with pytest.raises(ValueError, match="batching"):
        enc.encode([1, 2, 3])


def test_example_12_lwes_flow():
    """examples/12_lwes.py on the port: extract 8 coefficients at n = 1024
    and pack them back into one ciphertext."""
    n = 1024
    parms = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    context = HeContext.create(parms, "cpu", SecurityLevel.Nil, seed=1)
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, pk=keygen.create_public_key())
    decryptor = Decryptor(context, keygen.secret_key)
    evaluator = Evaluator(context)
    encoder = BatchEncoder(context)
    auto_keys = keygen.create_automorphism_keys()
    coeffs = np.random.default_rng(1).integers(0, parms.plain_modulus.value, n,
                                               dtype=np.uint64)
    ct = encryptor.encrypt_asymmetric(encoder.encode_polynomial(coeffs))
    lwes = [evaluator.extract_lwe(ct, 10 * i) for i in range(8)]
    packed = evaluator.pack_lwe_ciphertexts(lwes, auto_keys)
    dec = encoder.decode_polynomial(decryptor.decrypt(packed))
    stride = n // 8
    for i in range(8):
        assert dec[i * stride] == coeffs[10 * i]
    assert decryptor.invariant_noise_budget(packed) > 0

"""The port's CKKS (troy_tpu_torch: core/ckks_encoder.py, the CKKS branches
of the encryptor, decryptor and evaluator, rns_tool's
divide_and_round_q_last_ntt and the batched steps) against the JAX package,
bit for bit.

BothCKKS holds the same CKKS parameters in both packages (n = 1024, 4 x
30-bit primes, the last special; scale 2^25) and draws every key and
encryption from RandomGenerator(seed, mode="aes") streams with the same
seed and domains, so the keys and ciphertexts themselves must agree.  The
evaluator's operations run on ciphertexts carried over from the JAX package
and must give the same residues, scale and level.  Decode is compared with
tolerance 0: the port's host encoder runs the JAX package's numpy
operations in the same order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import CoeffModulus as JCoeff, SecurityLevel as JSec
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.core.keygen import KeyGenerator as JKeyGen
from troy_tpu.core.encryptor import Encryptor as JEncryptor
from troy_tpu.core.decryptor import Decryptor as JDecryptor
from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.core.ckks_encoder import CKKSEncoder as JEncoder
from troy_tpu.ops.galois import GaloisTool as JGalois
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from troy_tpu.utils.random import RandomGenerator as JRandom
from troy_tpu_torch import interop
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.ops import ntt_cuda
from troy_tpu_torch.parallel.batched import BatchedEvaluator
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_client import same

N, BITS, SEED, SCALE = 1024, [30, 30, 30, 30], 0xC0FFEE, 2.0 ** 25
KEY_STEPS = [1, -1, 3, 4]  # the batched rotate(3) takes the NAF rounds -1, 4
RNG = np.random.default_rng(8)


class BothCKKS:
    def __init__(self, special_prime: bool = False):
        jp = JParams(JScheme.CKKS).set_poly_modulus_degree(N)
        jp.set_coeff_modulus(JCoeff.create(N, BITS))
        jp.set_use_special_prime_for_encryption(special_prime)
        self.jc = JContext.create(jp, True, JSec.Nil, SEED)
        tp = EncryptionParameters(SchemeType.CKKS).set_poly_modulus_degree(N)
        tp.set_coeff_modulus(CoeffModulus.create(N, BITS))
        tp.set_use_special_prime_for_encryption(special_prime)
        self.tc = HeContext.create(tp, True, SecurityLevel.Nil, seed=SEED, device="cpu")
        self.jkg = JKeyGen(self.jc, prng=JRandom(SEED, mode="aes", domain="keygen"))
        self.kg = KeyGenerator(self.tc, prng=RandomGenerator(SEED, "aes", "keygen"))
        self.jenc, self.enc = JEncoder(self.jc), CKKSEncoder(self.tc)
        self.jev, self.ev = JEvaluator(self.jc), Evaluator(self.tc)

    def keys(self):
        jpk, pk = self.jkg.create_public_key(), self.kg.create_public_key()
        jrlk, rlk = self.jkg.create_relin_keys(), self.kg.create_relin_keys()
        elts = sorted({JGalois.get_element_from_step(s, N) for s in KEY_STEPS} | {2 * N - 1})
        jglk = self.jkg.create_galois_keys_from_elements(elts)
        glk = self.kg.create_galois_keys_from_elements(elts)
        return (jpk, pk), (jrlk, rlk), (jglk, glk), elts

    def encryptors(self, jpk, pk):
        return (JEncryptor(self.jc, pk=jpk, sk=self.jkg.secret_key,
                           prng=JRandom(SEED, mode="aes", domain="encryptor")),
                Encryptor(self.tc, sk=self.kg.secret_key, pk=pk,
                          prng=RandomGenerator(SEED, "aes", "encryptor")))

    def values(self, count=None):
        k = count or N // 2
        return RNG.uniform(-1, 1, k) + 1j * RNG.uniform(-1, 1, k)

    def port(self, jct) -> Ciphertext:
        return interop.ciphertext(np.asarray(jct.data), jct.parms_id, "cpu",
                                  bool(jct.is_ntt_form), jct.scale)

    def plain(self, jpt):
        return interop.plaintext(np.asarray(jpt.data), jpt.parms_id, "cpu",
                                 bool(jpt.is_ntt_form), jpt.scale)


def same_ct(jct, ct):
    same(jct.data, ct.data)
    assert ct.parms_id == jct.parms_id and ct.is_ntt_form == bool(jct.is_ntt_form)
    assert ct.scale == jct.scale


@pytest.fixture(scope="module")
def flow():
    both = BothCKKS()
    (jpk, pk), (jrlk, rlk), (jglk, glk), elts = both.keys()
    jencr, encr = both.encryptors(jpk, pk)
    v1, v2 = both.values(), both.values()
    cts = []
    for v in (v1, v2):
        jct = jencr.encrypt_symmetric(both.jenc.encode(v, scale=SCALE))
        ct = encr.encrypt_symmetric(both.enc.encode(v, scale=SCALE))
        cts.append((jct, ct))
    return dict(both=both, keys=((jpk, pk), (jrlk, rlk), (jglk, glk)), elts=elts,
                cts=cts, values=(v1, v2), encryptors=(jencr, encr))


def test_keys_match_jax(flow):
    both = flow["both"]
    same(both.jkg.secret_key.data, both.kg.secret_key.data)
    (jpk, pk), (jrlk, rlk), (jglk, glk) = flow["keys"]
    same(jpk.data(), pk.data())
    same(jrlk.key(2), rlk.key(2))
    for e in flow["elts"]:
        same(jglk.key(e), glk.key(e))


def test_encryptions_match_jax(flow):
    """Symmetric encryption (the fixture's two), then asymmetric, in one
    stream per package."""
    for jct, ct in flow["cts"]:
        same_ct(jct, ct)
        assert ct.is_ntt_form and ct.scale == SCALE
    both = flow["both"]
    jencr, encr = flow["encryptors"]
    v = both.values(7)
    same_ct(jencr.encrypt_asymmetric(both.jenc.encode(v, scale=SCALE)),
            encr.encrypt_asymmetric(both.enc.encode(v, scale=SCALE)))


def test_special_prime_encryption_matches_jax():
    both = BothCKKS(special_prime=True)
    (jpk, pk), _, _, _ = both.keys()
    jencr, encr = both.encryptors(jpk, pk)
    v = both.values()
    for fn in ("encrypt_symmetric", "encrypt_asymmetric"):
        jct = getattr(jencr, fn)(both.jenc.encode(v, scale=SCALE))
        ct = getattr(encr, fn)(both.enc.encode(v, scale=SCALE))
        same_ct(jct, ct)
        assert ct.parms_id == both.tc.first_parms_id
    got = both.enc.decode(Decryptor(both.tc, both.kg.secret_key).decrypt(ct))
    assert np.abs(got - v).max() < 1e-4


def test_encode_variants_match_jax(flow):
    both = flow["both"]
    v = both.values()
    pid = both.tc.first_context_data().next.parms_id
    cases = [("encode", (v,), {"scale": SCALE}),
             ("encode", (v[:5],), {"parms_id": pid, "scale": 2.0 ** 30}),
             ("encode_float64_polynomial", (RNG.uniform(-4, 4, N),), {"scale": SCALE}),
             ("encode_float64_single", (0.75,), {"scale": SCALE}),
             ("encode_complex64_single", (0.5 - 0.25j,), {"scale": SCALE}),
             ("encode_integer64_single", (-12345,), {})]
    for name, args, kw in cases:
        jpt = getattr(both.jenc, name)(*args, **kw)
        pt = getattr(both.enc, name)(*args, **kw)
        same(jpt.data, pt.data)
        assert pt.parms_id == jpt.parms_id and pt.scale == jpt.scale and pt.is_ntt_form
    with pytest.raises(ValueError, match="exceed"):
        both.enc.encode(v, scale=2.0 ** 118)


def test_decode_matches_jax(flow):
    """Decryption of the same ciphertext in both packages, then decode and
    decode_float64_polynomial: equal with tolerance 0, and within 1e-4 of
    the message (fresh noise over scale 2^25)."""
    both = flow["both"]
    (jct, ct), v = flow["cts"][0], flow["values"][0]
    jpt = JDecryptor(both.jc, both.jkg.secret_key).decrypt(jct)
    pt = Decryptor(both.tc, both.kg.secret_key).decrypt(ct)
    same(jpt.data, pt.data)
    assert pt.is_ntt_form and pt.scale == jpt.scale
    got = both.enc.decode(pt)
    np.testing.assert_array_equal(got, both.jenc.decode(jpt))
    np.testing.assert_array_equal(both.enc.decode_float64_polynomial(pt),
                                  both.jenc.decode_float64_polynomial(jpt))
    assert np.abs(got - v).max() < 1e-4


def test_arithmetic_matches_jax(flow):
    both = flow["both"]
    (j1, _), (j2, _) = flow["cts"]
    t1, t2 = both.port(j1), both.port(j2)
    jpt = both.jenc.encode(both.values(), scale=SCALE)
    pt = both.plain(jpt)
    for name, jargs, targs in [
            ("add", (j1, j2), (t1, t2)), ("sub", (j1, j2), (t1, t2)),
            ("negate", (j1,), (t1,)), ("add_plain", (j1, jpt), (t1, pt)),
            ("sub_plain", (j1, jpt), (t1, pt)), ("multiply_plain", (j1, jpt), (t1, pt)),
            ("multiply", (j1, j2), (t1, t2)), ("square", (j1,), (t1,))]:
        same_ct(getattr(both.jev, name)(*jargs), getattr(both.ev, name)(*targs))
    off = t2.clone()
    off.scale = SCALE * 1.001
    with pytest.raises(ValueError, match="scale"):
        both.ev.add(t1, off)


def test_relinearize_rescale_modswitch_match_jax(flow):
    both = flow["both"]
    (j1, _), (j2, _) = flow["cts"]
    (_, _), (jrlk, rlk), _ = flow["keys"]
    jprod = both.jev.relinearize(both.jev.multiply(j1, j2), jrlk)
    prod = both.ev.relinearize(both.ev.multiply(both.port(j1), both.port(j2)), rlk)
    same_ct(jprod, prod)
    same_ct(both.jev.rescale_to_next(jprod), both.ev.rescale_to_next(prod))
    last = both.tc.last_parms_id
    same_ct(both.jev.rescale_to(jprod, last), both.ev.rescale_to(prod, last))
    same_ct(both.jev.mod_switch_to_next(jprod), both.ev.mod_switch_to_next(prod))
    same_ct(both.jev.mod_switch_to(jprod, last), both.ev.mod_switch_to(prod, last))
    jres, res = both.jev.rescale_to_next(jprod), both.ev.rescale_to_next(prod)
    same_ct(both.jev.mod_switch_drop_to(jres, last), both.ev.mod_switch_drop_to(res, last))
    with pytest.raises(ValueError, match="scale out of bounds"):
        both.ev.mod_switch_drop_to(prod, last)  # scale 2^50 over a 30-bit level
    jpt = both.jenc.encode(both.values(), scale=SCALE)
    jnext, nxt = both.jev.mod_switch_plain_to_next(jpt), both.ev.mod_switch_plain_to_next(
        both.plain(jpt))
    same(jnext.data, nxt.data)
    assert nxt.parms_id == jnext.parms_id and nxt.scale == jnext.scale
    jcoef = both.jev.transform_plain_from_ntt(jpt)
    jback = both.jev.transform_plain_to_ntt(jcoef, jpt.parms_id)
    back = both.ev.transform_plain_to_ntt(both.plain(jcoef), jpt.parms_id)
    same(jback.data, back.data)
    assert back.scale == SCALE and back.is_ntt_form
    got = both.enc.decode(Decryptor(both.tc, both.kg.secret_key).decrypt(
        both.ev.rescale_to_next(prod)))
    v1, v2 = flow["values"]
    assert np.abs(got - v1 * v2).max() < 2e-3  # noise / 2^20 after the rescale
    with pytest.raises(ValueError, match="above"):
        both.ev.rescale_to(both.ev.rescale_to_next(prod), both.tc.first_parms_id)


def test_rotations_match_jax(flow):
    """rotate_vector(1), (-1), (3) and complex_conjugate, each decoding to
    the rotated (conjugated) slots within 1e-2: a keyswitch over one 30-bit
    special prime at n = 1024 adds noise of about 2^16 at scale 2^25."""
    both = flow["both"]
    (j1, _), _ = flow["cts"]
    v1 = flow["values"][0]
    _, _, (jglk, glk) = flow["keys"]
    dec = Decryptor(both.tc, both.kg.secret_key)
    t1 = both.port(j1)
    for steps in (1, -1, 3):
        jr, tr = both.jev.rotate_vector(j1, steps, jglk), both.ev.rotate_vector(t1, steps, glk)
        same_ct(jr, tr)
        assert np.abs(both.enc.decode(dec.decrypt(tr)) - np.roll(v1, -steps)).max() < 1e-2
    jc, tc = both.jev.complex_conjugate(j1, jglk), both.ev.complex_conjugate(t1, glk)
    same_ct(jc, tc)
    assert np.abs(both.enc.decode(dec.decrypt(tc)) - np.conj(v1)).max() < 1e-2


def test_batched_steps_match_jax(flow):
    """The batched mul + relinearize step, the rescale step, the CKKS mod
    switch step and the NTT-form Galois step, against the jitted JAX steps."""
    both = flow["both"]
    (j1, _), (j2, _) = flow["cts"]
    _, (jrlk, rlk), (jglk, glk) = flow["keys"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    jb, tb = JBatched(both.jev, jcd), BatchedEvaluator(both.ev, tcd)
    jd1, jd2 = jnp.stack([j1.data, j2.data]), jnp.stack([j2.data, j1.data])
    d1, d2 = interop.to_tensor(np.asarray(jd1), "cpu"), interop.to_tensor(np.asarray(jd2), "cpu")
    jout = jax.jit(jb.build_mul_relin_step(jrlk.key(2)))(jd1, jd2, jrlk.key(2))
    out = tb.build_mul_relin_step(rlk.key(2))(d1, d2, rlk.key(2))
    same(jout, out)
    same(jax.jit(jb.build_rescale_step())(jout), tb.build_rescale_step()(out))
    same(jb.build_mod_switch_step()(jout), tb.build_mod_switch_step()(out))
    jstep, elts = jb.build_rotate_rows_step(3)
    step, telts = tb.build_rotate_rows_step(3)
    assert telts == elts
    same(jstep(jd1, tuple(jglk.key(e) for e in elts)),
         step(d1, tuple(glk.key(e) for e in elts)))
    with pytest.raises(ValueError, match="CKKS"):
        BatchedEvaluator(Evaluator(_bfv_context()), _bfv_context().first_context_data()) \
            .build_rescale_step()


def _bfv_context():
    from troy_tpu_torch.core.coeff_modulus import PlainModulus

    p = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(64)
    p.set_coeff_modulus(CoeffModulus.create(64, [30, 30])).set_plain_modulus(
        PlainModulus.batching(64, 20))
    return HeContext.create(p, True, SecurityLevel.Nil, device="cpu")


@pytest.mark.parametrize("n", [1024])
def test_batched_galois_elements_match_jax(flow, n):
    """The batched steps' Galois elements for every rotation step in
    +-[1, n/2) equal the JAX package's (whose NAF list is filtered for zero
    components; the port's NAF never yields one)."""
    both = flow["both"]
    jb = JBatched(both.jev, both.jc.first_context_data())
    tb = BatchedEvaluator(both.ev, both.tc.first_context_data())
    for s in range(1, n // 2):
        assert tb.galois_elements_for_steps(s) == jb.galois_elements_for_steps(s)
        assert tb.galois_elements_for_steps(-s) == jb.galois_elements_for_steps(-s)


def test_ckks_basics_example_flow():
    """examples/5_ckks_basics.py on the port: n = 4096, 4 x 30-bit primes,
    scale 2^27; x^2 after relinearize and rescale within 5e-3, and no kernel
    launched on the CPU."""
    n, scale = 4096, 2.0 ** 27
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
    context = HeContext.create(parms, True, SecurityLevel.Nil, seed=5, device="cpu")
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, pk=keygen.create_public_key())
    decryptor = Decryptor(context, keygen.secret_key)
    evaluator = Evaluator(context)
    encoder = CKKSEncoder(context)
    rlk = keygen.create_relin_keys()
    v = np.linspace(0, 1, encoder.slot_count)
    ct = encryptor.encrypt_asymmetric(encoder.encode(v, scale=scale))
    prod = evaluator.rescale_to_next(evaluator.relinearize(evaluator.multiply(ct, ct), rlk))
    out = encoder.decode(decryptor.decrypt(prod)).real
    assert np.abs(out - v * v).max() < 5e-3
    assert set(ntt_cuda.LAUNCHES.values()) == {0}

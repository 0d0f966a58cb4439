"""The port's BGV (troy_tpu_torch: the correction factor, the BGV branches of
rlwe, keygen, the encryptor, decryptor and evaluator, rns_tool's
mod_t_and_divide_q_last_ntt and decrypt_mod_t, and the batched steps)
against the JAX package, bit for bit.

BothBGV holds the same parameters in both packages (n = 1024, 4 x 30-bit
primes, the last special; t = PlainModulus.batching(1024, 20)) and draws
every key and encryption from RandomGenerator(seed, mode="aes") streams with
the same seed and domains, so keys and ciphertexts must agree, correction
factors included.  BGV has no float path: every comparison has tolerance 0.
With scheme=BFV the same pair serves the surface tests of
test_torch_eval_surface.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                         SecurityLevel as JSec)
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.core.keygen import KeyGenerator as JKeyGen
from troy_tpu.core.encryptor import Encryptor as JEncryptor
from troy_tpu.core.decryptor import Decryptor as JDecryptor
from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.core.batch_encoder import BatchEncoder as JEncoder
from troy_tpu.ops.galois import GaloisTool as JGalois
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
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
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.ops import ntt_cuda
from troy_tpu_torch.parallel.batched import BatchedEvaluator
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_client import same

N, BITS, LOG_T, SEED = 1024, [30, 30, 30, 30], 20, 0xB6F
KEY_STEPS = [1, -1, 4]  # the rotate(3) takes the NAF rounds -1, 4
RNG = np.random.default_rng(17)


class BothBGV:
    """The same BGV (or, with scheme="BFV", BFV) parameters in both
    packages, keygen and encryptors keyed by RandomGenerator(SEED, "aes",
    domain) streams, with the encoders, evaluators and decryptors of both."""

    def __init__(self, special_prime: bool = False, scheme: str = "BGV"):
        jp = JParams(JScheme[scheme]).set_poly_modulus_degree(N)
        jp.set_coeff_modulus(JCoeff.create(N, BITS)).set_plain_modulus(
            JPlain.batching(N, LOG_T))
        jp.set_use_special_prime_for_encryption(special_prime)
        self.jc = JContext.create(jp, True, JSec.Nil, SEED)
        tp = EncryptionParameters(SchemeType[scheme]).set_poly_modulus_degree(N)
        tp.set_coeff_modulus(CoeffModulus.create(N, BITS)).set_plain_modulus(
            PlainModulus.batching(N, LOG_T))
        tp.set_use_special_prime_for_encryption(special_prime)
        self.tc = HeContext.create(tp, True, SecurityLevel.Nil, seed=SEED, device="cpu")
        self.t = jp.plain_modulus.value
        self.jkg = JKeyGen(self.jc, prng=JRandom(SEED, mode="aes", domain="keygen"))
        self.kg = KeyGenerator(self.tc, prng=RandomGenerator(SEED, "aes", "keygen"))
        self.jenc, self.enc = JEncoder(self.jc), BatchEncoder(self.tc)
        self.jev, self.ev = JEvaluator(self.jc), Evaluator(self.tc)
        self.jdec = JDecryptor(self.jc, self.jkg.secret_key)
        self.dec = Decryptor(self.tc, self.kg.secret_key)

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

    def messages(self, count: int) -> np.ndarray:
        return RNG.integers(0, self.t, size=(count, N), dtype=np.uint64)

    def port(self, jct) -> Ciphertext:
        return interop.ciphertext(np.asarray(jct.data), jct.parms_id, "cpu",
                                  bool(jct.is_ntt_form), jct.scale, jct.correction_factor)

    def plain(self, jpt):
        return interop.plaintext(np.asarray(jpt.data), jpt.parms_id, "cpu",
                                 bool(jpt.is_ntt_form), jpt.scale)

    def decode(self, ct) -> np.ndarray:
        return self.enc.decode(self.dec.decrypt(ct))


def same_ct(jct, ct):
    same(jct.data, ct.data)
    assert ct.parms_id == jct.parms_id and ct.is_ntt_form == bool(jct.is_ntt_form)
    assert ct.correction_factor == jct.correction_factor


def slots(msgs):
    return np.asarray(msgs, dtype=np.int64)


@pytest.fixture(scope="module")
def flow():
    both = BothBGV()
    (jpk, pk), (jrlk, rlk), (jglk, glk), elts = both.keys()
    jencr, encr = both.encryptors(jpk, pk)
    msgs = both.messages(2)
    cts = [(jencr.encrypt_symmetric(both.jenc.encode(m)),
            encr.encrypt_symmetric(both.enc.encode(m))) for m in msgs]
    return dict(both=both, keys=((jpk, pk), (jrlk, rlk), (jglk, glk)), elts=elts,
                cts=cts, msgs=msgs, encryptors=(jencr, encr))


def test_context_and_evaluator_accept_bgv(flow):
    both = flow["both"]
    cd = both.tc.first_context_data()
    jcd = both.jc.first_context_data()
    assert both.tc.scheme == SchemeType.BGV and both.ev.context is both.tc
    assert cd.rns_tool.gamma.value == jcd.rns_tool.gamma.value
    assert cd.rns_tool.base_Bsk.values == jcd.rns_tool.base_Bsk.values
    assert cd.rns_tool.q_mod_t == int(jcd.rns_tool.q_mod_t)
    assert cd.rns_tool.conv_matrix_q_to_t == [int(v) for v in
                                              np.asarray(jcd.rns_tool.conv_matrix_q_to_t)[:, 0]]
    for w, jw in zip(cd.rns_tool.r96_words, jcd.rns_tool.r96_words):
        same(jw, w)


def test_keys_match_jax(flow):
    both = flow["both"]
    same(both.jkg.secret_key.data, both.kg.secret_key.data)
    (jpk, pk), (jrlk, rlk), (jglk, glk) = flow["keys"]
    same(jpk.data(), pk.data())
    same(jrlk.key(2), rlk.key(2))
    for e in flow["elts"]:
        same(jglk.key(e), glk.key(e))


def test_encryptions_match_jax(flow):
    """Symmetric (the fixture's two), then asymmetric, in one stream per
    package; NTT form, factor 1, decrypting to the message in both."""
    both = flow["both"]
    for (jct, ct), m in zip(flow["cts"], flow["msgs"]):
        same_ct(jct, ct)
        assert ct.is_ntt_form and ct.correction_factor == 1
        np.testing.assert_array_equal(both.decode(ct), slots(m))
    jencr, encr = flow["encryptors"]
    m = both.messages(1)[0]
    jct, ct = (jencr.encrypt_asymmetric(both.jenc.encode(m)),
               encr.encrypt_asymmetric(both.enc.encode(m)))
    same_ct(jct, ct)
    np.testing.assert_array_equal(both.decode(ct), slots(m))


def test_special_prime_encryption_matches_jax():
    """Encryption at the key level divided by the special prime keeping the
    payload mod t: the factor is q_sp^-1 mod t, in both packages."""
    both = BothBGV(special_prime=True)
    (jpk, pk), _, _, _ = both.keys()
    jencr, encr = both.encryptors(jpk, pk)
    m = both.messages(1)[0]
    q_sp = both.tc.key_context_data().parms.coeff_modulus[-1].value
    for fn in ("encrypt_symmetric", "encrypt_asymmetric"):
        jct = getattr(jencr, fn)(both.jenc.encode(m))
        ct = getattr(encr, fn)(both.enc.encode(m))
        same_ct(jct, ct)
        assert ct.parms_id == both.tc.first_parms_id
        assert ct.correction_factor == pow(q_sp, -1, both.t) != 1
        same(both.jdec.decrypt(jct).data, both.dec.decrypt(ct).data)
        np.testing.assert_array_equal(both.decode(ct), slots(m))


def test_decrypt_and_noise_budget_match_jax(flow):
    both = flow["both"]
    (jct, ct), m = flow["cts"][0], flow["msgs"][0]
    jpt, pt = both.jdec.decrypt(jct), both.dec.decrypt(ct)
    same(jpt.data, pt.data)
    np.testing.assert_array_equal(both.enc.decode(pt), both.jenc.decode(jpt))
    budget = both.dec.invariant_noise_budget(ct)
    assert budget == both.jdec.invariant_noise_budget(jct) and budget > 0
    coeff = both.ev.transform_from_ntt(ct)
    same(jpt.data, both.dec.decrypt(coeff).data)
    assert both.dec.invariant_noise_budget(coeff) == budget


def _unequal(flow):
    """The fixture's ciphertexts at factors 1 and a factor-c product, and
    a copy of ct 1 at factor 12345 (its data as it is), in both packages."""
    both = flow["both"]
    (j1, t1), (j2, t2) = flow["cts"]
    j3, t3 = j2.clone(), t2.clone()
    j3.correction_factor = t3.correction_factor = 12345
    return (j1, t1), (j3, t3)


def test_arithmetic_matches_jax(flow):
    """add and sub (with equal and unequal factors), negate, the plaintext
    ops in both plaintext forms, multiply and square, with their factors."""
    both = flow["both"]
    (j1, t1), (j2, t2) = flow["cts"]
    (_, _), (j3, t3) = _unequal(flow)
    m = both.messages(1)[0]
    jpt = both.jenc.encode(m)
    pt = both.plain(jpt)
    jpt_ntt = both.jev.transform_plain_to_ntt(jpt, both.jc.first_parms_id)
    pt_ntt = both.ev.transform_plain_to_ntt(pt, both.tc.first_parms_id)
    same(jpt_ntt.data, pt_ntt.data)
    for name, jargs, targs in [
            ("add", (j1, j2), (t1, t2)), ("sub", (j1, j2), (t1, t2)),
            ("add", (j1, j3), (t1, t3)), ("sub", (j3, j1), (t3, t1)),
            ("negate", (j3,), (t3,)),
            ("add_plain", (j3, jpt), (t3, pt)), ("sub_plain", (j3, jpt), (t3, pt)),
            ("multiply_plain", (j3, jpt), (t3, pt)),
            ("multiply_plain", (j1, jpt_ntt), (t1, pt_ntt)),
            ("multiply", (j1, j3), (t1, t3)), ("square", (j3,), (t3,))]:
        same_ct(getattr(both.jev, name)(*jargs), getattr(both.ev, name)(*targs))
    m1, m2 = (slots(x) for x in flow["msgs"])
    t_ = both.t
    f = pow(12345, -1, t_)
    np.testing.assert_array_equal(both.decode(both.ev.add(t1, t3)), (m1 + m2 * f) % t_)
    np.testing.assert_array_equal(both.decode(both.ev.sub_plain(t3, pt)),
                                  (m2 * f - slots(m)) % t_)
    np.testing.assert_array_equal(both.decode(both.ev.multiply(t1, t3)),
                                  (m1.astype(object) * m2 * f % t_).astype(np.int64))


def test_coefficient_form_ops(flow):
    """A BGV ciphertext moved to the coefficient domain: add_plain and
    multiply_plain stay right there (the JAX package mixes domains), the
    products and the mod switch refuse it."""
    both = flow["both"]
    (_, t1), _ = flow["cts"]
    m1 = slots(flow["msgs"][0])
    coeff = both.ev.transform_from_ntt(t1)
    m = both.messages(1)[0]
    pt = both.enc.encode(m)
    np.testing.assert_array_equal(both.decode(both.ev.add_plain(coeff, pt)),
                                  (m1 + slots(m)) % both.t)
    np.testing.assert_array_equal(both.decode(both.ev.multiply_plain(coeff, pt)),
                                  (m1.astype(object) * slots(m) % both.t).astype(np.int64))
    for op, args in (("multiply", (coeff, coeff)), ("square", (coeff,)),
                     ("mod_switch_to_next", (coeff,))):
        with pytest.raises(ValueError, match="NTT form"):
            getattr(both.ev, op)(*args)


def test_relinearize_rotate_modswitch_match_jax(flow):
    both = flow["both"]
    (j1, t1), (j3, t3) = _unequal(flow)
    (_, _), (jrlk, rlk), (jglk, glk) = flow["keys"]
    jprod = both.jev.relinearize(both.jev.multiply(j1, j3), jrlk)
    prod = both.ev.relinearize(both.ev.multiply(t1, t3), rlk)
    same_ct(jprod, prod)
    m1, m2 = (slots(x) for x in flow["msgs"])
    t_ = both.t
    want = (m1.astype(object) * m2 * pow(12345, -1, t_) % t_).astype(np.int64)
    np.testing.assert_array_equal(both.decode(prod), want)
    rows = want.reshape(2, N // 2)
    for steps in (1, -1, 3):
        jr, tr = both.jev.rotate_rows(jprod, steps, jglk), both.ev.rotate_rows(prod, steps, glk)
        same_ct(jr, tr)
        np.testing.assert_array_equal(both.decode(tr),
                                      np.roll(rows, -steps, axis=-1).reshape(-1))
    jc, tc = both.jev.rotate_columns(jprod, jglk), both.ev.rotate_columns(prod, glk)
    same_ct(jc, tc)
    np.testing.assert_array_equal(both.decode(tc), rows[::-1].reshape(-1))
    jd, td = both.jev.mod_switch_to_next(jprod), both.ev.mod_switch_to_next(prod)
    same_ct(jd, td)
    q_last = both.tc.first_context_data().parms.coeff_modulus[-1].value
    assert td.correction_factor == prod.correction_factor * pow(q_last, -1, t_) % t_
    np.testing.assert_array_equal(both.decode(td), want)
    assert both.dec.invariant_noise_budget(td) == both.jdec.invariant_noise_budget(jd) > 0
    last = both.tc.last_parms_id
    same_ct(both.jev.mod_switch_to(jprod, last), both.ev.mod_switch_to(prod, last))
    with pytest.raises(KeyError, match="no Galois key"):
        both.ev.rotate_rows(prod, 2, glk)


@pytest.mark.parametrize("depth", [0, 1])
def test_mod_t_and_divide_q_last_ntt_matches_jax(flow, depth):
    """On random NTT-form residues (batch axes in front) at the key level,
    the special-prime division, and the first level."""
    both = flow["both"]
    jcd = both.jc.key_context_data()
    for _ in range(depth):
        jcd = jcd.next
    tcd = both.tc.get_context_data(jcd.parms_id)
    q = np.array(jcd.base_q.values, dtype=np.uint64)[:, None]
    x = (RNG.integers(0, 1 << 62, size=(2, 2, len(q), N), dtype=np.uint64) % q).astype(np.uint32)
    j = jcd.rns_tool.mod_t_and_divide_q_last_ntt(jnp.asarray(x), jcd.qtab())
    t = tcd.rns_tool.mod_t_and_divide_q_last_ntt(interop.to_tensor(x, "cpu"), tcd.qtab())
    assert tuple(t.shape) == (2, 2, len(q) - 1, N)
    same(j, t)


def _phases(values, base) -> np.ndarray:
    """Python ints in [0, Q) -> (L, k) u32 residues."""
    return np.array([[v % q for v in values] for q in base.values], dtype=np.uint32)


@pytest.mark.parametrize("case", ["random", "q_minus_1", "near_half"])
def test_decrypt_mod_t_matches_jax(flow, case):
    """_exact_alpha and decrypt_mod_t on random phases (equal to the big-int
    centred phase mod t too), on v_i = q_i - 1 (the largest fixed-point sum)
    and on phases within 8 units of Q/2 and of the top of [0, Q), where the
    96-bit rounding decides."""
    both = flow["both"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    base, Q, t_ = tcd.base_q, tcd.base_q.prod, both.t
    if case == "random":
        values = [int(v) for v in RNG.integers(0, 1 << 62, N)]
        values = [(v * (1 << 40) + v) % Q for v in values]
    elif case == "q_minus_1":
        v = np.array([[q - 1] * N for q in base.values], dtype=np.uint32)
        same(jcd.rns_tool._exact_alpha(jnp.asarray(v)),
             tcd.rns_tool._exact_alpha(interop.to_tensor(v, "cpu")))
        values = [Q - 1 - k for k in range(N)]
    else:
        values = [Q // 2 + d for d in range(-8, 9)] + [Q - 1 - d for d in range(9)] + \
                 [d for d in range(9)]
    ph = _phases(values, base)
    j = jcd.rns_tool.decrypt_mod_t(jnp.asarray(ph))
    t = tcd.rns_tool.decrypt_mod_t(interop.to_tensor(ph, "cpu"))
    same(j, t)
    if case != "near_half":
        want = [(v if v <= Q // 2 else v - Q) % t_ for v in values]
        np.testing.assert_array_equal(t.numpy(), np.array(want, dtype=np.int64))


def test_batched_steps_match_jax(flow):
    """multiply + relinearize, square + relinearize, rotate_rows(3) (two
    NAF rounds), rotate_columns and the BGV mod switch step, against the
    JAX steps, then decrypted with the factors the object API keeps."""
    both = flow["both"]
    (j1, _), (j2, _) = flow["cts"]
    _, (jrlk, rlk), (jglk, glk) = flow["keys"]
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    jb, tb = JBatched(both.jev, jcd), BatchedEvaluator(both.ev, tcd)
    assert tb.ntt_form
    jd1, jd2 = jnp.stack([j1.data, j2.data]), jnp.stack([j2.data, j1.data])
    d1, d2 = (interop.to_tensor(np.asarray(x), "cpu") for x in (jd1, jd2))
    jout = jax.jit(jb.build_mul_relin_step(jrlk.key(2)))(jd1, jd2, jrlk.key(2))
    out = tb.build_mul_relin_step(rlk.key(2))(d1, d2, rlk.key(2))
    same(jout, out)
    same(jax.jit(jb.build_square_relin_step(jrlk.key(2)))(jd1, jrlk.key(2)),
         tb.build_square_relin_step(rlk.key(2))(d1, rlk.key(2)))
    for jbuild, tbuild in ((jb.build_rotate_rows_step(3), tb.build_rotate_rows_step(3)),
                           (jb.build_rotate_columns_step(), tb.build_rotate_columns_step())):
        (jstep, elts), (step, telts) = jbuild, tbuild
        assert telts == elts
        same(jstep(jd1, tuple(jglk.key(e) for e in elts)),
             step(d1, tuple(glk.key(e) for e in elts)))
    jdown, down = jax.jit(jb.build_mod_switch_step())(jout), tb.build_mod_switch_step()(out)
    same(jdown, down)
    m1, m2 = (slots(x) for x in flow["msgs"])
    q_last = tcd.parms.coeff_modulus[-1].value
    cf = pow(q_last, -1, both.t)
    got = both.decode(Ciphertext(down[0], tcd.next.parms_id, True, correction_factor=cf))
    np.testing.assert_array_equal(got, (m1.astype(object) * m2 % both.t).astype(np.int64))


def test_bgv_basics_example_flow():
    """examples/4_bgv_basics.py on the port (n = 4096, 4 x 30-bit primes):
    public-key encryption, square, relinearize, mod switch, decrypt; with
    special-prime encryption too, and an add of two factors; no kernel
    launched on the CPU."""
    n = 4096
    for special in (False, True):
        parms = EncryptionParameters(SchemeType.BGV)
        parms.set_poly_modulus_degree(n)
        parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
        parms.set_plain_modulus(PlainModulus.batching(n, 20))
        parms.set_use_special_prime_for_encryption(special)
        context = HeContext.create(parms, True, SecurityLevel.Nil, seed=4, device="cpu")
        keygen = KeyGenerator(context)
        encryptor = Encryptor(context, pk=keygen.create_public_key())
        decryptor = Decryptor(context, keygen.secret_key)
        evaluator = Evaluator(context)
        encoder = BatchEncoder(context)
        rlk = keygen.create_relin_keys()
        t = parms.plain_modulus.value
        m = np.arange(n, dtype=np.int64)
        ct = encryptor.encrypt_asymmetric(encoder.encode(m))
        assert ct.is_ntt_form and (ct.correction_factor != 1) == special
        sq = evaluator.relinearize(evaluator.square(ct), rlk)
        down = evaluator.mod_switch_to_next(sq)
        out = encoder.decode(decryptor.decrypt(down))
        assert (out == m * m % t).all()
        both = evaluator.add(sq, ct)
        assert sq.correction_factor != ct.correction_factor or not special
        assert (encoder.decode(decryptor.decrypt(both)) == (m * m + m) % t).all()
    assert set(ntt_cuda.LAUNCHES.values()) == {0}

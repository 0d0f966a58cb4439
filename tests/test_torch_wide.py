"""The wide path (40-60-bit primes, ROADMAP A14) of the port against the JAX
package, bit for bit: every operation of tests/core/test_wide_e2e.py at
n = 32 on CoeffModulus.create(32, [60, 40, 40, 60]) (t =
PlainModulus.batching(32, 20), CKKS at scale 2^40).

WidePair holds one scheme in both packages under one context seed, every
object on the context's default (threefry) streams: the secret, public,
relin and Galois keys and the first encryptions must be equal.  The
operation tests take the JAX package's ciphertexts across the interop
boundary (its (hi, lo) u32 pairs at axis -3 become one int64 word), run the
operation in both packages and compare the residues with tolerance 0; the
port's result must also decrypt right: exactly mod t for BFV and BGV, and
for CKKS within the JAX test's atol (1e-6 for a fresh encryption, 1e-5 after
a product, 1e-4 after multiply_plain).  The bytes of every wide object
equal the JAX package's in Nil, Zlib and Zstd.

This file runs BFV; test_torch_wide_bgv.py and test_torch_wide_ckks.py run
the same tests for BGV and CKKS, each file on its own worker."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
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
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched, BatchedClient as JClient
from troy_tpu.utils import serialize as JS
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
from troy_tpu_torch.parallel.batched import BatchedEvaluator, BatchedClient
from troy_tpu_torch.utils import serialize as TS
from troy_tpu_torch.utils.random import RandomGenerator

N, BITS, LOG_T, SEED, SCALE = 32, [60, 40, 40, 60], 20, 0x1DE, 2.0 ** 40
MODES = ("Nil", "Zlib", "Zstd")


def same_w(j, t):
    """A JAX wide array ((hi, lo) pairs at -3) equals a port tensor."""
    np.testing.assert_array_equal(
        interop.to_tensor(np.asarray(j), "cpu", wide=True).numpy(), t.cpu().numpy())


def same_ct(jct, ct):
    same_w(jct.data, ct.data)
    assert ct.parms_id == jct.parms_id and ct.is_ntt_form == bool(jct.is_ntt_form)
    assert (ct.scale, ct.correction_factor) == (jct.scale, jct.correction_factor)


class WidePair:
    """One scheme at [60, 40, 40, 60] in both packages under one context
    seed; prng_mode="aes" keys both sides from RandomGenerator(seed, "aes",
    domain) streams instead of the default threefry ones."""

    def __init__(self, scheme: str, n: int = N, seed: int = SEED, prng_mode=None):
        self.scheme, self.n = scheme, n
        self.ckks = scheme == "CKKS"
        jp = JParams(JScheme[scheme]).set_poly_modulus_degree(n)
        jp.set_coeff_modulus(JCoeff.create(n, BITS))
        tp = EncryptionParameters(SchemeType[scheme]).set_poly_modulus_degree(n)
        tp.set_coeff_modulus(CoeffModulus.create(n, BITS))
        if not self.ckks:
            jp.set_plain_modulus(JPlain.batching(n, LOG_T))
            tp.set_plain_modulus(PlainModulus.batching(n, LOG_T))
            self.t = jp.plain_modulus.value
        self.jc = JContext.create(jp, True, JSec.Nil, seed)
        self.tc = HeContext.create(tp, "cpu", SecurityLevel.Nil, seed=seed)

        def prngs(domain):
            if prng_mode is None:
                return {}, {}
            return ({"prng": JRandom(seed, mode=prng_mode, domain=domain)},
                    {"prng": RandomGenerator(seed, prng_mode, domain)})
        jk, tk = prngs("keygen")
        self.jkg, self.kg = JKeyGen(self.jc, **jk), KeyGenerator(self.tc, **tk)
        self.jpk, self.pk = self.jkg.create_public_key(), self.kg.create_public_key()
        self.jrlk, self.rlk = self.jkg.create_relin_keys(), self.kg.create_relin_keys()
        je, te = prngs("encryptor")
        self.jencr = JEncryptor(self.jc, pk=self.jpk, sk=self.jkg.secret_key, **je)
        self.encr = Encryptor(self.tc, sk=self.kg.secret_key, pk=self.pk, **te)
        self.jdec, self.dec = JDecryptor(self.jc, self.jkg.secret_key), \
            Decryptor(self.tc, self.kg.secret_key)
        self.jev, self.ev = JEvaluator(self.jc), Evaluator(self.tc)
        if self.ckks:
            self.jcod, self.cod = JCKKSEncoder(self.jc), CKKSEncoder(self.tc)
        else:
            self.jcod, self.cod = JBatchEncoder(self.jc), BatchEncoder(self.tc)
        self.rng = np.random.default_rng(64646)
        self._glk = None

    def galois_keys(self):
        if self._glk is None:
            self._glk = (self.jkg.create_galois_keys(), self.kg.create_galois_keys())
        return self._glk

    def message(self):
        if self.ckks:
            s = self.n // 2
            return self.rng.uniform(-1, 1, s) + 1j * self.rng.uniform(-1, 1, s)
        return self.rng.integers(0, self.t, size=self.n, dtype=np.uint64)

    def jencode(self, m):
        return self.jcod.encode(m, scale=SCALE) if self.ckks else self.jcod.encode(m)

    def jencrypt(self, m):
        return self.jencr.encrypt_asymmetric(self.jencode(m))

    def port(self, jct):
        """The JAX ciphertext as the port's."""
        return interop.ciphertext(np.asarray(jct.data), jct.parms_id, "cpu",
                                  bool(jct.is_ntt_form), jct.scale, jct.correction_factor)

    def pair(self, m):
        jct = self.jencrypt(m)
        return jct, self.port(jct)

    def check(self, ct, want, atol=1e-6):
        """The port decrypts ct to want (mod t, or within atol for CKKS)."""
        got = self.cod.decode(self.dec.decrypt(ct))
        if self.ckks:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        else:
            want = np.mod(np.asarray(want).astype(object), self.t).astype(np.int64)
            np.testing.assert_array_equal(np.asarray(got.numpy() if isinstance(
                got, torch.Tensor) else got, dtype=np.int64), want)

    def signed(self, m):
        return m if self.ckks else m.astype(object)


SCHEMES = ["BFV"]


@pytest.fixture(scope="module", params=SCHEMES)
def W(request):
    return WidePair(request.param)


def test_keys_and_first_encryptions(W):
    """The context seed's threefry streams give the JAX package's keys and
    encryptions (fresh pair: its first draws)."""
    p = WidePair(W.scheme, seed=0xF5E)
    same_w(p.jkg.secret_key.data, p.kg.secret_key.data)
    same_w(p.jpk.data(), p.pk.data())
    for idx in p.jrlk.keys:
        same_w(p.jrlk.keys[idx], p.rlk.keys[idx])
    m = p.message()
    jpt = p.jencode(m)
    pt = p.cod.encode(m, scale=SCALE) if p.ckks else p.cod.encode(m)
    for sym in (False, True):
        if sym:
            jct, ct = p.jencr.encrypt_symmetric(jpt), p.encr.encrypt_symmetric(pt)
        else:
            jct, ct = p.jencr.encrypt_asymmetric(jpt), p.encr.encrypt_asymmetric(pt)
        same_ct(jct, ct)
        p.check(ct, m)
    jct, ct = p.jencr.encrypt_symmetric(jpt, save_seed=True), \
        p.encr.encrypt_symmetric(pt, save_seed=True)
    same_ct(jct, ct)
    assert ct.seed == jct.seed


def test_aes_streams(W):
    """Keys and an encryption from RandomGenerator(seed, "aes") streams."""
    p = WidePair(W.scheme, seed=0xAE5, prng_mode="aes")
    same_w(p.jkg.secret_key.data, p.kg.secret_key.data)
    same_w(p.jpk.data(), p.pk.data())
    m = p.message()
    jct = p.jencr.encrypt_symmetric(p.jencode(m))
    ct = p.encr.encrypt_symmetric(p.cod.encode(m, scale=SCALE) if p.ckks else p.cod.encode(m))
    same_ct(jct, ct)


def test_negate_add_sub(W):
    m1, m2 = W.message(), W.message()
    (j1, c1), (j2, c2) = W.pair(m1), W.pair(m2)
    for name, want in (("negate", -W.signed(m1)),):
        jr, r = W.jev.negate(j1), W.ev.negate(c1)
        same_ct(jr, r)
        W.check(r, want)
    for name, want in (("add", W.signed(m1) + m2), ("sub", W.signed(m1) - W.signed(m2))):
        jr, r = getattr(W.jev, name)(j1, j2), getattr(W.ev, name)(c1, c2)
        same_ct(jr, r)
        W.check(r, want)


def test_multiply_relinearize_square(W):
    m1, m2 = W.message(), W.message()
    (j1, c1), (j2, c2) = W.pair(m1), W.pair(m2)
    jm, m = W.jev.multiply(j1, j2), W.ev.multiply(c1, c2)
    same_ct(jm, m)
    want = W.signed(m1) * W.signed(m2)
    W.check(m, want, 1e-5)
    jr, r = W.jev.relinearize(jm, W.jrlk), W.ev.relinearize(m, W.rlk)
    same_ct(jr, r)
    W.check(r, want, 1e-5)
    js, s = W.jev.square(j1), W.ev.square(c1)
    same_ct(js, s)
    W.check(s, W.signed(m1) * W.signed(m1), 1e-5)


def test_plain_ops(W):
    m1, m2 = W.message(), W.message()
    j1, c1 = W.pair(m1)
    jpt = W.jencode(m2)
    pt = W.cod.encode(m2, scale=SCALE) if W.ckks else W.cod.encode(m2)
    for name, want, atol in (("add_plain", W.signed(m1) + m2, 1e-6),
                             ("sub_plain", W.signed(m1) - W.signed(m2), 1e-6),
                             ("multiply_plain", W.signed(m1) * W.signed(m2), 1e-4)):
        jr, r = getattr(W.jev, name)(j1, jpt), getattr(W.ev, name)(c1, pt)
        same_ct(jr, r)
        W.check(r, want, atol)


def test_mod_switch_and_rescale(W):
    m = W.message()
    j1, c1 = W.pair(m)
    jd, d = W.jev.mod_switch_to_next(j1), W.ev.mod_switch_to_next(c1)
    same_ct(jd, d)
    assert d.coeff_modulus_size == len(BITS) - 2
    W.check(d, m, 1e-5)
    if W.ckks:
        m2 = W.message()
        j2, c2 = W.pair(m2)
        jp = W.jev.relinearize(W.jev.multiply(j1, j2), W.jrlk)
        p = W.ev.relinearize(W.ev.multiply(c1, c2), W.rlk)
        jr, r = W.jev.rescale_to_next(jp), W.ev.rescale_to_next(p)
        same_ct(jr, r)
        W.check(r, m * m2, 1e-5)


def test_rotate_conjugate(W):
    jglk, glk = W.galois_keys()
    for g in jglk.keys:
        same_w(jglk.keys[g], glk.keys[g])
    m = W.message()
    j1, c1 = W.pair(m)
    if W.ckks:
        cases = (("rotate_vector", (1,), np.roll(m, -1)), ("complex_conjugate", (), np.conj(m)))
    else:
        h = W.n // 2
        cases = (("rotate_rows", (1,), np.concatenate([np.roll(m[:h], -1), np.roll(m[h:], -1)])),
                 ("rotate_columns", (), np.concatenate([m[h:], m[:h]])))
    for name, args, want in cases:
        jr, r = getattr(W.jev, name)(j1, *args, jglk), getattr(W.ev, name)(c1, *args, glk)
        same_ct(jr, r)
        W.check(r, want, 1e-5)


def test_size4_relinearize(W):
    jrlk3, rlk3 = W.jkg.create_relin_keys(max_power=3), W.kg.create_relin_keys(max_power=3)
    for idx in jrlk3.keys:
        same_w(jrlk3.keys[idx], rlk3.keys[idx])
    ms = [W.message() for _ in range(3)]
    pairs = [W.pair(m) for m in ms]
    jp = W.jev.multiply(W.jev.multiply(pairs[0][0], pairs[1][0]), pairs[2][0])
    p = W.ev.multiply(W.ev.multiply(pairs[0][1], pairs[1][1]), pairs[2][1])
    assert p.size == 4
    jr, r = W.jev.relinearize(jp, jrlk3), W.ev.relinearize(p, rlk3)
    same_ct(jr, r)
    W.check(r, W.signed(ms[0]) * W.signed(ms[1]) * W.signed(ms[2]))


def test_noise_budget(W):
    j1, c1 = W.pair(W.message())
    got = W.dec.invariant_noise_budget(c1)
    assert got > 0 and got == W.jdec.invariant_noise_budget(j1)


def test_serialize_bytes(W):
    """Every wide object's bytes equal the JAX package's in each mode, and
    each package loads the other's (the JAX package cannot expand a seeded
    coefficient-form wide ciphertext: its seed expansion runs the fast-path
    inverse NTT, so only the port loads those)."""
    m = W.message()
    jpt = W.jencode(m)
    pt = W.cod.encode(m, scale=SCALE) if W.ckks else W.cod.encode(m)
    jseeded = W.jencr.encrypt_symmetric(jpt, save_seed=True)
    seeded = interop.ciphertext(np.asarray(jseeded.data), jseeded.parms_id, "cpu",
                                bool(jseeded.is_ntt_form), jseeded.scale,
                                jseeded.correction_factor)
    seeded.seed = jseeded.seed
    j1, c1 = W.pair(m)
    for mode in MODES:
        jm, tm = getattr(JS.CompressionMode, mode), getattr(TS.CompressionMode, mode)
        for jct, ct in ((j1, c1), (jseeded, seeded)):
            bj, bt = JS.save_ciphertext(jct, W.jc, jm), TS.save_ciphertext(ct, W.tc, tm)
            assert bj == bt
            assert len(bt) <= TS.ciphertext_size_upperbound(ct)
            back = TS.load_ciphertext(bj, W.tc)
            if ct.seed is None or ct.is_ntt_form:
                same_ct(JS.load_ciphertext(bt, W.jc), back)
            same_w(jct.data, back.data) if ct.seed is None else W.check(back, m)
        assert JS.save_plaintext(jpt, jm) == TS.save_plaintext(pt, tm)
        assert JS.save_secret_key(W.jkg.secret_key, jm) == TS.save_secret_key(W.kg.secret_key, tm)
        assert JS.save_public_key(W.jpk, W.jc, jm) == TS.save_public_key(W.pk, W.tc, tm)
        assert JS.save_kswitch_keys(W.jrlk, jm) == TS.save_kswitch_keys(W.rlk, tm)
        same_w(W.jrlk.keys[0], TS.load_relin_keys(JS.save_kswitch_keys(W.jrlk, jm), "cpu").keys[0])
        same_w(W.jkg.secret_key.data,
               TS.load_secret_key(JS.save_secret_key(W.jkg.secret_key, jm), "cpu").data)
    assert len(TS.save_ciphertext(seeded, W.tc)) < len(TS.save_ciphertext(c1, W.tc))


def test_batched_ops(W):
    ms1, ms2 = [W.message() for _ in range(3)], [W.message() for _ in range(3)]
    p1, p2 = [W.pair(m) for m in ms1], [W.pair(m) for m in ms2]
    for name, op in (("add_batched", lambda a, b: W.signed(a) + b),
                     ("multiply_batched", lambda a, b: W.signed(a) * W.signed(b))):
        jouts = getattr(W.jev, name)([j for j, _ in p1], [j for j, _ in p2])
        outs = getattr(W.ev, name)([c for _, c in p1], [c for _, c in p2])
        for jo, o, a, b in zip(jouts, outs, ms1, ms2):
            same_ct(jo, o)
            W.check(o, op(a, b), 1e-5)


def test_stacked_steps(W):
    """BatchedEvaluator's mul+relin step on a (3, 2, L, n) stack, its
    rotation step and (CKKS) rescale step equal the JAX package's stacked
    steps and the object API."""
    jcd, cd = W.jc.first_context_data(), W.tc.first_context_data()
    jb, b = JBatched(W.jev, jcd), BatchedEvaluator(W.ev, cd)
    p1, p2 = [W.pair(W.message()) for _ in range(3)], [W.pair(W.message()) for _ in range(3)]
    js1, s1 = jb.stack([j for j, _ in p1]), b.stack([c for _, c in p1])
    js2, s2 = jb.stack([j for j, _ in p2]), b.stack([c for _, c in p2])
    same_w(js1, s1)
    jout = jb.build_mul_relin_step(W.jrlk.key(2))(js1, js2, W.jrlk.key(2))
    out = b.build_mul_relin_step(W.rlk.key(2))(s1, s2, W.rlk.key(2))
    same_w(jout, out)
    want = W.ev.relinearize(W.ev.multiply(p1[0][1], p2[0][1]), W.rlk)
    np.testing.assert_array_equal(out[0].numpy(), want.data.numpy())
    assert [c.data.shape for c in b.unstack(out, p1[0][1])] == [want.data.shape] * 3
    jglk, glk = W.galois_keys()
    jstep, jelts = jb.build_rotate_rows_step(1)
    step, elts = b.build_rotate_rows_step(1)
    assert elts == jelts
    same_w(jstep(js1, tuple(jglk.key(e) for e in jelts)),
           step(s1, tuple(glk.key(e) for e in elts)))
    if W.ckks:
        same_w(jb.build_rescale_step()(jout), b.build_rescale_step()(out))


def test_batched_client_steps(W):
    """BatchedClient at the wide width: the symmetric and asymmetric encrypt
    steps chained twice from one state (the probe is the state's first u32
    word, the high word of a wide residue), and the decrypt step."""
    jcd, cd = W.jc.first_context_data(), W.tc.first_context_data()
    jcl, cl = JClient(W.jc, jcd), BatchedClient(W.tc, cd)
    jkeys, keys = JRandom(0xC11E, domain="bench").base_keys, \
        RandomGenerator(0xC11E, domain="bench").base_keys
    m = W.message()
    jpt = W.jencode(m)
    pt = W.cod.encode(m, scale=SCALE) if W.ckks else W.cod.encode(m)
    start = W.rng.integers(0, 1 << 40, (2, 2, cd.coeff_modulus_size, W.n))
    jcur, cur = jnp.asarray(interop.to_numpy(torch.from_numpy(start), wide=True)), \
        torch.from_numpy(start)
    for build, jarg, arg in (("build_encrypt_symmetric_step", W.jkg.secret_key.data,
                              W.kg.secret_key.data),
                             ("build_encrypt_asymmetric_step", W.jpk.data(), W.pk.data())):
        jstep = getattr(jcl, build)(jkeys, jpt.data, bool(jpt.is_ntt_form))
        step = getattr(cl, build)(keys, pt.data, pt.is_ntt_form)
        for _ in range(2):
            jcur, cur = jstep(jcur, jarg), step(cur, arg)
            same_w(jcur, cur)
    jdec = jcl.build_decrypt_step([W.jkg.secret_key.data])
    dec = cl.build_decrypt_step([W.kg.secret_key.data])
    got = dec(cur)
    if W.ckks:
        same_w(jdec(jcur), got)
    else:
        np.testing.assert_array_equal(np.asarray(jdec(jcur)).astype(np.int64), got.numpy())
        np.testing.assert_array_equal(
            got[0].numpy(), W.cod.decode_polynomial(W.cod.encode(m)).astype(np.int64))

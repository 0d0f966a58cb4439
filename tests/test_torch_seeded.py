"""Seeded ciphertexts and the context's default streams (threefry) of the
port against the JAX package, bit for bit, for BFV, CKKS and BGV at
n = 1024 on 4 x 30-bit primes (the last special; t =
PlainModulus.batching(1024, 20) for BFV and BGV, CKKS at scale 2^25).

Seeded holds one scheme's parameters in both packages, each context created
with the same seed and every object drawing from the context's default
streams (no prng= on either side).  The secret key, the public key (seeded
and not), relin and Galois keys, symmetric encryptions (seeded and not),
asymmetric encryptions, special-prime encryptions (which drop the seed) and
Plain2d.encrypt_symmetric(save_seed=True) must equal the JAX objects with
tolerance 0, seeds included, and decrypt right: exactly for BFV and BGV,
within 1e-3 for CKKS (a public-key encryption's noise at scale 2^25 reaches
4e-4 in a slot at n = 1024)."""

import numpy as np
import pytest

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                         SecurityLevel as JSec)
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.core.keygen import KeyGenerator as JKeyGen
from troy_tpu.core.encryptor import Encryptor as JEncryptor
from troy_tpu.core.batch_encoder import BatchEncoder as JBatchEncoder
from troy_tpu.core.ckks_encoder import CKKSEncoder as JCKKSEncoder
from troy_tpu.app.cipher2d import Plain2d as JPlain2d
from troy_tpu_torch.app.cipher2d import Plain2d
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_client import same

N, BITS, LOG_T, SEED, SCALE = 1024, [30, 30, 30, 30], 20, 0x5EED5, 2.0 ** 25
SCHEMES = ["BFV", "CKKS", "BGV"]
CKKS_ATOL = 1e-3


class Seeded:
    """One scheme in both packages under one context seed, every object on
    the context's default streams."""

    def __init__(self, scheme: str, special_prime: bool = False, seed: int = SEED):
        self.scheme = scheme
        self.ckks = scheme == "CKKS"
        jp = JParams(JScheme[scheme]).set_poly_modulus_degree(N)
        jp.set_coeff_modulus(JCoeff.create(N, BITS))
        tp = EncryptionParameters(SchemeType[scheme]).set_poly_modulus_degree(N)
        tp.set_coeff_modulus(CoeffModulus.create(N, BITS))
        if not self.ckks:
            jp.set_plain_modulus(JPlain.batching(N, LOG_T))
            tp.set_plain_modulus(PlainModulus.batching(N, LOG_T))
        jp.set_use_special_prime_for_encryption(special_prime)
        tp.set_use_special_prime_for_encryption(special_prime)
        self.jc = JContext.create(jp, True, JSec.Nil, seed)
        self.tc = HeContext.create(tp, "cpu", SecurityLevel.Nil, seed=seed)
        self.jkg, self.kg = JKeyGen(self.jc), KeyGenerator(self.tc)
        if self.ckks:
            self.jcod, self.cod = JCKKSEncoder(self.jc), CKKSEncoder(self.tc)
        else:
            self.jcod, self.cod = JBatchEncoder(self.jc), BatchEncoder(self.tc)
            self.t = jp.plain_modulus.value
        self.dec = Decryptor(self.tc, self.kg.secret_key)
        self.rng = np.random.default_rng(99)

    def encryptors(self, jpk=None, pk=None):
        return (JEncryptor(self.jc, pk=jpk, sk=self.jkg.secret_key),
                Encryptor(self.tc, sk=self.kg.secret_key, pk=pk))

    def message(self):
        if self.ckks:
            return self.rng.uniform(-1, 1, N // 2) + 1j * self.rng.uniform(-1, 1, N // 2)
        return self.rng.integers(0, self.t, size=N, dtype=np.uint64)

    def encode(self, m):
        if self.ckks:
            return self.jcod.encode(m, scale=SCALE), self.cod.encode(m, scale=SCALE)
        return self.jcod.encode(m), self.cod.encode(m)

    def check_decrypts(self, ct, m):
        got = self.cod.decode(self.dec.decrypt(ct))
        if self.ckks:
            np.testing.assert_allclose(got, m, rtol=0, atol=CKKS_ATOL)
        else:
            np.testing.assert_array_equal(got.numpy(), m.astype(np.int64))


def same_ct(jct, ct):
    same(jct.data, ct.data)
    assert ct.parms_id == jct.parms_id and ct.is_ntt_form == bool(jct.is_ntt_form)
    assert (ct.seed, ct.scale, ct.correction_factor) == \
        (jct.seed, jct.scale, jct.correction_factor)


def same_keys(jk, k):
    assert sorted(jk.keys) == sorted(k.keys) and k.parms_id == jk.parms_id
    for idx in jk.keys:
        same(jk.keys[idx], k.keys[idx])


@pytest.fixture(scope="module", params=SCHEMES)
def S(request):
    return Seeded(request.param)


def test_default_streams_match_jax(S):
    """F5: from the same context seed and no prng= on either side, the
    secret key, public key, relin keys and a symmetric encryption equal the
    JAX package's (the port keyed its default streams by AES before)."""
    seeded = Seeded(S.scheme, seed=0xF5)
    assert seeded.kg.generator.mode == "threefry"
    same(seeded.jkg.secret_key.data, seeded.kg.secret_key.data)
    same(seeded.jkg.create_public_key().data(), seeded.kg.create_public_key().data())
    same_keys(seeded.jkg.create_relin_keys(), seeded.kg.create_relin_keys())
    jencr, encr = seeded.encryptors()
    m = seeded.message()
    jpt, pt = seeded.encode(m)
    ct = encr.encrypt_symmetric(pt)
    same_ct(jencr.encrypt_symmetric(jpt), ct)
    seeded.check_decrypts(ct, m)


@pytest.mark.parametrize("save_seed", [False, True])
def test_public_key(S, save_seed):
    jpk, pk = S.jkg.create_public_key(save_seed), S.kg.create_public_key(save_seed)
    same_ct(jpk.ciphertext, pk.ciphertext)
    assert (pk.ciphertext.seed is not None) == save_seed
    jencr, encr = S.encryptors(jpk, pk)
    m = S.message()
    jpt, pt = S.encode(m)
    ct = encr.encrypt_asymmetric(pt)
    same_ct(jencr.encrypt_asymmetric(jpt), ct)
    S.check_decrypts(ct, m)


def test_relin_and_galois_keys(S):
    same_keys(S.jkg.create_relin_keys(3), S.kg.create_relin_keys(3))
    elts = [3, 5, 2 * N - 1]
    same_keys(S.jkg.create_galois_keys_from_elements(elts),
              S.kg.create_galois_keys_from_elements(elts))


@pytest.mark.parametrize("save_seed", [False, True])
def test_symmetric_encryption(S, save_seed):
    jencr, encr = S.encryptors()
    for _ in range(2):
        m = S.message()
        jpt, pt = S.encode(m)
        ct = encr.encrypt_symmetric(pt, save_seed=save_seed)
        same_ct(jencr.encrypt_symmetric(jpt, save_seed=save_seed), ct)
        assert (ct.seed is not None) == save_seed
        S.check_decrypts(ct, m)
    jz, z = jencr.encrypt_zero_symmetric(save_seed=save_seed), \
        encr.encrypt_zero_symmetric(save_seed=save_seed)
    same_ct(jz, z)
    assert encr.generator.counter == jencr.prng._counter
    jbs = jencr.encrypt_symmetric_batched([jpt, jpt], save_seed=save_seed)
    bs = encr.encrypt_symmetric_batched([pt, pt], save_seed=save_seed)
    for jct, ct in zip(jbs, bs):
        same_ct(jct, ct)


def test_seeded_c1_is_the_seed_expansion(S):
    """A seeded ciphertext's c1 is uniform_from_seed of its seed, in the
    ciphertext's form; the clone keeps the seed and like drops it."""
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.ops import ntt as NTT
    from troy_tpu_torch.utils.random import uniform_from_seed

    _, encr = S.encryptors()
    ct = encr.encrypt_symmetric(S.encode(S.message())[1], save_seed=True)
    cd = S.tc.get_context_data(ct.parms_id)
    a = uniform_from_seed(ct.seed, (cd.coeff_modulus_size, N), cd.qtab())
    assert bool((ct.data[1] == (a if ct.is_ntt_form else NTT.ntt_inverse(a, cd.qtab()))).all())
    assert ct.clone().seed == ct.seed and Ciphertext.like(ct).seed is None
    assert not bool(Ciphertext.like(ct, 3).data.any()) and Ciphertext.like(ct, 3).size == 3


def test_plain2d_encrypt_symmetric_save_seed(S):
    jencr, encr = S.encryptors()
    pairs = [S.encode(S.message()) for _ in range(3)]
    jp2 = JPlain2d([[pairs[0][0], pairs[1][0]], [pairs[2][0]]])
    p2 = Plain2d([[pairs[0][1], pairs[1][1]], [pairs[2][1]]])
    jc2, c2 = jp2.encrypt_symmetric(jencr, save_seed=True), p2.encrypt_symmetric(encr, True)
    for jrow, row in zip(jc2.data, c2.data):
        assert len(jrow) == len(row)
        for jct, ct in zip(jrow, row):
            same_ct(jct, ct)
            assert ct.seed is not None


@pytest.mark.parametrize("scheme", SCHEMES)
def test_special_prime_encryption_drops_the_seed(scheme):
    sp = Seeded(scheme, special_prime=True)
    jpk, pk = sp.jkg.create_public_key(), sp.kg.create_public_key()
    jencr, encr = sp.encryptors(jpk, pk)
    m = sp.message()
    jpt, pt = sp.encode(m)
    for ct, jct in ((encr.encrypt_symmetric(pt, save_seed=True),
                     jencr.encrypt_symmetric(jpt, save_seed=True)),
                    (encr.encrypt_asymmetric(pt), jencr.encrypt_asymmetric(jpt))):
        same_ct(jct, ct)
        assert ct.seed is None
        sp.check_decrypts(ct, m)


def test_a_generator_gives_seeded_ciphertexts_too():
    """With a torch.Generator the seed is drawn from it; the ciphertext
    still decrypts and its c1 is the seed's expansion."""
    import torch

    S = Seeded("BFV")
    encr = Encryptor(S.tc, sk=S.kg.secret_key, generator=torch.Generator().manual_seed(4))
    m = S.message()
    ct = encr.encrypt_symmetric(S.encode(m)[1], save_seed=True)
    assert 0 < ct.seed < 1 << 63
    S.check_decrypts(ct, m)


def test_explicit_aes_streams_stay_opt_in():
    """prng= still wins over the context seed: an AES stream gives the JAX
    package's AES keys."""
    from troy_tpu.utils.random import RandomGenerator as JRandom

    S = Seeded("BFV")
    jkg = JKeyGen(S.jc, prng=JRandom(SEED, mode="aes", domain="keygen"))
    kg = KeyGenerator(S.tc, prng=RandomGenerator(SEED, "aes", "keygen"))
    same(jkg.secret_key.data, kg.secret_key.data)
    assert not bool((kg.secret_key.data == S.kg.secret_key.data).all())

"""Port client side against the JAX package, bit for bit where the math is
deterministic: the symmetric- and public-key-encryption and switching-key
combines with injected (numpy-made) randomness, batch encode/decode, and BFV
decrypt of ciphertexts carried over from the JAX package.  Encryption under
the port's own torch.Generator, with the secret key or a public key made by
either package, is checked by decryption in both packages; the quickstart
example's flow runs on the port.

Both (the pair of contexts and a JAX key set carried over) is shared with the
other test_torch_* files of the evaluator's operations."""

import numpy as np
import jax.numpy as jnp
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
from troy_tpu.core.batch_encoder import BatchEncoder as JEncoder
from troy_tpu.core.ciphertext import Ciphertext as JCiphertext
from troy_tpu.core.plaintext import Plaintext as JPlaintext
from troy_tpu.core.keys import SecretKey as JSecretKey
from troy_tpu.core.rlwe import (_symmetric_combine as j_symmetric_combine,
                                _asymmetric_combine as j_asymmetric_combine)
from troy_tpu_torch import interop
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.plaintext import Plaintext
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.core.rlwe import _symmetric_combine, _asymmetric_combine
from troy_tpu_torch.utils.random import RandomGenerator

N, BITS, LOG_T = 1024, [30, 30, 30, 30], 20
RNG = np.random.default_rng(31)


class Both:
    """The same BFV parameters in both packages (n = 1024, 4 x 30-bit
    primes), the JAX package's secret key carried over, and the encoders,
    evaluators and decryptors of both."""

    def __init__(self, special_prime: bool = False):
        jp = JParams(JScheme.BFV).set_poly_modulus_degree(N)
        jp.set_coeff_modulus(JCoeff.create(N, BITS)).set_plain_modulus(
            JPlain.batching(N, LOG_T))
        jp.set_use_special_prime_for_encryption(special_prime)
        self.jc = JContext.create(jp, True, JSec.Nil, 0x5EED)
        tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
        tp.set_coeff_modulus(CoeffModulus.create(N, BITS)).set_plain_modulus(
            PlainModulus.batching(N, LOG_T))
        tp.set_use_special_prime_for_encryption(special_prime)
        self.tc = HeContext.create(tp, sec_level=SecurityLevel.Nil, device="cpu")
        self.jkg = JKeyGen(self.jc)
        self.sk = interop.secret_key(np.asarray(self.jkg.secret_key.data),
                                     self.tc.key_parms_id, "cpu")
        self.jenc = JEncoder(self.jc)
        self.tenc = BatchEncoder(self.tc)
        self.jev = JEvaluator(self.jc)
        self.ev = Evaluator(self.tc)
        self.jdec = JDecryptor(self.jc, self.jkg.secret_key)
        self.dec = Decryptor(self.tc, self.sk)
        self.t = jp.plain_modulus.value

    def messages(self, count: int, rng=RNG) -> np.ndarray:
        return rng.integers(0, self.t, size=(count, N), dtype=np.uint64)

    def jax_cts(self, msgs) -> list:
        """JAX symmetric encryptions of msgs at the first level."""
        jencr = JEncryptor(self.jc, sk=self.jkg.secret_key)
        return [jencr.encrypt_symmetric(self.jenc.encode(m)) for m in msgs]

    def port(self, jct) -> Ciphertext:
        """A JAX ciphertext carried over to the port."""
        return interop.ciphertext(np.asarray(jct.data), jct.parms_id, "cpu",
                                  bool(jct.is_ntt_form))

    def decode(self, ct: Ciphertext) -> np.ndarray:
        """The port's decryption and decoding, as int64 slots."""
        return self.tenc.decode(self.dec.decrypt(ct))

    def jax_decode(self, ct: Ciphertext, sk=None) -> np.ndarray:
        """The JAX package's decryption of a port ciphertext, under the JAX
        secret key or a port secret key carried over."""
        jsk = self.jkg.secret_key if sk is None else JSecretKey(
            jnp.asarray(interop.to_numpy(sk.data)), sk.parms_id)
        jct = JCiphertext(jnp.asarray(interop.to_numpy(ct.data)), ct.parms_id,
                          is_ntt_form=ct.is_ntt_form)
        return self.jenc.decode(JDecryptor(self.jc, jsk).decrypt(jct)).astype(np.int64)

    def residues(self, cd, lead):
        q = np.array(cd.base_q.values, dtype=np.uint64)[:, None]
        return (RNG.integers(0, 1 << 62, size=(*lead, len(cd.base_q.values), N),
                             dtype=np.uint64) % q).astype(np.uint32)

    def lift(self, cd, e):
        """Signed small values (..., n) -> u32 residues (..., L, n)."""
        q = np.array(cd.base_q.values, dtype=np.int64)[:, None]
        return ((e[..., None, :] % q)).astype(np.uint32)


@pytest.fixture(scope="module")
def both():
    return Both()


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.cpu().numpy())


def same_ct(jct, ct):
    """A port ciphertext equals a JAX one: residues bit for bit, form, level."""
    same(jct.data, ct.data)
    assert ct.is_ntt_form == bool(jct.is_ntt_form) and ct.parms_id == jct.parms_id


@pytest.mark.parametrize("ntt_form", [False, True])
def test_symmetric_combine(both, ntt_form):
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    a = both.residues(jcd, ())
    e = both.lift(jcd, RNG.integers(-21, 22, size=N))
    j = j_symmetric_combine(jcd, both.jkg.secret_key.data, jnp.asarray(a),
                            jnp.asarray(e), ntt_form)
    t = _symmetric_combine(tcd, both.sk.data, interop.to_tensor(a, "cpu"),
                           interop.to_tensor(e, "cpu"), ntt_form)
    same(j, t)


def test_kswitch_combine(both):
    jcd, tcd = both.jc.key_context_data(), both.tc.key_context_data()
    decomp = jcd.coeff_modulus_size - 1
    target = both.residues(jcd, ())
    a = both.residues(jcd, (decomp,))
    e = both.lift(jcd, RNG.integers(-21, 22, size=(decomp, N)))
    j = JKeyGen._kswitch_combine(both.jkg, jcd, jnp.asarray(target), jnp.asarray(a),
                                 jnp.asarray(e), both.jkg.secret_key.data)
    t = KeyGenerator._kswitch_combine(tcd, *(interop.to_tensor(v, "cpu")
                                             for v in (target, a, e)), both.sk.data)
    assert tuple(t.shape) == (decomp, 2, jcd.coeff_modulus_size, N)
    same(j, t)


def test_secret_key_power(both):
    kg = KeyGenerator(both.tc, torch.Generator().manual_seed(0), sk=both.sk)
    same(both.jkg.secret_key_power(3), kg.secret_key_power(3))


def test_encode_decode(both):
    values = RNG.integers(0, both.t, size=N, dtype=np.uint64)
    tp = both.tenc.encode(values)
    same(both.jenc.encode(values).data, tp.data)
    plain = RNG.integers(0, both.t, size=(1, N)).astype(np.uint32)
    np.testing.assert_array_equal(both.jenc.decode(JPlaintext(jnp.asarray(plain))),
                                  both.tenc.decode(Plaintext(interop.to_tensor(plain, "cpu"))))
    short = [5, 6, 7]
    same(both.jenc.encode(short).data, both.tenc.encode(short).data)


@pytest.mark.parametrize("size", [2, 3])
def test_decrypt_jax_ciphertexts(both, size):
    jcd = both.jc.first_context_data()
    jencr = JEncryptor(both.jc, sk=both.jkg.secret_key)
    m1, m2 = (RNG.integers(0, both.t, size=N, dtype=np.uint64) for _ in range(2))
    ct = jencr.encrypt_symmetric(both.jenc.encode(m1))
    if size == 3:
        ct = JEvaluator(both.jc).multiply(ct, jencr.encrypt_symmetric(both.jenc.encode(m2)))
    assert ct.size == size
    want = JDecryptor(both.jc, both.jkg.secret_key).decrypt(ct).data
    got = Decryptor(both.tc, both.sk).decrypt(
        interop.ciphertext(np.asarray(ct.data), jcd.parms_id, "cpu"))
    same(want, got.data)


def test_port_encryption_decrypts_in_both_packages(both):
    gen = torch.Generator().manual_seed(9)
    encr = Encryptor(both.tc, both.sk, gen)
    m = RNG.integers(0, both.t, size=N, dtype=np.uint64)
    ct = encr.encrypt_symmetric(both.tenc.encode(m))
    assert ct.data.dtype == torch.int64 and tuple(ct.data.shape) == (2, 3, N)
    got = both.tenc.decode(Decryptor(both.tc, both.sk).decrypt(ct))
    np.testing.assert_array_equal(got, m.astype(np.int64))
    jct = JCiphertext(jnp.asarray(interop.to_numpy(ct.data)), ct.parms_id)
    jgot = both.jenc.decode(JDecryptor(both.jc, both.jkg.secret_key).decrypt(jct))
    np.testing.assert_array_equal(jgot, m)


def test_port_keys_relinearize(both):
    """Keys made by the port's own generator relinearize correctly."""
    from troy_tpu_torch.core.evaluator import Evaluator

    gen = torch.Generator().manual_seed(11)
    kg = KeyGenerator(both.tc, gen)
    encr = Encryptor(both.tc, kg.secret_key, gen)
    ev = Evaluator(both.tc)
    m1, m2 = (RNG.integers(0, both.t, size=N, dtype=np.uint64) for _ in range(2))
    prod = ev.multiply(encr.encrypt_symmetric(both.tenc.encode(m1)),
                       encr.encrypt_symmetric(both.tenc.encode(m2)))
    ct = ev.relinearize(prod, kg.create_relin_keys())
    assert ct.size == 2
    got = both.tenc.decode(Decryptor(both.tc, kg.secret_key).decrypt(ct))
    np.testing.assert_array_equal(
        got, ((m1.astype(object) * m2) % both.t).astype(np.int64))


@pytest.mark.parametrize("ntt_form", [False, True])
def test_asymmetric_combine(both, ntt_form):
    """Public-key encryption of zero from injected u, e0, e1."""
    kcd = both.jc.key_context_data()
    jcd, tcd = both.jc.first_context_data(), both.tc.first_context_data()
    pk = both.residues(kcd, (2,))
    u = both.lift(jcd, RNG.integers(-1, 2, size=N))
    e0, e1 = (both.lift(jcd, RNG.integers(-21, 22, size=N)) for _ in range(2))
    j = j_asymmetric_combine(jcd, jnp.asarray(pk), jnp.asarray(u), jnp.asarray(e0),
                             jnp.asarray(e1), ntt_form)
    t = _asymmetric_combine(tcd, *(interop.to_tensor(v, "cpu") for v in (pk, u, e0, e1)),
                            ntt_form)
    same(j, t)


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_public_key_encryption_decrypts_in_both_packages(both, maker):
    """encrypt_asymmetric under a public key made by either package."""
    gen = torch.Generator().manual_seed(13)
    if maker == "jax":
        jpk = both.jkg.create_public_key()
        pk = interop.public_key(np.asarray(jpk.data()), jpk.parms_id, "cpu")
    else:
        pk = KeyGenerator(both.tc, gen, sk=both.sk).create_public_key()
        assert pk.ciphertext.is_ntt_form and tuple(pk.data().shape) == (2, 4, N)
    encr = Encryptor(both.tc, pk=pk, generator=gen)
    m = both.messages(1)[0]
    ct = encr.encrypt_asymmetric(both.tenc.encode(m))
    assert not ct.is_ntt_form and tuple(ct.data.shape) == (2, 3, N)
    np.testing.assert_array_equal(both.decode(ct), m.astype(np.int64))
    np.testing.assert_array_equal(both.jax_decode(ct), m.astype(np.int64))


def test_encryptor_needs_its_key(both):
    encr = Encryptor(both.tc, generator=torch.Generator())
    with pytest.raises(ValueError, match="public key"):
        encr.encrypt_zero_asymmetric()
    with pytest.raises(ValueError, match="secret key"):
        encr.encrypt_zero_symmetric()
    # without a generator or a context seed: a threefry stream under a
    # fresh 128-bit seed, as the JAX package draws one
    a, b = Encryptor(both.tc, both.sk).generator, Encryptor(both.tc, both.sk).generator
    assert isinstance(a, RandomGenerator) and a.mode == "threefry" and a.domain == "encryptor"
    assert a.seed != b.seed and max(a.seed, b.seed) < 1 << 128


def test_quickstart_flow_on_port():
    """examples/99_quickstart.py on the port: public-key encryption of two
    slot vectors, add, decrypt, decode, at the example's parameters."""
    n = 8192
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    context = HeContext.create(parms, True, SecurityLevel.Classical128, device="cpu")
    gen = torch.Generator().manual_seed(99)
    keygen = KeyGenerator(context, gen)
    encryptor = Encryptor(context, pk=keygen.create_public_key(), generator=gen)
    decryptor = Decryptor(context, keygen.secret_key)
    evaluator = Evaluator(context)
    encoder = BatchEncoder(context)
    x = np.arange(n, dtype=np.uint64)
    y = np.arange(n, dtype=np.uint64)[::-1].copy()
    ct_sum = evaluator.add(encryptor.encrypt_asymmetric(encoder.encode(x)),
                           encryptor.encrypt_asymmetric(encoder.encode(y)))
    result = encoder.decode(decryptor.decrypt(ct_sum))
    np.testing.assert_array_equal(result, ((x + y) % parms.plain_modulus.value).astype(np.int64))

"""Port client side against the JAX package, bit for bit where the math is
deterministic: the symmetric-encryption and switching-key combines with
injected (numpy-made) randomness, batch encode/decode, and BFV decrypt of
ciphertexts carried over from the JAX package.  Encryption under the port's
own torch.Generator is checked by decryption in both packages."""

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
from troy_tpu.core.rlwe import _symmetric_combine as j_symmetric_combine
from troy_tpu_torch import interop
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.plaintext import Plaintext
from troy_tpu_torch.core.rlwe import _symmetric_combine

N, BITS, LOG_T = 1024, [30, 30, 30, 30], 20
RNG = np.random.default_rng(31)


class Both:
    def __init__(self):
        jp = JParams(JScheme.BFV).set_poly_modulus_degree(N)
        jp.set_coeff_modulus(JCoeff.create(N, BITS)).set_plain_modulus(
            JPlain.batching(N, LOG_T))
        self.jc = JContext.create(jp, True, JSec.Nil, 0x5EED)
        tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
        tp.set_coeff_modulus(CoeffModulus.create(N, BITS)).set_plain_modulus(
            PlainModulus.batching(N, LOG_T))
        self.tc = HeContext.create(tp, "cpu", sec_level=SecurityLevel.Nil)
        self.jkg = JKeyGen(self.jc)
        self.sk = interop.secret_key(np.asarray(self.jkg.secret_key.data),
                                     self.tc.key_parms_id, "cpu")
        self.jenc = JEncoder(self.jc)
        self.tenc = BatchEncoder(self.tc)
        self.t = jp.plain_modulus.value

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
    same(both.jenc.decode(JPlaintext(jnp.asarray(plain))),
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
    np.testing.assert_array_equal(got.numpy(), m.astype(np.int64))
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
        got.numpy(), ((m1.astype(object) * m2) % both.t).astype(np.int64))

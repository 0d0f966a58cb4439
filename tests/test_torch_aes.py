"""The port's AES-CTR samplers (troy_tpu_torch/native, utils/random.py mode
"aes") against the JAX package's, bit for bit: the keystream bytes, every
sampler and the block counter after each call, and the BFV quickstart's
keys and ciphertexts when both packages draw from RandomGenerator(seed,
mode="aes") streams with the same seed and domains."""

import numpy as np
import pytest
import torch

from troy_tpu import native as jnative
from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                         SecurityLevel as JSec)
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.core.keygen import KeyGenerator as JKeyGen
from troy_tpu.core.encryptor import Encryptor as JEncryptor
from troy_tpu.core.decryptor import Decryptor as JDecryptor
from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.core.batch_encoder import BatchEncoder as JEncoder
from troy_tpu.utils.random import RandomGenerator as JRandom
from troy_tpu_torch import native
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_client import same

KEYS = [bytes(16), bytes(range(16)), bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")]


@pytest.mark.parametrize("counter", [0, 7, (1 << 64) - 2, (1 << 64) + 5, 1 << 100])
def test_aes_bytes_match_jax(counter):
    """The keystream for several keys and byte counts (most not multiples of
    16), from counters on both sides of 2^64."""
    for key in KEYS:
        for nbytes in (1, 15, 16, 33, 1000):
            assert native.aes128_ctr_bytes(key, counter, nbytes) == \
                jnative.aes128_ctr_bytes(key, counter, nbytes)


def test_aes_is_aes128():
    """FIPS-197 appendix C.1: AES-128 of 00112233...ff under 000102...0f."""
    counter = int.from_bytes(bytes.fromhex("00112233445566778899aabbccddeeff"), "little")
    assert native.aes128_ctr_bytes(bytes(range(16)), counter, 16).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


class Q:
    """The port's samplers read only a (L,) q from their tables."""

    def __init__(self, primes):
        self.q = torch.tensor(primes, dtype=torch.int64)


@pytest.mark.parametrize("seed,domain", [(0x5EED, "keygen"), (12345, "encryptor"), (0, "")])
def test_samplers_match_jax(seed, domain):
    """uniform, ternary and CBD draws, in an interleaved order, and the
    block counter after each."""
    jp = JParams(JScheme.BFV).set_poly_modulus_degree(64).set_coeff_modulus(
        JCoeff.create(64, [30, 30, 30])).set_plain_modulus(JPlain.batching(64, 20))
    jcd = JContext.create(jp, True, JSec.Nil, seed).key_context_data()
    qtab = jcd.qtab()
    t = Q(jcd.base_q.values)
    jr, tr = JRandom(seed, mode="aes", domain=domain), RandomGenerator(seed, "aes", domain)
    draws = [("uniform", (3, 64)), ("ternary", (64,)), ("cbd", (2, 64)),
             ("uniform", (2, 3, 64)), ("cbd", (5,)), ("ternary", (3, 7))]
    for kind, shape in draws:
        if kind == "uniform":
            j, p = jr.sample_uniform(shape, qtab), tr.sample_uniform(shape, t)
        elif kind == "ternary":
            j, p = jr.sample_ternary(shape, qtab), tr.sample_ternary(shape, t)
        else:
            j, p = jr.sample_cbd(shape, qtab), tr.sample_cbd(shape, t)
        same(j, p)
        assert tr.counter == jr._counter
    e = tr.sample_cbd((4096,), t)[..., 0, :]
    e = torch.where(e > t.q[0] // 2, e - t.q[0], e)
    assert int(e.abs().max()) <= 21 and abs(float(e.float().mean())) < 0.5


def test_only_the_aes_mode():
    """The modes are the JAX package's two, threefry (the default) and aes;
    AES is opt-in, and any other mode is refused with the JAX message."""
    assert RandomGenerator(5).mode == "threefry" and RandomGenerator(5, "aes").mode == "aes"
    with pytest.raises(ValueError, match="unknown mode"):
        RandomGenerator(5, "philox")


def test_quickstart_keys_and_ciphertexts_match_jax():
    """examples/99_quickstart.py's flow under mode="aes" in both packages:
    the secret and public keys, both public-key encryptions and their sum
    equal bit for bit, and the sum decrypts to (x + y) mod t."""
    n, bits, seed = 8192, [30, 30, 30, 30], 0x5EED
    jp = JParams(JScheme.BFV).set_poly_modulus_degree(n)
    jp.set_coeff_modulus(JCoeff.create(n, bits)).set_plain_modulus(JPlain.batching(n, 20))
    jc = JContext.create(jp, True, JSec.Classical128, seed)
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(n)
    tp.set_coeff_modulus(CoeffModulus.create(n, bits)).set_plain_modulus(
        PlainModulus.batching(n, 20))
    tc = HeContext.create(tp, "cpu", SecurityLevel.Classical128, seed=seed)
    jkg = JKeyGen(jc, prng=JRandom(seed, mode="aes", domain="keygen"))
    kg = KeyGenerator(tc, prng=RandomGenerator(seed, "aes", "keygen"))
    same(jkg.secret_key.data, kg.secret_key.data)
    jpk, pk = jkg.create_public_key(), kg.create_public_key()
    same(jpk.data(), pk.data())
    jenc = JEncryptor(jc, pk=jpk, prng=JRandom(seed, mode="aes", domain="encryptor"))
    enc = Encryptor(tc, pk=pk, prng=RandomGenerator(seed, "aes", "encryptor"))
    x = np.arange(n, dtype=np.uint64)
    y = np.arange(n, dtype=np.uint64)[::-1].copy()
    jcod, cod = JEncoder(jc), BatchEncoder(tc)
    cts = []
    for m in (x, y):
        jct, ct = jenc.encrypt_asymmetric(jcod.encode(m)), enc.encrypt_asymmetric(cod.encode(m))
        same(jct.data, ct.data)
        cts.append((jct, ct))
    jsum = JEvaluator(jc).add(cts[0][0], cts[1][0])
    tsum = Evaluator(tc).add(cts[0][1], cts[1][1])
    same(jsum.data, tsum.data)
    want = ((x + y) % jp.plain_modulus.value).astype(np.int64)
    np.testing.assert_array_equal(
        cod.decode(Decryptor(tc, kg.secret_key).decrypt(tsum)).numpy(), want)
    np.testing.assert_array_equal(
        jcod.decode(JDecryptor(jc, jkg.secret_key).decrypt(jsum)).astype(np.int64), want)

"""The port's threefry stream (troy_tpu_torch/utils/random.py) against
jax.random and the JAX package's samplers, bit for bit: threefry2x32's known
answers, key, fold_in (int and device-tensor counters) and bits at several
shapes, _bits2, the *_from_keys samplers, uniform_from_seed (a seed above
2^32), and RandomGenerator("threefry")'s draws, counters, key pairs and
seeds.  Everything here assumes the partitionable threefry layout and x64
off, which the first test pins, so that a JAX upgrade fails loudly here
instead of diverging elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from troy_tpu.core.params import EncryptionParameters as JParams, SchemeType as JScheme
from troy_tpu.core.coeff_modulus import (CoeffModulus as JCoeff, PlainModulus as JPlain,
                                         SecurityLevel as JSec)
from troy_tpu.core.context import HeContext as JContext
from troy_tpu.utils import random as JR
from troy_tpu_torch.utils import random as R

from .test_torch_aes import Q
from .test_torch_client import same

KNOWN = [  # (key, counter) -> output, the Threefry-2x32-20 answers jax.random's tests use
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3), (0xc4923a9c, 0x483df7a0)),
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1cb996fc, 0xbb002be7)),
]


def key_words(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def port_words(k) -> tuple[int, int]:
    return tuple(int(v) for v in k)


def jax_qtab():
    jp = JParams(JScheme.BFV).set_poly_modulus_degree(64).set_coeff_modulus(
        JCoeff.create(64, [30, 30, 30])).set_plain_modulus(JPlain.batching(64, 20))
    jcd = JContext.create(jp, True, JSec.Nil, 1).key_context_data()
    return jcd.qtab(), Q(jcd.base_q.values)


def test_jax_threefry_layout_is_pinned():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("k,x,y", KNOWN)
def test_known_answers(k, x, y):
    assert R.threefry2x32(*k, *x) == y
    t = R.threefry2x32(*(torch.tensor(v) for v in (*k, *x)))
    assert tuple(int(v) for v in t) == y


@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 5, (1 << 63) - 1])
def test_key_keeps_the_low_32_bits(seed):
    assert R.key(seed) == key_words(jax.random.key(seed))


@pytest.mark.parametrize("counter", [0, 1, 1 << 31, (1 << 32) - 1])
def test_fold_in(counter):
    jk = jax.random.key(0xBEEF)
    assert port_words(R.fold_in(R.key(0xBEEF), counter)) == key_words(
        jax.random.fold_in(jk, counter))
    # a device tensor counter (BatchedClient's probe): no host read
    dev = R.fold_in(R.key(0xBEEF), torch.tensor(counter, dtype=torch.int64))
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in dev)
    assert port_words(dev) == key_words(jax.random.fold_in(jk, jnp.uint32(counter)))


@pytest.mark.parametrize("shape", [(7,), (2, 3, 5), (2, 6, 1024)])
def test_bits(shape):
    jk = jax.random.fold_in(jax.random.key(3), 9)
    k = R.fold_in(R.key(3), 9)
    same(jax.random.bits(jk, shape, jnp.uint32), R.bits(k, shape, "cpu"))


def test_bits2_and_samplers_from_keys():
    qtab, t = jax_qtab()
    jkeys = (jax.random.key(11), jax.random.key(12))
    keys = (R.key(11), R.key(12))
    same(JR._bits2(jkeys, (2, 3, 64)), R._bits2(keys, (2, 3, 64), "cpu"))
    for shape in ((3, 64), (2, 3, 64)):
        same(JR.uniform_from_keys(jkeys, shape, qtab), R.uniform_from_keys(keys, shape, t))
    for shape in ((64,), (4, 64)):
        same(JR.ternary_from_keys(jkeys, shape, qtab), R.ternary_from_keys(keys, shape, t))
        same(JR.cbd_from_keys(jkeys, shape, qtab), R.cbd_from_keys(keys, shape, t))
    ka, kb = JR.fold_in_keys(jkeys, 5)
    assert (port_words(R.fold_in_keys(keys, 5)[0]), port_words(R.fold_in_keys(keys, 5)[1])) \
        == (key_words(ka), key_words(kb))


@pytest.mark.parametrize("seed", [1, 0xDEADBEEF, (1 << 40) + 123, (1 << 63) - 25])
def test_uniform_from_seed(seed):
    qtab, t = jax_qtab()
    same(JR.uniform_from_seed(seed, (3, 64), qtab), R.uniform_from_seed(seed, (3, 64), t))
    # the 32-bit seed cut: seeds equal mod 2^32 expand alike
    same(JR.uniform_from_seed(seed & 0xFFFFFFFF, (3, 64), qtab),
         R.uniform_from_seed(seed, (3, 64), t))


@pytest.mark.parametrize("seed,domain", [(0x5EED, "keygen"), (12345, "encryptor"),
                                         (1 << 100, "")])
def test_generator_draws_and_counters(seed, domain):
    qtab, t = jax_qtab()
    jr, tr = JR.RandomGenerator(seed, domain=domain), R.RandomGenerator(seed, domain=domain)
    assert tr.mode == "threefry"
    assert [port_words(k) for k in tr.base_keys] == [key_words(k) for k in jr.base_keys]
    draws = [("uniform", (3, 64)), ("ternary", (64,)), ("cbd", (2, 64)),
             ("uniform", (2, 3, 64)), ("cbd", (5,)), ("ternary", (3, 7))]
    for kind, shape in draws:
        j = getattr(jr, f"sample_{kind}")(shape, qtab)
        p = getattr(tr, f"sample_{kind}")(shape, t)
        same(j, p)
        assert tr.counter == jr._counter
    np.testing.assert_array_equal(np.asarray(jr.sample_cbd_signed((2, 64))),
                                  tr.sample_cbd_signed((2, 64), "cpu").numpy())
    assert tr.reserve_counters(3) == jr.reserve_counters(3) and tr.counter == jr._counter
    for (ja, jb), (pa, pb) in zip(jr.next_key_pairs(2), tr.next_key_pairs(2)):
        assert (port_words(pa), port_words(pb)) == (key_words(ja), key_words(jb))
    assert tr.counter == jr._counter
    assert [tr.new_seed() for _ in range(3)] == [jr.new_seed() for _ in range(3)]


def test_aes_generator_refuses_threefry_only_calls():
    g = R.RandomGenerator(5, "aes")
    for call in (lambda: g.reserve_counters(1), lambda: g.next_key_pairs(1),
                 lambda: g.sample_cbd_signed((4,), "cpu")):
        with pytest.raises(ValueError, match="threefry"):
            call()
    assert g.new_seed() == JR.RandomGenerator(5, "aes").new_seed()


def test_cbd_distribution():
    _, t = jax_qtab()
    e = R.RandomGenerator(9).sample_cbd((8192,), t)[0]
    e = torch.where(e > t.q[0] // 2, e - t.q[0], e)
    assert int(e.abs().max()) <= 21 and abs(float(e.float().mean())) < 0.2


def test_wide_moduli_wait_for_the_wide_path():
    """The wide path has come (it used to raise here): tables with words ==
    2 draw 128 random bits a residue, reduced mod each 40-60-bit prime, and
    the small samplers lift to q + e; every draw equals the JAX package's
    wide branch, in threefry and AES mode."""
    from troy_tpu.ops.ntt64 import wide_scalar_pack as jwide
    from troy_tpu_torch.ops.ntt64 import wide_scalar_pack as twide
    from troy_tpu_torch import interop

    primes = [1152921504606830593, 1099511480321]
    jt, tt = jwide(primes), twide(primes)
    for mode in ("threefry", "aes"):
        jg, tg = JR.RandomGenerator(1, mode=mode), R.RandomGenerator(1, mode)
        for _ in range(2):
            got = tg.sample_uniform((3, 2, 8), tt)
            np.testing.assert_array_equal(
                interop.to_tensor(np.asarray(jg.sample_uniform((3, 2, 8), jt)), "cpu",
                                  wide=True).numpy(), got.numpy())
            assert bool((got < tt.q.view(-1, 1)).all())
            for name in ("sample_ternary", "sample_cbd"):
                got = getattr(tg, name)((3, 8), tt)
                np.testing.assert_array_equal(
                    interop.to_tensor(np.asarray(getattr(jg, name)((3, 8), jt)), "cpu",
                                      wide=True).numpy(), got.numpy())

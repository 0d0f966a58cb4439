"""The slice as a whole: the port's batched BFV multiply + relinearize step
equals the JAX package's bit for bit, on ciphertexts and relinearization
keys made by the JAX package and carried over with troy_tpu_torch.interop,
under both lifts: the default HPS lift, and the reference-exact BEHZ lift
(lift="behz" in the port, TROY_BFV_BCONV=behz in the JAX package) under
both JAX base-conversion backends, the VPU dot and the Pallas kernel K3
(interpret mode here)."""

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
from troy_tpu.core.evaluator import Evaluator as JEvaluator
from troy_tpu.core.batch_encoder import BatchEncoder as JEncoder
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from troy_tpu.core.ciphertext import Ciphertext as JCiphertext
from troy_tpu.rns import rns_base as JRB
from troy_tpu_torch import interop
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.ciphertext import Ciphertext
from troy_tpu_torch.parallel.batched import BatchedEvaluator

N, BITS, LOG_T, BATCH = 2048, [30, 30, 30, 30], 20, 2


@pytest.fixture(scope="module")
def flow():
    rng = np.random.default_rng(5)
    jp = JParams(JScheme.BFV).set_poly_modulus_degree(N)
    jp.set_coeff_modulus(JCoeff.create(N, BITS)).set_plain_modulus(JPlain.batching(N, LOG_T))
    jc = JContext.create(jp, True, JSec.Nil, 0xBEEF)
    jkg = JKeyGen(jc)
    jencr = JEncryptor(jc, sk=jkg.secret_key)
    jenc = JEncoder(jc)
    t = jp.plain_modulus.value
    msgs = rng.integers(0, t, size=(2 * BATCH, N), dtype=np.uint64)
    cts = np.stack([np.asarray(jencr.encrypt_symmetric(jenc.encode(m)).data)
                    for m in msgs])
    rlk = jkg.create_relin_keys()
    tp = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
    tp.set_coeff_modulus(CoeffModulus.create(N, BITS)).set_plain_modulus(
        PlainModulus.batching(N, LOG_T))
    tc = HeContext.create(tp, "cpu", sec_level=SecurityLevel.Nil)
    return dict(jc=jc, jkg=jkg, rlk=rlk, cts=cts, msgs=msgs, t=t, tc=tc,
                keys=interop.relin_keys({k: np.asarray(v) for k, v in rlk.keys.items()},
                                        tc.key_parms_id, "cpu"),
                sk=interop.secret_key(np.asarray(jkg.secret_key.data),
                                      tc.key_parms_id, "cpu"))


def test_mul_relin_step_matches_jax(flow):
    jcd = flow["jc"].first_context_data()
    jstep = jax.jit(JBatched(JEvaluator(flow["jc"]), jcd).build_mul_relin_step(
        flow["rlk"].key(2)))
    cts = flow["cts"]
    want = np.asarray(jstep(jnp.asarray(cts[:BATCH]), jnp.asarray(cts[BATCH:]),
                            flow["rlk"].key(2)))

    tc = flow["tc"]
    cd = tc.first_context_data()
    step = BatchedEvaluator(Evaluator(tc), cd).build_mul_relin_step(flow["keys"].key(2))
    got = step(interop.to_tensor(cts[:BATCH], "cpu"), interop.to_tensor(cts[BATCH:], "cpu"),
               flow["keys"].key(2))
    assert tuple(got.shape) == (BATCH, 2, cd.coeff_modulus_size, N)
    np.testing.assert_array_equal(interop.to_numpy(got), want)

    encoder, dec = BatchEncoder(tc), Decryptor(tc, flow["sk"])
    msgs, t = flow["msgs"], flow["t"]
    for b in range(BATCH):
        m = encoder.decode(dec.decrypt(Ciphertext(got[b], cd.parms_id)))
        np.testing.assert_array_equal(
            m.numpy(), ((msgs[b].astype(object) * msgs[BATCH + b]) % t).astype(np.int64))


def test_evaluator_multiply_relinearize_matches_jax(flow):
    """The unbatched Evaluator path: multiply, square, relinearize, add."""
    jcd = flow["jc"].first_context_data()
    from troy_tpu.core.ciphertext import Ciphertext as JCiphertext

    jev = JEvaluator(flow["jc"])
    ja, jb = (JCiphertext(jnp.asarray(c), jcd.parms_id) for c in flow["cts"][:2])
    ev = Evaluator(flow["tc"])
    ta, tb = (interop.ciphertext(c, jcd.parms_id, "cpu") for c in flow["cts"][:2])
    pairs = [(jev.multiply(ja, jb), ev.multiply(ta, tb)),
             (jev.square(ja), ev.multiply(ta, ta))]
    for jprod, tprod in pairs:
        np.testing.assert_array_equal(interop.to_numpy(tprod.data), np.asarray(jprod.data))
        jrel = jev.relinearize(jprod, flow["rlk"])
        trel = ev.relinearize(tprod, flow["keys"])
        np.testing.assert_array_equal(interop.to_numpy(trel.data), np.asarray(jrel.data))
    np.testing.assert_array_equal(interop.to_numpy(ev.add(ta, tb).data),
                                  np.asarray(jev.add(ja, jb).data))


@pytest.fixture(params=["vpu", "pallas"])
def jax_behz(request, monkeypatch):
    """The JAX package under TROY_BFV_BCONV=behz and one base-conversion
    backend, restored afterwards."""
    monkeypatch.setenv("TROY_BFV_BCONV", "behz")
    prev = JRB.get_bconv_backend()
    JRB.set_bconv_backend(request.param)
    try:
        yield request.param
    finally:
        JRB.set_bconv_backend(prev)


def test_behz_step_matches_jax(flow, jax_behz):
    jcd = flow["jc"].first_context_data()
    jstep = jax.jit(JBatched(JEvaluator(flow["jc"]), jcd).build_mul_relin_step(
        flow["rlk"].key(2)))
    cts = flow["cts"]
    want = np.asarray(jstep(jnp.asarray(cts[:BATCH]), jnp.asarray(cts[BATCH:]),
                            flow["rlk"].key(2)))
    tc = flow["tc"]
    cd = tc.first_context_data()
    step = BatchedEvaluator(Evaluator(tc, lift="behz"), cd).build_mul_relin_step(
        flow["keys"].key(2))
    got = step(interop.to_tensor(cts[:BATCH], "cpu"), interop.to_tensor(cts[BATCH:], "cpu"),
               flow["keys"].key(2))
    np.testing.assert_array_equal(interop.to_numpy(got), want)


def test_behz_evaluator_matches_jax(flow, jax_behz):
    """Evaluator.multiply, square and relinearize with lift="behz", and the
    noise budget of the products."""
    jcd = flow["jc"].first_context_data()
    jev = JEvaluator(flow["jc"])
    ja, jb = (JCiphertext(jnp.asarray(c), jcd.parms_id) for c in flow["cts"][:2])
    ev = Evaluator(flow["tc"], lift="behz")
    ta, tb = (interop.ciphertext(c, jcd.parms_id, "cpu") for c in flow["cts"][:2])
    for jprod, tprod in [(jev.multiply(ja, jb), ev.multiply(ta, tb)),
                         (jev.square(ja), ev.multiply(ta, ta))]:
        np.testing.assert_array_equal(interop.to_numpy(tprod.data), np.asarray(jprod.data))
        jrel = jev.relinearize(jprod, flow["rlk"])
        trel = ev.relinearize(tprod, flow["keys"])
        np.testing.assert_array_equal(interop.to_numpy(trel.data), np.asarray(jrel.data))


def test_noise_budget_matches_jax(flow):
    """invariant_noise_budget of a fresh ciphertext and of a product under
    each lift, port against JAX."""
    from troy_tpu.core.decryptor import Decryptor as JDecryptor

    jcd = flow["jc"].first_context_data()
    jdec = JDecryptor(flow["jc"], flow["jkg"].secret_key)
    dec = Decryptor(flow["tc"], flow["sk"])
    ja = JCiphertext(jnp.asarray(flow["cts"][0]), jcd.parms_id)
    ta = interop.ciphertext(flow["cts"][0], jcd.parms_id, "cpu")
    tb = interop.ciphertext(flow["cts"][1], jcd.parms_id, "cpu")
    fresh = dec.invariant_noise_budget(ta)
    assert fresh == jdec.invariant_noise_budget(ja) > 0
    for lift in ("hps", "behz"):
        prod = Evaluator(flow["tc"], lift=lift).multiply(ta, tb)
        jprod = JCiphertext(jnp.asarray(interop.to_numpy(prod.data)), jcd.parms_id)
        budget = dec.invariant_noise_budget(prod)
        assert budget == jdec.invariant_noise_budget(jprod)
        assert 0 < budget < fresh, lift


def test_unknown_lift_raises(flow):
    with pytest.raises(ValueError, match="lift"):
        Evaluator(flow["tc"], lift="bogus")

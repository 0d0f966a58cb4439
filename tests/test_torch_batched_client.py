"""The port's BatchedClient (troy_tpu_torch/parallel/batched.py) against the
JAX package's, bit for bit: for BFV, CKKS and BGV at n = 1024 (4 x 30-bit
primes, tests/test_torch_seeded.py's Seeded pairs), batch 3, the same
threefry base keys and the same chained state, the asymmetric and symmetric
encrypt steps (of a message and of zero) chained over three calls, the
decrypt step (sizes 2 and 3, and a BGV correction factor), and the batch
encode and decode steps.  Every output has tolerance 0; the chained
encryptions must also decrypt to their message (exactly for BFV and BGV,
within 1e-3 for CKKS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from troy_tpu.parallel.batched import BatchedClient as JClient
from troy_tpu.utils.random import RandomGenerator as JRandom
from troy_tpu_torch.parallel.batched import BatchedClient
from troy_tpu_torch.utils.random import RandomGenerator

from .test_torch_client import same
from .test_torch_seeded import Seeded

B, STEPS, KEY_SEED = 3, 3, 0xC11E


class Clients:
    def __init__(self, scheme: str):
        self.p = p = Seeded(scheme)
        self.jcd, self.cd = p.jc.first_context_data(), p.tc.first_context_data()
        self.jcl, self.cl = JClient(p.jc, self.jcd), BatchedClient(p.tc, self.cd)
        self.jkeys = JRandom(KEY_SEED, domain="bench").base_keys
        self.keys = RandomGenerator(KEY_SEED, domain="bench").base_keys
        self.jpk, self.pk = p.jkg.create_public_key(), p.kg.create_public_key()
        self.m = p.message()
        self.jpt, self.pt = p.encode(self.m)
        L, n = self.cd.coeff_modulus_size, self.cd.parms.poly_modulus_degree
        start = np.random.default_rng(5).integers(0, 1 << 30, (B, 2, L, n), dtype=np.uint32)
        self.jstart, self.start = jnp.asarray(start), torch.from_numpy(start.astype(np.int64))

    def payload(self):
        """(plain_data, plain_ntt) of the message in each package."""
        return (self.jpt.data, bool(self.jpt.is_ntt_form)), (self.pt.data, self.pt.is_ntt_form)

    def chain(self, jstep, step, jarg, arg):
        jcur, cur = self.jstart, self.start
        outs = []
        for _ in range(STEPS):
            jcur, cur = jstep(jcur, jarg), step(cur, arg)
            same(jcur, cur)
            assert tuple(cur.shape) == tuple(self.start.shape)
            outs.append(cur)
        return outs

    def decrypts(self, out: torch.Tensor, ntt_form: bool):
        from troy_tpu_torch.core.ciphertext import Ciphertext

        for b in range(out.shape[0]):
            ct = Ciphertext(out[b], self.cd.parms_id, ntt_form,
                            self.pt.scale if self.p.ckks else 1.0)
            self.p.check_decrypts(ct, self.m)


@pytest.fixture(scope="module", params=["BFV", "CKKS", "BGV"])
def C(request):
    return Clients(request.param)


@pytest.mark.parametrize("with_message", [True, False])
def test_encrypt_asymmetric_step(C, with_message):
    (jd, jntt), (d, ntt) = C.payload() if with_message else ((None, False), (None, False))
    jstep = C.jcl.build_encrypt_asymmetric_step(C.jkeys, jd, jntt)
    step = C.cl.build_encrypt_asymmetric_step(C.keys, d, ntt)
    outs = C.chain(jstep, step, C.jpk.data(), C.pk.data())
    if with_message:
        C.decrypts(outs[-1], C.cl.ntt_form)


@pytest.mark.parametrize("with_message", [True, False])
def test_encrypt_symmetric_step(C, with_message):
    (jd, jntt), (d, ntt) = C.payload() if with_message else ((None, False), (None, False))
    jstep = C.jcl.build_encrypt_symmetric_step(C.jkeys, jd, jntt)
    step = C.cl.build_encrypt_symmetric_step(C.keys, d, ntt)
    outs = C.chain(jstep, step, C.p.jkg.secret_key.data, C.p.kg.secret_key.data)
    if with_message:
        C.decrypts(outs[-1], C.cl.ntt_form)
    # fresh randomness each call: no two chained batches share a c1
    assert not any(bool((outs[i][:, 1] == outs[i + 1][:, 1]).all()) for i in range(STEPS - 1))


@pytest.mark.parametrize("size", [2, 3])
def test_decrypt_step(C, size):
    jd, d = C.payload()
    cur = C.cl.build_encrypt_symmetric_step(C.keys, *d)(C.start, C.p.kg.secret_key.data)
    if size == 3:  # a third poly: the phase takes s^2 too
        cur = torch.cat([cur, cur[:, 1:]], dim=1)
    jcur = jnp.asarray(cur.numpy().astype(np.uint32))
    jpows = [C.p.jkg.secret_key_power(k) for k in (1, 2)]
    pows = [C.p.kg.secret_key_power(k) for k in (1, 2)]
    inv_cf = 5 if C.p.scheme == "BGV" else 1
    got = C.cl.build_decrypt_step(pows, size, inv_cf)(cur)
    same(C.jcl.build_decrypt_step(jpows, size, inv_cf)(jcur), got)
    if size == 2 and not C.p.ckks:
        want = C.p.cod.decode_polynomial(C.p.cod.encode(C.m))
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(
            (want.astype(np.int64) * inv_cf) % C.p.t, got.shape))


@pytest.mark.parametrize("scheme", ["BFV", "BGV"])
def test_batch_encode_and_decode_steps(scheme):
    """The SIMD encoding mod t (BFV and BGV): an inverse NTT mod t after the
    slot scatter, and its inverse."""
    p = Seeded(scheme)
    jcl = JClient(p.jc, p.jc.first_context_data())
    vals = np.random.default_rng(8).integers(0, p.t, (B, 1024), dtype=np.uint32)
    enc = BatchedClient.build_batch_encode_step(p.cod)
    dec = BatchedClient.build_batch_decode_step(p.cod)
    coeffs = enc(torch.from_numpy(vals.astype(np.int64)))
    same(jcl.build_batch_encode_step(p.jcod)(jnp.asarray(vals)), coeffs)
    same(jcl.build_batch_decode_step(p.jcod)(jnp.asarray(coeffs.numpy().astype(np.uint32))),
         dec(coeffs))
    np.testing.assert_array_equal(dec(coeffs).numpy(), vals.astype(np.int64))
    np.testing.assert_array_equal(coeffs[0].numpy(), p.cod.encode(vals[0]).data[0].numpy())


def test_example_21_device_client_flow():
    """examples/21_device_client_ops.py on the port (n = 1024, batch 4): the
    batch encode, one payload encrypted under fresh randomness per element
    with the encryptor's base keys, the batch decrypt; every element decodes
    to the payload."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.plaintext import Plaintext

    n, batch = 1024, 4
    parms = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30] * 4))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    context = HeContext.create(parms, True, SecurityLevel.Nil, device="cpu")
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, pk=keygen.create_public_key(), sk=keygen.secret_key)
    decryptor = Decryptor(context, keygen.secret_key)
    encoder = BatchEncoder(context)
    client = BatchedClient(context, context.first_context_data())
    t = parms.plain_modulus.value
    vals = np.arange(batch * n, dtype=np.int64).reshape(batch, n) % t
    coeffs = client.build_batch_encode_step(encoder)(torch.from_numpy(vals))
    pt0 = encoder.encode(vals[0])
    assert bool((coeffs[0] == pt0.data[0]).all())
    step = client.build_encrypt_asymmetric_step(encryptor.generator.base_keys, pt0.data)
    proto = encryptor.encrypt_asymmetric(pt0)
    cts = step(torch.stack([proto.data] * batch), encryptor.pk.data())
    assert bool((cts[0] != cts[1]).any())
    out = client.build_decrypt_step([decryptor._power(1)])(cts)
    for i in range(batch):
        got = encoder.decode(Plaintext(out[i][None, :], coeff_count=n))
        np.testing.assert_array_equal(got, vals[0])

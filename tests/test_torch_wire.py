"""The app helpers' wire format (MatmulHelper / Conv2dHelper
serialize_outputs, deserialize_outputs and the encoded weights' pair) on the
port against the JAX package, exactly: for BFV and CKKS at the app tests'
n = 64 (tests/test_torch_app.py's AppCase, AES-keyed streams), the client
sends seed-compressed inputs (save_ciphertext, Zstd), the server loads them
(each package loads the other's bytes), multiplies, packs (pack_lwe) or not,
and sends its outputs back; every frame must equal the JAX package's bytes,
each package's loader must give the same ciphertexts, and the decrypted
outputs must equal the JAX package's and the plain oracle (exact mod t for
BFV, within tests/test_torch_app.py's CKKS_ATOL).  The JAX contraction cache
is dropped before each JAX contraction (fresh_jax_contract).  Then
examples/10_bfv_matmul.py's flow, wire included, on the port at its own
n = 4096."""

import numpy as np
import pytest

from troy_tpu.app.cipher2d import Cipher2d as JCipher2d
from troy_tpu.utils import serialize as JS
from troy_tpu_torch.app.cipher2d import Cipher2d
from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter
from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.utils import serialize as S

from .test_torch_app import (AppCase, CONV, MATMUL, N, context, fresh_jax_contract,
                             plain_conv2d_valid, same_2d, same_pt)
from .test_torch_lwe import same_ct

ZSTD = S.CompressionMode.Zstd


@pytest.fixture(scope="module", params=["BFV", "CKKS"])
def A(request):
    return AppCase(request.param)


def same_seeded(jct, ct):
    same_ct(jct, ct)
    assert ct.seed == jct.seed and ct.seed is not None


def send_inputs(A, jx, tx):
    """The client's seeded inputs over the wire: equal bytes, and the
    server's loads (the port loading the JAX bytes) equal the JAX ones."""
    p = A.p
    jwire = [[JS.save_ciphertext(c, p.jc, ZSTD) for c in row] for row in jx.data]
    wire = [[S.save_ciphertext(c, p.tc, ZSTD) for c in row] for row in tx.data]
    assert wire == jwire
    assert all(c.seed is not None for row in tx.data for c in row)
    jsrv = JCipher2d([[JS.load_ciphertext(b, p.jc) for b in row] for row in jwire])
    srv = Cipher2d([[S.load_ciphertext(b, p.tc) for b in row] for row in jwire])
    same_2d(jsrv, srv)
    for row, trow in zip(srv.data, tx.data):
        for c, t in zip(row, trow):
            assert c.seed is None and bool((c.data == t.data).all())
    return jsrv, srv


def send_outputs(A, jh, th, jy, ty, mode):
    """The server's outputs over the wire, both ways."""
    p = A.p
    jblobs, blobs = jh.serialize_outputs(p.jc, jy, mode), th.serialize_outputs(p.tc, ty, mode)
    assert blobs == jblobs
    got = th.deserialize_outputs(p.tc, jblobs)
    same_2d(jh.deserialize_outputs(p.jc, blobs), got)
    return jh.deserialize_outputs(p.jc, jblobs), got, sum(len(b) for b in blobs)


@pytest.mark.parametrize("mode", [S.CompressionMode.Nil, ZSTD])
@pytest.mark.parametrize("pack_lwe", [False, True])
def test_matmul_wire(A, pack_lwe, mode):
    p = A.p
    B, I, O = 4, 5, 6
    jh, th = A.helpers(MATMUL, B, I, O, N, pack_lwe=pack_lwe)
    x, w = A.values((B, I)), A.values((I, O))
    jx = jh.encode_inputs(A.jad, x).encrypt_symmetric(p.jencr, save_seed=True)
    tx = th.encode_inputs(A.ad, x).encrypt_symmetric(p.encr, save_seed=True)
    same_2d(jx, tx, same_seeded)
    jsrv, srv = send_inputs(A, jx, tx)
    jw, tw = jh.encode_weights(A.jad, w), th.encode_weights(A.ad, w)
    fresh_jax_contract(p)
    jy, ty = jh.matmul(p.jev, jsrv, jw), th.matmul(p.ev, srv, tw)
    if pack_lwe:
        jy, ty = jh.pack_outputs(p.jev, A.jglk, jy), th.pack_outputs(p.ev, A.glk, ty)
    same_2d(jy, ty)
    jy, ty, nbytes = send_outputs(A, jh, th, jy, ty, mode)
    full = sum(len(S.save_ciphertext(c, p.tc, mode)) for row in ty.data for c in row)
    assert nbytes <= full  # sparse terms, or packed outputs sent whole
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty),
            A.oracle(x @ w if p.ckks else x.astype(object) @ w.astype(object)))


def test_encoded_weights_wire(A):
    p = A.p
    jh, th = A.helpers(MATMUL, 4, 5, 6, N, pack_lwe=False)
    w = A.values((5, 6))
    jw, tw = jh.encode_weights(A.jad, w), th.encode_weights(A.ad, w)
    for mode in (S.CompressionMode.Nil, S.CompressionMode.Zlib, ZSTD):
        jblobs, blobs = jh.serialize_encoded_weights(jw, mode), th.serialize_encoded_weights(tw, mode)
        assert blobs == jblobs
        same_2d(jw, th.deserialize_encoded_weights(jblobs, p.tc), same_pt)
        same_2d(jh.deserialize_encoded_weights(blobs), tw, same_pt)
    with pytest.raises(ValueError, match="expected"):
        th.deserialize_encoded_weights(blobs[:-1], "cpu")


def test_conv2d_wire(A):
    p = A.p
    shape = (1, 2, 3, 8, 8, 3, 3)
    B, Ci, Co, H, W, kh, kw = shape
    jh, th = A.helpers(CONV, *shape, N)
    x, k = A.values((B, Ci, H, W)), A.values((Co, Ci, kh, kw))
    jx = jh.encode_inputs(A.jad, x).encrypt_symmetric(p.jencr, save_seed=True)
    tx = th.encode_inputs(A.ad, x).encrypt_symmetric(p.encr, save_seed=True)
    same_2d(jx, tx, same_seeded)
    jsrv, srv = send_inputs(A, jx, tx)
    jk, tk = jh.encode_weights(A.jad, k), th.encode_weights(A.ad, k)
    fresh_jax_contract(p)
    jy, ty = jh.conv2d(p.jev, jsrv, jk), th.conv2d(p.ev, srv, tk)
    same_2d(jy, ty)
    jy, ty, _ = send_outputs(A, jh, th, jy, ty, ZSTD)
    want = (plain_conv2d_valid(x, k) if p.ckks else
            plain_conv2d_valid(x.astype(object), k.astype(object)))
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty),
            A.oracle(want))


def test_example_10_bfv_matmul_wire_flow():
    """examples/10_bfv_matmul.py on the port, its wire included: 8 x 32 x
    16 at n = 4096, the inputs seed-compressed under the context's default
    stream and sent as Zstd frames, the outputs sent back as sparse terms."""
    n = 4096
    ctx, _, encryptor, decryptor, evaluator = context("BFV", n)
    adapter = BatchEncoderAdapter(BatchEncoder(ctx))
    t = ctx.first_context_data().parms.plain_modulus.value
    helper = MatmulHelper(8, 32, 16, n, MatmulObjective.EncryptLeft, pack_lwe=False)
    rng = np.random.default_rng(0)
    x = rng.integers(0, t, (8, 32), dtype=np.uint64)
    w = rng.integers(0, t, (32, 16), dtype=np.uint64)
    x_enc = helper.encode_inputs(adapter, x).encrypt_symmetric(encryptor, save_seed=True)
    wire = [[S.save_ciphertext(c, ctx, ZSTD) for c in row] for row in x_enc.data]
    unseeded = [S.save_ciphertext(c, ctx, ZSTD) for c in
                helper.encode_inputs(adapter, x).encrypt_symmetric(encryptor)[0]]
    assert sum(map(len, wire[0])) < 0.6 * sum(map(len, unseeded))
    x_srv = Cipher2d([[S.load_ciphertext(b, ctx) for b in row] for row in wire])
    y = helper.matmul(evaluator, x_srv, helper.encode_weights(adapter, w))
    back = helper.deserialize_outputs(ctx, helper.serialize_outputs(ctx, y, ZSTD))
    dec = helper.decrypt_outputs(adapter, decryptor, back)
    assert (dec.astype(object) % t == (x.astype(object) @ w.astype(object)) % t).all()


def test_example_7_serialization_flow():
    """examples/7_serialization.py on the port at its n = 4096 on 3 x 30-bit
    primes: a public-key encryption saved raw and with Zstd, a seeded
    symmetric one with Zstd (about half the bytes), each loading and
    decrypting to the message."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor

    n = 4096
    parms = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30]))
    parms.set_plain_modulus(PlainModulus.batching(n, 20))
    context = HeContext.create(parms, True, SecurityLevel.Nil, device="cpu")
    keygen = KeyGenerator(context)
    encryptor = Encryptor(context, sk=keygen.secret_key, pk=keygen.create_public_key())
    decryptor = Decryptor(context, keygen.secret_key)
    encoder = BatchEncoder(context)
    m = np.arange(encoder.slot_count, dtype=np.uint64)
    pt = encoder.encode(m)
    ct_pk = encryptor.encrypt_asymmetric(pt)
    blob_raw = S.save_ciphertext(ct_pk, context)
    blob_zstd = S.save_ciphertext(ct_pk, context, ZSTD)
    blob_seed = S.save_ciphertext(encryptor.encrypt_symmetric(pt, save_seed=True), context, ZSTD)
    assert len(blob_seed) < 0.6 * len(blob_raw) and len(blob_zstd) <= len(blob_raw)
    for blob in (blob_raw, blob_zstd, blob_seed):
        back = S.load_ciphertext(blob, context)
        np.testing.assert_array_equal(encoder.decode(decryptor.decrypt(back)),
                                      m.astype(np.int64))

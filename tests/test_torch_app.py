"""The port's app layer for BFV and CKKS (troy_tpu_torch/app: cipher2d,
encoder_adapter, matmul, conv2d) against the JAX package's, bit for bit;
their wire format is tests/test_torch_wire.py's.

Each scheme's pair is tests/test_torch_lwe.py's Pair at n = 64 on 4 x 30-bit
primes, as tests/app/test_matmul.py and test_conv2d.py (t =
PlainModulus.batching(64, 20); CKKS at scale 2^20), keyed by
RandomGenerator(seed, mode="aes") streams in both packages, so the encoded
blocks, the encryptions, every product, packed output and biased output
must agree with tolerance 0, and so must the decrypted matrices (the CKKS
host decode is bit-exact).  Decrypts are held to the plain oracle as well:
exactly mod t for BFV, within 1e-3 for CKKS (products at scale 2^40 carry
errors near 2^-12 at these sizes).  The block searches are compared on a
grid that includes the reference's app-bench sizes at n = 8192.

The JAX package's multiply_plain_contract keeps one compiled function per
level under the name "mm_contract", built around the first call's number of
input blocks: a later call on the same level with another inner dimension
sums only that many blocks.  Each JAX contraction here therefore starts
from an empty cache (fresh_jax_contract); the port has no such cache, and
test_jax_contract_cache_fault pins the fault down."""

import numpy as np
import pytest
import torch

from troy_tpu.app.matmul import MatmulHelper as JMatmul, MatmulObjective as JObjective
from troy_tpu.app.conv2d import Conv2dHelper as JConv2d
from troy_tpu.app.encoder_adapter import (BatchEncoderAdapter as JBatchAdapter,
                                          CKKSEncoderAdapter as JCKKSAdapter)
from troy_tpu_torch.app.cipher2d import Plain2d, Cipher2d
from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective, ceil_div
from troy_tpu_torch.app.conv2d import Conv2dHelper
from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter, CKKSEncoderAdapter
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.batch_encoder import BatchEncoder
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
from troy_tpu_torch.parallel import mesh as M

from .test_torch_client import same
from .test_torch_lwe import Pair, same_ct

N, BITS, SEED, SCALE = 64, [30, 30, 30, 30], 0xA99, 2.0 ** 20
CKKS_ATOL = 1e-3
OBJECTIVES = list(MatmulObjective)
SERIALIZATION = {"serialize_outputs", "deserialize_outputs", "serialize_encoded_weights",
                 "deserialize_encoded_weights"}


def same_2d(j2d, t2d, compare=same_ct):
    assert j2d.size() == t2d.size()
    for jrow, trow in zip(j2d.data, t2d.data):
        assert len(jrow) == len(trow)
        for j, t in zip(jrow, trow):
            compare(j, t)


def same_data(a, b):
    """Two port ciphertexts are equal."""
    assert torch.equal(a.data, b.data) and a.is_ntt_form == b.is_ntt_form
    assert (a.scale, a.correction_factor) == (b.scale, b.correction_factor)


def same_pt(jpt, pt):
    same(jpt.data, pt.data)
    assert pt.parms_id == jpt.parms_id and pt.is_ntt_form == bool(jpt.is_ntt_form)
    assert pt.scale == jpt.scale


def fresh_jax_contract(p):
    """Drop the JAX package's cached contraction at every level of p's JAX
    context, so that its next multiply_plain_contract builds for its own
    inner dimension."""
    cd = p.jc.key_context_data()
    while cd is not None:
        getattr(cd, "_jit_ops", {}).pop("mm_contract", None)
        cd = cd.next


def plain_conv2d_valid(x, k):
    """The valid convolution in object integers or float64."""
    B, Ci, H, W = x.shape
    Co, _, kh, kw = k.shape
    out = np.zeros((B, Co, H - kh + 1, W - kw + 1), dtype=x.dtype)
    for i in range(H - kh + 1):
        for j in range(W - kw + 1):
            out[:, :, i, j] = np.einsum("bchw,ochw->bo", x[:, :, i:i + kh, j:j + kw], k)
    return out


class AppCase:
    """A Pair at n = 64 with its automorphism keys and the adapters of both
    packages: `ad` for the operands, `out` for the products (scale^2 for
    CKKS)."""

    def __init__(self, scheme: str):
        self.p = p = Pair(scheme, n=N, bits=BITS, seed=SEED, scale=SCALE)
        self.rng = np.random.default_rng(2024)
        self.jglk, self.glk = p.automorphism_keys()
        if p.ckks:
            self.jad, self.ad = JCKKSAdapter(p.jenc, SCALE), CKKSEncoderAdapter(p.enc, SCALE)
            self.jout = JCKKSAdapter(p.jenc, SCALE * SCALE)
            self.out = CKKSEncoderAdapter(p.enc, SCALE * SCALE)
        else:
            self.jad, self.ad = JBatchAdapter(p.jenc), BatchEncoderAdapter(p.enc)
            self.jout, self.out = self.jad, self.ad

    def values(self, shape):
        if self.p.ckks:
            return self.rng.uniform(-1, 1, shape)
        return self.rng.integers(0, self.p.t, size=shape, dtype=np.uint64)

    def oracle(self, y):
        """The plain result as the decrypt gives it."""
        return y if self.p.ckks else y.astype(object) % self.p.t

    def check(self, jdec, dec, want):
        np.testing.assert_array_equal(dec, jdec)
        assert dec.dtype == jdec.dtype
        if self.p.ckks:
            np.testing.assert_allclose(dec, want, rtol=0, atol=CKKS_ATOL)
        else:
            np.testing.assert_array_equal(dec.astype(object), want)

    def helpers(self, cls_pair, *args, **kw):
        fresh_jax_contract(self.p)
        return cls_pair[0](*args, **kw), cls_pair[1](*args, **kw)


MATMUL = (JMatmul, MatmulHelper)
CONV = (JConv2d, Conv2dHelper)


@pytest.fixture(scope="module", params=["BFV", "CKKS"])
def A(request):
    return AppCase(request.param)


# ----------------------------------------------------------------------
# block searches (pure Python: the large n is cheap)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pack_lwe", [False, True])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_matmul_blocks_match_jax(objective, pack_lwe):
    shapes = [(100, 105, 110, 8192), (4, 5, 6, 64), (3, 17, 9, 64), (2, 5, 4, 64),
              (1, 1, 1, 64), (8, 32, 16, 4096), (4, 16, 8, 2048), (16, 300, 7, 1024),
              (1, 512, 2, 4096)]
    for B, I, O, n in shapes:
        j = JMatmul(B, I, O, n, JObjective(int(objective)), pack_lwe=pack_lwe)
        t = MatmulHelper(B, I, O, n, objective, pack_lwe=pack_lwe)
        assert ((t.batch_block, t.input_block, t.output_block)
                == (j.batch_block, j.input_block, j.output_block)), (B, I, O, n)
    if pack_lwe and objective == MatmulObjective.EncryptLeft:
        big = MatmulHelper(100, 105, 110, 8192, objective, pack_lwe=True)
        assert (big.batch_block, big.input_block, big.output_block) == (100, 16, 5)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_conv2d_blocks_match_jax(objective):
    shapes = [(4, 3, 16, 32, 32, 3, 3, 8192), (2, 2, 2, 5, 6, 2, 3, 64),
              (1, 1, 1, 8, 8, 3, 3, 64), (1, 2, 3, 8, 8, 3, 3, 2048),
              (2, 3, 4, 6, 6, 3, 3, 64), (1, 64, 64, 16, 16, 3, 3, 4096)]
    for shape in shapes:
        j, t = JConv2d(*shape, JObjective(int(objective))), Conv2dHelper(*shape, objective)
        keys = ("batch_block", "image_height_block", "image_width_block",
                "input_channel_block", "output_channel_block")
        assert [getattr(t, k) for k in keys] == [getattr(j, k) for k in keys], shape
        assert t.get_total_batch_size() == j.get_total_batch_size()
        assert t._required_terms() == j._required_terms()
    cifar = Conv2dHelper(4, 3, 16, 32, 32, 3, 3, 8192, objective)
    if objective == MatmulObjective.EncryptLeft:
        assert (cifar.batch_block, cifar.image_height_block, cifar.image_width_block,
                cifar.input_channel_block, cifar.output_channel_block) == (4, 32, 32, 1, 2)
        assert cifar.get_total_batch_size() == 1


def test_helper_surfaces_match_jax():
    """The helpers' public names equal the JAX package's, the wire-format
    methods included (tests/test_torch_wire.py)."""
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    assert public(MatmulHelper) == public(JMatmul) and SERIALIZATION <= public(MatmulHelper)
    assert public(Conv2dHelper) == public(JConv2d)
    j = JMatmul(4, 5, 6, 64, JObjective.EncryptLeft, pack_lwe=False)
    t = MatmulHelper(4, 5, 6, 64, MatmulObjective.EncryptLeft, pack_lwe=False)
    assert t._required_terms() == j._required_terms()
    assert [int(o) for o in MatmulObjective] == [int(o) for o in JObjective]
    assert ceil_div(7, 2) == 4 and ceil_div(8, 2) == 4


# ----------------------------------------------------------------------
# matmul
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pack_lwe", [False, True])
def test_matmul_pack_bias_decrypt(A, pack_lwe):
    """encrypt_inputs, encode_weights, matmul, pack_outputs (with pack_lwe),
    encode_outputs + add_plain, decrypt_outputs."""
    p = A.p
    B, I, O = 4, 5, 6
    jh, th = A.helpers(MATMUL, B, I, O, N, pack_lwe=pack_lwe)
    x, w, bias = A.values((B, I)), A.values((I, O)), A.values((B, O))
    jx, tx = jh.encrypt_inputs(p.jencr, A.jad, x), th.encrypt_inputs(p.encr, A.ad, x)
    same_2d(jx, tx)
    jw, tw = jh.encode_weights(A.jad, w), th.encode_weights(A.ad, w)
    same_2d(jw, tw, same_pt)
    jy, ty = jh.matmul(p.jev, jx, jw), th.matmul(p.ev, tx, tw)
    same_2d(jy, ty)
    if pack_lwe:
        jy, ty = jh.pack_outputs(p.jev, A.jglk, jy), th.pack_outputs(p.ev, A.glk, ty)
        same_2d(jy, ty)
        assert ty.size() == 1 and len(ty[0]) == ceil_div(
            ceil_div(B, th.batch_block) * ceil_div(O, th.output_block), th.input_block)
    jb, tb = jh.encode_outputs(A.jout, bias), th.encode_outputs(A.out, bias)
    same_2d(jb, tb, same_pt)
    jy, ty = jy.add_plain(jb, p.jev), ty.add_plain(tb, p.ev)
    same_2d(jy, ty)
    jdec = jh.decrypt_outputs(A.jout, p.jdec, jy)
    dec = th.decrypt_outputs(A.out, p.dec, ty)
    A.check(jdec, dec, A.oracle(x @ w + bias if p.ckks else
                                x.astype(object) @ w.astype(object) + bias))


def test_matmul_fly_equals_matmul(A):
    p = A.p
    B, I, O = 3, 17, 9
    jh, th = A.helpers(MATMUL, B, I, O, N, pack_lwe=False)
    x, w = A.values((B, I)), A.values((I, O))
    jx, tx = jh.encrypt_inputs(p.jencr, A.jad, x), th.encrypt_inputs(p.encr, A.ad, x)
    jy, ty = jh.matmul_fly(p.jev, A.jad, jx, w), th.matmul_fly(p.ev, A.ad, tx, w)
    same_2d(jy, ty)
    same_2d(ty, th.matmul(p.ev, tx, th.encode_weights(A.ad, w)),
            lambda a, b: same(a.data.numpy(), b.data))
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty),
            A.oracle(x @ w if p.ckks else x.astype(object) @ w.astype(object)))


def test_matmul_reverse(A):
    """Plain inputs, encrypted weights (EncryptRight)."""
    p = A.p
    B, I, O = 2, 5, 4
    jh, th = A.helpers(MATMUL, B, I, O, N, MatmulObjective.EncryptRight, pack_lwe=False)
    x, w = A.values((B, I)), A.values((I, O))
    jx, tx = jh.encode_inputs(A.jad, x, False), th.encode_inputs(A.ad, x, False)
    same_2d(jx, tx, same_pt)
    jw, tw = jh.encrypt_weights(p.jencr, A.jad, w), th.encrypt_weights(p.encr, A.ad, w)
    same_2d(jw, tw)
    jy, ty = jh.matmul_reverse(p.jev, jx, jw), th.matmul_reverse(p.ev, tx, tw)
    same_2d(jy, ty)
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty),
            A.oracle(x @ w if p.ckks else x.astype(object) @ w.astype(object)))


def test_matmul_cipher(A):
    """Both operands encrypted (Crossed): size-3 products."""
    p = A.p
    B, I, O = 2, 3, 2
    jh, th = A.helpers(MATMUL, B, I, O, N, MatmulObjective.Crossed, pack_lwe=False)
    x, w = A.values((B, I)), A.values((I, O))
    jx, tx = jh.encrypt_inputs(p.jencr, A.jad, x), th.encrypt_inputs(p.encr, A.ad, x)
    jw, tw = jh.encrypt_weights(p.jencr, A.jad, w), th.encrypt_weights(p.encr, A.ad, w)
    jy, ty = jh.matmul_cipher(p.jev, jx, jw), th.matmul_cipher(p.ev, tx, tw)
    same_2d(jy, ty)
    assert ty[0][0].size == 3
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty),
            A.oracle(x @ w if p.ckks else x.astype(object) @ w.astype(object)))


def test_cipher2d_ops_and_refusals(A):
    """Cipher2d.add, mod_switch_to_next, Plain2d.encrypt_asymmetric against
    the JAX package; save_seed, mesh= and pack_outputs without pack_lwe
    refuse."""
    p = A.p
    jh, th = A.helpers(MATMUL, 2, 5, 4, N, pack_lwe=False)
    x = A.values((2, 5))
    jpl, tpl = jh.encode_inputs(A.jad, x), th.encode_inputs(A.ad, x)
    ja, ta = jpl.encrypt_asymmetric(p.jencr), tpl.encrypt_asymmetric(p.encr)
    same_2d(ja, ta)
    js, ts = ja.add(ja, p.jev), ta.add(ta, p.ev)
    same_2d(js, ts)
    same_2d(js.mod_switch_to_next(p.jev), ts.mod_switch_to_next(p.ev))
    assert ts.size() == len(ts.data) and tpl.size() == len(tpl.data)
    assert Cipher2d().size() == 0 and Plain2d().size() == 0
    jseeded = jpl.encrypt_symmetric(p.jencr, save_seed=True)
    seeded = tpl.encrypt_symmetric(p.encr, save_seed=True)
    same_2d(jseeded, seeded)
    assert all(c.seed is not None and c.seed == j.seed
               for row, jrow in zip(seeded.data, jseeded.data) for c, j in zip(row, jrow))
    # mesh= (tests/test_torch_app_mesh.py): equal to the run without a mesh
    mesh = M.make_mesh(data=2, limb=2, devices=[torch.device("cpu")] * 4)
    tw = th.encode_weights(A.ad, A.values((5, 4)))
    same_2d(th.matmul(p.ev, ta, tw), th.matmul(p.ev, ta, tw, mesh=mesh), same_data)
    with pytest.raises(ValueError, match="pack_lwe"):
        th.pack_outputs(p.ev, A.glk, ta)
    packed = MatmulHelper(2, 5, 4, N, pack_lwe=True)
    pair = Cipher2d([[ta[0][0], ta[0][0]]])
    same_2d(packed.pack_outputs(p.ev, A.glk, pair),
            packed.pack_outputs(p.ev, A.glk, pair, mesh=mesh), same_data)


def test_jax_contract_cache_fault(A):
    """The fault fresh_jax_contract works around: on one level, a JAX
    contraction over 2 input blocks after one over 1 block sums only the
    first block, while the port (and the JAX package's own per-product
    path) sums both."""
    p = A.p
    jcts, cts = zip(*[p.encrypt(p.coefficients(A.rng, N), asymmetric=False)
                      for _ in range(2)])
    jpls, pls = zip(*[p.encode(p.coefficients(A.rng, N)) for _ in range(2)])
    fresh_jax_contract(p)
    p.jev.multiply_plain_contract([[jcts[0]]], [[jpls[0]]])
    stale = p.jev.multiply_plain_contract([list(jcts)], [[jpls[0]], [jpls[1]]])[0][0]
    port = p.ev.multiply_plain_contract([list(cts)], [[pls[0]], [pls[1]]])[0][0]
    want = p.jev.add(p.jev.multiply_plain(jcts[0], jpls[0]),
                     p.jev.multiply_plain(jcts[1], jpls[1]))
    same_ct(want, port)
    first = p.jev.multiply_plain(jcts[0], jpls[0])
    np.testing.assert_array_equal(np.asarray(stale.data), np.asarray(first.data))
    fresh_jax_contract(p)
    same_ct(p.jev.multiply_plain_contract([list(jcts)], [[jpls[0]], [jpls[1]]])[0][0], port)


# ----------------------------------------------------------------------
# conv2d
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 2, 2, 5, 6, 2, 3), (1, 1, 1, 8, 8, 3, 3)])
def test_conv2d_bias_decrypt(A, shape):
    """encrypt_inputs (the overlapping tiles), encode_weights (the flipped
    kernel), conv2d, encode_outputs + add_plain and decrypt_outputs; the
    second shape forces image tiling."""
    p = A.p
    B, Ci, Co, H, W, kh, kw = shape
    jh, th = A.helpers(CONV, *shape, N)
    x, k = A.values((B, Ci, H, W)), A.values((Co, Ci, kh, kw))
    bias = A.values((B, Co, H - kh + 1, W - kw + 1))
    jx, tx = jh.encrypt_inputs(p.jencr, A.jad, x), th.encrypt_inputs(p.encr, A.ad, x)
    same_2d(jx, tx)
    jk, tk = jh.encode_weights(A.jad, k), th.encode_weights(A.ad, k)
    same_2d(jk, tk, same_pt)
    jy, ty = jh.conv2d(p.jev, jx, jk), th.conv2d(p.ev, tx, tk)
    same_2d(jy, ty)
    jb, tb = jh.encode_outputs(A.jout, bias), th.encode_outputs(A.out, bias)
    same_2d(jb, tb, same_pt)
    jy, ty = jy.add_plain(jb, p.jev), ty.add_plain(tb, p.ev)
    same_2d(jy, ty)
    want = (plain_conv2d_valid(x, k) + bias if p.ckks else
            plain_conv2d_valid(x.astype(object), k.astype(object)) + bias)
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty),
            A.oracle(want))


def test_conv2d_reverse_and_cipher(A):
    """Plain inputs by encrypted weights, and both encrypted."""
    p = A.p
    shape = (1, 2, 2, 4, 5, 2, 2)
    B, Ci, Co, H, W, kh, kw = shape
    jh, th = A.helpers(CONV, *shape, N)
    x, k = A.values((B, Ci, H, W)), A.values((Co, Ci, kh, kw))
    want = A.oracle(plain_conv2d_valid(x, k) if p.ckks else
                    plain_conv2d_valid(x.astype(object), k.astype(object)))
    jxp, txp = jh.encode_inputs(A.jad, x, False), th.encode_inputs(A.ad, x, False)
    same_2d(jxp, txp, same_pt)
    jkc, tkc = jh.encrypt_weights(p.jencr, A.jad, k), th.encrypt_weights(p.encr, A.ad, k)
    same_2d(jkc, tkc)
    jy, ty = jh.conv2d_reverse(p.jev, jxp, jkc), th.conv2d_reverse(p.ev, txp, tkc)
    same_2d(jy, ty)
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty), want)
    jxc, txc = jh.encrypt_inputs(p.jencr, A.jad, x), th.encrypt_inputs(p.encr, A.ad, x)
    jy, ty = jh.conv2d_cipher(p.jev, jxc, jkc), th.conv2d_cipher(p.ev, txc, tkc)
    same_2d(jy, ty)
    A.check(jh.decrypt_outputs(A.jout, p.jdec, jy), th.decrypt_outputs(A.out, p.dec, ty), want)


# ----------------------------------------------------------------------
# the examples' flows, on the port alone
# ----------------------------------------------------------------------
def context(scheme: str, n: int, t_bits: int | None = 20):
    parms = EncryptionParameters(SchemeType[scheme]).set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
    if t_bits:
        parms.set_plain_modulus(PlainModulus.batching(n, t_bits))
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, seed=3, device="cpu")
    keygen = KeyGenerator(ctx)
    encryptor = Encryptor(ctx, sk=keygen.secret_key, pk=keygen.create_public_key())
    return ctx, keygen, encryptor, Decryptor(ctx, keygen.secret_key), Evaluator(ctx)


def test_example_10_bfv_matmul_flow():
    """examples/10_bfv_matmul.py on the port without its wire format (the
    wire: tests/test_torch_wire.py): 8 x 32 x 16 at n = 4096."""
    n = 4096
    ctx, _, encryptor, decryptor, evaluator = context("BFV", n)
    adapter = BatchEncoderAdapter(BatchEncoder(ctx))
    t = ctx.first_context_data().parms.plain_modulus.value
    helper = MatmulHelper(8, 32, 16, n, MatmulObjective.EncryptLeft, pack_lwe=False)
    rng = np.random.default_rng(0)
    x = rng.integers(0, t, (8, 32), dtype=np.uint64)
    w = rng.integers(0, t, (32, 16), dtype=np.uint64)
    y = helper.matmul(evaluator, helper.encode_inputs(adapter, x).encrypt_symmetric(encryptor),
                      helper.encode_weights(adapter, w))
    dec = helper.decrypt_outputs(adapter, decryptor, y)
    assert (dec.astype(object) % t == (x.astype(object) @ w.astype(object)) % t).all()


def test_example_11_ckks_matmul_flow():
    """examples/11_ckks_matmul.py on the port: 4 x 16 x 8 at n = 2048, scale
    2^25, max error below 1e-2."""
    n, scale = 2048, 2.0 ** 25
    ctx, _, encryptor, decryptor, evaluator = context("CKKS", n, None)
    encoder = CKKSEncoder(ctx)
    adapter = CKKSEncoderAdapter(encoder, scale)
    helper = MatmulHelper(4, 16, 8, n, MatmulObjective.EncryptLeft, pack_lwe=False)
    rng = np.random.default_rng(0)
    x, w = rng.uniform(-1, 1, (4, 16)), rng.uniform(-1, 1, (16, 8))
    y = helper.matmul(evaluator, helper.encrypt_inputs(encryptor, adapter, x),
                      helper.encode_weights(adapter, w))
    dec = helper.decrypt_outputs(CKKSEncoderAdapter(encoder, scale * scale), decryptor, y)
    assert np.abs(dec - x @ w).max() < 1e-2


def test_example_14_bfv_conv2d_flow():
    """examples/14_bfv_conv2d.py on the port: 1 x 2 -> 3 channels, 8 x 8, 3 x 3
    kernels at n = 2048."""
    n = 2048
    ctx, _, encryptor, decryptor, evaluator = context("BFV", n)
    adapter = BatchEncoderAdapter(BatchEncoder(ctx))
    t = ctx.first_context_data().parms.plain_modulus.value
    helper = Conv2dHelper(1, 2, 3, 8, 8, 3, 3, n, MatmulObjective.EncryptLeft)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (1, 2, 8, 8), dtype=np.uint64)
    kern = rng.integers(0, 256, (3, 2, 3, 3), dtype=np.uint64)
    y = helper.conv2d(evaluator, helper.encrypt_inputs(encryptor, adapter, x),
                      helper.encode_weights(adapter, kern))
    dec = helper.decrypt_outputs(adapter, decryptor, y)
    want = plain_conv2d_valid(x.astype(object), kern.astype(object)) % t
    np.testing.assert_array_equal(dec.astype(object) % t, want)


def test_packed_matmul_at_the_bench_shape_blocks():
    """The [app] phase's BFV flow at a small degree: 10 x 12 x 11 with
    pack_lwe at n = 256, its packed groups ragged, decrypting exactly."""
    n = 256
    ctx, keygen, encryptor, decryptor, evaluator = context("BFV", n)
    adapter = BatchEncoderAdapter(BatchEncoder(ctx))
    t = ctx.first_context_data().parms.plain_modulus.value
    helper = MatmulHelper(10, 12, 11, n, MatmulObjective.EncryptLeft, pack_lwe=True)
    tiles = ceil_div(10, helper.batch_block) * ceil_div(11, helper.output_block)
    assert tiles % helper.input_block  # the last group is short
    rng = np.random.default_rng(5)
    x = rng.integers(0, t, (10, 12), dtype=np.uint64)
    w = rng.integers(0, t, (12, 11), dtype=np.uint64)
    y = helper.matmul(evaluator, helper.encrypt_inputs(encryptor, adapter, x),
                      helper.encode_weights(adapter, w))
    packed = helper.pack_outputs(evaluator, keygen.create_automorphism_keys(), y)
    dec = helper.decrypt_outputs(adapter, decryptor, packed)
    np.testing.assert_array_equal(dec.astype(object) % t,
                                  (x.astype(object) @ w.astype(object)) % t)
    assert all(decryptor.invariant_noise_budget(c) > 0 for c in packed[0])


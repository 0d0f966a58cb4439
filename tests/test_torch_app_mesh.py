"""The app layer under a mesh, against the JAX package: a twin of each test
of tests/parallel/test_app_mesh.py.  MatmulHelper.matmul and
Conv2dHelper.conv2d with mesh= split multiply_plain_contract's block rows
over 'data' and its limbs over 'limb' (no collective), pack_outputs(mesh=)
runs the PackLWEs tree on each position's limbs with limb-partitioned
keyswitches; on [cpu] * 8 each result must equal the JAX package's
single-device run bit for bit.  Both packages hold one Pair
(tests/test_torch_lwe.py: the same AES-keyed keys and encryptions) at
n = 64, as the JAX tests.  The JAX test reads that the contraction's output
is spread over the mesh (its sharding's device set); the port's results come
back gathered, and the twin reads it in the record: more than one mesh
position ran a stage."""

import numpy as np
import torch

from troy_tpu.app.matmul import MatmulHelper as JMatmul
from troy_tpu.app.conv2d import Conv2dHelper as JConv2d
from troy_tpu.app.encoder_adapter import BatchEncoderAdapter as JAdapter
from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective, ceil_div
from troy_tpu_torch.app.conv2d import Conv2dHelper
from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter
from troy_tpu_torch.parallel import mesh as M

from .test_torch_app import fresh_jax_contract, same_2d
from .test_torch_lwe import Pair

N = 64
CPU8 = [torch.device("cpu")] * 8
RNG = np.random.default_rng(77)


def _force_blocks(helper, bb, ib, ob):
    """Pin the block grid (the default packs small batches into one block
    row, which would leave 'data' with nothing to split)."""
    assert bb * ib * ob <= helper.slot_count
    helper.batch_block, helper.input_block, helper.output_block = bb, ib, ob
    return helper


def _pair(primes: int) -> Pair:
    return Pair("BFV", n=N, bits=[30] * primes, seed=0xA77)


def test_matmul_sharded_end_to_end():
    p = _pair(5)
    jad, ad = JAdapter(p.jenc), BatchEncoderAdapter(p.enc)
    batch, in_d, out_d = 8, 5, 6
    jh = _force_blocks(JMatmul(batch, in_d, out_d, N, MatmulObjective.EncryptLeft,
                               pack_lwe=True), 2, 2, 4)
    th = _force_blocks(MatmulHelper(batch, in_d, out_d, N, MatmulObjective.EncryptLeft,
                                    pack_lwe=True), 2, 2, 4)
    assert ceil_div(batch, th.batch_block) == 4     # 'data' really splits
    x = RNG.integers(0, p.t, size=(batch, in_d), dtype=np.uint64)
    w = RNG.integers(0, p.t, size=(in_d, out_d), dtype=np.uint64)
    jx, tx = jh.encrypt_inputs(p.jencr, jad, x), th.encrypt_inputs(p.encr, ad, x)
    same_2d(jx, tx)
    jw, tw = jh.encode_weights(jad, w), th.encode_weights(ad, w)
    jglk, glk = p.automorphism_keys()
    fresh_jax_contract(p)
    jy = jh.matmul(p.jev, jx, jw)
    jpk = jh.pack_outputs(p.jev, jglk, jy)

    m = M.make_mesh(data=4, limb=2, devices=CPU8)
    with M.recording() as rec:
        ty = th.matmul(p.ev, tx, tw, mesh=m)
    same_2d(jy, ty)
    assert len(rec.active_shards) == 8 and M.collective_stats(rec)["total"] == 0
    with M.recording() as rec:
        tpk = th.pack_outputs(p.ev, glk, ty, mesh=m)
    same_2d(jpk, tpk)
    assert len(rec.active_shards) > 1 and M.collective_stats(rec)["total"] >= 1

    dec = th.decrypt_outputs(ad, p.dec, tpk)
    want = (x.astype(object) @ w.astype(object)) % p.t
    np.testing.assert_array_equal(dec.astype(object) % p.t, want)


def test_matmul_sharded_limb_only_mesh():
    """A (1, 8) mesh, all parallelism on the limbs (L = 8)."""
    p = _pair(9)
    jad, ad = JAdapter(p.jenc), BatchEncoderAdapter(p.enc)
    jh = JMatmul(4, 4, 4, N, MatmulObjective.EncryptLeft, pack_lwe=False)
    th = MatmulHelper(4, 4, 4, N, MatmulObjective.EncryptLeft, pack_lwe=False)
    x = RNG.integers(0, p.t, size=(4, 4), dtype=np.uint64)
    w = RNG.integers(0, p.t, size=(4, 4), dtype=np.uint64)
    jx, tx = jh.encrypt_inputs(p.jencr, jad, x), th.encrypt_inputs(p.encr, ad, x)
    jw, tw = jh.encode_weights(jad, w), th.encode_weights(ad, w)
    fresh_jax_contract(p)
    jy = jh.matmul(p.jev, jx, jw)
    with M.recording() as rec:
        ty = th.matmul(p.ev, tx, tw, mesh=M.make_mesh(data=1, limb=8, devices=CPU8))
    same_2d(jy, ty)
    assert len(rec.active_shards) == 8
    dec = th.decrypt_outputs(ad, p.dec, ty)
    want = (x.astype(object) @ w.astype(object)) % p.t
    np.testing.assert_array_equal(dec.astype(object) % p.t, want)


def test_conv2d_sharded_end_to_end():
    p = _pair(5)
    jad, ad = JAdapter(p.jenc), BatchEncoderAdapter(p.enc)
    B, Ci, Co, H, W, kh, kw = 2, 2, 2, 4, 4, 2, 2
    args = (B, Ci, Co, H, W, kh, kw, N, MatmulObjective.EncryptLeft)
    jh, th = JConv2d(*args), Conv2dHelper(*args)
    x = RNG.integers(0, p.t, size=(B, Ci, H, W), dtype=np.uint64)
    w = RNG.integers(0, p.t, size=(Co, Ci, kh, kw), dtype=np.uint64)
    jx, tx = jh.encrypt_inputs(p.jencr, jad, x), th.encrypt_inputs(p.encr, ad, x)
    jw, tw = jh.encode_weights(jad, w), th.encode_weights(ad, w)
    fresh_jax_contract(p)
    jy = jh.conv2d(p.jev, jx, jw)
    with M.recording() as rec:
        ty = th.conv2d(p.ev, tx, tw, mesh=M.make_mesh(data=2, limb=4, devices=CPU8))
    same_2d(jy, ty)
    assert len(rec.active_shards) > 1
    got = th.decrypt_outputs(ad, p.dec, ty)
    xo, wo = x.astype(object), w.astype(object)
    want = np.zeros((B, Co, H - kh + 1, W - kw + 1), dtype=object)
    for i in range(H - kh + 1):
        for j in range(W - kw + 1):
            for b in range(B):
                for oc in range(Co):
                    want[b, oc, i, j] = sum(
                        (xo[b, ic, i:i + kh, j:j + kw] * wo[oc, ic]).sum()
                        for ic in range(Ci))
    np.testing.assert_array_equal(got.astype(object) % p.t, want % p.t)


def test_pack_rlwe_batched_on_a_mesh():
    """pack_rlwe_ciphertexts_batched(mesh=) for an NTT-form scheme (BGV, its
    correction factor kept), 4 groups over (data=2, limb=2) on 3 primes
    (L = 2): equal to the port's unsharded pack, whose parity with the JAX
    package is test_torch_lwe.py's."""
    p = Pair("BGV", n=32, bits=[30, 30, 30], seed=0x1E)
    _, glk = p.automorphism_keys()
    rng = np.random.default_rng(5)
    groups = [[p.encrypt(p.coefficients(rng))[1] for _ in range(2)] for _ in range(4)]
    whole = p.ev.pack_rlwe_ciphertexts_batched(groups, glk, 0, 32, 16)
    with M.recording() as rec:
        split = p.ev.pack_rlwe_ciphertexts_batched(
            groups, glk, 0, 32, 16, mesh=M.make_mesh(data=2, limb=2, devices=CPU8))
    for a, b in zip(whole, split):
        assert torch.equal(a.data, b.data) and a.is_ntt_form == b.is_ntt_form
        assert (a.scale, a.correction_factor) == (b.scale, b.correction_factor)
    assert len(rec.active_shards) == 4 and M.collective_stats(rec)["total"] >= 1

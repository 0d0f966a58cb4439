"""The ring2k encoder (troy_tpu_torch/app/ring2k.py, ops/limb.py, the
Ring2kEncoderAdapter) against the JAX package's, bit for bit on integers.

Each k runs on a BFV pair (tests/test_torch_lwe.py's Pair: both packages,
keys and encryptions from RandomGenerator(seed, "aes") streams) at n = 32
on 4, 6 or 8 x 30-bit primes (the chains of tests/app/test_ring2k_matrix.py),
for the k of tests/app/test_ring2k.py and test_ring2k_matrix.py and k = 24,
30, 40 and 72.  Per k: scale_up, centralize, decentralize and scale_down
(on random phases and on decrypted ones) equal the JAX package's and the
big-integer oracles; encryptions of scale_up plaintexts equal the JAX
ones and decrypt to the messages.  The {t, gamma} conversion into t = 2^30
and 2^31 equals the JAX BaseConverter's, and the old 7-term int64 chunk is
shown to overflow there.  The matmul (k = 20, 72) and conv2d (k = 40) flows
of tests/app/test_matmul.py and test_conv2d.py at n = 64, and the
examples/13_ring2k.py flow, match the JAX package and the integer oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.app.ring2k import PolynomialEncoderRing2k as JRing2k
from troy_tpu.app.encoder_adapter import Ring2kEncoderAdapter as JRing2kAdapter
from troy_tpu.app.matmul import MatmulHelper as JMatmul, MatmulObjective as JObjective
from troy_tpu.app.conv2d import Conv2dHelper as JConv2d
from troy_tpu.core.plaintext import Plaintext as JPlaintext
from troy_tpu.ops import limb as JLB
from troy_tpu.rns.rns_base import RNSBase as JRNSBase, BaseConverter as JBaseConverter
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu_torch.app.ring2k import PolynomialEncoderRing2k
from troy_tpu_torch.app.encoder_adapter import Ring2kEncoderAdapter
from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
from troy_tpu_torch.app.conv2d import Conv2dHelper
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.core.plaintext import Plaintext
from troy_tpu_torch.ops import limb as LB, u32 as U
from troy_tpu_torch.rns.rns_base import RNSBase, BaseConverter

from .test_torch_client import same
from .test_torch_lwe import Pair, same_ct
from .test_torch_app import fresh_jax_contract

N, SEED = 32, 0x2CA
KS = [8, 16, 17, 20, 24, 30, 31, 32, 40, 48, 64, 72, 100, 128]
RNG = np.random.default_rng(4242)
_pairs: dict = {}


def limbs_for(k: int) -> int:
    return 4 if k <= 60 else (6 if k <= 100 else 8)


def pair(limbs: int, n: int = N) -> Pair:
    key = (limbs, n)
    if key not in _pairs:
        _pairs[key] = Pair("BFV", n=n, bits=[30] * limbs, seed=SEED)
    return _pairs[key]


def messages(k: int, count: int = N) -> list[int]:
    """Random values mod 2^k with the edges 0, 1, 2^(k-1) - 1, 2^(k-1) and
    2^k - 1 in front."""
    mask = (1 << k) - 1
    edges = [0, 1, (1 << (k - 1)) - 1, 1 << (k - 1), mask]
    rest = [int.from_bytes(RNG.bytes(17), "little") & mask for _ in range(count - 5)]
    return edges + rest


def as_ints(a) -> list[int]:
    return [int(v) for v in np.asarray(a).reshape(-1)]


def same_pt(jpt, pt):
    same(jpt.data, pt.data)
    assert pt.parms_id == jpt.parms_id and pt.is_ntt_form == bool(jpt.is_ntt_form)


class Enc:
    """One k's encoders on its pair."""

    def __init__(self, k: int):
        self.k = k
        self.p = pair(limbs_for(k))
        self.j = JRing2k(self.p.jc, k)
        self.t = PolynomialEncoderRing2k(self.p.tc, k)


@pytest.fixture(scope="module", params=KS)
def E(request):
    return Enc(request.param)


def test_scale_up_and_centralize(E):
    m = messages(E.k)
    for name in ("scale_up", "centralize"):
        jpt, pt = getattr(E.j, name)(m), getattr(E.t, name)(m)
        same_pt(jpt, pt)
    same_pt(E.j.scale_up_host(m), E.t.scale_up_host(m))
    same(E.t.scale_up_host(m).data, E.t.scale_up(m).data)


def test_decentralize(E):
    m = messages(E.k)
    got = E.t.decentralize(E.t.centralize(m))
    assert as_ints(got) == m
    assert as_ints(E.j.decentralize(E.j.centralize(m))) == as_ints(got)


def test_scale_down_random_phase(E):
    """Random residues: the JAX package's {t, gamma} rounding, integer for
    integer (whatever the noise)."""
    cd = E.p.tc.first_context_data()
    phase = np.stack([RNG.integers(0, q, N) for q in cd.base_q.values]).astype(np.uint32)
    jpt = JPlaintext(jnp.asarray(phase), parms_id=cd.parms_id)
    pt = Plaintext(torch.from_numpy(phase.astype(np.int64)), parms_id=cd.parms_id)
    assert as_ints(E.t.scale_down(pt)) == as_ints(E.j.scale_down(jpt))
    assert as_ints(E.t.scale_down_host(pt)) == as_ints(E.j.scale_down_host(jpt))


def test_encrypt_decrypt(E):
    """A symmetric and an asymmetric encryption of scale_up(m) equal the JAX
    ones and decrypt to m through bfv_decrypt_without_scaling_down, on the
    device path and the host oracle alike."""
    p, m = E.p, messages(E.k)
    jpt, pt = E.j.scale_up(m), E.t.scale_up(m)
    for sym in (True, False):
        if sym:
            jct, ct = p.jencr.encrypt_symmetric(jpt), p.encr.encrypt_symmetric(pt)
        else:
            jct, ct = p.jencr.encrypt_asymmetric(jpt), p.encr.encrypt_asymmetric(pt)
        same_ct(jct, ct)
        phase = p.dec.bfv_decrypt_without_scaling_down(ct)
        same_pt(p.jdec.bfv_decrypt_without_scaling_down(jct), phase)
        assert as_ints(E.t.decrypt_scale_down(p.dec, ct)) == m
        assert as_ints(E.t.scale_down_host(phase)) == m
        assert as_ints(E.j.decrypt_scale_down(p.jdec, jct)) == m


@pytest.mark.parametrize("k", [30, 31])
def test_t_gamma_conversion(k):
    """The plain {t, gamma} conversion into t = 2^k equals the JAX
    BaseConverter at 4 x 30-bit inputs; the product bound sizes its chunks,
    and the fast path's 7-term chunk overflows int64 there."""
    p = pair(4)
    cd, jcd = p.tc.first_context_data(), p.jc.first_context_data()
    gamma = PolynomialEncoderRing2k(p.tc, k).helper().gamma.value
    conv = BaseConverter(cd.base_q, RNSBase([Modulus(1 << k), Modulus(gamma)], "cpu"))
    jconv = JBaseConverter(jcd.base_q, JRNSBase([JModulus(1 << k), JModulus(gamma)]))
    q = cd.base_q.values
    x = np.stack([np.concatenate([[v - 1] * 8, RNG.integers(0, v, N - 8)]) for v in q])
    got = conv.convert(torch.from_numpy(x.astype(np.int64)))
    same(jconv.convert(jnp.asarray(x.astype(np.uint32))), got)
    Q = cd.base_q.prod
    for j, t in enumerate((1 << k, gamma)):
        want = [sum(int(x[i, c]) * cd.base_q.inv_punctured[i] % q[i] * (Q // q[i])
                    for i in range(len(q))) % t for c in range(N)]
        assert as_ints(got[j]) == want
    # a residue below q_i < 2^30 times a matrix entry below 2^k: at k = 31
    # seven such products pass 2^63, so the fast path's 7-term int64 chunk
    # wraps (to a negative sum: signed overflow, which only the power-of-two
    # modulus hides); the chunk sized by the product bound stays exact
    a = torch.tensor([[max(q) - 1]])
    b = torch.tensor([[(1 << k) - 1]])
    exact = 7 * (max(q) - 1) * ((1 << k) - 1)
    sized = U.dot_terms(max(q), 1 << k)
    assert int(U.dot_mod([(a, b)] * 7, 1 << k, sized)) == exact % (1 << k)
    wrapped = int(sum(a * b for _ in range(7)))
    assert (wrapped == exact) == (k == 30)
    if k == 31:
        assert exact >= 1 << 63 and wrapped < 0 and sized == 4


@pytest.mark.parametrize("k", [40, 64, 100, 128])
def test_limb_ops(k):
    """Every limb helper on random limbs against the JAX package's."""
    w = LB.width(k)
    vals = messages(k)
    x_np = LB.from_ints(vals, k)
    np.testing.assert_array_equal(x_np, JLB.from_ints(vals, k).astype(np.int64))
    x, jx = torch.from_numpy(x_np), jnp.asarray(x_np.astype(np.uint32))
    assert as_ints(LB.to_ints(x, k)) == vals
    c = LB.const_limbs(int.from_bytes(RNG.bytes(16), "little") & ((1 << k) - 1), w)
    assert c == JLB.const_limbs(int(LB.to_ints(np.array(c)[:, None], k)[0]), w)
    small = torch.from_numpy(RNG.integers(0, 1 << 32, (3, N)).astype(np.int64))
    jsmall = jnp.asarray(small.numpy().astype(np.uint32))
    cases = [
        (LB.mul_const_full(x, c), JLB.mul_const_full(jx, c)),
        (LB.mul_const_low(x, c, k), JLB.mul_const_low(jx, c, k)),
        (LB.dot_const_low(list(small), [c, c[:2], c], k),
         JLB.dot_const_low(list(jsmall), [c, c[:2], c], k)),
        (LB.add_const_low(x, c, k), JLB.add_const_low(jx, c, k)),
        (LB.sub_low(x, x.flip(-1), k), JLB.sub_low(jx, jx[..., ::-1], k)),
        (LB.sub_low(x, x[..., :2, :], k), JLB.sub_low(jx, jx[..., :2, :], k)),
        (LB.add_bit(LB.mul_const_full(x, [1]), k - 1),
         JLB.add_bit(JLB.mul_const_full(jx, [1]), k - 1)),
        (LB.shift_right(x, k // 2), JLB.shift_right(jx, k // 2)),
        (LB.shift_right(x, 16), JLB.shift_right(jx, 16)),
        (LB.get_bit(x, k - 1), JLB.get_bit(jx, k - 1)),
        (LB.u32_split(small), JLB.u32_split(jsmall)),
        (LB.low(LB.mul_const_full(x, c), k), JLB.low(JLB.mul_const_full(jx, c), k)),
    ]
    for got, want in cases:
        same(want, got)
    p = pair(4)
    cd, jcd = p.tc.first_context_data(), p.jc.first_context_data()
    pows = [torch.tensor([pow(2, 16 * i, q) for q in cd.base_q.values]).view(-1, 1)
            for i in range(w)]
    jpows = [jnp.asarray(np.array([pow(2, 16 * i, q) for q in cd.base_q.values],
                                  np.uint32))[:, None] for i in range(w)]
    jpack = jcd.base_q.pack()
    same(JLB.fold_mod_q(jx, jpows, jpack["q"][:, None], jpack["ratio_hi"][:, None],
                        jpack["ratio_lo"][:, None]),
         LB.fold_mod_q(x, pows, cd.base_q.q.view(-1, 1)))


def _ring2k_pair(n: int, k: int):
    p = pair(limbs_for(k) if k != 72 else 6, n)
    return (p, JRing2kAdapter(JRing2k(p.jc, k)), Ring2kEncoderAdapter(PolynomialEncoderRing2k(p.tc, k)))


@pytest.mark.parametrize("k", [20, 72])
def test_matmul(k):
    """tests/app/test_matmul.py's ring2k flows (k = 20 on 4 primes, k = 72 on
    6) at n = 64, batch 2 x 3 x 2, EncryptLeft without packing."""
    p, jad, ad = _ring2k_pair(64, k)
    mask = (1 << k) - 1
    x = np.array(messages(k, 6), dtype=object).reshape(2, 3)
    w = np.array(messages(k, 6)[::-1], dtype=object).reshape(3, 2)
    if k <= 64:
        x, w = x.astype(np.uint64), w.astype(np.uint64)
    jh = JMatmul(2, 3, 2, 64, JObjective.EncryptLeft, pack_lwe=False)
    th = MatmulHelper(2, 3, 2, 64, MatmulObjective.EncryptLeft, pack_lwe=False)
    jx, tx = jh.encrypt_inputs(p.jencr, jad, x), th.encrypt_inputs(p.encr, ad, x)
    jw, tw = jh.encode_weights(jad, w), th.encode_weights(ad, w)
    fresh_jax_contract(p)
    jy, ty = jh.matmul(p.jev, jx, jw), th.matmul(p.ev, tx, tw)
    for jrow, trow in zip(jy.data, ty.data):
        for jct, ct in zip(jrow, trow):
            same_ct(jct, ct)
    got = th.decrypt_outputs(ad, p.dec, ty)
    want = (x.astype(object) @ w.astype(object)) & mask
    assert [[int(v) & mask for v in r] for r in got] == [[int(v) for v in r] for r in want]
    assert [[int(v) for v in r] for r in jh.decrypt_outputs(jad, p.jdec, jy)] == \
        [[int(v) for v in r] for r in got]


def test_conv2d_k40():
    """tests/app/test_conv2d.py's ring2k conv2d at k = 40, n = 64."""
    k = 40
    p, jad, ad = _ring2k_pair(64, k)
    mask = (1 << k) - 1
    B, Ci, Co, H, W, kh, kw = 1, 1, 1, 3, 3, 2, 2
    x = RNG.integers(0, 1 << 20, (B, Ci, H, W), dtype=np.uint64)
    kern = RNG.integers(0, 1 << 20, (Co, Ci, kh, kw), dtype=np.uint64)
    jh = JConv2d(B, Ci, Co, H, W, kh, kw, 64, JObjective.EncryptLeft)
    th = Conv2dHelper(B, Ci, Co, H, W, kh, kw, 64, MatmulObjective.EncryptLeft)
    jx, tx = jh.encrypt_inputs(p.jencr, jad, x), th.encrypt_inputs(p.encr, ad, x)
    jk, tk = jh.encode_weights(jad, kern), th.encode_weights(ad, kern)
    fresh_jax_contract(p)
    jy, ty = jh.conv2d(p.jev, jx, jk), th.conv2d(p.ev, tx, tk)
    for jrow, trow in zip(jy.data, ty.data):
        for jct, ct in zip(jrow, trow):
            same_ct(jct, ct)
    got = th.decrypt_outputs(ad, p.dec, ty)
    for i in range(H - kh + 1):
        for j in range(W - kw + 1):
            want = int((x[0, 0, i:i + kh, j:j + kw].astype(object)
                        * kern[0, 0].astype(object)).sum()) & mask
            assert int(got[0, 0, i, j]) & mask == want


def test_example_13_ring2k_flow():
    """examples/13_ring2k.py: k = 24, an asymmetric encryption of
    scale_up(m1), add_plain(scale_up(m2)), decrypt_scale_down, on the pair at
    n = 64: equal to the JAX package's ciphertexts and to (m1 + m2) mod 2^k."""
    k = 24
    p = pair(4, 64)
    j, t = JRing2k(p.jc, k), PolynomialEncoderRing2k(p.tc, k)
    mask = (1 << k) - 1
    m1 = RNG.integers(0, 1 << k, 64, dtype=np.uint64)
    m2 = RNG.integers(0, 1 << k, 64, dtype=np.uint64)
    jct = p.jev.add_plain(p.jencr.encrypt_asymmetric(j.scale_up(m1)), j.scale_up(m2))
    ct = p.ev.add_plain(p.encr.encrypt_asymmetric(t.scale_up(m1)), t.scale_up(m2))
    same_ct(jct, ct)
    out = t.decrypt_scale_down(p.dec, ct)
    assert out.dtype == np.uint64 and (out == (m1 + m2) & mask).all()

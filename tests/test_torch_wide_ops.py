"""The wide path's scalar core, NTT and RNS toolbox (troy_tpu_torch/ops/u64.py,
ops/ntt64.py, ops/rp.py, rns/rns_base.BaseConverter64, rns/rns_tool64.py,
rns/scaling.BFVScaler64) against the JAX package's counterparts and Python
integers, bit for bit.

* u64: products, Barrett and Shoup reductions and dots at the edges (q - 1,
  products near 2^122, the largest prime below 2^61), against Python ints
  and the JAX (hi, lo) primitives.
* ntt64: the forward and inverse transforms at n = 32 and 64 on {60, 40, 40,
  60} against the JAX package's ntt_forward64 / ntt_inverse64 and a
  schoolbook negacyclic product; the width dispatch of ops/rp.py.
* RNSTool64 at n = 16 on the JAX tests' [60, 40, 50] base (t a 20-bit prime)
  and at n = 32 on {60, 40, 40}: each function against the JAX tool on the
  same residues, the HPS lift (its float32 alpha) included, with phases
  next to +-Q/2; and the Python-int oracles of tests/rns/test_rns_wide.py.
* BFVScaler64 against the JAX scaler and the oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.ops import u64 as JW, ntt64 as JN64
from troy_tpu.rns.rns_base import RNSBase as JRNSBase, BaseConverter64 as JConv64
from troy_tpu.rns.rns_tool64 import RNSTool64 as JTool64
from troy_tpu.rns.scaling import BFVScaler64 as JScaler64
from troy_tpu_torch import interop
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import u64 as W, ntt64 as N64, rp as R
from troy_tpu_torch.rns.rns_base import RNSBase, BaseConverter64
from troy_tpu_torch.rns.rns_tool64 import RNSTool64
from troy_tpu_torch.rns.scaling import BFVScaler64
from troy_tpu_torch.utils import numth

RNG = np.random.default_rng(6464)
Q61 = max(p for p in numth.get_primes(64, 60, 4))  # a 60-bit NTT prime
P61 = (1 << 61) - 1                                  # the largest q the path takes


def t_of(vals) -> torch.Tensor:
    return torch.tensor([int(v) for v in vals], dtype=torch.int64)


def jpair(x: np.ndarray):
    """int residues (..., n) -> JAX (hi, lo) u32 words."""
    a = np.asarray(x, dtype=np.uint64)
    return jnp.asarray((a >> np.uint64(32)).astype(np.uint32)), \
        jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def from_jpair(h, l) -> list[int]:
    return [(int(a) << 32) | int(b) for a, b in zip(np.asarray(h).reshape(-1),
                                                    np.asarray(l).reshape(-1))]


def same_w(j, t):
    np.testing.assert_array_equal(
        interop.to_tensor(np.asarray(j), "cpu", wide=True).numpy(), t.cpu().numpy())


def edge_values(q: int, count: int = 64) -> list[int]:
    return [0, 1, q - 1, q - 2, q // 2, (q + 1) // 2] + \
        [int(v) for v in RNG.integers(0, q, count - 6, dtype=np.uint64)]


@pytest.mark.parametrize("q", [Q61, P61, (1 << 40) + 15, (1 << 31) - 1])
def test_mul_mod_and_barrett(q):
    a, b = edge_values(q), edge_values(q)[::-1]
    k = W.barrett_consts([q], shape=())
    got = W.mul_mod64(t_of(a), t_of(b), k)
    assert got.tolist() == [x * y % q for x, y in zip(a, b)]
    h, l = W.mul64_wide(t_of(a), t_of(b))
    assert [(int(x) << 62) + int(y) for x, y in zip(h, l)] == [x * y for x, y in zip(a, b)]
    assert W.mul64_lo(t_of(a), t_of(b)).tolist() == [x * y % (1 << 62) for x, y in zip(a, b)]
    assert W.mul64_hi(t_of(a), t_of(b)).tolist() == [x * y >> 62 for x, y in zip(a, b)]
    # any 124-bit value below 2^(bit_length(q) + 61), its top included
    top = (1 << (q.bit_length() + 61)) - 1
    vals = [top, top - 1, q * q - 1, (q - 1) * (q - 1)] + \
        [int.from_bytes(RNG.bytes(16), "little") % top for _ in range(60)]
    got = W.barrett_reduce_u128(t_of([v >> 62 for v in vals]),
                                t_of([v & W.M62 for v in vals]), k)
    assert got.tolist() == [v % q for v in vals]
    # the JAX Barrett on the same products
    jah, jal = jpair(a)
    jbh, jbl = jpair(b)
    r = JW.barrett_ratio_u128(q)
    q_lo, q_hi = JW.words(q)
    jr = JW.mul_mod64(jah, jal, jbh, jbl, q_hi, q_lo, r[3], r[2], r[1], r[0])
    assert from_jpair(*jr) == [x * y % q for x, y in zip(a, b)]


@pytest.mark.parametrize("q", [Q61, P61, (1 << 40) + 15])
def test_shoup_and_dot(q):
    w = edge_values(q, 16)
    x = [int.from_bytes(RNG.bytes(8), "little") % (1 << 62) for _ in range(16)] + \
        [(1 << 62) - 1, 0, q, 2 * q - 1]
    for wv in w[:6]:
        ws = W.shoup62(wv, q)
        lazy = W.shoup_mul64_lazy(t_of(x), wv, ws, q)
        assert all(0 <= int(v) < 2 * q and int(v) % q == xv * wv % q
                   for v, xv in zip(lazy, x))
        assert W.shoup_mul64(t_of(x), wv, ws, q).tolist() == [xv * wv % q for xv in x]
    k = W.barrett_consts([q], shape=())
    a = [t_of(edge_values(q, 32)) for _ in range(20)]
    b = [t_of(edge_values(q, 32)[::-1]) for _ in range(20)]
    terms = W.dot_mod64_terms(q)
    got = W.dot_mod64(list(zip(a, b)), k, terms)
    want = [sum(int(a[i][c]) * int(b[i][c]) for i in range(20)) % q for c in range(32)]
    assert got.tolist() == want
    assert W.dot_mod64_terms(q) == max(1, min(16, (1 << 61) // q))


def test_modular_add_sub_neg_and_helpers():
    q = Q61
    a, b = t_of(edge_values(q)), t_of(edge_values(q)[::-1])
    assert W.add_mod64(a, b, q).tolist() == [(x + y) % q for x, y in zip(a.tolist(), b.tolist())]
    assert W.sub_mod64(a, b, q).tolist() == [(x - y) % q for x, y in zip(a.tolist(), b.tolist())]
    assert W.neg_mod64(a, q).tolist() == [(-x) % q for x in a.tolist()]
    inv2 = pow(2, -1, q)
    assert W.div2_mod64(a, q).tolist() == [x * inv2 % q for x in a.tolist()]
    assert W.cond_sub64(a + q, q).tolist() == a.tolist()
    s, c = W.add64c(a + (1 << 61), b + (1 << 61))
    assert [(int(ci) << 62) + int(si) for si, ci in zip(s, c)] == \
        [x + y + (1 << 62) for x, y in zip(a.tolist(), b.tolist())]
    assert W.add64(a, b).tolist() == (a + b).tolist() and W.sub64(a, b).tolist() == (a - b).tolist()
    assert W.geq64(a, b).tolist() == (a >= b).tolist()
    h, l = W.add128(W.mul64_wide(a, b), W.mul64_wide(b, a))
    assert [(int(x) << 62) + int(y) for x, y in zip(h, l)] == \
        [2 * x * y for x, y in zip(a.tolist(), b.tolist())]
    # the host helpers are the JAX package's
    for v in (q, P61, 12345):
        assert W.words(v, 4) == JW.words(v, 4)
        assert W.barrett_ratio_u128(v) == JW.barrett_ratio_u128(v)
        assert W.shoup_word64(v - 1, v) == JW.shoup_word64(v - 1, v)
    arr = np.array(edge_values(q, 16), dtype=np.uint64)
    hi, lo = W.pack64(arr)
    jhi, jlo = JW.pack64(arr)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(W.unpack64(hi, lo), JW.unpack64(jhi, jlo))


@pytest.mark.parametrize("log_n", [5, 6])
def test_ntt64_against_jax_and_schoolbook(log_n):
    from troy_tpu.core.coeff_modulus import CoeffModulus as JCoeff

    n = 1 << log_n
    primes = [m.value for m in JCoeff.create(n, [60, 40, 40, 60])]
    t = N64.NTT64Tables(log_n, primes, "cpu")
    jt = JN64.NTT64Tables(log_n, primes).pack()
    x = np.stack([RNG.integers(0, q, (3, n), dtype=np.uint64) for q in primes], axis=-2)
    y = np.stack([RNG.integers(0, q, n, dtype=np.uint64) for q in primes])
    xt, yt = torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64))
    fx = R.ntt_forward(xt, t)
    same_w(jnp.stack(JN64.ntt_forward64(*jpair(x), jt), axis=-3), fx)
    back = R.ntt_inverse(fx, t)
    same_w(jnp.stack(JN64.ntt_inverse64(*jpair(np.asarray(fx)), jt), axis=-3), back)
    np.testing.assert_array_equal(back.numpy(), xt.numpy())
    prod = R.ntt_inverse(R.dyadic_product(fx, R.ntt_forward(yt, t)[None], t), t)
    for i, q in enumerate(primes):
        a, b = [int(v) for v in x[0, i]], [int(v) for v in y[i]]
        ref = [0] * n
        for u in range(n):
            for v in range(n):
                if u + v < n:
                    ref[u + v] += a[u] * b[v]
                else:
                    ref[u + v - n] -= a[u] * b[v]
        assert prod[0, i].tolist() == [r % q for r in ref]
    # lazy input in [0, 2q) for the forward transform, as digits arrive
    lazy = xt + t.q.view(-1, 1) * torch.from_numpy(RNG.integers(0, 2, xt.shape))
    np.testing.assert_array_equal(R.ntt_forward(lazy, t).numpy(), fx.numpy())
    assert R.words(t) == 2 and R.poly_axis(t) == -3
    sub = R.slice_tables(t, 1, 3)
    np.testing.assert_array_equal(R.ntt_forward(xt[..., 1:3, :], sub).numpy(), fx[..., 1:3, :].numpy())


def test_rp_width_dispatch():
    """rp sends products and transforms to the wide core by the tables'
    width, and every elementwise op agrees with Python ints."""
    primes = [Q61, P61 - 30]
    n = 16
    from troy_tpu_torch.ops.ntt64 import wide_scalar_pack

    t = wide_scalar_pack(primes)
    x = t_of(sum([edge_values(q, n) for q in primes], [])).view(2, n)
    y = t_of(sum([edge_values(q, n)[::-1] for q in primes], [])).view(2, n)
    xi, yi = x.tolist(), y.tolist()

    def ref(f):
        return [[f(a, b) % q for a, b in zip(xr, yr)] for xr, yr, q in zip(xi, yi, primes)]
    assert R.dyadic_product(x, y, t).tolist() == ref(lambda a, b: a * b)
    assert R.mul_mod(x, y, t).tolist() == ref(lambda a, b: a * b)
    assert R.add(x, y, t).tolist() == ref(lambda a, b: a + b)
    assert R.sub(x, y, t).tolist() == ref(lambda a, b: a - b)
    assert R.negate(x, t).tolist() == ref(lambda a, b: -a)
    assert R.multiply_scalar(x, 12345, t).tolist() == ref(lambda a, b: a * 12345)
    w = t_of([q - 3 for q in primes])
    ws = t_of([W.shoup62(q - 3, q) for q in primes])
    assert R.multiply_operand(x, w, ws, t).tolist() == \
        [[a * (q - 3) % q for a in xr] for xr, q in zip(xi, primes)]
    assert R.modulo(x + t.q.view(-1, 1), t).tolist() == x.tolist()
    conv = R.dyadic_convolute(torch.stack([x, y]), torch.stack([y, x]), t)
    assert conv[1].tolist() == ref(lambda a, b: a * a + b * b)
    sq = R.dyadic_square(torch.stack([x, y]), t)
    assert sq[1].tolist() == ref(lambda a, b: 2 * a * b)
    h, l = R.hi_lo(x)
    assert R.pair(h, l).tolist() == xi


def make_base(bits, log_n):
    primes = []
    for b in bits:
        p = numth.get_primes(2 * (1 << log_n), b, len(bits) + 4)
        primes.append(next(q for q in p if q not in primes))
    return primes


class Tools:
    """RNSTool64 of each package on one base, t a 20-bit prime."""

    def __init__(self, bits, log_n, with_t=True):
        self.n = 1 << log_n
        self.primes = make_base(bits, log_n)
        self.t = numth.get_prime(2 * self.n, 20) if with_t else None
        self.base = RNSBase([Modulus(p) for p in self.primes], "cpu")
        self.jbase = JRNSBase([JModulus(p) for p in self.primes])
        self.tool = RNSTool64(log_n, self.base, Modulus(self.t) if with_t else None)
        self.jtool = JTool64(log_n, self.jbase, JModulus(self.t) if with_t else None)
        self.Q = self.base.prod

    def residues(self, values):
        """Python ints -> (port tensor, JAX (2, L, n) pair array)."""
        arr = np.stack([[v % q for v in values] for q in self.primes]).astype(np.uint64)
        return torch.from_numpy(arr.astype(np.int64)), jnp.stack(jpair(arr))

    def boundary_values(self):
        """Random values and values next to +-Q/2 (no closer than the
        fixed-point alpha resolves, as tests/rns/test_rns_wide.py), 0 and
        Q - 1."""
        Q, L = self.Q, len(self.primes)
        min_delta = (L * Q >> 66) + 1
        xs = []
        for delta in (min_delta, 2 * min_delta, Q >> 24):
            xs += [Q // 2 - delta, Q // 2 + delta, Q // 2 + 1 + delta]
        xs += [0, 1, Q - 1]
        xs += [int.from_bytes(RNG.bytes(32), "little") % Q for _ in range(self.n)]
        return xs[:self.n] if len(xs) >= self.n else (xs * self.n)[:self.n]


@pytest.fixture(scope="module", params=[([60, 40, 50], 4), ([60, 40, 40], 5)])
def T(request):
    return Tools(*request.param)


def test_base_converter64(T):
    conv = BaseConverter64(T.base, T.tool.base_Bsk)
    jconv = JConv64(T.jbase, T.jtool.base_Bsk)
    x, jx = T.residues(T.boundary_values())
    same_w(jconv.convert(jx), conv.convert(x))
    assert T.tool.base_Bsk.values == T.jtool.base_Bsk.values
    assert T.tool.gamma == T.jtool.gamma


def test_lifts_hps_and_behz(T):
    """Both lifts against the JAX tool; the HPS lift's float32 alpha sums
    the limbs in the JAX package's order, so it is bit-exact on phases next
    to +-Q/2 too.  The BEHZ lift represents x, x - Q or x + Q."""
    vals = T.boundary_values()
    x, jx = T.residues(vals)
    same_w(T.jtool.fast_b_conv_hps(jx), T.tool.fast_b_conv_hps(x))
    y = T.tool.fast_b_conv_m_tilde_sm_mrq(x)
    same_w(T.jtool.fast_b_conv_m_tilde_sm_mrq(jx), y)
    bsk = T.tool.base_Bsk
    for c, v in enumerate(bsk.compose_array_host(y.numpy())):
        Y = v - bsk.prod if v > bsk.prod // 2 else v
        assert Y in (vals[c], vals[c] - T.Q, vals[c] + T.Q)


def test_fast_floor_and_sk(T):
    """floor(t d / Q) through the folded floor and Shenoy-Kumaresan, on
    d = c1 c2 in both bases (the tensor product of two lifted values)."""
    d = [int.from_bytes(RNG.bytes(64), "little") % (T.Q * T.Q // 4) for _ in range(T.n)]
    d_q, jd_q = T.residues(d)
    bsk = T.tool.base_Bsk.values
    arr = np.stack([[v % b for v in d] for b in bsk]).astype(np.uint64)
    d_b, jd_b = torch.from_numpy(arr.astype(np.int64)), jnp.stack(jpair(arr))
    got = T.tool.fast_floor_scale_fast_b_conv_sk(d_q, d_b)
    same_w(T.jtool.fast_floor_scale_fast_b_conv_sk(jd_q, jd_b), got)
    L = len(T.primes)
    for c, v in enumerate(T.base.compose_array_host(got.numpy())):
        err = (v - T.t * d[c] // T.Q) % T.Q
        assert min(err, T.Q - err) <= L   # the fast conversion's overflow, at most L


def test_last_prime_divisions(T):
    x, jx = T.residues(T.boundary_values())
    same_w(T.jtool.divide_and_round_q_last(jx), T.tool.divide_and_round_q_last(x))
    qtab = N64.NTT64Tables(T.tool.log_n, T.primes, "cpu")
    jq = JN64.NTT64Tables(T.tool.log_n, T.primes).pack()
    same_w(T.jtool.divide_and_round_q_last_ntt(jx, jq),
           T.tool.divide_and_round_q_last_ntt(x, qtab))
    same_w(T.jtool.mod_t_and_divide_q_last_ntt(jx, jq),
           T.tool.mod_t_and_divide_q_last_ntt(x, qtab))
    q_last = T.primes[-1]
    vals = T.boundary_values()
    x, _ = T.residues(vals)
    down = RNSBase([Modulus(p) for p in T.primes[:-1]], "cpu")
    for c, v in enumerate(down.compose_array_host(T.tool.divide_and_round_q_last(x).numpy())):
        assert v == (vals[c] + q_last // 2) // q_last % down.prod


def test_decrypts(T):
    """decrypt_scale_and_round (BFV) on Delta m + e, decrypt_mod_t and
    _exact_alpha (BGV) on m + t e and on phases next to +-Q/2."""
    t, Q = T.t, T.Q
    m = RNG.integers(0, t, T.n)
    e = RNG.integers(-(1 << 30), 1 << 30, T.n)
    bfv = [(int(m[i]) * (Q // t) + int(e[i])) % Q for i in range(T.n)]
    x, jx = T.residues(bfv)
    got = T.tool.decrypt_scale_and_round(x)
    np.testing.assert_array_equal(np.asarray(T.jtool.decrypt_scale_and_round(jx)).astype(np.int64),
                                  got.numpy())
    np.testing.assert_array_equal(got.numpy(), m)
    bgv = [(int(m[i]) + t * int(e[i])) % Q for i in range(T.n)]
    for vals in (bgv, T.boundary_values()):
        x, jx = T.residues(vals)
        got = T.tool.decrypt_mod_t(x)
        np.testing.assert_array_equal(np.asarray(T.jtool.decrypt_mod_t(jx)).astype(np.int64),
                                      got.numpy())
        assert got.tolist() == [(v - Q if v > Q // 2 else v) % t for v in vals]
    v = W.shoup_mul64(x, *T.tool.inv_punctured, T.tool.q_col)
    jv = JW.shoup_mul64(jx[0], jx[1], T.jtool.inv_punctured[0], T.jtool.inv_punctured[1],
                        T.jtool.inv_punctured_shoup[0], T.jtool.inv_punctured_shoup[1],
                        *T.jtool.q_cols)
    same_w(jnp.stack(jv), v)
    np.testing.assert_array_equal(np.asarray(T.jtool._exact_alpha(*jv)).astype(np.int64),
                                  T.tool._exact_alpha(v).numpy())


def test_ckks_tool_without_t():
    """The CKKS level's tool: the divisions only."""
    T = Tools([60, 40, 40], 5, with_t=False)
    x, jx = T.residues(T.boundary_values())
    same_w(T.jtool.divide_and_round_q_last(jx), T.tool.divide_and_round_q_last(x))
    assert not hasattr(T.tool, "gamma")


def test_bfv_scaler64(T):
    scaler = BFVScaler64(T.base, Modulus(T.t))
    jscaler = JScaler64(T.jbase, JModulus(T.t))
    m = RNG.integers(0, T.t, T.n)
    m[:3] = [0, T.t - 1, (T.t + 1) // 2]
    mt, jm = torch.from_numpy(m.astype(np.int64)), jnp.asarray(m.astype(np.uint32))
    up = scaler.scale_up(mt)
    same_w(jscaler.scale_up(jm), up)
    for i, q in enumerate(T.primes):
        assert up[i].tolist() == [(int(v) * T.Q + T.t // 2) // T.t % q for v in m]
    cent = scaler.centralize(mt)
    same_w(jscaler.centralize(jm), cent)
    np.testing.assert_array_equal(np.asarray(jscaler.decentralize(jscaler.centralize(jm))),
                                  scaler.decentralize(cent).numpy())
    np.testing.assert_array_equal(scaler.decentralize(cent).numpy(), m)
    with pytest.raises(ValueError, match="odd"):
        BFVScaler64(T.base, Modulus(1 << 20))

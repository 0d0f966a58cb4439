"""The redesigned Hopper base-conversion kernel K3 (csrc/bconv.cu) on the
CPU: its integer schedule (replay below: the Shoup step, each output's
reduction cadence and Barrett constant from BConvTables) against the plain
version at every table of the paths, on worst-case and
seeded inputs, at L_in 1 to 17 (17: the shared-memory form); the tables'
overflow checks; the Shenoy-Kumaresan pair as one joined conversion of a
strided input, against the JAX package's RNSTool._b_conv_sk; and the
wrapper's stride rule (bconv_cuda.row_stride, addressable)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.rns.rns_base import RNSBase as JBase
from troy_tpu.rns.rns_tool import RNSTool as JTool
from troy_tpu.utils import numth
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import bconv as BC, bconv_cuda
from troy_tpu_torch.rns.rns_base import RNSBase, BaseConverter
from troy_tpu_torch.rns.rns_tool import RNSTool, _aux_primes
from troy_tpu_torch.utils.timer import reset_launch_counts

RNG = np.random.default_rng(1717)
LOG_N, L = 6, 6                       # the flagship's base q at a small degree
N = 1 << LOG_N


W64 = 1 << 64


def replay(x: torch.Tensor, tabs: BC.BConvTables) -> torch.Tensor:
    """The kernel's integer schedule (csrc/bconv.cu), exactly, in Python
    integers: the low 32 bits of each input through the u32 Shoup product
    and its conditional subtract, each output's u64 sum reduced after every
    tabs.cadence[o] products when that is fewer than L_in and once at the
    end, by Barrett with tabs.ratio[o] and its one correction.  Raises
    AssertionError where a value leaves the bound the kernel relies on (a
    lazy product of 2q or more, a sum of 2^64 or more, a Barrett remainder
    of 2p or more)."""
    m32 = (1 << 32) - 1
    xs = x.detach().cpu().numpy().astype(object)
    q_in, ip, mat = tabs.q_in.tolist(), tabs.ip.tolist(), tabs.mat.tolist()
    t = []
    for i, (q, w) in enumerate(zip(q_in, ip)):
        xi = xs[..., i, :] & m32
        v = (xi * w - ((xi * ((w << 32) // q)) >> 32) * q) & m32
        assert (v < 2 * q).all(), "lazy Shoup product of 2q or more"
        t.append(np.where(v >= q, v - q, v))

    def barrett(acc, p, ratio):
        assert (acc < W64).all(), "sum of 2^64 or more"
        r = acc - ((acc * ratio) >> 64) * p
        assert (r < 2 * p).all(), "Barrett needs more than one correction"
        return np.where(r >= p, r - p, r)

    out = []
    for o, (p, ratio, every) in enumerate(zip(tabs.p_out.tolist(), tabs.ratio, tabs.cadence)):
        acc, left = np.zeros_like(t[0]), every
        for i in range(tabs.L_in):
            acc = acc + t[i] * mat[o][i]
            left -= 1
            if every < tabs.L_in and left == 0:
                acc, left = barrett(acc, p, ratio), every
        out.append(barrett(acc, p, ratio))
    return torch.from_numpy(np.stack(out, axis=-2).astype(np.int64))


@pytest.fixture(scope="module")
def pair():
    primes = numth.get_primes(2 * N, 30, L)
    t = numth.get_prime(2 * N, 20)
    jt = JTool(LOG_N, JBase([JModulus(p) for p in primes]), JModulus(t))
    tt = RNSTool(LOG_N, RNSBase([Modulus(p) for p in primes], "cpu"), Modulus(t))
    return jt, tt


def t_gamma(tt, k):
    """ring2k's {2^k, gamma} conversion from base q (app/ring2k.py)."""
    gamma = _aux_primes(N, set(tt.base_q.values), 1, need_ntt=False)[0]
    return BaseConverter(tt.base_q, RNSBase([Modulus(1 << k), Modulus(gamma)], "cpu")).tables


def path_tables(tt) -> dict:
    return {"floor": tt.ff_tables, "joined SK": tt._rows("q", None)["sk"],
            "BEHZ Bsk u {m~}": tt.conv_q_to_Bsk_m_tilde.tables,
            "decrypt {t, gamma}": tt.conv_q_to_t_gamma.tables,
            "ring2k {2^30, gamma}": t_gamma(tt, 30), "ring2k {2^31, gamma}": t_gamma(tt, 31)}


def random_input(tabs, lead=(2, 3), n=N):
    q = np.array(tabs.q_in.tolist(), dtype=np.uint64)[:, None]
    x = RNG.integers(0, 1 << 62, size=(*lead, tabs.L_in, n), dtype=np.uint64) % q
    return torch.from_numpy(x.astype(np.int64))


def worst_input(tabs, lead=(2,), n=N):
    """Every x_i = q_i - 1."""
    return (tabs.q_in.view(-1, 1) - 1).expand(*lead, tabs.L_in, n).contiguous()


@pytest.mark.parametrize("which", ["floor", "joined SK", "BEHZ Bsk u {m~}", "decrypt {t, gamma}",
                                   "ring2k {2^30, gamma}", "ring2k {2^31, gamma}"])
def test_replay_equals_plain_at_the_path_tables(pair, which):
    _, tt = pair
    tabs = path_tables(tt)[which]
    for x in (worst_input(tabs), random_input(tabs)):
        want = BC.base_convert_plain(x, tabs)
        assert torch.equal(replay(x, tabs), want)
        assert torch.equal(BC.base_convert(x, tabs), want)


def worst_tables(l_in: int, out_bits: int) -> BC.BConvTables:
    """The largest 30-bit input primes with ip = 1 (so [x ip]_q = q - 1 at
    x = q - 1), the largest output moduli below 2^out_bits, every entry of M
    at p_o - 1."""
    q = numth.get_primes(2 * N, 30, l_in)
    p = [(1 << out_bits) - 1 - 2 * j for j in range(5)]
    return BC.BConvTables(q, [1] * l_in, p, [[v - 1] * l_in for v in p], "cpu")


@pytest.mark.parametrize("l_in", [1, 6, 8, 16, 17])
@pytest.mark.parametrize("out_bits", [30, 31, 32])
def test_replay_equals_plain_at_the_worst_case(l_in, out_bits):
    """Every x = q_i - 1, every M entry and output modulus at its largest:
    the sums reach the cadence's bound (a reduction every 4 products below
    2^32, 8 below 2^31, 16 below 2^30), and seeded random inputs on the
    same tables."""
    tabs = worst_tables(l_in, out_bits)
    assert tabs.cadence == [min(l_in, {30: 16, 31: 8, 32: 4}[out_bits])] * tabs.L_out
    for x in (worst_input(tabs, (3,)), random_input(tabs, (3,))):
        assert torch.equal(replay(x, tabs), BC.base_convert_plain(x, tabs))


@pytest.mark.parametrize("l_in", [1, 6, 8, 16, 17])
def test_replay_equals_plain_at_generic_tables(l_in):
    """BaseConverter tables between 30-bit and 29-bit primes (as
    chip_smoke.py's generic cases), on odd n."""
    iv = numth.get_primes(2 * N, 30, l_in)
    ov = numth.get_primes(2 * N, 29, 9)
    tabs = BaseConverter(RNSBase([Modulus(p) for p in iv], "cpu"),
                         RNSBase([Modulus(p) for p in ov], "cpu")).tables
    x = random_input(tabs, (2,), 33)
    assert torch.equal(replay(x, tabs), BC.base_convert_plain(x, tabs))


def test_replay_raises_where_the_schedule_would_overflow():
    """A cadence beyond the bound would wrap the u64 sum: the replay's own
    checks catch it (tables forced past the check to show it)."""
    tabs = worst_tables(8, 32)
    tabs.cadence = [8] * tabs.L_out
    with pytest.raises(AssertionError):
        replay(worst_input(tabs), tabs)


def test_tables_refuse_an_overflowing_cadence_or_modulus():
    """check_cadence, the bound every derived cadence is held to, refuses
    a forced count that would wrap the sum; the tables refuse a word above
    32 bits and an output modulus below 2."""
    p = (1 << 32) - 5
    term = ((1 << 30) - 1) * (p - 1)   # the largest product below 2^30 x p
    assert BC.check_cadence(4, term, p) == 4
    for every in (5, 8, 0):
        with pytest.raises(ValueError):
            BC.check_cadence(every, term, p)
    q = numth.get_primes(2 * N, 30, 8)
    assert BC.BConvTables(q, [1] * 8, [p], [[p - 1] * 8], "cpu").cadence == [4]
    with pytest.raises(ValueError):   # a table word above 32 bits
        BC.BConvTables(q, [1] * 8, [(1 << 32) + 15], [[1] * 8], "cpu")
    with pytest.raises(ValueError):
        BC.BConvTables(q, [1] * 8, [1], [[0] * 8], "cpu")
    # below 2^30 no reduction inside the sum
    small = BC.BConvTables(q, [1] * 8, [(1 << 30) - 35], [[5] * 8], "cpu")
    assert small.cadence == [8]


@pytest.mark.parametrize("rows", [None, (1, 4), (5,)])
def test_joined_sk_tables(pair, rows):
    """The joined SK tables: take_outputs of conv_B_to_q's rows (all when
    None), then conv_B_to_m_sk's one row."""
    _, tt = pair
    joined = tt._rows("q", rows)["sk"]
    conv = tt.conv_B_to_q.tables
    q_rows = BC.take_outputs(conv, rows) if rows is not None else conv
    msk = tt.conv_B_to_m_sk.tables
    assert torch.equal(joined.q_in, conv.q_in) and torch.equal(joined.ip, conv.ip)
    assert joined.p_out.tolist() == q_rows.p_out.tolist() + [tt.m_sk.value]
    assert torch.equal(joined.mat, torch.cat([q_rows.mat, msk.mat]))
    assert joined.cadence == q_rows.cadence + msk.cadence
    assert joined is tt._rows("q", rows)["sk"]   # cached
    with pytest.raises(ValueError):
        BC.join_outputs(conv, tt.conv_q_to_Bsk.tables)


@pytest.mark.parametrize("rows", [None, (0, 2, 3), (5,)])
def test_b_conv_sk_equals_jax(pair, rows):
    """One joined conversion of y[..., :-1, :] (a strided view), split into
    u and the m_sk residue: the JAX package's _b_conv_sk bit for bit, on
    all of q or on a limb shard's rows."""
    jt, tt = pair
    y = random_input(tt._rows("q", None)["sk"], (2, 3))   # B residues
    y_msk = torch.from_numpy(RNG.integers(0, tt.m_sk.value, size=(2, 3, 1, N)))
    y = torch.cat([y, y_msk], dim=-2)
    want = np.asarray(jt._b_conv_sk(jnp.asarray(y.numpy().astype(np.uint32)))).astype(np.int64)
    got = tt._b_conv_sk(y, rows)
    np.testing.assert_array_equal(got.numpy(), want if rows is None else want[..., rows, :])


def test_strided_input_is_read_where_it_lies(pair):
    """The wrapper's stride rule: the SK slice and a batch slice are
    addressed as they lie; a transposed, broadcast or limb-sliced view is
    copied, and each copy counted."""
    _, tt = pair
    tabs = tt._rows("q", None)["sk"]
    lb = tabs.L_in
    y = random_input(BC.BConvTables(tabs.q_in.tolist() + [3], tabs.ip.tolist() + [1],
                                    [5], [[1] * (lb + 1)], "cpu"), (2, 3))
    view = y[..., :-1, :]
    assert bconv_cuda.row_stride(view, lb) == (lb + 1) * N
    assert bconv_cuda.row_stride(view[1:], lb) == (lb + 1) * N
    assert bconv_cuda.row_stride(view[:, 1], lb) == 3 * (lb + 1) * N
    assert bconv_cuda.row_stride(view[:, :1], lb) == 3 * (lb + 1) * N
    assert bconv_cuda.row_stride(view.contiguous()[0, 0], lb) == lb * N
    bad = {"a transposed batch": view.transpose(0, 1),
           "coefficients not contiguous": view[..., ::2],
           "a broadcast row": view[:1, :1].expand(2, 3, lb, N),
           "limbs not at stride n": view.transpose(-1, -2).contiguous().transpose(-1, -2)}
    reset_launch_counts()
    for what, v in bad.items():
        assert bconv_cuda.row_stride(v, v.shape[-2]) is None, what
        assert bconv_cuda.addressable(v, v.shape[-2]).is_contiguous(), what
    assert bconv_cuda.addressable(view, lb) is view
    assert bconv_cuda.LAUNCHES == {"base_convert": 0, "base_convert_first": 0,
                                   "base_convert_copy": len(bad)}
    reset_launch_counts()
    assert torch.equal(BC.base_convert(view, tabs), BC.base_convert_plain(view.contiguous(), tabs))

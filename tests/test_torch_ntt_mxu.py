"""The port's matrix-product NTT (troy_tpu_torch/ops/ntt_mxu.py, K2's form)
against the JAX package's troy_tpu/ops/ntt_mxu.py and its Pallas kernel K2
(ntt_forward_pallas_mxu, in interpret mode), bit for bit:

* MxuNTTTables' every table (plain_tables, and the kernel's layout) against
  the JAX tables at log_n 8-14, on the flagship chain's 7 x 30-bit primes
  and on 2 primes;
* split_balanced and recombine_planes at the edges;
* the plain ntt_forward_mxu / ntt_inverse_mxu against JAX's XLA form
  (jitted), its interpret-mode kernel and the port's butterfly plain
  version at log_n 8-15, lead shapes (), (2,), (2, 3), lazy input; the
  references are computed once a degree on the (2, 3) batch (reference),
  and the () and (2,) cases take their rows of it;
* emulate_mxu, the first form of the CUDA kernel (csrc/ntt_mxu.cu, now
  the yardstick and the route above 16384) replayed in PyTorch from its
  own tables: kernel_plan's launches, blocks and K chunks, the
  shared-memory operand layouts with their zero padding, the 16 x 16
  tiles (computed together: they are independent), 7 diagonal accumulators
  asserted inside int32 after every 32-deep K step, the recombination, the
  twiddle Shoup pass and the second stage read back from the output row (or
  a scratch tensor, two launches), at every degree 256-131072;
* emulate_wg (test_torch_ntt_mxu_wg.py), the redesigned kernel
  (csrc/ntt_mxu_wg.cu) replayed from its own tables, at every degree
  256-131072: equal to the plain version and K1's, and at 256-32768 to the
  JAX kernel in interpret mode on the same rows;
* set_ntt_backend / get_ntt_backend against the JAX module's, and the
  BFV HPS multiply + relinearize, a rotation and a limb-sharded step on the
  CPU mesh under "pallas_mxu", against the JAX package's jitted steps;
* the wrapper's refusals that need no card.
The kernel itself runs only on the card (chip_smoke.py [mxu])."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import troy_tpu.ops.ntt as JNTT
import troy_tpu.ops.ntt_mxu as JMX
from troy_tpu.ops.ntt_pallas import ntt_forward_pallas_mxu, ntt_inverse_pallas_mxu
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.parallel.batched import BatchedEvaluator as JBatched
from tests.core.fixtures import GeneralHeContext
from troy_tpu_torch import interop
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.ops import ntt as TNTT, ntt_mxu as MX, ntt_mxu_cuda
from troy_tpu_torch.parallel import mesh as M
from troy_tpu_torch.parallel.batched import BatchedEvaluator
from troy_tpu_torch.utils import numth
from tests.test_torch_ntt_mxu_wg import emulate_wg

RNG = np.random.default_rng(2626)
FLAGSHIP = 7  # bench.py's 7 x 30-bit chain


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: the suite runs a worker a core or so,
    and the replays' many small float64 products thrash when every
    worker's torch takes every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def primes_for(log_n: int, count: int) -> list[int]:
    return numth.get_primes(2 << log_n, 30, count)


def residues(shape, primes, factor=1) -> np.ndarray:
    q = np.array(primes, dtype=np.uint64)[:, None]
    return (RNG.integers(0, 1 << 62, size=shape, dtype=np.uint64) % (factor * q)
            ).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def jax_tables(log_n: int, primes: tuple) -> JMX.MxuNTTTables:
    """The JAX package's tables, built once for the file."""
    return JMX.MxuNTTTables(log_n, [JModulus(p) for p in primes])


def tables(log_n: int, primes: list[int]) -> MX.MxuNTTTables:
    return MX.MxuNTTTables(log_n, [Modulus(p) for p in primes], "cpu")


# The JAX tables the port keeps none of: its Pallas kernel's twiddle-folded
# weights (the port's kernel applies the twiddle by one Shoup product).
JAX_ONLY = {"T16", "T16_shoup", "Tcorr", "Ti16", "Ti16_shoup", "Ticorr"}


@pytest.mark.parametrize("count", [FLAGSHIP, 2])
@pytest.mark.parametrize("log_n", range(8, 15))
def test_tables_match_jax(log_n, count):
    primes = primes_for(log_n, count)
    jt = jax_tables(log_n, tuple(primes))
    tt = tables(log_n, primes)
    plain = MX.plain_tables(tt)
    assert set(plain) | JAX_ONLY == set(jt._host)
    for k, v in plain.items():
        if k.startswith("W"):
            assert v.dtype == torch.int8, k
        np.testing.assert_array_equal(v.numpy(), jt._host[k].astype(np.int64), err_msg=k)
    assert (tt.n1, tt.n2) == (1 << jt.a, 1 << jt.b)
    # the kernel's layout: W2 stored transposed, the contraction zero-padded
    for i, (name, k) in enumerate((("W1", tt.n1), ("W2", tt.n2), ("W1i", tt.n1),
                                   ("W2i", tt.n2))):
        w = tt.kernel_w[i].numpy()
        assert w.shape[-1] == max(32, k) and not w[..., k:].any(), name
        want = jt._host[name] if i % 2 == 0 else jt._host[name].swapaxes(-1, -2)
        np.testing.assert_array_equal(w[..., :k], want, err_msg=name)
    tw = tt.kernel_twiddle.numpy().view(np.uint32)
    np.testing.assert_array_equal(tw[1, ..., 0], jt._host["Ti"])
    np.testing.assert_array_equal(tw[1, ..., 1], jt._host["Ti_shoup"])
    sc = tt.kernel_scalars.numpy().view(np.uint32)
    np.testing.assert_array_equal(sc[:, 10:17], jt._host["pow8"])
    np.testing.assert_array_equal(sc[:, 24], jt._host["corr8"])
    assert not sc[:, 25:].any()


def test_take_matches_mxu_limb_axes():
    primes = primes_for(10, 4)
    tt = tables(10, primes)
    jpack = JMX.MxuNTTTables(10, [JModulus(p) for p in primes]).pack_prefixed()
    idx = [3, 0, 2]
    sub = tt.take(idx)
    jsub = JNTT.take_tables(jpack, idx)
    plain = MX.plain_tables(sub)
    assert {"mxu_" + k for k in plain} | {"mxu_" + k for k in JAX_ONLY} == set(jsub) | {"mxu_q"}
    for k, v in plain.items():
        if k != "q":
            np.testing.assert_array_equal(v.numpy(), np.asarray(jsub["mxu_" + k]), err_msg=k)
    assert plain["q"].tolist() == [primes[i] for i in idx]
    assert sub.size == 3 and sub.moduli == [tt.moduli[i] for i in idx]
    assert torch.equal(sub.kernel_w[3], tt.kernel_w[3][:, idx])
    assert torch.equal(sub.kernel_scalars, tt.kernel_scalars[idx])
    x = torch.from_numpy(residues((2, 4, 1024), primes, 2).astype(np.int64))
    assert torch.equal(MX.ntt_forward_mxu(x[:, idx], sub), MX.ntt_forward_mxu(x, tt)[:, idx])


def test_split_balanced_edges():
    q = primes_for(13, 3)
    edge = []
    for qi in q:
        vals = [0, 1, 127, 128, 255, 256, 0x7F7F7F, 0x808080, 0x80808080 % qi, qi - 1, qi,
                qi + 1, 2 * qi - 1, qi + 128, qi + 0x8080]
        edge.append(vals + [int(v) for v in RNG.integers(0, 2 * qi, 64 - len(vals))])
    x = np.array(edge, dtype=np.uint32)
    qcol = np.array(q, dtype=np.uint32)[:, None]
    got = MX.split_balanced(torch.from_numpy(x.astype(np.int64)), torch.tensor(q).view(-1, 1))
    want = np.asarray(JMX.split_balanced(jnp.asarray(x), jnp.asarray(qcol)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8
    assert int(got[:3].min()) == -128 and int(got[:3].max()) == 127
    assert 0 <= int(got[3].min()) and int(got[3].max()) <= 64
    w = (got.to(torch.int64) * torch.tensor([1, 256, 1 << 16, 1 << 24]).view(4, 1, 1)).sum(0)
    assert torch.equal(w, torch.from_numpy((x % qcol).astype(np.int64)))


@pytest.mark.parametrize("contraction", [128, 256])
def test_recombine_planes_edges(contraction):
    """Random plane partials and the extremes of each plane product over
    the contraction (every digit at its bound), against the JAX function."""
    q = primes_for(13, 2)
    bound = 128 * 128 * contraction
    P = RNG.integers(-bound, bound + 1, size=(4, 4, 2, 64), dtype=np.int64)
    for i in range(4):
        for j in range(4):
            b = MX.DIGIT_BOUND[i] * MX.DIGIT_BOUND[j] * contraction
            P[i, j, :, 0], P[i, j, :, 1], P[i, j, :, 2] = b, -b, 0
    P = P.astype(np.int32)
    jt = JMX.MxuNTTTables(13, [JModulus(p) for p in q])._host
    sh = (-1, 1)

    def jcol(k, i=None):
        v = jt[k] if i is None else jt[k][:, i]
        return jnp.asarray(v.reshape(sh))

    def tcol(k, i=None):
        v = jt[k] if i is None else jt[k][:, i]
        return torch.from_numpy(v.astype(np.int64).reshape(sh))

    args = lambda col: ([col("pow16", k) for k in range(4)], [col("pow16_shoup", k) for k in range(4)],
                        [col("pow8", k) for k in range(7)], [col("pow8_shoup", k) for k in range(7)],
                        col("corr16"), col("corr8"), col("q"))
    want = np.asarray(JMX.recombine_planes(jnp.asarray(P), *args(jcol), contraction))
    got = MX.recombine_planes(torch.from_numpy(P), *args(tcol), contraction)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    exact = sum(P[i, j].astype(object) * (1 << (8 * (i + j))) for i in range(4) for j in range(4))
    np.testing.assert_array_equal(got.numpy(), (exact % np.array(q, dtype=object)[:, None])
                                  .astype(np.int64))


def test_int32_bounds():
    """The pair fold stays inside int32 up to a contraction of 128 and not
    at 256; the single diagonals up to 512 (n = 131072's n2)."""
    for k in (16, 32, 64, 128, 256, 512):
        MX.check_int32(k)
    d = MX.diagonal_bounds(256)
    assert d[2] + 256 * d[3] >= 1 << 31


def jax_pack(log_n: int, primes: list[int]) -> dict:
    """The JAX tables its matrix-product transforms read: q and mxu_*."""
    jt = jax_tables(log_n, tuple(primes))
    return {"q": jnp.asarray(np.array(primes, np.uint32)),
            **{k: jnp.asarray(v) for k, v in jt.pack_prefixed().items()}}


@functools.lru_cache(maxsize=None)
def reference(log_n: int) -> dict:
    """One input batch a degree, lead (2, 3) on L = 2 limbs, lazy [0, 2q) and
    canonical, and every reference the file holds the port's transforms
    to, each computed once: the port's plain forward (lazy) and inverse
    (canonical), K1's plain version (and its inverse of the lazy input
    reduced), the JAX package's XLA form (jitted) on the batch, and
    its Pallas kernel in interpret mode on rows [:, 0] (the lead (2,)
    case).  A case of lead () or (2,) takes its rows of each."""
    n, L = 1 << log_n, 2
    primes = primes_for(log_n, L)
    tt = tables(log_n, primes)
    kt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    pack = jax_pack(log_n, primes)
    lazy = residues((2, 3, L, n), primes, factor=2)
    canon = residues((2, 3, L, n), primes)
    reduced = lazy % np.array(primes, np.uint32)[:, None]
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    jfwd = jax.jit(JMX.ntt_forward_mxu, static_argnames=("prefix",))
    jinv = jax.jit(JMX.ntt_inverse_mxu, static_argnames=("prefix",))
    return dict(
        primes=primes, tt=tt, lazy=lazy, canon=canon,
        fwd=MX.ntt_forward_mxu(t(lazy), tt), inv=MX.ntt_inverse_mxu(t(canon), tt),
        k1_fwd=TNTT.ntt_forward_plain(t(lazy), kt), k1_inv=TNTT.ntt_inverse_plain(t(canon), kt),
        k1_inv_lazy=TNTT.ntt_inverse_plain(t(reduced), kt),
        jax_fwd=np.asarray(jfwd(jnp.asarray(lazy), pack, prefix="mxu_")),
        jax_inv=np.asarray(jinv(jnp.asarray(canon), pack, prefix="mxu_")),
        # interpret mode, compiled anew at each shape
        pallas_fwd=np.asarray(ntt_forward_pallas_mxu(jnp.asarray(lazy[:, 0]), pack)),
        pallas_inv=np.asarray(ntt_inverse_pallas_mxu(jnp.asarray(canon[:, 0]), pack)))


ROWS = {(): (0, 0), (2,): (slice(None), 0), (2, 3): (slice(None), slice(None))}


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
@pytest.mark.parametrize("log_n", range(8, 16))
def test_plain_matches_jax_and_k1(log_n, lead):
    r = reference(log_n)
    rows = ROWS[lead]
    lazy, canon = r["lazy"][rows], r["canon"][rows]
    fwd = MX.ntt_forward_mxu(torch.from_numpy(lazy.astype(np.int64)), r["tt"])
    inv = MX.ntt_inverse_mxu(torch.from_numpy(canon.astype(np.int64)), r["tt"])
    assert fwd.shape == (*lead, 2, 1 << log_n)
    assert torch.equal(fwd, r["k1_fwd"][rows])
    assert torch.equal(inv, r["k1_inv"][rows])
    np.testing.assert_array_equal(r["jax_fwd"][rows], fwd.numpy())
    np.testing.assert_array_equal(r["jax_inv"][rows], inv.numpy())
    if lead == (2,):   # the JAX kernel in interpret mode
        np.testing.assert_array_equal(r["pallas_fwd"], fwd.numpy())
        np.testing.assert_array_equal(r["pallas_inv"], inv.numpy())
    # the inverse takes lazy input too
    assert torch.equal(MX.ntt_inverse_mxu(torch.from_numpy(lazy.astype(np.int64)), r["tt"]),
                       r["k1_inv_lazy"][rows])


@pytest.mark.parametrize("log_n", range(8, 18))
def test_wg_schedule_matches_plain_k1_and_jax(log_n):
    """emulate_wg, the redesigned kernel's integer steps from its own
    tables, equals the plain version, K1's plain version and (to 32768) the
    JAX kernel in interpret mode, forward on lazy input, inverse on
    canonical and lazy input; above 32768 on one polynomial a limb."""
    if log_n <= 15:
        r = reference(log_n)
        tt = r["tt"]
        rows = ROWS[(2,)]
        lazy = torch.from_numpy(r["lazy"][rows].astype(np.int64))
        canon = torch.from_numpy(r["canon"][rows].astype(np.int64))
        fwd, inv = emulate_wg(lazy, tt, False), emulate_wg(canon, tt, True)
        for got, name in ((fwd, "fwd"), (inv, "inv")):
            assert torch.equal(got, r[name][rows]) and torch.equal(got, r["k1_" + name][rows])
            np.testing.assert_array_equal(got.numpy(), r["pallas_" + name])
        assert torch.equal(emulate_wg(lazy, tt, True), r["k1_inv_lazy"][rows])
        return
    primes = primes_for(log_n, 1)
    tt = tables(log_n, primes)
    kt = TNTT.NTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    x = torch.from_numpy(residues((1, 1, 1 << log_n), primes, factor=2).astype(np.int64))
    fwd = emulate_wg(x, tt, False)
    assert torch.equal(fwd, MX.ntt_forward_mxu(x, tt))
    assert torch.equal(fwd, TNTT.ntt_forward_plain(x, kt))
    inv = emulate_wg(x, tt, True)
    assert torch.equal(inv, MX.ntt_inverse_mxu(x, tt))
    assert torch.equal(inv, TNTT.ntt_inverse_plain(x % int(primes[0]), kt))


# ---------------------------------------------------------------------------
# The kernel's schedule (csrc/ntt_mxu.cu), replayed from its tables.
# ---------------------------------------------------------------------------

TILE = 16


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values in int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _load_data(src: torch.Tensor, t, stage: dict, left: bool, base: int) -> torch.Tensor:
    """load_data: (polys, n) int64 rows -> (polys, 4, block, kp) digit planes
    of the block, zero past K.  Left: row i is matrix column base + i;
    right: matrix row base + i."""
    X = src.view(-1, t.n1, t.n2)
    blk = X[:, :, base:base + stage["block"]].transpose(1, 2) if left else \
        X[:, base:base + stage["block"], :]
    q = _u32(t.kernel_scalars[:, 0]).repeat(src.shape[0] // t.size).view(-1, 1, 1)
    planes = MX.split_balanced(blk, q).movedim(0, 1)   # (polys, 4, block, K)
    out = torch.zeros(*planes.shape[:-1], stage["kp"], dtype=torch.int8)
    out[..., :stage["k"]] = planes
    return out


def _run_stage(src, dst, t, stage: dict, left: bool, w: torch.Tensor, twiddle, base: int):
    """run_stage for every polynomial's block at `base`: the block's 16 x 16
    tiles together (each warp's tile is independent of the others), over
    the table's K chunks and 32-deep steps, then the epilogue."""
    polys = src.shape[0]
    limbs = torch.arange(polys) % t.size
    D = _load_data(src, t, stage, left, base).to(torch.float64)
    Wl = w[:, limbs].movedim(0, 1).to(torch.float64)     # (polys, 4, w_rows, kp)
    A, B = (Wl, D) if left else (D, Wl)                   # out[r][c] = sum_k A[r][k] B[c][k]
    rows, cols = A.shape[2], B.shape[2]
    assert rows % TILE == 0 and cols % TILE == 0
    sc = _u32(t.kernel_scalars)[limbs].view(polys, -1, 1, 1)
    q = sc[:, 0]
    acc = [torch.zeros(polys, rows, cols, dtype=torch.int64) for _ in range(7)]
    for k0 in range(0, stage["kp"], stage["kc"]):
        for kk in range(k0, k0 + stage["kc"], 32):
            a, b = A[..., kk:kk + 32], B[..., kk:kk + 32]
            for i in range(4):
                for j in range(4):
                    acc[i + j] += (a[:, i] @ b[:, j].transpose(-1, -2)).to(torch.int64)
            assert all(int(v.abs().max()) < 1 << 31 for v in acc)
    v = MX.recombine_diagonals(acc, [sc[:, 1 + s] for s in range(4)],
                               [sc[:, 5 + s] for s in range(4)],
                               [sc[:, 10 + s] for s in range(7)],
                               [sc[:, 17 + s] for s in range(7)],
                               sc[:, 9], sc[:, 24], q, stage["k"])
    r0, c0 = (0, base) if left else (base, 0)
    if twiddle is not None:
        tw = _u32(twiddle[limbs, r0:r0 + rows, c0:c0 + cols])
        v = MX.shoup_lazy(v, tw[..., 0], tw[..., 1], q)
        v = torch.where(v >= q, v - q, v)
    dst.view(polys, t.n1, t.n2)[:, r0:r0 + rows, c0:c0 + cols] = v


def emulate_mxu(x: torch.Tensor, t: MX.MxuNTTTables, inverse: bool) -> torch.Tensor:
    """The kernel's launches on (..., L, n) int64 input in [0, 2q)."""
    plan = t.plan
    src = x.reshape(-1, t.n).clone()
    out = torch.full_like(src, -1)
    mid = out if plan["launches"] == 1 else torch.full_like(src, -1)
    w_left, w_right = t.kernel_w[2:] if inverse else t.kernel_w[:2]
    twiddle = t.kernel_twiddle[int(inverse)]
    order = [("right", w_right), ("left", w_left)] if inverse else \
        [("left", w_left), ("right", w_right)]
    for s, (name, w) in enumerate(order):
        stage = plan[name]
        left = name == "left"
        data_rows = t.n2 if left else t.n1
        a, b = (src, mid) if s == 0 else (mid, out)
        snapshot = a.clone()  # a launch (or a CTA before its stores) reads its input whole
        for base in range(0, data_rows, stage["block"]):
            _run_stage(snapshot, b, t, stage, left, w, twiddle if s == 0 else None, base)
    assert int(out.min()) >= 0
    return out.view(x.shape)


@pytest.mark.parametrize("log_n", range(8, 18))
def test_kernel_schedule_matches_plain(log_n):
    """emulate_mxu equals the plain version (and so K1 and the JAX
    package) at every degree the kernel takes, one launch up to 32768 and
    two above, lazy input; and kernel_plan fits shared memory."""
    plan = MX.kernel_plan(log_n)
    assert plan["launches"] == (1 if log_n <= 15 else 2)
    for name in ("left", "right"):
        st = plan[name]
        assert st["smem"] <= MX.SMEM_LIMIT and st["kp"] % st["kc"] == 0 and st["kc"] % 32 == 0
    if log_n == 13:
        assert (plan["n1"], plan["n2"]) == (64, 128)
        assert max(plan["left"]["smem"], plan["right"]["smem"]) == 110592
        assert plan["left"]["kc"] == 64 and plan["right"]["kc"] == 128
    L = 2 if log_n <= 15 else 1
    primes = primes_for(log_n, L)
    tt = tables(log_n, primes)
    lead = (2,) if log_n <= 13 else (1,)
    x = torch.from_numpy(residues((*lead, L, 1 << log_n), primes, factor=2).astype(np.int64))
    assert torch.equal(emulate_mxu(x, tt, False), MX.ntt_forward_mxu(x, tt))
    assert torch.equal(emulate_mxu(x, tt, True), MX.ntt_inverse_mxu(x, tt))


# ---------------------------------------------------------------------------
# The backend selection, and the steps under "pallas_mxu".
# ---------------------------------------------------------------------------

@pytest.fixture
def backend():
    """Restore both packages' NTT backend after the test."""
    saved = (JNTT.get_ntt_backend(), TNTT.get_ntt_backend())
    yield
    JNTT.set_ntt_backend(saved[0])
    TNTT.set_ntt_backend(saved[1])


def test_backend_names_match_jax(backend):
    assert TNTT.get_ntt_backend() == JNTT.get_ntt_backend() == "sixstep"
    for name in ("radix2", "mxu", "sixstep", "pallas", "pallas_mxu"):
        JNTT.set_ntt_backend(name)
        TNTT.set_ntt_backend(name)
        assert TNTT.get_ntt_backend() == JNTT.get_ntt_backend() == name
    for bad in ("gpu", "", "PALLAS_MXU"):
        with pytest.raises(ValueError) as jerr:
            JNTT.set_ntt_backend(bad)
        with pytest.raises(ValueError) as terr:
            TNTT.set_ntt_backend(bad)
        assert str(terr.value) == str(jerr.value)
    assert TNTT.get_ntt_backend() == "pallas_mxu"


def _counting():
    calls = []
    real_f, real_i = MX.ntt_forward_mxu, MX.ntt_inverse_mxu

    def f(*a):
        calls.append("f")
        return real_f(*a)

    def i(*a):
        calls.append("i")
        return real_i(*a)
    return calls, f, i


@pytest.mark.parametrize("name,routed", [("radix2", False), ("sixstep", False),
                                         ("pallas", False), ("mxu", True),
                                         ("pallas_mxu", True)])
def test_backend_routes(backend, monkeypatch, name, routed):
    """Tables built under 'mxu' / 'pallas_mxu' at n >= 256 carry the
    matrix-product route, below 256 and under the other names none; the
    dispatch takes it and equals the butterfly route."""
    TNTT.set_ntt_backend(name)
    primes = primes_for(10, 3)
    t = TNTT.NTTTables(10, [Modulus(p) for p in primes], "cpu")
    small = TNTT.NTTTables(7, [Modulus(p) for p in primes_for(7, 3)], "cpu")
    assert (t.mxu is not None) == routed and small.mxu is None
    assert t.take([2, 0]).mxu is None if not routed else t.take([2, 0]).mxu.size == 2
    x = torch.from_numpy(residues((2, 3, 1024), primes, 2).astype(np.int64))
    calls, f, i = _counting()
    monkeypatch.setattr(MX, "ntt_forward_mxu", f)
    monkeypatch.setattr(MX, "ntt_inverse_mxu", i)
    y = TNTT.ntt_forward(x, t)
    z = TNTT.ntt_inverse(y, t)
    assert calls == (["f", "i"] if routed else [])
    assert torch.equal(y, TNTT.ntt_forward_plain(x, t))
    assert torch.equal(z, TNTT.ntt_inverse_plain(y, t))


class MxuFlow:
    """The JAX package's and the port's BFV context at n = 256 on 5 x 30-bit
    primes (L = 4), both built under set_ntt_backend("pallas_mxu"): the
    JAX package's jitted multiply + relinearize and rotate_rows(1) steps on
    its own ciphertexts and keys, and the port's steps on the same."""

    N, BITS, B = 256, (30,) * 5, 4

    def __init__(self):
        JNTT.set_ntt_backend("pallas_mxu")
        TNTT.set_ntt_backend("pallas_mxu")
        rng = np.random.default_rng(1414)
        self.h = h = GeneralHeContext("BFV", self.N, log_t=20, q_bits=self.BITS)
        jcd = h.context.first_context_data()
        jb = JBatched(h.evaluator, jcd)
        rlk = h.keygen.create_relin_keys()
        self.ms1 = [h.random_simd(rng) for _ in range(self.B)]
        self.ms2 = [h.random_simd(rng) for _ in range(self.B)]
        self.jd1 = np.asarray(jb.stack([h.encrypt(m) for m in self.ms1]))
        self.jd2 = np.asarray(jb.stack([h.encrypt(m) for m in self.ms2]))
        jkey = rlk.key(2)
        self.jmul = np.asarray(jax.jit(jb.build_mul_relin_step(jkey))(
            jnp.asarray(self.jd1), jnp.asarray(self.jd2), jkey))
        jrot, elts = jb.build_rotate_rows_step(1)
        jglk = h.keygen.create_galois_keys_from_elements(elts)
        jkeys = tuple(jglk.key(e) for e in elts)
        self.jrot = np.asarray(jax.jit(jrot)(jnp.asarray(self.jd1), jkeys))
        p = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(self.N)
        p.set_coeff_modulus(CoeffModulus.create(self.N, list(self.BITS)))
        p.set_plain_modulus(PlainModulus.batching(self.N, 20))
        self.tc = tc = HeContext.create(p, True, SecurityLevel.Nil, device="cpu")
        self.cd = tc.first_context_data()
        self.keys = interop.relin_keys({k: np.asarray(v) for k, v in rlk.keys.items()},
                                       tc.key_parms_id, "cpu").key(2)
        glk = interop.galois_keys({g: np.asarray(k) for g, k in jglk.keys.items()},
                                  tc.key_parms_id, "cpu")
        self.be = BatchedEvaluator(Evaluator(tc), self.cd)
        self.mul = self.be.build_mul_relin_step(self.keys)
        rot, relts = self.be.build_rotate_rows_step(1)
        assert list(relts) == list(elts)
        self.rot = lambda d: rot(d, tuple(glk.key(e) for e in relts))
        self.d1 = interop.to_tensor(self.jd1, "cpu")
        self.d2 = interop.to_tensor(self.jd2, "cpu")


@pytest.fixture(scope="module")
def F():
    saved = (JNTT.get_ntt_backend(), TNTT.get_ntt_backend())
    try:
        yield MxuFlow()
    finally:
        JNTT.set_ntt_backend(saved[0])
        TNTT.set_ntt_backend(saved[1])


def test_steps_under_pallas_mxu_match_jax(F, monkeypatch):
    """The HPS multiply + relinearize (9 transforms: 5 forward, 4 inverse)
    and rotate_rows(1) take the matrix-product route and equal the JAX
    package's jitted steps under its "pallas_mxu"."""
    assert F.cd.qtab().mxu is not None
    calls, f, i = _counting()
    monkeypatch.setattr(MX, "ntt_forward_mxu", f)
    monkeypatch.setattr(MX, "ntt_inverse_mxu", i)
    out = F.mul(F.d1, F.d2, F.keys)
    assert (calls.count("f"), calls.count("i")) == (5, 4)
    np.testing.assert_array_equal(interop.to_numpy(out), F.jmul)
    del calls[:]
    np.testing.assert_array_equal(interop.to_numpy(F.rot(F.d1)), F.jrot)
    assert calls and set(calls) <= {"f", "i"}


def test_limb_sharded_step_under_pallas_mxu(F, monkeypatch):
    """A (data=2, limb=2) step on the CPU mesh: each limb shard transforms
    its own rows through the route's sliced tables; equal to the unsharded
    step."""
    calls, f, i = _counting()
    monkeypatch.setattr(MX, "ntt_forward_mxu", f)
    monkeypatch.setattr(MX, "ntt_inverse_mxu", i)
    mesh = M.make_mesh(data=2, limb=2, devices=[torch.device("cpu")] * 4)
    out = F.mul(M.shard_batch(F.d1, mesh), M.shard_batch(F.d2, mesh), M.replicate(F.keys, mesh))
    np.testing.assert_array_equal(interop.to_numpy(out.gather()), F.jmul)
    assert calls.count("f") >= 2 * 5 and calls.count("i") >= 2 * 4
    # 'poly': each transform runs on whole rows after an all-to-all, through
    # row tables taken from the route's tables
    del calls[:]
    poly = M.make_latency_mesh(devices=[torch.device("cpu")] * 2)
    one = F.mul(*(M.shard_poly(x, poly) for x in (F.d1[:1], F.d2[:1], F.keys)))
    np.testing.assert_array_equal(interop.to_numpy(one.gather()), F.jmul[:1])
    assert calls.count("f") >= 5 and calls.count("i") >= 4


def test_wrapper_refuses_cpu_and_bad_input():
    """The refusals that need no card: CPU tensors, and the tables' type."""
    primes = primes_for(10, 2)
    tt = tables(10, primes)
    x = torch.zeros(2, 1024, dtype=torch.int64)
    for fn in (ntt_mxu_cuda.ntt_forward, ntt_mxu_cuda.ntt_inverse):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, tt)
        with pytest.raises(TypeError, match="MxuNTTTables"):
            fn(x, TNTT.NTTTables(10, [Modulus(p) for p in primes], "cpu"))
    with pytest.raises(ValueError, match="outside"):
        MX.MxuNTTTables(7, [Modulus(p) for p in primes_for(7, 1)], "cpu")
    assert ntt_mxu_cuda.plan_words(tt) == [32, 32, 32, 32, tt.plan["left"]["smem"],
                                           tt.plan["right"]["smem"]]

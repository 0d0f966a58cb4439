"""The redesigned matrix-product NTT kernel (troy_tpu_torch/csrc/ntt_mxu_wg.cu)
on the CPU: its integer steps replayed from its own tables, its bounds, its
table layout against the JAX package's planes, and its wrapper's refusals.

emulate_wg replays the kernel a stage at a time: each thread's split of 4
values of an operand row into one word a plane (a conditional subtract,
then the unsigned bytes) at the word's place in the core-matrix layout;
the 16 unsigned plane products of every wgmma tile into the 7 diagonal
accumulators, read through the descriptors' addressing (8 x 16-byte core
matrices, the next along K 128 bytes on, the next 8 rows 8 Kp bytes on),
with the tables' zero padding to 64 rows and 32 deep and stage 2's operand
left as garbage where stage 1 writes nothing; the recombination as one
wide sum and one Barrett step, its result asserted in [0, 3q); the
twiddle's Shoup product in stage 1's output order; stage 1's values
written as bytes into stage 2's operand planes; and stage 2's output rows.
The tiles are all computed at once (they are independent: which warpgroup
runs which tile changes nothing the replay could see).  The replay is held
to the plain version, K1's plain version and the JAX package's K2 in
interpret mode at every degree 256 .. 131072 (test_torch_ntt_mxu.py).
The kernel itself runs only on the card (chip_smoke.py [mxu])."""

import numpy as np
import pytest
import torch

import troy_tpu.ops.ntt_mxu as JMX
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import ntt as TNTT, ntt_mxu as MX, ntt_mxu_cuda
from troy_tpu_torch.utils import numth

RNG = np.random.default_rng(1515)
M32 = (1 << 32) - 1


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


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & M32


def umulhi(a: torch.Tensor, b) -> torch.Tensor:
    """floor(a b / 2^32) for a, b < 2^32 in int64, exactly (a in halves)."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def cond_sub(x: torch.Tensor, q) -> torch.Tensor:
    """min(x, x - q) on u32: x - q wraps above x when x < q."""
    return torch.minimum(x, (x - q) & M32)


def cm_offsets(rows: int, kp: int) -> torch.Tensor:
    """(rows, kp) byte offsets of a K-major operand in the core-matrix
    layout: ((r / 8) (kp / 16) + k / 16) 128 + (r % 8) 16 + k % 16."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(kp)[None, :]
    return ((r // 8) * (kp // 16) + k // 16) * 128 + (r % 8) * 16 + k % 16


def split_words(src: torch.Tensor, q: torch.Tensor, rows: int, K: int, kp: int, n2: int,
                inverse: bool) -> torch.Tensor:
    """split<kInverse>: (polys, n) int64 in [0, 2q) -> (polys, 4 rows kp) u8
    plane bytes, word i of each plane from thread item i: core matrix i / 32,
    row (i % 32) / 4, bytes 4 (i % 4) .. + 3 (zeros at k >= K)."""
    kb = kp // 16
    i = torch.arange(rows * kp // 4)
    cm, lane = i // 32, i % 32
    row = (cm // kb) * 8 + lane // 4
    k = (cm % kb) * 16 + (lane % 4) * 4
    out = torch.zeros(src.shape[0], 4, rows * kp, dtype=torch.uint8)
    for j in range(4):
        kk = (k + j).clamp(max=K - 1)
        idx = row * n2 + kk if inverse else kk * n2 + row
        v = cond_sub(src[:, idx], q)
        v = torch.where((k + j < K)[None, :], v, torch.zeros_like(v))
        for p in range(4):
            out[:, p, 4 * i + j] = ((v >> (8 * p)) & 255).to(torch.uint8)
    return out.reshape(src.shape[0], -1)


def diagonals(A: torch.Tensor, B: torch.Tensor) -> list:
    """The 7 diagonal accumulators of D[m][n] = sum_k A[m][k] B[n][k]:
    A (polys, 4, M, K), B (polys, 4, N, K) byte planes -> 7 x (polys, M, N)
    int64, each asserted nonnegative and below 2^31 (s32)."""
    P = torch.einsum("pimk,pjnk->pijmn", A.to(torch.float64), B.to(torch.float64))
    P = P.to(torch.int64)
    acc = [sum(P[:, i, s - i] for i in range(max(0, s - 3), min(4, s + 1))) for s in range(7)]
    assert all(int(a.min()) >= 0 and int(a.max()) < 1 << 31 for a in acc)
    return acc


def recombine(acc: list, sc: torch.Tensor) -> torch.Tensor:
    """The kernel's recombine: p45 = P4 + 2^8 P5 (asserted below 2^32), v =
    P0 + 2^8 P1 + 2^16 P2 + 2^24 P3 + c4 p45 + c6 P6 (asserted below 2^63),
    qhat = umulhi(v >> s, mu), v - qhat q in [0, 3q) (asserted).  sc:
    (polys, 8, 1, 1) u32 scalars."""
    q, mu, s, c4, c6 = (sc[:, i] for i in range(5))
    p45 = acc[4] + (acc[5] << 8)
    assert int(p45.max()) < 1 << 32
    v = acc[0] + (acc[1] << 8) + (acc[2] << 16) + (acc[3] << 24) + p45 * c4 + acc[6] * c6
    assert int(v.max()) < 1 << 63
    t = (v >> s) & M32
    r = v - umulhi(t, mu) * q
    assert int(r.min()) >= 0 and bool((r < 3 * q).all())
    return r


def stage_operand(flat: torch.Tensor, rows: int, kp: int) -> torch.Tensor:
    """(polys, 4 rows kp) u8 in the core-matrix layout -> (polys, 4, rows, kp)."""
    return flat.view(flat.shape[0], 4, rows * kp)[:, :, cm_offsets(rows, kp)]


def emulate_wg(x: torch.Tensor, t: MX.MxuNTTTables, inverse: bool) -> torch.Tensor:
    """The kernel's launch on (..., L, n) int64 input in [0, 2q)."""
    p = MX.wg_plan(t.log_n, inverse)
    src = x.reshape(-1, t.n)
    polys = src.shape[0]
    limbs = torch.arange(polys) % t.size
    sc = _u32(t.wg_scalars)[limbs].view(polys, -1, 1, 1)
    q = sc[:, 0]
    t1, t2 = (w[limbs] for w in (t.wg_w[2:] if inverse else t.wg_w[:2]))
    assert t1.shape[1] == p["t1"] and t2.shape[1] == p["t2"]
    tw = _u32(t.wg_twiddle[int(inverse)])[limbs].view(polys, p["M1"], p["N1"], 2)
    # stage 1: the table (padded to M1p rows) and the split data
    B1 = split_words(src, q.view(polys, 1), p["N1"], p["M1"], p["K1p"], t.n2, inverse)
    acc = diagonals(stage_operand(t1, p["M1p"], p["K1p"]),
                    stage_operand(B1, p["N1"], p["K1p"]))
    v = recombine(acc, sc)[:, :p["M1"]]
    v = cond_sub(MX.shoup_lazy(v, tw[..., 0], tw[..., 1], q), q)
    # its bytes into stage 2's operand planes (rows M1 = N2, k = n), over garbage
    B2 = torch.from_numpy(RNG.integers(0, 256, (polys, p["b2"]), dtype=np.uint8))
    off = cm_offsets(p["N2"], p["K2p"])[:, :p["N1"]]
    plane = p["N2"] * p["K2p"]
    for b in range(4):
        B2[:, b * plane + off.reshape(-1)] = ((v >> (8 * b)) & 255).reshape(polys, -1).to(
            torch.uint8)
    acc = diagonals(stage_operand(t2, p["M2p"], p["K2p"]),
                    stage_operand(B2, p["N2"], p["K2p"]))
    v = cond_sub(cond_sub(recombine(acc, sc)[:, :p["M2"]], q), q)
    # stage 2's (m, n): out[n][m] forward (n = r, m = c'), out[m][n] inverse
    out = v if inverse else v.transpose(1, 2)
    assert int(out.min()) >= 0 and bool((out < q).all())
    return out.reshape(x.shape)


@pytest.mark.parametrize("log_n", range(8, 18))
def test_wg_plan_fits(log_n):
    """The plan: both directions' shared bytes as the kernel computes them,
    resident (tables loaded once a CTA, the next row staged) to 8192, one
    table buffer at 16384; the tiles' N; the route's degrees."""
    for inverse in (False, True):
        p = MX.wg_plan(log_n, inverse)
        assert p["M2"] == p["N1"] and p["N2"] == p["M1"]
        assert p["resident"] == (log_n <= 13)
        if log_n <= MX.WG_MAX_LOG_N:
            assert p["smem"] <= MX.WG_SMEM_LIMIT
        for name in ("t1", "t2", "b1", "b2", "staging"):
            assert p[name] % 128 == 0
        assert p["N1"] % p["nt1"] == 0 and p["N2"] % p["nt2"] == 0
    if log_n == 13:
        p = MX.wg_plan(13, False)
        assert (p["t1"], p["t2"], p["b1"], p["b2"], p["staging"], p["smem"]) == (
            16384, 65536, 32768, 32768, 65536, 212992)


@pytest.mark.parametrize("log_n", [8, 10, 13, 14, 15, 16, 17])
def test_wg_tables_rebuild_jax_planes(log_n):
    """The redesigned kernels' tables: each stage's unsigned byte planes,
    read back from the core-matrix layout, rebuild the values the JAX
    package's balanced planes rebuild (W1, W2^T, W2i^T, W1i), zero past the
    table; above 16384 the cluster kernel's planes (cl_layout) hold the same
    bytes; its twiddles are T and Ti transposed; its scalars wg_barrett's."""
    primes = primes_for(log_n, 3)
    jt = JMX.MxuNTTTables(log_n, [JModulus(p) for p in primes])._host
    tt = MX.MxuNTTTables(log_n, [Modulus(p) for p in primes], "cpu")
    weights = torch.tensor([1, 256, 1 << 16, 1 << 24]).view(1, 4, 1, 1)

    def jax_values(name):
        planes = jt[name].astype(np.int64)   # (4, L, ., .) balanced digits
        return (planes * np.array([1, 256, 1 << 16, 1 << 24]).reshape(4, 1, 1, 1)).sum(0)

    for w, (name, trans) in zip(tt.wg_w, (("W1", False), ("W2", True), ("W2i", True),
                                          ("W1i", False))):
        want = jax_values(name)
        if trans:
            want = want.swapaxes(-1, -2)
        M = K = want.shape[-1]
        Mp, Kp = max(64, M), max(32, K)
        assert w.dtype == torch.uint8 and w.shape == (3, 4 * Mp * Kp)
        planes = MX.wg_unlayout(w, Mp, Kp).to(torch.int64)
        assert not planes[:, :, M:].any() and not planes[:, :, :, K:].any(), name
        assert int(planes[:, 3].max()) <= 63
        got = (planes[:, :, :M, :K] * weights).sum(1)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        if log_n > MX.WG_MAX_LOG_N:   # cl_w: (tile, block, plane, row group, K block, row, byte)
            cl = tt.cl_w[[w_ is w for w_ in tt.wg_w].index(True)]
            blocks = cl.reshape(3, M // 64, K // 64, 4, 8, 4, 8, 16).permute(0, 3, 1, 4, 6, 2, 5, 7)
            assert torch.equal(blocks.reshape(3, 4, M, K), planes), name
    tw = tt.wg_twiddle.numpy().view(np.uint32).reshape(2, 3, -1, 2)
    np.testing.assert_array_equal(tw[0, ..., 0].reshape(jt["T"].shape), jt["T"])
    np.testing.assert_array_equal(tw[1, ..., 0].reshape(3, tt.n2, tt.n1),
                                  jt["Ti"].swapaxes(-1, -2))
    np.testing.assert_array_equal(tw[1, ..., 1].reshape(3, tt.n2, tt.n1),
                                  jt["Ti_shoup"].swapaxes(-1, -2))
    sc = tt.wg_scalars.numpy().view(np.uint32)
    for l, q in enumerate(primes):
        s, mu, c = MX.wg_barrett(q, tt.n2)
        assert sc[l].tolist() == [q, mu, s, *c, 0, 0, 0]


@pytest.mark.parametrize("q_bits", [17, 20, 24, 25, 29, 30])
def test_wg_bounds_at_every_contraction(q_bits):
    """Every degree's largest contraction (16 .. 512) at moduli of 17 to 30
    bits: each diagonal below 2^31, the Barrett step's shift and factor
    inside 32 bits; and the accumulators reached by all-255 bytes (every
    residue at q - 1 and 2q - 1's reduction)."""
    q = numth.get_primes(1 << 10, q_bits, 1)[0]
    b = MX.byte_bounds(q)
    assert b[3] <= 63 and all(0 <= v <= 255 for v in b)
    for k in (16, 32, 64, 128, 256, 512):
        d = MX.wg_diagonal_bounds(k, q)
        assert max(d) < 1 << 31
        s, mu, c = MX.wg_barrett(q, k)
        assert (1 << s) < q and mu < 1 << 32 and c == [pow(2, 32, q), pow(2, 48, q)]
    assert MX.wg_diagonal_bounds(128, (1 << 30) - 35)[3] == 128 * (2 * 255 * 255 + 2 * 255 * 63)


@pytest.mark.parametrize("contraction", [32, 128, 512])
def test_wg_recombination_at_its_extremes(contraction):
    """The wide recombination and its Barrett step: the diagonals of all
    operands at q - 1 (the split's bytes of q - 1 and of lazy 2q - 1), at
    the bytes' bounds, zero, and random; each equal to the exact sum mod q."""
    primes = primes_for(13, 2) + [numth.get_primes(1 << 10, 20, 1)[0]]
    for q in primes:  # the split takes q - 1, q and 2q - 1 to the bytes of x mod q
        src = torch.tensor([[q - 1, 2 * q - 1, q, 0] * 64], dtype=torch.int64)  # 8 rows of 32
        planes = split_words(src, torch.tensor([[q]]), 8, 32, 32, 32, True)
        planes = stage_operand(planes, 8, 32)[0, :, 0, :4].to(torch.int64)
        want = torch.tensor([[(v % q) >> (8 * i) & 255 for v in (q - 1, 2 * q - 1, q, 0)]
                             for i in range(4)])
        assert torch.equal(planes, want)
    rows = []
    for q in primes:
        b = MX.byte_bounds(q)
        ones = [(q - 1) >> (8 * i) & 255 for i in range(4)]   # bytes of q - 1
        cases = [b, ones, [0, 0, 0, 0], [b[0], 0, 0, b[3]], [0, 0, b[2], b[3]]]
        for _ in range(3):
            cases.append([int(RNG.integers(0, v + 1)) for v in b])
        rows.append(cases)
    # diagonals of a contraction whose every term multiplies bytes x by y
    acc = [torch.zeros(len(primes), 1, len(rows[0]) ** 2, dtype=torch.int64)
           for _ in range(7)]
    exact = np.zeros((len(primes), len(rows[0]) ** 2), dtype=object)
    for l, cases in enumerate(rows):
        for a, x in enumerate(cases):
            for c, y in enumerate(cases):
                col = a * len(cases) + c
                for i in range(4):
                    for j in range(4):
                        acc[i + j][l, 0, col] += contraction * x[i] * y[j]
                xv = sum(v << (8 * i) for i, v in enumerate(x))
                yv = sum(v << (8 * i) for i, v in enumerate(y))
                exact[l, col] = contraction * xv * yv % primes[l]
    sc = torch.from_numpy(MX.wg_scalar_rows([Modulus(q) for q in primes], contraction)
                          .astype(np.int64)).view(len(primes), -1, 1, 1)
    r = recombine(acc, sc)
    q = torch.tensor(primes).view(-1, 1, 1)
    got = cond_sub(cond_sub(r, q), q).view(len(primes), -1)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int64))


def test_wrapper_refuses_bad_input():
    """The route's refusals that need no card: CPU tensors and other tables,
    at a degree of the redesigned kernel and above it (where the cluster
    kernel takes the same tables)."""
    primes = primes_for(10, 2)
    tt = MX.MxuNTTTables(10, [Modulus(p) for p in primes], "cpu")
    big = MX.MxuNTTTables(15, [Modulus(p) for p in primes_for(15, 2)], "cpu")
    assert tt.wg_w is not None and tt.take([1]).wg_w[0].shape[0] == 1
    assert big.wg_w is not None and big.take([1]).wg_w[0].shape[0] == 1
    for t in (tt, big):
        x = torch.zeros(2, t.n, dtype=torch.int64)
        for fn in (ntt_mxu_cuda.ntt_forward, ntt_mxu_cuda.ntt_inverse,
                   ntt_mxu_cuda.mma_forward, ntt_mxu_cuda.mma_inverse):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(x, t)
            with pytest.raises(TypeError, match="MxuNTTTables"):
                fn(x, TNTT.NTTTables(t.log_n, [Modulus(p) for p in
                                               [m.value for m in t.moduli]], "cpu"))
    assert ntt_mxu_cuda.WG_INFO[:5] == ("threads", "smem", "regs", "local_bytes", "ctas_per_sm")

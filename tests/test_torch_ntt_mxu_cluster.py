"""The cluster kernel of the matrix-product NTT (troy_tpu_torch/csrc/
ntt_mxu_cluster.cu, K2's route at n = 32768, 65536, 131072) on the CPU: its
integer schedule replayed from its own tables, its plan, its tables and its
wrapper's refusals.

emulate_cluster replays one launch a polynomial at a time, CTA by CTA of a
cluster (ops/ntt_mxu.py:cl_plan): each CTA's int64 slice of the input
(forward: R1 columns of each of X's n1 rows; inverse: R1 whole rows), split into stage 1's operand planes
(test_torch_ntt_mxu_wg.split_words); each warpgroup's sequence of table
chunks (chunk_of, the kernel's own mapping), each chunk the one contiguous
run of the table (cl_layout) its bulk copy brings into a slot, read back
through the descriptors' addressing (64 x 64 blocks of 4 planes, the next
row group 512 bytes on, the next K block 128) and multiplied against the K
range of the CTA's operand it covers, the 7 diagonal accumulators summed over the chunks and asserted
inside s32 after each; the recombination and the twiddle of emulate_wg;
stage 1's values written into the CTA's outgoing tile as each lane of a
quad stores them after the kernel's two xor shuffles (8 bytes of one plane
a lane), each tile's blocks then pushed by one copy a destination CTA (the
one holding rows m of V2, m / R2) and plane into that CTA's stage 2 operand
planes (K block major: a source CTA's block is one run), every byte of
those planes written exactly once; then stage 2 the same way into the output rows.  The CTAs of
a cluster are computed side by side (the table chunk is the same for all).
The kernel itself runs only on the card (chip_smoke.py [mxu])."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import troy_tpu.ops.ntt_mxu as JMX
from troy_tpu.core.modulus import Modulus as JModulus
from troy_tpu.ops.ntt_pallas import ntt_forward_pallas_mxu, ntt_inverse_pallas_mxu
from troy_tpu_torch.core.modulus import Modulus
from troy_tpu_torch.ops import ntt as TNTT, ntt_mxu as MX, ntt_mxu_cuda
from tests.test_torch_ntt_mxu_wg import (_u32, cm_offsets, cond_sub, diagonals, primes_for,
                                         recombine, split_words, stage_operand)

RNG = np.random.default_rng(1616)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test, as the other K2 files (many small float64
    products thrash under xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def chunk_of(p: dict, group: int, v: int) -> tuple:
    """ntt_mxu_cluster.cu:chunk_of: warpgroup `group`'s chunk v -> (the
    polynomial it of the cluster's run, the stage, the 64-row tile mt, the
    chunk j of the tile's K, the chunk's byte offset in the limb's table
    (cl_layout) and its bytes)."""
    it, w = divmod(v, p["per_row"])
    first = (p["M1"] // 128) * (p["K1"] // p["kc"])
    one = w < first
    if not one:
        w -= first
    K, kc = (p["K1"] if one else p["K2"]), p["kc"]
    mt, j = 2 * (w // (K // kc)) + group, w % (K // kc)
    return it, 1 if one else 2, mt, j, mt * 256 * K + j * 256 * kc, 256 * kc


def slot_operand(slot: torch.Tensor, kc: int) -> torch.Tensor:
    """A slot's (polys, 256 kc) bytes as the descriptors read them: block
    k / 64 at 16384 (k / 64), its plane q at 4096 q, then the core-matrix
    layout of 64 rows x 64 -> (polys, 4, 64, kc)."""
    off = torch.stack([torch.cat([b * MX.CL_BLOCK + q * 4096 + cm_offsets(64, 64)
                                  for b in range(kc // 64)], dim=1) for q in range(4)])
    return slot[:, off]


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """__byte_perm(x, y, sel) on u32 values in int64: byte i of the result is
    byte (sel >> 4 i) & 7 of the pair (y << 32 | x)."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 255) << (8 * i) for i in range(4))


def quad_words(v: torch.Tensor) -> tuple:
    """The hand-off's lane trade: v (..., 8) stage 1 values n0 .. n0 + 7 of
    one row, lane t of a quad holding n0 + 2 t and + 1 -> each lane's
    (plane, low word, high word) of the 8 bytes it stores, by the kernel's
    two xor shuffles."""
    lo = byte_perm(v[..., 0::2], v[..., 1::2], 0x5140)   # (..., 4 lanes)
    hi = byte_perm(v[..., 0::2], v[..., 1::2], 0x7362)
    t = torch.arange(4)
    odd, upper = (t & 1).bool(), (t & 2).bool()
    send = torch.where(odd, lo, hi)
    got = send[..., t ^ 1]
    x = torch.where(odd, byte_perm(got, hi, 0x5410), byte_perm(lo, got, 0x5410))
    y = torch.where(odd, byte_perm(got, hi, 0x7632), byte_perm(lo, got, 0x7632))
    other = torch.where(upper, x, y)[..., t ^ 2]
    plane = (t >> 1) | ((t & 1) << 1)
    return plane, torch.where(upper, other, x), torch.where(upper, y, other)


def staged(X: torch.Tensor, p: dict, rank: int, inverse: bool) -> torch.Tensor:
    """CTA rank's slice of (polys, n1, n2) X as the split reads it, row-major:
    forward R1 columns of each row (n1 x R1), inverse R1 whole rows."""
    R1 = p["R1"]
    part = X[:, rank * R1:(rank + 1) * R1, :] if inverse else X[:, :, rank * R1:(rank + 1) * R1]
    return part.reshape(X.shape[0], -1)


def run_stage(p: dict, stage: int, table: torch.Tensor, B: torch.Tensor, sc: torch.Tensor,
              epilogue) -> None:
    """Both warpgroups' chunks of one stage against every CTA's operand B
    (polys, C, 4, R, K): each tile's diagonals over its chunks, then
    epilogue(mt, v) with v (polys, C, 64, R) in [0, 3q)."""
    for group in (0, 1):
        acc = {}
        for v in range(p["per_row"]):
            it, s, mt, j, off, nbytes = chunk_of(p, group, v)
            assert it == 0
            if s != stage:
                continue
            kc = p["kc"]
            A = slot_operand(table[:, off:off + nbytes], kc)   # the one bulk copy
            part = diagonals(A.unsqueeze(1).expand(-1, p["C"], -1, -1, -1).flatten(0, 1),
                             B[..., j * kc:(j + 1) * kc].flatten(0, 1))
            acc[mt] = part if mt not in acc else [a + b for a, b in zip(acc[mt], part)]
            assert all(int(a.max()) < 1 << 31 for a in acc[mt])
            if j == table_k(p, stage) // kc - 1:
                tile = [a.view(B.shape[0], p["C"], 64, -1) for a in acc.pop(mt)]
                epilogue(mt, recombine(tile, sc))
        assert not acc


def table_k(p: dict, stage: int) -> int:
    return p["K1"] if stage == 1 else p["K2"]


def emulate_cluster(x: torch.Tensor, t: MX.MxuNTTTables, inverse: bool,
                    log_c: int | None = None) -> torch.Tensor:
    """The kernel's launch on (..., L, n) int64 input in [0, 2q)."""
    p = MX.cl_plan(t.log_n, inverse, log_c)
    assert p["ok"]
    C, R1, R2, K1, K2 = p["C"], p["R1"], p["R2"], p["K1"], p["K2"]
    src = x.reshape(-1, t.n)
    polys = src.shape[0]
    limbs = torch.arange(polys) % t.size
    sc = _u32(t.wg_scalars)[limbs].view(polys, -1, 1, 1, 1)
    q = sc[:, 0]
    t1, t2 = (w[limbs] for w in (t.cl_w[2:] if inverse else t.cl_w[:2]))
    tw = _u32(t.wg_twiddle[int(inverse)])[limbs].view(polys, p["M1"], p["N1"], 2)
    X = src.view(polys, t.n1, t.n2)
    # stage 1's operand of every CTA, split from its staged slice
    B1 = torch.stack([
        stage_operand(split_words(staged(X, p, r, inverse), q.view(polys, 1), R1, K1, K1,
                                  t.n2 if inverse else R1, inverse), R1, K1)
        for r in range(C)], dim=1)
    # stage 2's operand planes of every CTA, garbage until stage 1's pushes
    # land; each CTA's outgoing tiles likewise
    plane2 = R2 * K2
    V2 = torch.from_numpy(RNG.integers(0, 256, (polys, C, 4 * plane2), dtype=np.uint8))
    written = torch.zeros(C, 4 * plane2, dtype=torch.int64)
    out1 = torch.from_numpy(RNG.integers(0, 256, (polys, C, p["out"]), dtype=np.uint8))
    ml = torch.arange(64).view(64, 1)
    tile = 256 * R1                                        # a tile's bytes, 4 planes

    def handoff(mt, v):
        m = 64 * mt + ml                                   # (64, 1) table rows
        n = torch.arange(C).view(C, 1, 1) * R1 + torch.arange(R1).view(1, 1, R1)  # (C, 1, R1)
        w = tw[:, m, n]                                    # (polys, C, 64, R1, 2)
        v = cond_sub(MX.shoup_lazy(v, w[..., 0], w[..., 1], q), q)
        # each quad's 8 values k0 .. k0 + 7 (local) of row m: lane t's word of
        # plane(t), stored into the outgoing tile as the destination holds it
        plane, w_lo, w_hi = quad_words(v.view(polys, C, 64, R1 // 8, 8))
        word = torch.stack([(w >> (8 * b)) & 255 for w in (w_lo, w_hi) for b in range(4)], -1)
        rr = m % R2                                                        # (64, 1)
        k0 = torch.arange(0, R1, 8).view(1, -1)                            # (1, R1 / 8)
        off = (mt * tile + (ml // R2) * (4 * R1 * R2) + (k0 >> 4) * (16 * R2) + (rr >> 3) * 128
               + (rr & 7) * 16 + (k0 & 15))                                # (64, R1 / 8)
        idx = (off.unsqueeze(-1) + plane * (R1 * R2)).unsqueeze(-1) + torch.arange(8)
        out1[:, :, idx.reshape(-1)] = word.reshape(polys, C, -1).to(torch.uint8)
        # then one bulk copy a destination and plane: this CTA's K block of V2
        for r in range(C):
            for d in range(64 // R2):
                dest = 64 * mt // R2 + d
                for b in range(4):
                    src = mt * tile + d * (4 * R1 * R2) + b * (R1 * R2)
                    dst = b * plane2 + r * R1 * R2
                    V2[:, dest, dst:dst + R1 * R2] = out1[:, r, src:src + R1 * R2]
                    written[dest, dst:dst + R1 * R2] += 1

    run_stage(p, 1, t1, B1, sc, handoff)
    assert bool((written == 1).all()), "stage 2's planes not written exactly once"
    # V2's layout: (plane, K block, row group, row, byte) -> (polys, C, 4, R2, K2)
    B2 = V2.view(polys, C, 4, K2 // 16, R2 // 8, 8, 16).permute(0, 1, 2, 4, 5, 3, 6).reshape(
        polys, C, 4, R2, K2)
    out = torch.full((polys, t.n1, t.n2), -1, dtype=torch.int64)

    def store(mt, v):
        v = cond_sub(cond_sub(v, q), q)                   # (polys, C, 64, R2)
        m = 64 * mt + ml
        n = torch.arange(C).view(C, 1, 1) * R2 + torch.arange(R2).view(1, 1, R2)
        if inverse:   # out[m][n]
            out.view(polys, -1)[:, (m * t.n2 + n).reshape(-1)] = v.reshape(polys, -1)
        else:         # out[n][m]
            out.view(polys, -1)[:, (n * t.n2 + m).reshape(-1)] = v.reshape(polys, -1)

    run_stage(p, 2, t2, B2, sc, store)
    assert int(out.min()) >= 0 and bool((out < q.view(polys, 1, 1)).all())
    return out.reshape(x.shape)


def residues(shape, primes, factor=1) -> torch.Tensor:
    q = np.array(primes, dtype=np.uint64)[:, None]
    return torch.from_numpy((RNG.integers(0, 1 << 62, size=shape, dtype=np.uint64)
                             % (factor * q)).astype(np.int64))


@functools.lru_cache(maxsize=None)
def tables(log_n: int, count: int) -> tuple:
    primes = primes_for(log_n, count)
    mods = [Modulus(p) for p in primes]
    return primes, MX.MxuNTTTables(log_n, mods, "cpu"), TNTT.NTTTables(log_n, mods, "cpu")


CASES = [(15, (2,)), (16, (1,)), (17, (1,))]


@pytest.mark.parametrize("log_n, lead", CASES + [(15, (2, 2))])
def test_cluster_schedule_matches_plain_and_k1(log_n, lead):
    """The replay at the route's cluster size equals the plain version and
    K1's plain version: forward on lazy input, inverse on canonical and lazy
    input; one polynomial a limb (1 or 2 limbs), and at 32768 2 limbs x 2
    rows."""
    count = 2 if log_n == 15 else 1
    primes, tt, kt = tables(log_n, count)
    lazy = residues((*lead, count, 1 << log_n), primes, factor=2)
    canon = lazy % torch.tensor(primes).view(-1, 1)
    fwd = emulate_cluster(lazy, tt, False)
    assert torch.equal(fwd, MX.ntt_forward_mxu(lazy, tt))
    assert torch.equal(fwd, TNTT.ntt_forward_plain(lazy, kt))
    inv = emulate_cluster(canon, tt, True)
    assert torch.equal(inv, MX.ntt_inverse_mxu(canon, tt))
    assert torch.equal(inv, TNTT.ntt_inverse_plain(canon, kt))
    assert torch.equal(emulate_cluster(lazy, tt, True), inv)


def test_cluster_schedule_matches_the_jax_kernel():
    """At 32768, on 2 limbs, the replay equals the JAX package's K2 (its
    Pallas kernel in interpret mode) forward on lazy input and inverse on
    canonical input; and at 65536 in clusters of 8 as well as 16 (the
    sweep's other size), both equal the plain version."""
    primes, tt, _ = tables(15, 2)
    lazy = residues((1, 2, 1 << 15), primes, factor=2)
    canon = lazy % torch.tensor(primes).view(-1, 1)
    jt = JMX.MxuNTTTables(15, [JModulus(p) for p in primes])
    pack = {"q": jnp.asarray(np.array(primes, np.uint32)),
            **{k: jnp.asarray(v) for k, v in jt.pack_prefixed().items()}}
    np.testing.assert_array_equal(
        emulate_cluster(lazy, tt, False).numpy(),
        np.asarray(ntt_forward_pallas_mxu(jnp.asarray(lazy.numpy().astype(np.uint32)), pack)))
    np.testing.assert_array_equal(
        emulate_cluster(canon, tt, True).numpy(),
        np.asarray(ntt_inverse_pallas_mxu(jnp.asarray(canon.numpy().astype(np.uint32)), pack)))
    primes, tt, _ = tables(16, 1)
    x = residues((1, 1, 1 << 16), primes, factor=2)
    want = MX.ntt_forward_mxu(x, tt), MX.ntt_inverse_mxu(x, tt)
    for log_c in MX.CL_SWEEP[16]:
        assert torch.equal(emulate_cluster(x, tt, False, log_c), want[0])
        assert torch.equal(emulate_cluster(x, tt, True, log_c), want[1])


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_cluster_plan_fits(log_n):
    """The plan at every cluster size the kernel takes: each CTA's shared
    bytes at or under WG_SMEM_LIMIT with 1 to CL_MAX_SLOTS chunks a
    warpgroup; a cluster size
    the H100 allows (16 non-portable); a CTA's data rows one wgmma tile (16
    or 32), the table's rows whole 64-row tiles for each warpgroup and K
    whole chunks of whole 64-byte blocks; every chunk a warpgroup streams a
    distinct (stage, tile, K chunk) inside its limb's table, the two
    warpgroups together every one once; the route's size among them; sizes
    outside it refused; and the clusters' rows (cid + it G) covering a
    launch's rows once."""
    for inverse in (False, True):
        for log_c in range(1, 6):
            p = MX.cl_plan(log_n, inverse, log_c)
            assert p["ok"] == (log_c in MX.CL_SWEEP[log_n]), (log_n, inverse, log_c)
            if not p["ok"]:
                continue
            assert p["smem"] <= MX.WG_SMEM_LIMIT and 1 <= p["slots"] <= MX.CL_MAX_SLOTS
            assert 2 <= p["C"] <= 16 and p["kc"] == MX.CL_KC
            assert p["R1"] in (16, 32) and p["R2"] in (16, 32)
            assert p["R1"] * p["C"] == p["N1"] and p["R2"] * p["C"] == p["N2"]
            assert p["M1"] % 128 == 0 and p["M2"] % 128 == 0
            assert p["kc"] % 64 == 0 and p["K1"] % p["kc"] == 0 and p["K2"] % p["kc"] == 0
            for name in ("v1", "v2", "out", "chunk"):
                assert p[name] % 128 == 0
            assert p["R1"] * p["R2"] % 16 == 0   # a pushed block, a multiple of 16 bytes
            seen = [chunk_of(p, g, v) for g in (0, 1) for v in range(p["per_row"])]
            want = [(s, mt, j) for s, M, K in ((1, p["M1"], p["K1"]), (2, p["M2"], p["K2"]))
                    for mt in range(M // 64) for j in range(K // p["kc"])]
            assert sorted(c[1:4] for c in seen) == sorted(want)
            for it, s, mt, j, off, nbytes in seen:
                assert off + nbytes <= 4 * (p["M1"] * p["K1"] if s == 1 else p["M2"] * p["K2"])
        with pytest.raises(ValueError, match="no cut"):
            ntt_mxu_cuda.cluster_plan(tables(log_n, 1)[1], inverse, 5)
    for rows, G in ((1, 1), (7, 3), (144, 8), (6, 6)):
        got = sorted(cid + it * G for cid in range(G) for it in range(-(-(rows - cid) // G)))
        assert got == list(range(rows))


def test_cluster_tables_and_refusals():
    """The route's tables at 32768: take slices them by limb (the planes,
    twiddles and scalars of limb 1 equal a one-limb build's), and none at
    16384; the wrapper refuses a CPU tensor, other tables, and degrees
    outside the cluster kernel's."""
    primes, tt, kt = tables(15, 2)
    one = MX.MxuNTTTables(15, [Modulus(primes[1])], "cpu")
    sub = tt.take([1])
    for a, b in zip(sub.cl_w + sub.wg_w, one.cl_w + one.wg_w):
        assert torch.equal(a, b)
    assert torch.equal(sub.wg_twiddle, one.wg_twiddle)
    assert torch.equal(sub.wg_scalars, one.wg_scalars)
    x = torch.zeros(1, 2, 1 << 15, dtype=torch.int64)
    for fn in (ntt_mxu_cuda.ntt_forward, ntt_mxu_cuda.ntt_inverse):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, tt)
        with pytest.raises(TypeError, match="MxuNTTTables"):
            fn(x, kt)
    for fn in (ntt_mxu_cuda.cluster_forward, ntt_mxu_cuda.cluster_inverse):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, tt, 3)
    small = MX.MxuNTTTables(14, [Modulus(p) for p in primes_for(14, 1)], "cpu")
    assert small.cl_w is None and small.take([0]).cl_w is None
    with pytest.raises(ValueError, match="cluster kernel serves"):
        ntt_mxu_cuda.cluster_plan(small, False)
    assert ntt_mxu_cuda.CL_INFO[:5] == ("threads", "smem", "regs", "local_bytes", "clusters")

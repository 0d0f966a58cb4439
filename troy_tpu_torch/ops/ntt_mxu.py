"""The negacyclic NTT as two exact modular matrix products on int8 digit
planes: the counterpart of troy_tpu/ops/ntt_mxu.py (K2's form).

With n = n1 n2 and the polynomial viewed as an (n1, n2) matrix X (row
major), the forward transform is

    A = W1 X        (n1 x n1 times n1 x n2; the negacyclic twist folded in)
    B = A o T       (elementwise twiddle)
    C = B W2        (n1 x n2 times n2 x n2)

with the bit reversals baked into W1 and W2, so that the flat C is exactly
the NTT order of ops/ntt.py: the two routes are bit-interchangeable.  The
inverse runs C = X W2i, B = C o Ti, A = W1i B, with n^-1 folded into W1i.

Each modular product is exact on int8 tensor cores: both operands, residues
below q < 2^30, are split into four balanced base-256 digits (three in
[-128, 127], the top one in [0, 64]); the 16 plane products accumulate in
int32, one sum per anti-diagonal s = i + j of the digit indices (7 sums);
the sums are recombined mod q by Shoup multiplies by 2^(8s) mod q, or, for a
contraction of at most 128 where P[2t] + 256 P[2t+1] still fits int32, by
2^(16t) mod q on four pair-folded sums.  A uniform +2^31 shift makes each
sum nonnegative for its Shoup multiply, and one constant per limb removes
the excess.

Two implementations of one function:

  * ntt_forward_mxu / ntt_inverse_mxu: the plain PyTorch version.  The plane
    products are float64 matrix products (every partial sum is an integer
    below 2^25, so exact on the CPU and the card); the recombination runs
    the kernel's u32 Shoup arithmetic in int64 (recombine_planes).  CPU
    tensors take it; it is the reference the kernel is held to.
  * ops/ntt_mxu_cuda.py: the hand-written Hopper kernels, which serve CUDA
    tensors when the NTT backend is "mxu" or "pallas_mxu"
    (ops/ntt.py:set_ntt_backend): csrc/ntt_mxu_wg.cu up to n = 2^WG_MAX_LOG_N
    (wgmma on unsigned byte planes, the wg_* tables below, a CTA a
    polynomial) and csrc/ntt_mxu_cluster.cu above (the same planes and
    tables, a polynomial a thread-block cluster: cl_plan).  The first form
    of the kernel (csrc/ntt_mxu.cu, on the balanced planes) stays as their
    yardstick at every degree.

MxuNTTTables holds the tables once, in the kernel's layout, on the default
split a = log2(n1) = log_n // 2: the digit planes of W1, W2, W1i, W2i with
the right-hand factors stored transposed (K contiguous for an mma B
operand) and every contraction padded to a multiple of 32 with zeros, the
twiddles as (w, w') u32 pairs, and one row of scalars per limb.
plain_tables reads them under the JAX package's names for the plain
version.  The JAX package's Pallas kernel also keeps twiddle-folded
weights (T16, Ti16, Tcorr, Ticorr); the port's kernel applies the twiddle
by one Shoup product and keeps none.  kernel_plan gives the kernel's
launches, shared-memory tiles and K chunks at each degree.

The redesigned kernels (csrc/ntt_mxu_wg.cu, csrc/ntt_mxu_cluster.cu) take
their own tables, wg_*: the unsigned bytes of each stage's table (W1, W2^T,
W2i^T, W1i, the wgmma A operand) in the core-matrix layout of wgmma
(wg_layout), the twiddles in the first stage's output order, and per limb
the recombination's constants (wg_scalar_rows: the Barrett shift and factor
of wg_barrett and 2^32, 2^48 mod q), at every degree.  wg_plan gives the
shared-memory plan of the kernel to n = 16384, cl_plan the cut of a stage
across a cluster above it: CTA r of C holds rows [r R, (r + 1) R) of each
stage's data operand (R = N / C) and streams the whole table through a ring
of 64-row chunks (cl_w, the tables in cl_layout: each chunk one contiguous
run), stage 1's values written into the planes of the CTA that holds their
row in stage 2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.modulus import Modulus
from ..utils import numth
from . import u32 as U

LIMB_BITS = 8
N_LIMBS = 4  # balanced base-256 digits covering [0, 2^30)
N_DIAGS = 2 * N_LIMBS - 1
PAIR_FOLD_MAX_K = 128  # max contraction length for the pairwise int32 fold
MIN_LOG_N = 8          # below, the JAX package keeps radix-2 (_MXU_MIN_LOG_N)
MAX_LOG_N = 17
MODULUS_BOUND = 1 << 30

_HALF = 1 << 31
_M32 = (1 << 32) - 1
# the largest |digit| of each plane of a residue below 2^30
DIGIT_BOUND = (128, 128, 128, 64)


def _balance_const(m: np.ndarray) -> np.ndarray:
    """(...,) host matrix (entries < 2^30) -> (4, ...) int8 balanced
    base-256 digit planes."""
    v = m.astype(np.int64)
    out = np.empty((N_LIMBS,) + m.shape, dtype=np.int8)
    for p in range(N_LIMBS):
        d = v & 0xFF
        carry = d >= 128
        d = d - (carry << 8)
        v = (v >> 8) + carry
        out[p] = d.astype(np.int8)
    assert (v == 0).all()
    return out


def split_balanced(x: torch.Tensor, q) -> torch.Tensor:
    """(...,) int64 residues in [0, 2q) -> (4, ...) int8 balanced digit planes
    of x mod q.  q broadcastable to x."""
    v = U.cond_sub(x, q)
    b0 = v & 255
    b1 = (v >> 8) & 255
    b2 = (v >> 16) & 255
    b3 = v >> 24
    c0 = (b0 >= 128).to(torch.int64)
    d0 = b0 - (c0 << 8)
    b1 = b1 + c0
    c1 = (b1 >= 128).to(torch.int64)
    d1 = b1 - (c1 << 8)
    b2 = b2 + c1
    c2 = (b2 >= 128).to(torch.int64)
    d2 = b2 - (c2 << 8)
    d3 = b3 + c2  # <= 64 for x < 2^30
    return torch.stack([d.to(torch.int8) for d in (d0, d1, d2, d3)])


def shoup_lazy(x: torch.Tensor, w, ws, q) -> torch.Tensor:
    """The u32 Shoup product x w - floor(x ws / 2^32) q in [0, 2q), for
    x < 2^32, w < q, ws = floor(w 2^32 / q), in int64: the high word of
    x ws is taken in two 16-bit halves of x, so nothing passes 2^63."""
    hi = ((x >> 16) * ws + (((x & 0xFFFF) * ws) >> 16)) >> 16
    return x * w - hi * q


def _diagonals(P: torch.Tensor) -> list:
    """(4, 4, ...) plane-pair partials P[i, j] -> the 7 anti-diagonal sums."""
    out = []
    for s in range(N_DIAGS):
        acc = None
        for i in range(max(0, s - N_LIMBS + 1), min(N_LIMBS, s + 1)):
            acc = P[i, s - i] if acc is None else acc + P[i, s - i]
        out.append(acc)
    return out


def recombine_diagonals(diags: list, pow16, pow16_shoup, pow8, pow8_shoup,
                        corr16, corr8, q, contraction: int) -> torch.Tensor:
    """The 7 anti-diagonal int32 sums (as int64) -> (sum_s D[s] 2^(8s)) mod q
    in [0, q), by the kernel's arithmetic: the pair fold for a contraction
    of at most PAIR_FOLD_MAX_K, else the 7 single diagonals; each sum
    shifted by +2^31 as a u32, Shoup-multiplied by its weight, the partial
    results kept in [0, 2q), and the shift's excess corr removed."""
    if contraction <= PAIR_FOLD_MAX_K:
        groups = [diags[0] + (diags[1] << 8), diags[2] + (diags[3] << 8),
                  diags[4] + (diags[5] << 8), diags[6]]
        weights, wshoups, corr = pow16, pow16_shoup, corr16
    else:
        groups = diags
        weights, wshoups, corr = pow8, pow8_shoup, corr8
    two_q = 2 * q
    acc = None
    for t, g in enumerate(groups):
        gu = (g + _HALF) & _M32  # the u32 view of g + 2^31: g + 2^31 in [0, 2^32)
        contrib = shoup_lazy(gu, weights[t], wshoups[t], q)  # [0, 2q)
        acc = contrib if acc is None else U.cond_sub(acc + contrib, two_q)
    return U.sub_mod(U.cond_sub(acc, q), corr, q)


def recombine_planes(P: torch.Tensor, pow16, pow16_shoup, pow8, pow8_shoup,
                     corr16, corr8, q, contraction: int) -> torch.Tensor:
    """P: (i, j, ...) int32 plane-pair partials (i, j = digit indices of the
    two operands) -> (sum_ij P 2^(8(i+j))) mod q, elementwise over the
    trailing shape.  pow16 / pow8: per-limb lists of 2^(16t) / 2^(8s) mod q
    (with Shoup words) broadcastable to the output; corr16 / corr8: the
    per-limb constant (sum_t 2^31 w_t) mod q removed after the uniform
    +2^31 shift.  `contraction` selects the pairwise fold (exact for <= 128)
    or the per-diagonal fallback."""
    return recombine_diagonals(_diagonals(P.to(torch.int64)), pow16, pow16_shoup, pow8,
                               pow8_shoup, corr16, corr8, q, contraction)


def _pow_tables(moduli: list[Modulus]):
    """Per-limb recombination constants: 2^(16t) and 2^(8s) mod q with Shoup
    words, plus the shift corrections corr = (sum_t 2^31 w_t) mod q for
    each weight set."""
    L = len(moduli)
    pow16 = np.zeros((L, N_LIMBS), dtype=np.uint32)
    pow16_sh = np.zeros((L, N_LIMBS), dtype=np.uint32)
    pow8 = np.zeros((L, N_DIAGS), dtype=np.uint32)
    pow8_sh = np.zeros((L, N_DIAGS), dtype=np.uint32)
    corr16 = np.zeros((L,), dtype=np.uint32)
    corr8 = np.zeros((L,), dtype=np.uint32)
    for l, mod in enumerate(moduli):
        q = mod.value
        for t in range(N_LIMBS):
            c = pow(2, 16 * t, q)
            pow16[l, t] = c
            pow16_sh[l, t] = (c << 32) // q
        for s in range(N_DIAGS):
            c = pow(2, 8 * s, q)
            pow8[l, s] = c
            pow8_sh[l, s] = (c << 32) // q
        corr16[l] = sum(_HALF * pow(2, 16 * t, q) for t in range(N_LIMBS)) % q
        corr8[l] = sum(_HALF * pow(2, 8 * s, q) for s in range(N_DIAGS)) % q
    return pow16, pow16_sh, pow8, pow8_sh, corr16, corr8


def diagonal_bounds(contraction: int) -> list[int]:
    """The largest |sum| of each anti-diagonal over a contraction of that
    length, from DIGIT_BOUND: every plane product of both operands' digits."""
    return [contraction * sum(DIGIT_BOUND[i] * DIGIT_BOUND[s - i]
                              for i in range(max(0, s - N_LIMBS + 1), min(N_LIMBS, s + 1)))
            for s in range(N_DIAGS)]


def check_int32(contraction: int):
    """Assert that every accumulator of a contraction of this length stays
    inside int32: each diagonal sum, and with the pair fold (contraction <=
    PAIR_FOLD_MAX_K) each folded sum P[2t] + 256 P[2t+1]."""
    d = diagonal_bounds(contraction)
    assert max(d) < _HALF, (contraction, d)
    if contraction <= PAIR_FOLD_MAX_K:
        folded = [d[0] + 256 * d[1], d[2] + 256 * d[3], d[4] + 256 * d[5], d[6]]
        assert max(folded) < _HALF, (contraction, folded)


def _powers(base: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint64)
    v = 1
    for i in range(count):
        out[i] = v
        v = v * base % q
    return out


def _limb_matrices(log_n: int, a: int, q: int) -> tuple:
    """W1, T, W2, W1i, Ti, W2i of one modulus (uint32), as the JAX tables
    hold them, built from power tables: every entry is the same residue."""
    n = 1 << log_n
    n1, n2 = 1 << a, 1 << (log_n - a)
    brv_a = np.array([numth.reverse_bits(i, a) for i in range(n1)], dtype=np.int64)
    brv_b = np.array([numth.reverse_bits(i, log_n - a) for i in range(n2)], dtype=np.int64)
    psi = numth.try_minimal_primitive_root(2 * n, q)
    ipsi = numth.invert_mod(psi, q)
    w, iw = psi * psi % q, ipsi * ipsi % q
    n_inv = numth.invert_mod(n, q)
    qq = np.uint64(q)
    pw, piw = _powers(w, n, q), _powers(iw, n, q)      # w, iw have order n
    ppsi, pipsi = _powers(psi, n2, q), _powers(ipsi, n2, q)
    i1 = np.arange(n1, dtype=np.int64)
    i2 = np.arange(n2, dtype=np.int64)
    # w^n2 has order n1 and w^n1 order n2: exponents taken mod n
    w1 = pw[(n2 * brv_a[:, None] * i1[None, :]) % n] * _powers(pow(psi, n2, q), n1, q)[None, :] % qq
    t = pw[(brv_a[:, None] * i2[None, :]) % n] * ppsi[None, :] % qq
    w2 = pw[(n1 * i2[:, None] * brv_b[None, :]) % n]
    w2i = piw[(n1 * brv_b[:, None] * i2[None, :]) % n]
    ti = piw[(i2[None, :] * brv_a[:, None]) % n] * pipsi[None, :] % qq
    c = _powers(pow(ipsi, n2, q), n1, q) * np.uint64(n_inv) % qq
    w1i = c[:, None] * piw[(n2 * i1[:, None] * brv_a[None, :]) % n] % qq
    return tuple(m.astype(np.uint32) for m in (w1, t, w2, w1i, ti, w2i))


def _shoup_rows(m: np.ndarray, moduli: list[Modulus]) -> np.ndarray:
    out = np.zeros_like(m, dtype=np.uint32)
    for l, mod in enumerate(moduli):
        out[l] = ((m[l].astype(np.uint64) << np.uint64(32)) // np.uint64(mod.value)).astype(np.uint32)
    return out


def _pad_k(planes: np.ndarray) -> np.ndarray:
    """Zero-pad the last (contraction) axis to a multiple of 32, the
    depth of one m16n8k32 product."""
    k = planes.shape[-1]
    kp = -(-k // 32) * 32
    if kp == k:
        return np.ascontiguousarray(planes)
    out = np.zeros(planes.shape[:-1] + (kp,), planes.dtype)
    out[..., :k] = planes
    return out


SCALAR_SLOTS = 32  # u32 words a limb's kernel_scalars row holds (25 used)


def _kernel_scalar_rows(moduli: list[Modulus]) -> np.ndarray:
    """(L, 32) u32: q, pow16[4], pow16_shoup[4], corr16, pow8[7],
    pow8_shoup[7], corr8, zeros: the kernel's per-limb constants."""
    pow16, pow16_sh, pow8, pow8_sh, corr16, corr8 = _pow_tables(moduli)
    q = np.array([m.value for m in moduli], dtype=np.uint32)
    stacked = np.concatenate([q[:, None], pow16, pow16_sh, corr16[:, None], pow8, pow8_sh,
                              corr8[:, None]], axis=1)
    out = np.zeros((len(moduli), SCALAR_SLOTS), np.uint32)
    out[:, :stacked.shape[1]] = stacked
    return out


# The kernel's plan (csrc/ntt_mxu.cu): a stage is out[r][c] = sum_k A[r][k]
# Bt[c][k] with a data operand and a table operand; a CTA holds its block
# of the data operand's digit planes in shared memory, split from the int64
# values, and streams the table operand's planes in K chunks (the whole K
# when it fits: the table is then loaded once).  Rows of both are padded by
# SMEM_PAD bytes, so that the 8 row groups of a fragment load hit distinct
# banks.
SMEM_LIMIT = 232448 - 256   # the H100's 227 KB a CTA, less the static scalars
SMEM_PAD = 16
ONE_LAUNCH_MAX_LOG_N = 15   # one CTA a polynomial up to n = 32768
TWO_LAUNCH_BLOCK = 32       # above, data rows (left) or columns (right) a CTA


def _split_factors(log_n: int) -> tuple[int, int]:
    """(n1, n2) of the default split a = log_n // 2."""
    a = log_n // 2
    return 1 << a, 1 << (log_n - a)


def _stage_bytes(data_rows: int, kp: int, w_rows: int, kc: int) -> int:
    """Shared bytes of a stage: 4 planes of the data block (data_rows x kp)
    and of one K chunk of the table (w_rows x kc), rows padded."""
    return 4 * data_rows * (kp + SMEM_PAD) + 4 * w_rows * (kc + SMEM_PAD)


def _stage_plan(data_rows: int, w_rows: int, k: int, two_launch: bool) -> dict:
    kp = max(32, k)
    block = min(TWO_LAUNCH_BLOCK, data_rows) if two_launch else data_rows
    kc = kp
    while _stage_bytes(block, kp, w_rows, kc) > SMEM_LIMIT:
        kc //= 2
        if kc < 32:
            raise ValueError(f"[ntt_mxu] no stage plan fits shared memory (k = {k})")
    return dict(k=k, kp=kp, kc=kc, block=block, data_rows=data_rows, w_rows=w_rows,
                smem=_stage_bytes(block, kp, w_rows, kc), fold=k <= PAIR_FOLD_MAX_K)


def kernel_plan(log_n: int) -> dict:
    """The kernel's launches at degree 2^log_n: 'launches' 1 (one CTA a
    polynomial runs both stages, the first stage's result through the
    output row) up to ONE_LAUNCH_MAX_LOG_N, else 2 (a launch a stage, through
    a scratch tensor; a CTA a block of TWO_LAUNCH_BLOCK data rows or
    columns).  'left': the stage W X (K = n1; the data is the B operand,
    its columns the rows of Bt), 'right': X W (K = n2; the data is the A
    operand).  Each: k, its padding kp, the K chunk kc of the table, the
    data block, shared bytes, and whether the recombination folds pairs."""
    n1, n2 = _split_factors(log_n)
    two = log_n > ONE_LAUNCH_MAX_LOG_N
    return dict(n1=n1, n2=n2, launches=2 if two else 1,
                left=_stage_plan(n2, n1, n1, two), right=_stage_plan(n1, n2, n2, two))


# ---------------------------------------------------------------------------
# The redesigned kernel (csrc/ntt_mxu_wg.cu): its plan, bounds and tables.
# Every stage is D[m][n] = sum_k W[m][k] V[n][k], the table W the wgmma A
# operand (M rows, zero-padded to 64, K to 32), the data V the B operand:
#   forward  stage 1 W1 (M = n1), V = X^T (N = n2); stage 2 W2^T (M = n2),
#            V = stage 1's output (N = n1);
#   inverse  stage 1 W2i^T (M = n2), V = X (N = n1); stage 2 W1i (M = n1),
#            V = stage 1's output (N = n2).
# ---------------------------------------------------------------------------

WG_MAX_LOG_N = 14                # above, the cluster kernel (csrc/ntt_mxu_cluster.cu)
WG_SMEM_LIMIT = 232448 - 1024    # ntt_mxu_wg.cu kMaxSmem
WG_SCALAR_SLOTS = 8              # q, mu, shift, c4, c6, 0, 0, 0


def wg_plan(log_n: int, inverse: bool) -> dict:
    """ntt_mxu_wg.cu:make_plan: stage 1's table M1 x M1 (padded M1p x K1p)
    and data N1 rows, stage 2's M2 = N1 and N2 = M1; the bytes of the two
    tables (t1, t2), the two operand plane sets (b1, b2) and the staging row
    of the next polynomial's int64 values; 'resident' when all of them fit
    (the tables then load once a CTA), else one table buffer reloaded before
    each stage and no staging row."""
    n1, n2 = _split_factors(log_n)
    M1, N1 = (n2, n1) if inverse else (n1, n2)
    M2, N2 = N1, M1
    K1p, M1p, K2p, M2p = max(32, M1), max(64, M1), max(32, M2), max(64, M2)
    t1, t2 = 4 * M1p * K1p, 4 * M2p * K2p
    b1, b2 = 4 * N1 * K1p, 4 * N2 * K2p
    full = t1 + t2 + b1 + b2 + 8 * n1 * n2
    resident = full <= WG_SMEM_LIMIT
    return dict(n1=n1, n2=n2, M1=M1, N1=N1, M2=M2, N2=N2, K1p=K1p, M1p=M1p, K2p=K2p,
                M2p=M2p, t1=t1, t2=t2, b1=b1, b2=b2, staging=8 * n1 * n2 if resident else 0,
                resident=resident,
                smem=full if resident else max(t1, t2) + b1 + b2,
                nt1=32 if N1 % 32 == 0 else 16, nt2=32 if N2 % 32 == 0 else 16)


# The cluster kernel (csrc/ntt_mxu_cluster.cu) at n = 32768 .. 131072: a
# polynomial a cluster of 2^log_c CTAs, each stage cut by the data's rows.
CL_MIN_LOG_N = WG_MAX_LOG_N + 1
CL_BLOCK = 4 * 64 * 64           # a table block: 64 rows x 64 bytes of K, 4 planes
CL_KC = 128                      # K bytes of a table chunk (4 steps of 32)
CL_MAX_SLOTS = 4                 # chunks a warpgroup's ring holds
CL_MAX_CLUSTER = 16              # the H100's largest cluster (8 is portable)
CL_TILES = (16, 32)              # a CTA's data rows: one wgmma tile (N)
CL_SWEEP = {15: (3,), 16: (3, 4), 17: (4,)}  # the cluster sizes (log2 C) the kernel takes


def cl_plan(log_n: int, inverse: bool, log_c: int | None = None) -> dict:
    """ntt_mxu_cluster.cu:make_plan at degree 2^log_n (WG_MAX_LOG_N <
    log_n <= MAX_LOG_N) in clusters of C = 2^log_c CTAs (default the
    smallest of CL_SWEEP): stage 1's table M1 x K1 (K1 = M1) against N1
    data rows, R1 = N1 / C a CTA; stage 2's M2 = K2 = N1, N2 = M1, R2 = N2 / C.  Each CTA's
    shared memory: its stage 1 and stage 2 operand planes v1 = 4 R1 K1,
    v2 = 4 R2 K2 (V2 in core matrices by K block, then row group: each
    CTA's block of it one run); stage 1's outgoing tiles, out = 4 M1 R1
    (each tile's values as blocks of their destination CTAs, pushed by bulk
    copies); and the two warpgroups' rings of 'slots' chunks each (as many
    as fit, to CL_MAX_SLOTS), a chunk 64 table rows x kc = CL_KC bytes of
    K.  'per_row': the chunks a warpgroup
    streams a polynomial (it takes every other 64-row tile of each stage);
    'ok' when the cut is one the kernel takes."""
    log_c = CL_SWEEP[log_n][0] if log_c is None else log_c
    n1, n2 = _split_factors(log_n)
    C = 1 << log_c
    M1, N1 = (n2, n1) if inverse else (n1, n2)
    M2, N2 = N1, M1
    K1, K2 = M1, M2
    R1, R2 = N1 // C, N2 // C
    v1, v2, out = 4 * R1 * K1, 4 * R2 * K2, 4 * M1 * R1
    kc = CL_KC
    slots = max(0, min(CL_MAX_SLOTS, (WG_SMEM_LIMIT - v1 - v2 - out) // (512 * kc)))
    ok = (2 <= C <= CL_MAX_CLUSTER and R1 in CL_TILES and R2 in CL_TILES and slots >= 1
          and M1 % 128 == 0 and M2 % 128 == 0 and K1 % kc == 0 and K2 % kc == 0)
    return dict(n1=n1, n2=n2, C=C, M1=M1, N1=N1, K1=K1, R1=R1, M2=M2, N2=N2, K2=K2, R2=R2,
                v1=v1, v2=v2, out=out, kc=kc, slots=slots,
                chunk=256 * kc, smem=2 * slots * 256 * kc + v1 + v2 + out,
                per_row=(M1 // 128) * (K1 // kc) + (M2 // 128) * (K2 // kc), ok=ok)


def cl_layout(m: np.ndarray) -> np.ndarray:
    """(L, M, K) u32 table -> (L, 4 M K) u8, the cluster kernel's layout: the
    64 x 64 blocks (64 rows, 64 bytes of K; M and K multiples of 64) by row
    tile, then K, each block's 4 unsigned byte planes together, each plane
    in wgmma's K-major core-matrix order (row group, K block of 16, row in
    group, byte).  Element (p, r, k) at ((r / 64 (K / 64) + k / 64) 4 + p)
    4096 + (r % 64 / 8) 512 + (k % 64 / 16) 128 + (r % 8) 16 + k % 16: every
    chunk of a row tile, any multiple of 64 deep, is one contiguous run."""
    L, M, K = m.shape
    planes = np.ascontiguousarray(m, dtype="<u4").view(np.uint8).reshape(
        L, M // 64, 8, 8, K // 64, 4, 16, N_LIMBS)
    return np.ascontiguousarray(planes.transpose(0, 1, 4, 7, 2, 5, 3, 6)).reshape(L, -1)


def byte_bounds(q: int) -> list[int]:
    """The largest value of each byte of a residue in [0, q)."""
    m = q - 1
    return [255 if m >> (8 * (i + 1)) else (m >> (8 * i)) & 255 for i in range(N_LIMBS)]


def wg_diagonal_bounds(contraction: int, q: int) -> list[int]:
    """The largest sum of each diagonal s = i + j of the unsigned plane
    products over a contraction of that length, both operands in [0, q)."""
    b = byte_bounds(q)
    return [contraction * sum(b[i] * b[s - i]
                              for i in range(max(0, s - N_LIMBS + 1), min(N_LIMBS, s + 1)))
            for s in range(N_DIAGS)]


def wg_barrett(q: int, contraction: int) -> tuple[int, int, list[int]]:
    """The recombination's constants for modulus q and contractions up to
    `contraction`: the shift s and mu = floor(2^(s + 32) / q) of its Barrett
    step, and c4 = 2^32 mod q, c6 = 2^48 mod q.  With v = sum_{s<4} P_s
    2^(8s) + c4 (P4 + 2^8 P5) + c6 P6 (P4 + 2^8 P5 below 2^32, as c4 2^8 =
    2^40 mod q) below 2^(s + 32) and 2^s < q, qhat = umulhi(v >> s, mu)
    leaves v - qhat q in [0, 3q); every diagonal stays below 2^31 (all
    asserted)."""
    d = wg_diagonal_bounds(contraction, q)
    assert max(d) < _HALF and d[4] + (d[5] << 8) <= _M32, (q, contraction, d)
    c = [pow(2, 32, q), pow(2, 48, q)]
    vmax = sum(d[s] << (8 * s) for s in range(4)) + (d[4] + (d[5] << 8)) * c[0] + d[6] * c[1]
    shift = max(0, vmax.bit_length() - 32)
    mu = (1 << (shift + 32)) // q
    assert (1 << shift) < q and mu < 1 << 32 and 3 * q <= _M32, (q, contraction, shift)
    return shift, mu, c


def wg_scalar_rows(moduli: list[Modulus], contraction: int) -> np.ndarray:
    """(L, 8) u32: q, mu, shift, c4, c6, 0, 0, 0 a limb (wg_barrett)."""
    out = np.zeros((len(moduli), WG_SCALAR_SLOTS), np.uint32)
    for l, mod in enumerate(moduli):
        shift, mu, c = wg_barrett(mod.value, contraction)
        out[l, :5] = [mod.value, mu, shift, *c]
    return out


def wg_layout(m: np.ndarray) -> np.ndarray:
    """(L, M, K) u32 table -> (L, 4 Mp Kp) u8: its 4 unsigned byte planes,
    zero-padded to Mp = max(64, M) rows and Kp = max(32, K), each in wgmma's
    K-major core-matrix order (row group, K block of 16, row in group, byte):
    element (p, r, k) at p Mp Kp + ((r / 8) (Kp / 16) + k / 16) 128 + (r % 8)
    16 + k % 16."""
    L, M, K = m.shape
    Mp, Kp = max(64, M), max(32, K)
    planes = np.zeros((L, N_LIMBS, Mp, Kp), np.uint8)
    planes[:, :, :M, :K] = np.ascontiguousarray(m, dtype="<u4").view(np.uint8).reshape(
        L, M, K, N_LIMBS).transpose(0, 3, 1, 2)
    return np.ascontiguousarray(planes.reshape(L, N_LIMBS, Mp // 8, 8, Kp // 16, 16)
                                .transpose(0, 1, 2, 4, 3, 5)).reshape(L, -1)


def wg_unlayout(w: torch.Tensor, M: int, K: int) -> torch.Tensor:
    """wg_layout's inverse: (L, 4 Mp Kp) u8 -> (L, 4, M, K) byte planes."""
    Mp, Kp = max(64, M), max(32, K)
    planes = w.reshape(-1, N_LIMBS, Mp // 8, Kp // 16, 8, 16).permute(0, 1, 2, 4, 3, 5)
    return planes.reshape(-1, N_LIMBS, Mp, Kp)[:, :, :M, :K]


class MxuNTTTables:
    """Per-(n, moduli) tables of the matrix-product transform on one device,
    in the kernel's layout (u32 bit patterns as int32, planes int8):

      kernel_w (fwd_left, fwd_right, inv_left, inv_right): the digit planes
        of W1 (4, L, n1, n1p), W2 transposed (4, L, n2, n2p), W1i, W2i
        transposed, the contraction padded to n1p, n2p = max(32, .);
      kernel_twiddle (2, L, n1, n2, 2): (T, T') and (Ti, Ti') pairs;
      kernel_scalars (L, 32): _kernel_scalar_rows.

    The redesigned kernels' (csrc/ntt_mxu_wg.cu to n = 2^WG_MAX_LOG_N,
    csrc/ntt_mxu_cluster.cu above), at every degree:

      wg_w (forward stage 1, stage 2, inverse stage 1, stage 2): W1, W2^T,
        W2i^T, W1i as (L, 4 Mp Kp) u8 (wg_layout);
      wg_twiddle (2, L, 2n): T as (n1, n2, 2) and Ti transposed, (n2, n1,
        2), (w, w') u32 pairs in each first stage's output order;
      wg_scalars (L, 8): wg_scalar_rows for the contraction n2.

    Above n = 2^WG_MAX_LOG_N also the cluster kernel's planes (else None):

      cl_w (forward stage 1, stage 2, inverse stage 1, stage 2): W1, W2^T,
        W2i^T, W1i as (L, 4 M K) u8 (cl_layout).

    The plain version reads them through plain_tables."""

    _cache: dict = {}  # (log_n, q) -> the six uint32 matrices

    def __init__(self, log_n: int, moduli: list[Modulus], device):
        if not MIN_LOG_N <= log_n <= MAX_LOG_N:
            raise ValueError(f"[MxuNTTTables] n = 2^{log_n} outside [2^{MIN_LOG_N}, "
                             f"2^{MAX_LOG_N}]")
        self.log_n = log_n
        self.n = 1 << log_n
        self.a = log_n // 2
        self.b = log_n - self.a
        self.n1, self.n2 = _split_factors(log_n)
        self.moduli = list(moduli)
        self.device = torch.device(device)
        self.plan = kernel_plan(log_n)
        check_int32(self.n1)
        check_int32(self.n2)
        mats = []
        for mod in self.moduli:
            key = (log_n, mod.value)
            if key not in self._cache:
                self._cache[key] = _limb_matrices(log_n, self.a, mod.value)
            mats.append(self._cache[key])
        W1, T, W2, W1i, Ti, W2i = (np.stack(m) for m in zip(*mats))
        kernel_w = [_pad_k(_balance_const(W1)), _pad_k(_balance_const(W2).swapaxes(-1, -2)),
                    _pad_k(_balance_const(W1i)), _pad_k(_balance_const(W2i).swapaxes(-1, -2))]
        twiddle = np.stack([np.stack([T, _shoup_rows(T, self.moduli)], axis=-1),
                            np.stack([Ti, _shoup_rows(Ti, self.moduli)], axis=-1)])
        self.kernel_w = tuple(torch.from_numpy(w).to(self.device) for w in kernel_w)
        self.kernel_twiddle = torch.from_numpy(twiddle.view(np.int32)).to(self.device)
        self.kernel_scalars = torch.from_numpy(
            _kernel_scalar_rows(self.moduli).view(np.int32)).to(self.device)
        mats = (W1, W2.swapaxes(-1, -2), W2i.swapaxes(-1, -2), W1i)
        self.wg_w = tuple(torch.from_numpy(wg_layout(m)).to(self.device) for m in mats)
        tw = np.stack([twiddle[0].reshape(len(self.moduli), -1),
                       twiddle[1].swapaxes(1, 2).reshape(len(self.moduli), -1)])
        self.wg_twiddle = torch.from_numpy(tw.view(np.int32)).to(self.device)
        self.wg_scalars = torch.from_numpy(
            wg_scalar_rows(self.moduli, self.n2).view(np.int32)).to(self.device)
        self.cl_w = (tuple(torch.from_numpy(cl_layout(m)).to(self.device) for m in mats)
                     if log_n >= CL_MIN_LOG_N else None)

    @property
    def size(self) -> int:
        return len(self.moduli)

    @property
    def max_modulus(self) -> int:
        return max(m.value for m in self.moduli)

    def take(self, idx: list[int]) -> "MxuNTTTables":
        """The tables of the limb rows idx (the limb axis of every table)."""
        out = object.__new__(MxuNTTTables)
        for k in ("log_n", "n", "a", "b", "n1", "n2", "device", "plan"):
            setattr(out, k, getattr(self, k))
        out.moduli = [self.moduli[i] for i in idx]
        ix = torch.tensor(idx, dtype=torch.int64, device=self.device)
        out.kernel_w = tuple(w[:, ix].contiguous() for w in self.kernel_w)
        out.kernel_twiddle = self.kernel_twiddle[:, ix].contiguous()
        out.kernel_scalars = self.kernel_scalars[ix].contiguous()
        out.wg_w = tuple(w[ix].contiguous() for w in self.wg_w)
        out.wg_twiddle = self.wg_twiddle[:, ix].contiguous()
        out.wg_scalars = self.wg_scalars[ix].contiguous()
        out.cl_w = None if self.cl_w is None else tuple(w[ix].contiguous() for w in self.cl_w)
        return out


def plain_tables(t: MxuNTTTables) -> dict:
    """t's tables under the JAX package's MxuNTTTables names, read from the
    kernel's layout: the planes W1, W2, W1i, W2i (4, L, ., .) int8 (views);
    T, T_shoup, Ti, Ti_shoup (L, n1, n2), q (L,), pow16, pow16_shoup (L, 4),
    pow8, pow8_shoup (L, 7), corr16, corr8 (L,) as int64."""
    w = t.kernel_w
    tw = t.kernel_twiddle.to(torch.int64) & _M32
    sc = t.kernel_scalars.to(torch.int64) & _M32
    return dict(W1=w[0][..., :t.n1], W2=w[1][..., :t.n2].transpose(-1, -2),
                W1i=w[2][..., :t.n1], W2i=w[3][..., :t.n2].transpose(-1, -2),
                T=tw[0, ..., 0], T_shoup=tw[0, ..., 1], Ti=tw[1, ..., 0], Ti_shoup=tw[1, ..., 1],
                q=sc[:, 0], pow16=sc[:, 1:5], pow16_shoup=sc[:, 5:9], corr16=sc[:, 9],
                pow8=sc[:, 10:17], pow8_shoup=sc[:, 17:24], corr8=sc[:, 24])


# ---------------------------------------------------------------------------
# Plain PyTorch versions.  x has shape (..., L, n); t is an MxuNTTTables.
# ---------------------------------------------------------------------------

def _limb_col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(L,) -> broadcastable to (..., L, r, c) of ndim dimensions."""
    return v.view((1,) * (ndim - 3) + (-1, 1, 1))


def _recombine(P: torch.Tensor, t: dict, ndim: int, contraction: int) -> torch.Tensor:
    col = lambda v: _limb_col(v, ndim)
    return recombine_planes(
        P, [col(t["pow16"][:, k]) for k in range(N_LIMBS)],
        [col(t["pow16_shoup"][:, k]) for k in range(N_LIMBS)],
        [col(t["pow8"][:, k]) for k in range(N_DIAGS)],
        [col(t["pow8_shoup"][:, k]) for k in range(N_DIAGS)],
        col(t["corr16"]), col(t["corr8"]), col(t["q"]), contraction)


def _plane_products(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """The 16 plane products, exact in float64 (|partial| < 2^25), as int64."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def _modular_matmul_left(Wl: torch.Tensor, x: torch.Tensor, t: dict) -> torch.Tensor:
    """C[..., L, a, c] = sum_b W[L, a, b] x[..., L, b, c] mod q.
    Wl: (4, L, a, b) int8 planes; x: (..., L, b, c) int64 in [0, 2q);
    t: plain_tables."""
    xl = split_balanced(x, _limb_col(t["q"], x.dim()))
    P = _plane_products(Wl, xl, "ilab,j...lbc->ij...lac")
    return _recombine(P, t, x.dim(), x.shape[-2])


def _modular_matmul_right(x: torch.Tensor, Wl: torch.Tensor, t: dict) -> torch.Tensor:
    """C[..., L, a, d] = sum_c x[..., L, a, c] W[L, c, d] mod q."""
    xl = split_balanced(x, _limb_col(t["q"], x.dim()))
    P = _plane_products(Wl, xl, "ilcd,j...lac->ij...lad")
    return _recombine(P, t, x.dim(), x.shape[-1])


def ntt_forward_mxu(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Forward negacyclic NTT, bit-identical to ops/ntt.ntt_forward_plain.
    x: (..., L, n) int64 in [0, 2q) -> [0, q) NTT order."""
    p = plain_tables(t)
    X = x.reshape(*x.shape[:-1], t.n1, t.n2)
    A = _modular_matmul_left(p["W1"], X, p)
    B = A * p["T"] % _limb_col(p["q"], A.dim())
    return _modular_matmul_right(B, p["W2"], p).reshape(x.shape)


def ntt_inverse_mxu(x: torch.Tensor, t: MxuNTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-identical to ops/ntt.ntt_inverse_plain.
    x: (..., L, n) int64 in [0, 2q) NTT order -> [0, q) natural order."""
    p = plain_tables(t)
    X = x.reshape(*x.shape[:-1], t.n1, t.n2)
    C = _modular_matmul_right(X, p["W2i"], p)
    B = C * p["Ti"] % _limb_col(p["q"], C.dim())
    return _modular_matmul_left(p["W1i"], B, p).reshape(x.shape)

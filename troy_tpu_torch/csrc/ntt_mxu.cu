// Negacyclic NTT / INTT as two modular matrix products on int8 tensor cores,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel K2 of troy_tpu/ops/ntt_pallas.py: _fwd_kernel_mxu /
// _inv_kernel_mxu (launcher _ntt_pallas_mxu), the transform the JAX package
// runs under set_ntt_backend("pallas_mxu") (bench.py's setting).  The same
// function as the butterfly kernels of ntt.cu (K1): output in [0, q), in
// the NTT order of troy_tpu/ops/ntt.py, bit for bit.
//
// What it computes (ops/ntt_mxu.py).  With n = n1 n2 (n1 = 2^(log_n / 2))
// and the polynomial a row-major (n1, n2) matrix X, the forward transform
// is A = W1 X, then B = A o T, then C = B W2; the inverse runs
// C = X W2i, B = C o Ti, A = W1i B (n^-1 folded into W1i).  Each product
// is exact mod q < 2^30: both operands are split into four balanced
// base-256 digit planes (int8), the 16 plane products accumulate in int32,
// one accumulator per anti-diagonal s = i + j of the digit indices (7),
// and the 7 sums are recombined mod q by Shoup multiplies by 2^(8s) mod q,
// or, for a contraction of at most 128, by 2^(16t) mod q on the four sums
// P[2t] + 256 P[2t+1] (exact in int32 there: ops/ntt_mxu.py:check_int32),
// after a uniform +2^31 shift whose excess one per-limb constant removes.
//
// A stage is out[r][c] = sum_k A[r][k] Bt[c][k] (mma's "row.col" operands,
// both K contiguous).  Stage "left" (W X, K = n1): A is the table W (rows
// of W1 or W1i), Bt the data's columns.  Stage "right" (X W, K = n2): A is
// the data's rows, Bt the table stored transposed (W2 or W2i, ops/ntt_mxu.py
// kernel_w).  The plane products are mma.sync.aligned.m16n8k32.row.col.s32
// .s8.s8.s32: a warp owns a 16 x 16 output tile, 7 x 2 accumulator
// fragments, and per 32-deep K step loads 4 A and 8 B fragments from shared
// memory and issues 32 products.
//
// Design, simple first:
//   * n <= 32768: one CTA of 256 threads a (row, limb) polynomial, one
//     launch a transform, as the Pallas kernel takes one grid step a row.
//     The CTA splits its polynomial into digit planes in shared memory,
//     in the first stage's layout (cond_sub first: input in [0, 2q)), loads
//     the stage's table planes beside it (in K chunks where they do not
//     fit: the right stage at n = 32768), runs the stage, applies the
//     twiddle to each recombined value by a Shoup multiply (T, T' pairs),
//     and writes the stage's result into its output row; after a barrier it
//     reads that row back, split into the second stage's layout, and writes
//     the transform over it.  At n = 8192: data planes 36-40 KB and table
//     planes 20-74 KB a stage, 110.6 KB at most, so two CTAs an SM.
//   * n = 65536 and 131072 (a polynomial's planes exceed shared memory):
//     two launches of the same stage code through a scratch tensor, a CTA
//     a (polynomial, block of 32 data rows or columns), the table streamed
//     in K chunks.
//   * The shared rows are padded by 16 bytes, so the 8 row groups of a
//     fragment load fall on distinct banks.
// Bound: at the keyswitch digits (16, 6, 7) and n = 8192, 16 plane products
// a stage are 50.3 M int8 operations a polynomial (17.1 us at 1979 TOPS),
// beside 26.3 us of device memory; the digit split and the recombination
// add about 100 int32 operations a value.  wgmma, TMA and tables shared
// across rows are later work (ROADMAP B).
//
// Layout: input (rows, n) int64 contiguous and 16-byte aligned, the limb of
// row r equal to r % L.  Tables (ops/ntt_mxu.py:MxuNTTTables): the table
// planes (4, L, rows, kp) int8 (kp: the contraction padded to a multiple of
// 32 with zeros), twiddles (L, n1, n2, 2) u32 (w, w') pairs, scalars
// (L, 32) u32 (_kernel_scalar_rows).  Kernels never allocate.

#include <cstdint>

#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace troy {
namespace mxu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 16;           // bytes a shared row is padded by
constexpr int kScalarSlots = 32;   // u32 words of a limb's scalar row
constexpr int kFoldMaxK = 128;     // ops/ntt_mxu.py:PAIR_FOLD_MAX_K
constexpr uint32_t kHalf = 0x80000000u;

// One stage of one polynomial: out[r][c] = sum_k A[r][k] Bt[c][k].
struct StageArgs {
  const int64_t* src;       // the data: n values of the (n1, n2) matrix
  int64_t* dst;             // the stage's output row (n values)
  const int8_t* w;          // the table planes (4, L, w_rows, kp)
  const uint32_t* twiddle;  // (n1, n2, 2) of this limb, or null
  int L, l, n1, n2;
  int left;                 // 1: W X (data is Bt), 0: X W (data is A)
  int k, kp, kc;            // contraction, padded, table chunk
  int base, block;          // the data block: first and count of its rows
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// v in [0, 2q) -> the balanced base-256 digits of v mod q (three in
// [-128, 127], the top one in [0, 64]), each as its int8 byte.
__device__ __forceinline__ void split_digits(uint32_t v, uint32_t q,
                                             uint32_t (&d)[4]) {
  v = v >= q ? v - q : v;
  const int b0 = v & 255, c0 = b0 >= 128;
  const int b1 = ((v >> 8) & 255) + c0, c1 = b1 >= 128;
  const int b2 = ((v >> 16) & 255) + c1, c2 = b2 >= 128;
  d[0] = static_cast<uint32_t>(b0 - (c0 << 8)) & 255;
  d[1] = static_cast<uint32_t>(b1 - (c1 << 8)) & 255;
  d[2] = static_cast<uint32_t>(b2 - (c2 << 8)) & 255;
  d[3] = (v >> 24) + c2;
}

// The block of the data operand into shared memory, 4 planes of `rows`
// rows of kp digits (row stride ld), zeros at k >= K.  Left stage (data is
// Bt): row i is column base + i of the matrix, Bt[i][k] = src[k n2 + base +
// i]; right stage (data is A): row i is matrix row base + i.  A thread
// takes 4 consecutive k of one row and stores one word a plane.
__device__ void load_data(uint8_t* D, int ld, const StageArgs& a, uint32_t q) {
  const int groups = a.kp / 4;
  const size_t plane = static_cast<size_t>(a.block) * ld;
  for (int item = threadIdx.x; item < a.block * groups; item += blockDim.x) {
    int i, g;
    if (a.left) {  // neighbouring threads on neighbouring columns
      i = item % a.block;
      g = item / a.block;
    } else {       // neighbouring threads on neighbouring k of one row
      g = item % groups;
      i = item / groups;
    }
    uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * g + j;
      if (k < a.k) {
        const int64_t v = a.left ? a.src[static_cast<size_t>(k) * a.n2 + a.base + i]
                                 : a.src[static_cast<size_t>(a.base + i) * a.n2 + k];
        uint32_t d[4];
        split_digits(static_cast<uint32_t>(v), q, d);
#pragma unroll
        for (int p = 0; p < 4; ++p) word[p] |= d[p] << (8 * j);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<uint32_t*>(D + p * plane + static_cast<size_t>(i) * ld + 4 * g) =
          word[p];
  }
}

// Columns [k0, k0 + kc) of the limb's table planes (w_rows rows each) into
// shared memory (row stride ld), 16 bytes a load.
__device__ void load_table(uint8_t* Wsm, int ld, const StageArgs& a, int w_rows,
                           int k0) {
  const int vecs = a.kc / 16;
  const int per_plane = w_rows * vecs;
  for (int item = threadIdx.x; item < 4 * per_plane; item += blockDim.x) {
    const int p = item / per_plane, rem = item % per_plane;
    const int r = rem / vecs, v = rem % vecs;
    const int4* s = reinterpret_cast<const int4*>(
        a.w + ((static_cast<size_t>(p) * a.L + a.l) * w_rows + r) * a.kp + k0 + 16 * v);
    *reinterpret_cast<int4*>(Wsm + static_cast<size_t>(p) * w_rows * ld +
                             static_cast<size_t>(r) * ld + 16 * v) = *s;
  }
}

// x w mod q in [0, q) for x < 2^32, w < q.
__device__ __forceinline__ uint32_t shoup_full(uint32_t x, uint32_t w,
                                               uint32_t ws, uint32_t q) {
  const uint32_t v = shoup_lazy(x, w, ws, q);
  return v >= q ? v - q : v;
}

// The 7 diagonal sums -> (sum_s P[s] 2^(8s)) mod q in [0, q), as
// ops/ntt_mxu.py:recombine_diagonals.  sc: the limb's kernel_scalars row
// (q, pow16[4], pow16'[4], corr16, pow8[7], pow8'[7], corr8).
__device__ __forceinline__ uint32_t recombine(const int (&P)[7], bool fold,
                                              const uint32_t* sc) {
  const uint32_t q = sc[0], two_q = q << 1;
  uint32_t acc, corr;
  if (fold) {
    const uint32_t g[4] = {
        static_cast<uint32_t>(P[0]) + (static_cast<uint32_t>(P[1]) << 8),
        static_cast<uint32_t>(P[2]) + (static_cast<uint32_t>(P[3]) << 8),
        static_cast<uint32_t>(P[4]) + (static_cast<uint32_t>(P[5]) << 8),
        static_cast<uint32_t>(P[6])};
    acc = shoup_lazy(g[0] + kHalf, sc[1], sc[5], q);
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      acc += shoup_lazy(g[t] + kHalf, sc[1 + t], sc[5 + t], q);
      acc = acc >= two_q ? acc - two_q : acc;
    }
    corr = sc[9];
  } else {
    acc = shoup_lazy(static_cast<uint32_t>(P[0]) + kHalf, sc[10], sc[17], q);
#pragma unroll
    for (int s = 1; s < 7; ++s) {
      acc += shoup_lazy(static_cast<uint32_t>(P[s]) + kHalf, sc[10 + s], sc[17 + s], q);
      acc = acc >= two_q ? acc - two_q : acc;
    }
    corr = sc[24];
  }
  acc = acc >= q ? acc - q : acc;
  return acc >= corr ? acc - corr : acc + q - corr;
}

// One stage over the CTA's block.  The output block is rows x cols: left,
// every matrix row by the block's columns; right, the block's rows by every
// column.  Warps take 16 x 16 tiles in passes of kWarps tiles; a tile's
// accumulators live across the table's K chunks.  Starts and ends without a
// barrier of its own after the last store: the caller separates stages.
__device__ void run_stage(const StageArgs& a, uint8_t* smem, const uint32_t* sc) {
  const int w_rows = a.left ? a.n1 : a.n2;
  const int ldd = a.kp + kPad, ldw = a.kc + kPad;
  uint8_t* D = smem;
  uint8_t* Wsm = smem + 4 * static_cast<size_t>(a.block) * ldd;
  const size_t dplane = static_cast<size_t>(a.block) * ldd;
  const size_t wplane = static_cast<size_t>(w_rows) * ldw;
  const uint32_t q = sc[0];
  const bool resident = a.kc == a.kp;
  const bool fold = a.k <= kFoldMaxK;

  load_data(D, ldd, a, q);
  if (resident) load_table(Wsm, ldw, a, w_rows, 0);
  __syncthreads();  // also: every read of src precedes every store of dst

  const int rows = a.left ? a.n1 : a.block;
  const int cols = a.left ? a.block : a.n2;
  const int tiles_c = cols / 16, tiles = (rows / 16) * tiles_c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // A: the table (left) or the data (right); Bt: the other.  The table's
  // chunk sits at k offset 0 in shared memory, the data at its own k.
  const uint8_t* A = a.left ? Wsm : D;
  const uint8_t* B = a.left ? D : Wsm;
  const size_t a_plane = a.left ? wplane : dplane, b_plane = a.left ? dplane : wplane;
  const int lda = a.left ? ldw : ldd, ldb = a.left ? ldd : ldw;

  for (int t0 = 0; t0 < tiles; t0 += kWarps) {
    const int tile = t0 + warp;
    const bool active = tile < tiles;
    const int tr = active ? tile / tiles_c : 0, tc = active ? tile % tiles_c : 0;
    int acc[2][7][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int s = 0; s < 7; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][s][e] = 0;

    for (int k0 = 0; k0 < a.kp; k0 += a.kc) {
      if (!resident) {
        __syncthreads();
        load_table(Wsm, ldw, a, w_rows, k0);
        __syncthreads();
      }
      if (!active) continue;
      const int ka = a.left ? 0 : k0, kb = a.left ? k0 : 0;
      for (int kk = 0; kk < a.kc; kk += 32) {
        uint32_t af[4][4], bf[4][2][2];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint8_t* pa = A + p * a_plane + static_cast<size_t>(16 * tr + g) * lda +
                              ka + kk + 4 * t;
          af[p][0] = ld32(pa);
          af[p][1] = ld32(pa + 8 * lda);
          af[p][2] = ld32(pa + 16);
          af[p][3] = ld32(pa + 8 * lda + 16);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint8_t* pb = B + p * b_plane +
                                static_cast<size_t>(16 * tc + 8 * j + g) * ldb + kb + kk +
                                4 * t;
            bf[p][j][0] = ld32(pb);
            bf[p][j][1] = ld32(pb + 16);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jp = 0; jp < 4; ++jp)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_s8(acc[j][i + jp], af[i], bf[jp][j][0], bf[jp][j][1]);
      }
    }
    if (!active) continue;

    // Epilogue: fragment register e of subtile j is the element (g + 8
    // (e >= 2), 8 j + 2 t + (e & 1)) of the tile; each pair (e, e + 1) is
    // two neighbouring columns, stored as one 16-byte vector.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = 16 * tr + g + 8 * h, lc = 16 * tc + 8 * j + 2 * t;
        const int r = a.left ? lr : a.base + lr;
        const int c = a.left ? a.base + lc : lc;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int P[7];
#pragma unroll
          for (int s = 0; s < 7; ++s) P[s] = acc[j][s][2 * h + e];
          v[e] = recombine(P, fold, sc);
        }
        if (a.twiddle) {
          const uint4 tw = *reinterpret_cast<const uint4*>(
              a.twiddle + 2 * (static_cast<size_t>(r) * a.n2 + c));
          v[0] = shoup_full(v[0], tw.x, tw.y, q);
          v[1] = shoup_full(v[1], tw.z, tw.w, q);
        }
        *reinterpret_cast<longlong2*>(a.dst + static_cast<size_t>(r) * a.n2 + c) =
            make_longlong2(v[0], v[1]);
      }
    }
  }
}

__device__ __forceinline__ void load_scalars(uint32_t* sc, const uint32_t* scalars,
                                             int l) {
  if (threadIdx.x < kScalarSlots)
    sc[threadIdx.x] = scalars[static_cast<size_t>(l) * kScalarSlots + threadIdx.x];
  __syncthreads();
}

__device__ __forceinline__ StageArgs stage_args(int left, int L, int l, int log_n1,
                                                int log_n2, int kc, int base,
                                                int block) {
  StageArgs a;
  a.L = L;
  a.l = l;
  a.n1 = 1 << log_n1;
  a.n2 = 1 << log_n2;
  a.left = left;
  a.k = left ? a.n1 : a.n2;
  a.kp = a.k < 32 ? 32 : a.k;
  a.kc = kc;
  a.base = base;
  a.block = block;
  return a;
}

// One CTA a polynomial, both stages (n <= 32768).  Forward: left then
// right; inverse: right then left.  twiddle: this transform's (L, n1, n2, 2).
template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    ntt_mxu_kernel(const int64_t* x, int64_t* out, const int8_t* w_left,
                   const int8_t* w_right, const uint32_t* twiddle,
                   const uint32_t* scalars, int L, int log_n1, int log_n2,
                   int kc_left, int kc_right) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t sc[kScalarSlots];
  const long long poly = blockIdx.x;
  const int l = static_cast<int>(poly % L);
  const int n = 1 << (log_n1 + log_n2);
  load_scalars(sc, scalars, l);
  StageArgs left = stage_args(1, L, l, log_n1, log_n2, kc_left, 0, 1 << log_n2);
  StageArgs right = stage_args(0, L, l, log_n1, log_n2, kc_right, 0, 1 << log_n1);
  left.w = w_left;
  right.w = w_right;
  StageArgs& first = kInverse ? right : left;
  StageArgs& second = kInverse ? left : right;
  first.src = x + poly * n;
  first.dst = second.dst = out + poly * n;
  second.src = second.dst;
  first.twiddle = twiddle + static_cast<size_t>(l) * n * 2;
  second.twiddle = nullptr;
  run_stage(first, smem, sc);
  __syncthreads();  // the first stage's row is written before it is read
  run_stage(second, smem, sc);
}

// One stage (n = 65536, 131072): a CTA a (polynomial, block of `block` data
// rows (right) or columns (left)).
__global__ void __launch_bounds__(kThreads)
    ntt_mxu_stage_kernel(const int64_t* src, int64_t* dst, const int8_t* w,
                         const uint32_t* twiddle, const uint32_t* scalars, int L,
                         int log_n1, int log_n2, int left, int kc, int block) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t sc[kScalarSlots];
  const long long poly = blockIdx.x;
  const int l = static_cast<int>(poly % L);
  const int n = 1 << (log_n1 + log_n2);
  load_scalars(sc, scalars, l);
  StageArgs a = stage_args(left, L, l, log_n1, log_n2, kc, blockIdx.y * block, block);
  a.w = w;
  a.src = src + poly * n;
  a.dst = dst + poly * n;
  a.twiddle = twiddle ? twiddle + static_cast<size_t>(l) * n * 2 : nullptr;
  run_stage(a, smem, sc);
}

cudaError_t allow_smem(const void* fn, int smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// plan: kc_left, kc_right, block_left, block_right, smem_left, smem_right
// (ops/ntt_mxu.py:kernel_plan); launches 1 or 2.
int launch(bool inverse, const void* x, void* out, void* mid, const void* w_left,
           const void* w_right, const void* twiddle, const void* scalars,
           long long polys, int L, int log_n1, int log_n2, int launches,
           const int* plan, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int64_t*>(x);
  auto* o = static_cast<int64_t*>(out);
  const auto* wl = static_cast<const int8_t*>(w_left);
  const auto* wr = static_cast<const int8_t*>(w_right);
  const auto* sc = static_cast<const uint32_t*>(scalars);
  const size_t per_transform = static_cast<size_t>(L) << (log_n1 + log_n2 + 1);
  const auto* tw = static_cast<const uint32_t*>(twiddle) + (inverse ? per_transform : 0);
  cudaError_t err;
  if (launches == 1) {
    const int smem = plan[4] > plan[5] ? plan[4] : plan[5];
    const void* fn = inverse ? reinterpret_cast<const void*>(ntt_mxu_kernel<true>)
                             : reinterpret_cast<const void*>(ntt_mxu_kernel<false>);
    if ((err = allow_smem(fn, smem)) != cudaSuccess) return static_cast<int>(err);
    if (inverse)
      ntt_mxu_kernel<true><<<static_cast<unsigned>(polys), kThreads, smem, s>>>(
          in, o, wl, wr, tw, sc, L, log_n1, log_n2, plan[0], plan[1]);
    else
      ntt_mxu_kernel<false><<<static_cast<unsigned>(polys), kThreads, smem, s>>>(
          in, o, wl, wr, tw, sc, L, log_n1, log_n2, plan[0], plan[1]);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = plan[4] > plan[5] ? plan[4] : plan[5];
  if ((err = allow_smem(reinterpret_cast<const void*>(ntt_mxu_stage_kernel), smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  auto* m = static_cast<int64_t*>(mid);
  const dim3 grid_left(static_cast<unsigned>(polys), (1u << log_n2) / plan[2]);
  const dim3 grid_right(static_cast<unsigned>(polys), (1u << log_n1) / plan[3]);
  if (!inverse) {
    ntt_mxu_stage_kernel<<<grid_left, kThreads, plan[4], s>>>(
        in, m, wl, tw, sc, L, log_n1, log_n2, 1, plan[0], plan[2]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ntt_mxu_stage_kernel<<<grid_right, kThreads, plan[5], s>>>(
        m, o, wr, nullptr, sc, L, log_n1, log_n2, 0, plan[1], plan[3]);
  } else {
    ntt_mxu_stage_kernel<<<grid_right, kThreads, plan[5], s>>>(
        in, m, wr, tw, sc, L, log_n1, log_n2, 0, plan[1], plan[3]);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ntt_mxu_stage_kernel<<<grid_left, kThreads, plan[4], s>>>(
        m, o, wl, nullptr, sc, L, log_n1, log_n2, 1, plan[0], plan[2]);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mxu
}  // namespace troy

// polys rows of n = 2^(log_n1 + log_n2) int64 values; mid: a scratch
// tensor of the input's size (two launches only, else unused); plan: six
// ints (kc_left, kc_right, block_left, block_right, smem_left, smem_right).
extern "C" int troy_ntt_forward_mxu(const void* x, void* out, void* mid,
                                    const void* w_left, const void* w_right,
                                    const void* twiddle, const void* scalars,
                                    long long polys, int L, int log_n1, int log_n2,
                                    int launches, const int* plan, void* stream) {
  return troy::mxu::launch(false, x, out, mid, w_left, w_right, twiddle, scalars,
                           polys, L, log_n1, log_n2, launches, plan, stream);
}

extern "C" int troy_ntt_inverse_mxu(const void* x, void* out, void* mid,
                                    const void* w_left, const void* w_right,
                                    const void* twiddle, const void* scalars,
                                    long long polys, int L, int log_n1, int log_n2,
                                    int launches, const int* plan, void* stream) {
  return troy::mxu::launch(true, x, out, mid, w_left, w_right, twiddle, scalars,
                           polys, L, log_n1, log_n2, launches, plan, stream);
}

// which: 0 / 1 the one-CTA kernel's forward / inverse, 2 the stage kernel;
// smem: its dynamic shared bytes.  info: threads, smem, registers, local
// (spill) bytes a thread, CTAs resident per SM.
extern "C" int troy_ntt_mxu_info(int which, int smem, int* info) {
  const void* fn =
      which == 0 ? reinterpret_cast<const void*>(troy::mxu::ntt_mxu_kernel<false>)
      : which == 1 ? reinterpret_cast<const void*>(troy::mxu::ntt_mxu_kernel<true>)
                   : reinterpret_cast<const void*>(troy::mxu::ntt_mxu_stage_kernel);
  cudaError_t err = troy::mxu::allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, troy::mxu::kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = troy::mxu::kThreads;
  info[1] = smem;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = blocks;
  return 0;
}

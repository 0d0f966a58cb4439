// Negacyclic NTT / INTT as two modular matrix products on 8-bit tensor
// cores, redesigned for NVIDIA Hopper (sm_90a): wgmma on unsigned byte
// planes, a limb's tables resident across its polynomials, the first
// stage's result handed to the second in shared memory.
//
// Replaces the TPU kernel K2 of troy_tpu/ops/ntt_pallas.py: _fwd_kernel_mxu /
// _inv_kernel_mxu (launcher _ntt_pallas_mxu), the transform the JAX package
// runs under set_ntt_backend("pallas_mxu").  The same function as the
// butterfly kernels of ntt.cu (K1) and the first form of K2 (ntt_mxu.cu,
// kept as a yardstick): output in [0, q), in the NTT order of
// troy_tpu/ops/ntt.py, bit for bit.  Serves 256 <= n <= 16384; the larger
// degrees stay on ntt_mxu.cu (ops/ntt_mxu.py:WG_MAX_LOG_N).
//
// What it computes (ops/ntt_mxu.py).  With n = n1 n2 and the polynomial a
// row-major (n1, n2) matrix X, the forward transform is A = W1 X, B = A o T,
// C = B W2; the inverse C = X W2i, B = C o Ti, A = W1i B.  Every stage here
// is written D[m][n] = sum_k W[m][k] V[n][k] with the table W the wgmma A
// operand and the data V the B operand, both K-major in shared memory:
//   forward  stage 1: W = W1    (m = r,  k = r'), V = X^T       (n = c)
//            stage 2: W = W2^T  (m = c', k = c),  V = stage 1   (n = r)
//   inverse  stage 1: W = W2i^T (m = c,  k = c'), V = X         (n = r)
//            stage 2: W = W1i   (m = r', k = r),  V = stage 1^T (n = c)
// so stage 1's D[m][n] is stage 2's V[m][n]: its epilogue writes each
// value's bytes straight into stage 2's operand planes.  A table of fewer
// than 64 rows is zero-padded to the 64 rows of one wgmma, every
// contraction to a multiple of 32.
//
// Exactness.  A residue v < q < 2^30 is its 4 unsigned bytes (the top one
// at most 63); the tables are the bytes of W in [0, q), so every operand is
// .u8.  Plane products i x j accumulate in s32, one accumulator per
// diagonal s = i + j (7), all nonnegative and below 2^31 (asserted at table
// build: ops/ntt_mxu.py:wg_diagonal_bounds).  The recombination is
//   v = P0 + 2^8 P1 + 2^16 P2 + 2^24 P3 + c4 (P4 + 2^8 P5) + c6 P6,
// c_s = 2^(8s) mod q (P4 + 2^8 P5 < 2^32 at every contraction to 512), one
// 32-bit and five wide multiply-adds into one u64 (below 2^62), then one
// Barrett step with a per-limb shift s and mu = floor(2^(s+32) / q)
// (ops/ntt_mxu.py:wg_barrett): qhat = umulhi(v >> s, mu), v - qhat q in
// [0, 3q).  Stage 1 takes that into the twiddle's Shoup product and one
// conditional subtract; stage 2 ends with two.
//
// Design.  A persistent CTA of two warpgroups takes one limb and a run of
// its polynomials (grid: limbs x runs, sized to the CTAs the card holds).
//   * The limb's two table planes are loaded once by cp.async.bulk (TMA)
//     into shared memory, in the wgmma core-matrix layout the tables are
//     stored in (8 rows x 16 bytes a core matrix, no swizzle); at n = 16384
//     they do not fit beside the data and are reloaded before each stage.
//   * The next polynomial's int64 row is fetched by cp.async.bulk into a
//     staging buffer while the current one's stages run, and split into
//     stage 1's operand planes while stage 2's products run (n <= 8192).
//   * Each thread splits 4 values of one operand row into one word a plane
//     (a conditional subtract, then byte permutes), one core matrix a warp.
//   * A warpgroup computes a 64 x 32 (or 64 x 16) tile: for each 32-deep K
//     step 16 wgmma.m64nNk32.s32.u8.u8 into the 7 diagonals (7 x 16
//     registers at N = 32), loads stage 1's twiddles while they run, then
//     its epilogue; the second warpgroup starts each stage one tile's
//     products behind the first, so that epilogues run beside products.
//   * Stage 1's epilogue recombines, twiddles and writes the byte planes
//     of stage 2's operand as 16-bit pairs; stage 2's writes the output.
// Shared memory at n = 8192: tables 16 + 64 KB, two operand plane sets
// 2 x 32 KB, the staging row 64 KB: 208 KB, one CTA an SM.
// Bound: the transform's bytes (the values in and out); the method adds
// 16 plane products a stage on the tensor cores and 42 int32 operations a
// value (chip_smoke.py WG_*_OPS, counted from this code).
//
// Layout: input (rows, n) int64 contiguous and 16-byte aligned, the limb of
// row r equal to r % L, values in [0, 2q).  Tables (ops/ntt_mxu.py
// MxuNTTTables.wg_w): per stage (L, 4, Mp/8, Kp/16, 8, 16) u8; twiddles
// (L, M1, N1, 2) u32 (w, w') pairs in stage 1's output order; scalars
// (L, 8) u32: q, mu, s, c4, c6.  Kernels never allocate.

#include <cstdint>

#include <cuda_runtime.h>

namespace troy {
namespace mxu_wg {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kGroups = kThreads / 128;
constexpr int kScalarSlots = 8;

// The shared-memory plan of one direction (ops/ntt_mxu.py:wg_plan).
struct Plan {
  int n1, n2;
  int M1, K1p, M1p, N1;  // stage 1: table M1 x M1, data N1 rows
  int M2, K2p, M2p, N2;  // stage 2: table M2 x M2, data N2 = M1 rows
  int t1, t2, b1, b2, staging, smem;
  bool resident;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Plan make_plan(bool inverse, int log_n1, int log_n2,
                                          int max_smem) {
  Plan p;
  p.n1 = 1 << log_n1;
  p.n2 = 1 << log_n2;
  p.M1 = inverse ? p.n2 : p.n1;
  p.N1 = inverse ? p.n1 : p.n2;
  p.M2 = p.N1;
  p.N2 = p.M1;
  p.K1p = imax(32, p.M1);
  p.M1p = imax(64, p.M1);
  p.K2p = imax(32, p.M2);
  p.M2p = imax(64, p.M2);
  p.t1 = 4 * p.M1p * p.K1p;
  p.t2 = 4 * p.M2p * p.K2p;
  p.b1 = 4 * p.N1 * p.K1p;
  p.b2 = 4 * p.N2 * p.K2p;
  const int n = p.n1 * p.n2;
  const int resident = p.t1 + p.t2 + p.b1 + p.b2 + 8 * n;
  p.resident = resident <= max_smem;
  p.staging = p.resident ? 8 * n : 0;
  p.smem = p.resident ? resident : imax(p.t1, p.t2) + p.b1 + p.b2;
  return p;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk copies, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor, no swizzle, K-major: 8 x 16-byte core matrices,
// the next one along K 128 bytes on (LBO), along M / N `sbo` bytes on.
__device__ __forceinline__ uint64_t descriptor(const uint8_t* p, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d = a b (accumulate 0) or d + a b (accumulate 1).
template <int NT>
__device__ __forceinline__ void wgmma(int (&d)[NT / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma<32>(int (&d)[16], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<16>(int (&d)[8], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keep the accumulators' reads and writes on their side of the wgmma
// fence and wait.
template <int NT>
__device__ __forceinline__ void pin(int (&acc)[7][NT / 2]) {
#pragma unroll
  for (int s = 0; s < 7; ++s)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) asm volatile("" : "+r"(acc[s][e])::"memory");
}

// ---------------------------------------------------------------------------
// Arithmetic.
// ---------------------------------------------------------------------------

struct Scalars {
  uint32_t q, mu, s, c4, c6;
};

__device__ __forceinline__ uint32_t cond_sub(uint32_t x, uint32_t q) {
  return min(x, x - q);  // x - q wraps above x when x < q
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws, uint32_t q) {
  return x * w - __umulhi(x, ws) * q;  // [0, 2q) for any x < 2^32
}

// The 7 diagonal sums (nonnegative, below 2^31) -> sum_s P_s 2^(8s) mod q,
// in [0, 3q).
__device__ __forceinline__ uint32_t recombine(uint32_t p0, uint32_t p1, uint32_t p2,
                                              uint32_t p3, uint32_t p4, uint32_t p5,
                                              uint32_t p6, const Scalars& c) {
  const uint32_t p45 = p5 * 256u + p4;  // below 2^32 (ops/ntt_mxu.py:wg_barrett)
  uint64_t v = static_cast<uint64_t>(p1) * 256u + p0;
  v += static_cast<uint64_t>(p2) * 65536u;
  v += static_cast<uint64_t>(p3) * 16777216u;
  v += static_cast<uint64_t>(p45) * c.c4;
  v += static_cast<uint64_t>(p6) * c.c6;
  const uint32_t lo = static_cast<uint32_t>(v), hi = static_cast<uint32_t>(v >> 32);
  const uint32_t qhat = __umulhi(__funnelshift_r(lo, hi, c.s), c.mu);
  return lo - qhat * c.q;
}

// ---------------------------------------------------------------------------
// The stages.
// ---------------------------------------------------------------------------

// Stage 1's operand: rows x Kp bytes a plane from the int64 row src (in
// shared or device memory), the forward's V = X^T (row c, k = r at src[k n2
// + row]) or the inverse's V = X (row r, k at src[row n2 + k]); zeros at
// k >= K.  Item i is word i of every plane: core matrix i / 32, its row
// (i % 32) / 4, its bytes 4 (i % 4) .. + 3.
struct Split {
  uint8_t* planes;
  const int64_t* src;
  int rows, K, Kp, n2;
  uint32_t q;
  bool active;
  __device__ int words() const { return rows * Kp / 4; }
};

template <bool kInverse>
__device__ __forceinline__ void split_item(const Split& sp, int i) {
  const int KB = sp.Kp >> 4;
  const int plane = sp.rows * sp.Kp;
  const int cm = i >> 5, lane = i & 31;
  const int row = (cm / KB) * 8 + (lane >> 2);
  const int k = (cm % KB) * 16 + (lane & 3) * 4;
  uint32_t v[4] = {0, 0, 0, 0};
  if (k < sp.K) {
    if (kInverse) {  // V = X: row r, k contiguous
      const longlong2* p = reinterpret_cast<const longlong2*>(sp.src + row * sp.n2 + k);
      const longlong2 a = p[0], b = p[1];
      v[0] = static_cast<uint32_t>(a.x);
      v[1] = static_cast<uint32_t>(a.y);
      v[2] = static_cast<uint32_t>(b.x);
      v[3] = static_cast<uint32_t>(b.y);
    } else {  // V = X^T: row c, k = r
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = static_cast<uint32_t>(sp.src[(k + j) * sp.n2 + row]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cond_sub(v[j], sp.q);
  }
  const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140), lo23 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362), hi23 = __byte_perm(v[2], v[3], 0x7362);
  uint32_t* w = reinterpret_cast<uint32_t*>(sp.planes) + i;
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[plane / 4] = __byte_perm(lo01, lo23, 0x7632);
  w[plane / 2] = __byte_perm(hi01, hi23, 0x5410);
  w[3 * plane / 4] = __byte_perm(hi01, hi23, 0x7632);
}

// The whole operand by every thread.
template <bool kInverse>
__device__ __forceinline__ void split(const Split& sp) {
  for (int i = threadIdx.x; i < sp.words(); i += kThreads) split_item<kInverse>(sp, i);
}

// Rounds [r0, r1) of warpgroup `group`'s share: items (kGroups r + group)
// 128 + its thread.
template <bool kInverse>
__device__ __forceinline__ void split_rounds(const Split& sp, int group, int r0, int r1) {
  for (int r = r0; r < r1; ++r) {
    const int i = (kGroups * r + group) * 128 + (threadIdx.x & 127);
    if (i < sp.words()) split_item<kInverse>(sp, i);
  }
}

// One 64 x NT tile: the 16 plane products of every 32-deep K step into the
// 7 diagonal accumulators, started and committed; wait_products ends them.
// A: the table's 64 rows, B: the data's NT rows, both Kp bytes deep (row
// groups sbo = 8 Kp bytes apart).  The first product into each diagonal
// (i = 0 or j = 3 at k = 0) overwrites it, so no instruction but a wgmma
// defines the accumulators.
template <int NT>
__device__ __forceinline__ void start_products(int (&acc)[7][NT / 2], const uint8_t* A,
                                               int a_plane, const uint8_t* B, int b_plane,
                                               int Kp) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint32_t sbo = 8u * Kp;
  for (int k = 0; k < Kp; k += 32) {
    uint64_t da[4], db[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      da[p] = descriptor(A + p * a_plane + 8 * k, sbo);
      db[p] = descriptor(B + p * b_plane + 8 * k, sbo);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma<NT>(acc[i + j], da[i], db[j], k > 0 || (i > 0 && j < 3));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void stagger_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void stagger_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

template <int NT>
__device__ __forceinline__ void wait_products(int (&acc)[7][NT / 2]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  pin<NT>(acc);
}

// Where the stage's values go: stage 1 into stage 2's operand planes
// (twiddled), stage 2 into the output row.
struct Epilogue {
  uint8_t* planes;          // stage 1: stage 2's operand (rows M1, Kp = next)
  int next_kp;
  const uint32_t* twiddle;  // stage 1: this limb's (M1, N1, 2)
  int64_t* out;             // stage 2: the output row
  int n2;
};

// The stage's tiles, a warpgroup each in turn.  Fragment register 4 j +
// 2 h + e of a thread is D[m][n] at m = 64 mb + 16 warp + g + 8 h, n = NT nt +
// 8 j + 2 t + e (g = lane / 4, t = lane % 4).  Stage 1's twiddles are
// loaded while the tile's products run; rows m >= M (a table padded to 64
// rows) are computed and not stored.
template <int NT, bool kFirst, bool kInverse>
__device__ __forceinline__ void run_stage(const uint8_t* A, int M, int Mp, int Kp,
                                          const uint8_t* B, int N, const Epilogue& ep,
                                          const Scalars& c, const Split& side) {
  const int group = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // warp-uniform
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a_plane = Mp * Kp, b_plane = N * Kp;
  const int ntiles = N / NT, tiles = (Mp >> 6) * ntiles;
  // the next polynomial's split, in equal shares while this group's tiles'
  // products run
  const int mine = (tiles - group + kGroups - 1) / kGroups;
  const int rounds = side.active ? (side.words() + kThreads - 1) / kThreads : 0;
  // Stagger: warpgroup 1 starts its first products only when warpgroup 0's
  // first products are done, so that one group's epilogue runs beside the
  // other's products (named barrier 1: group 0 arrives, group 1 waits).
  if (group == 1 && !mine) stagger_wait();
  int u = 0;
  for (int tile = group; tile < tiles; tile += kGroups, ++u) {
    const int mb = tile / ntiles, nt = tile % ntiles;
    int acc[7][NT / 2];
    if (group == 1 && u == 0) stagger_wait();
    start_products<NT>(acc, A + mb * 64 * Kp, a_plane, B + nt * NT * Kp, b_plane, Kp);
    if (rounds) split_rounds<kInverse>(side, group, u * rounds / mine, (u + 1) * rounds / mine);
    uint4 tw[NT / 8][2];
    if (kFirst) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 64 * mb + 16 * warp + g + 8 * h;
          const int n = NT * nt + 8 * j + 2 * t;
          tw[j][h] = m < M ? *reinterpret_cast<const uint4*>(
                                 ep.twiddle + 2 * (static_cast<size_t>(m) * N + n))
                           : make_uint4(0, 0, 0, 0);
        }
    }
    wait_products<NT>(acc);
    if (group == 0 && u == 0) stagger_arrive();
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * mb + 16 * warp + g + 8 * h;
        const int n = NT * nt + 8 * j + 2 * t;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * h + e;
          v[e] = recombine(acc[0][r], acc[1][r], acc[2][r], acc[3][r], acc[4][r], acc[5][r],
                           acc[6][r], c);
        }
        if (kFirst) {
          v[0] = cond_sub(shoup(v[0], tw[j][h].x, tw[j][h].y, c.q), c.q);
          v[1] = cond_sub(shoup(v[1], tw[j][h].z, tw[j][h].w, c.q), c.q);
          const uint32_t lo = __byte_perm(v[0], v[1], 0x5140);
          const uint32_t hi = __byte_perm(v[0], v[1], 0x7362);
          const int plane = M * ep.next_kp;
          uint8_t* p = ep.planes + ((m >> 3) * (ep.next_kp >> 4) + (n >> 4)) * 128 +
                       (m & 7) * 16 + (n & 15);
          if (m < M) {
            *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(lo);
            *reinterpret_cast<uint16_t*>(p + plane) = static_cast<uint16_t>(lo >> 16);
            *reinterpret_cast<uint16_t*>(p + 2 * plane) = static_cast<uint16_t>(hi);
            *reinterpret_cast<uint16_t*>(p + 3 * plane) = static_cast<uint16_t>(hi >> 16);
          }
        } else {
          v[0] = cond_sub(cond_sub(v[0], c.q), c.q);
          v[1] = cond_sub(cond_sub(v[1], c.q), c.q);
          if (m < M) {
            if (kInverse) {  // out[r'][c]: (m, n) and (m, n + 1) side by side
              *reinterpret_cast<longlong2*>(ep.out + static_cast<size_t>(m) * ep.n2 + n) =
                  make_longlong2(v[0], v[1]);
            } else {         // out[r][c']: n is the row
              ep.out[static_cast<size_t>(n) * ep.n2 + m] = v[0];
              ep.out[static_cast<size_t>(n + 1) * ep.n2 + m] = v[1];
            }
          }
        }
      }
    }
  }
  if (rounds && !mine) split_rounds<kInverse>(side, group, 0, rounds);
}

template <bool kFirst, bool kInverse>
__device__ __forceinline__ void stage(const uint8_t* A, int M, int Mp, int Kp, const uint8_t* B,
                                      int N, const Epilogue& ep, const Scalars& c,
                                      const Split& side) {
  if (N % 32 == 0)
    run_stage<32, kFirst, kInverse>(A, M, Mp, Kp, B, N, ep, c, side);
  else
    run_stage<16, kFirst, kInverse>(A, M, Mp, Kp, B, N, ep, c, side);
}

// A CTA: limb blockIdx.x % L, batch rows [b0, b0 + per) of it.
template <bool kInverse, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    ntt_mxu_wg_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                      const uint8_t* __restrict__ t1g, const uint8_t* __restrict__ t2g,
                      const uint32_t* __restrict__ twiddle, const uint32_t* __restrict__ scalars,
                      int L, int log_n1, int log_n2, int batch, int per, int max_smem) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2];  // tables, staging
  __shared__ uint32_t sc[kScalarSlots];
  const Plan p = make_plan(kInverse, log_n1, log_n2, max_smem);
  const int l = blockIdx.x % L;
  const int b0 = (blockIdx.x / L) * per;
  const int count = min(per, batch - b0);
  const int n = p.n1 * p.n2;
  uint8_t* T1 = smem;
  uint8_t* T2 = kResident ? smem + p.t1 : smem;
  uint8_t* B1 = smem + (kResident ? p.t1 + p.t2 : imax(p.t1, p.t2));
  uint8_t* B2 = B1 + p.b1;
  int64_t* staging = reinterpret_cast<int64_t*>(B2 + p.b2);
  const uint8_t* t1src = t1g + static_cast<size_t>(l) * p.t1;
  const uint8_t* t2src = t2g + static_cast<size_t>(l) * p.t2;

  if (threadIdx.x < kScalarSlots) sc[threadIdx.x] = scalars[l * kScalarSlots + threadIdx.x];
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Scalars c{sc[0], sc[1], sc[2], sc[3], sc[4]};
  Epilogue first{B2, p.K2p, twiddle + static_cast<size_t>(l) * p.M1 * p.N1 * 2, nullptr, p.n2};
  Split sp{B1, x, p.N1, p.M1, p.K1p, p.n2, c.q, false};
  const Split none{B1, x, 0, 0, 32, 0, 0, false};
  const size_t row0 = static_cast<size_t>(b0) * L + l;
  if (kResident) {
    // Tables once; row it + 1 staged while row it runs, and split into B1
    // while row it's stage 2 products run.
    if (threadIdx.x == 0) {
      mbar_expect(&bars[0], p.t1 + p.t2);
      bulk_load(T1, t1src, p.t1, &bars[0]);
      bulk_load(T2, t2src, p.t2, &bars[0]);
      mbar_expect(&bars[1], 8 * n);
      bulk_load(staging, x + row0 * n, 8 * n, &bars[1]);
    }
    uint32_t in_phase = 0;
    mbar_wait(&bars[1], in_phase);
    in_phase ^= 1;
    sp.src = staging;
    split<kInverse>(sp);
    fence_async_smem();
    __syncthreads();  // B1 whole; every read of the staging row done
    if (threadIdx.x == 0 && count > 1) {
      mbar_expect(&bars[1], 8 * n);
      bulk_load(staging, x + (row0 + L) * n, 8 * n, &bars[1]);
    }
    mbar_wait(&bars[0], 0);
    for (int it = 0; it < count; ++it) {
      const size_t row = row0 + static_cast<size_t>(it) * L;
      stage<true, kInverse>(T1, p.M1, p.M1p, p.K1p, B1, p.N1, first, c, none);
      fence_async_smem();
      __syncthreads();  // B2 whole; every wgmma of stage 1 done (B1 free)
      sp.active = it + 1 < count;
      if (sp.active) {
        mbar_wait(&bars[1], in_phase);
        in_phase ^= 1;
      }
      const Epilogue second{nullptr, 0, nullptr, out + row * n, p.n2};
      stage<false, kInverse>(T2, p.M2, p.M2p, p.K2p, B2, p.N2, second, c, sp);
      fence_async_smem();
      __syncthreads();  // B1 whole again; every read of the staging row done
      if (threadIdx.x == 0 && it + 2 < count) {
        mbar_expect(&bars[1], 8 * n);
        bulk_load(staging, x + (row + 2 * L) * n, 8 * n, &bars[1]);
      }
    }
    return;
  }
  // n = 16384: one table buffer, reloaded before each stage; the row split
  // straight from device memory.
  uint32_t tab_phase = 0;
  for (int it = 0; it < count; ++it) {
    const size_t row = row0 + static_cast<size_t>(it) * L;
    sp.src = x + row * n;
    split<kInverse>(sp);
    fence_async_smem();
    __syncthreads();  // B1 whole; every wgmma of the last stage 2 done
    if (threadIdx.x == 0) {
      mbar_expect(&bars[0], p.t1);
      bulk_load(T1, t1src, p.t1, &bars[0]);
    }
    mbar_wait(&bars[0], tab_phase);
    tab_phase ^= 1;
    stage<true, kInverse>(T1, p.M1, p.M1p, p.K1p, B1, p.N1, first, c, none);
    fence_async_smem();
    __syncthreads();  // B2 whole; every wgmma of stage 1 done
    if (threadIdx.x == 0) {
      mbar_expect(&bars[0], p.t2);
      bulk_load(T2, t2src, p.t2, &bars[0]);
    }
    mbar_wait(&bars[0], tab_phase);
    tab_phase ^= 1;
    const Epilogue second{nullptr, 0, nullptr, out + row * n, p.n2};
    stage<false, kInverse>(T2, p.M2, p.M2p, p.K2p, B2, p.N2, second, c, none);
  }
}

constexpr int kMaxSmem = 232448 - 1024;  // the H100's 227 KB a CTA, less the static part

const void* kernel_fn(bool inverse, bool resident) {
  if (inverse)
    return resident ? reinterpret_cast<const void*>(ntt_mxu_wg_kernel<true, true>)
                    : reinterpret_cast<const void*>(ntt_mxu_wg_kernel<true, false>);
  return resident ? reinterpret_cast<const void*>(ntt_mxu_wg_kernel<false, true>)
                  : reinterpret_cast<const void*>(ntt_mxu_wg_kernel<false, false>);
}

// The CTAs an SM holds and the SMs of the current device.
cudaError_t slots(const void* fn, int smem, int* ctas, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, smem)) !=
      cudaSuccess)
    return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

int launch(bool inverse, const void* x, void* out, const void* t1, const void* t2,
           const void* twiddle, const void* scalars, long long polys, int L, int log_n1,
           int log_n2, void* stream) {
  const Plan p = make_plan(inverse, log_n1, log_n2, kMaxSmem);
  if (p.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_fn(inverse, p.resident);
  int ctas = 0, sms = 0;
  cudaError_t err = slots(fn, p.smem, &ctas, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int batch = static_cast<int>(polys / L);
  const int runs = imax(1, ctas * sms / L);
  const int per = (batch + runs - 1) / runs;
  const int grid = (batch + per - 1) / per * L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int64_t*>(x);
  auto* o = static_cast<int64_t*>(out);
  const auto* a = static_cast<const uint8_t*>(t1);
  const auto* b = static_cast<const uint8_t*>(t2);
  const auto* tw = static_cast<const uint32_t*>(twiddle);
  const auto* sc = static_cast<const uint32_t*>(scalars);
  if (inverse && p.resident)
    ntt_mxu_wg_kernel<true, true><<<grid, kThreads, p.smem, s>>>(
        in, o, a, b, tw, sc, L, log_n1, log_n2, batch, per, kMaxSmem);
  else if (inverse)
    ntt_mxu_wg_kernel<true, false><<<grid, kThreads, p.smem, s>>>(
        in, o, a, b, tw, sc, L, log_n1, log_n2, batch, per, kMaxSmem);
  else if (p.resident)
    ntt_mxu_wg_kernel<false, true><<<grid, kThreads, p.smem, s>>>(
        in, o, a, b, tw, sc, L, log_n1, log_n2, batch, per, kMaxSmem);
  else
    ntt_mxu_wg_kernel<false, false><<<grid, kThreads, p.smem, s>>>(
        in, o, a, b, tw, sc, L, log_n1, log_n2, batch, per, kMaxSmem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mxu_wg
}  // namespace troy

// polys rows of n = 2^(log_n1 + log_n2) int64 values, limb of row r = r % L;
// t1, t2: the direction's two stage tables (MxuNTTTables.wg_w); twiddle:
// the direction's (L, M1, N1, 2); scalars (L, 8).
extern "C" int troy_ntt_forward_mxu_wg(const void* x, void* out, const void* t1,
                                       const void* t2, const void* twiddle,
                                       const void* scalars, long long polys, int L,
                                       int log_n1, int log_n2, void* stream) {
  return troy::mxu_wg::launch(false, x, out, t1, t2, twiddle, scalars, polys, L, log_n1,
                              log_n2, stream);
}

extern "C" int troy_ntt_inverse_mxu_wg(const void* x, void* out, const void* t1,
                                       const void* t2, const void* twiddle,
                                       const void* scalars, long long polys, int L,
                                       int log_n1, int log_n2, void* stream) {
  return troy::mxu_wg::launch(true, x, out, t1, t2, twiddle, scalars, polys, L, log_n1,
                              log_n2, stream);
}

// info: threads, dynamic shared bytes, registers, local (spill) bytes a
// thread, CTAs resident per SM, 1 if the tables stay resident, and the
// plan's table, operand and staging bytes (t1, t2, b1, b2, staging).
extern "C" int troy_ntt_mxu_wg_info(int inverse, int log_n1, int log_n2, int* info) {
  using namespace troy::mxu_wg;
  const Plan p = make_plan(inverse != 0, log_n1, log_n2, kMaxSmem);
  const void* fn = kernel_fn(inverse != 0, p.resident);
  int ctas = 0, sms = 0;
  cudaError_t err = slots(fn, p.smem, &ctas, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return static_cast<int>(err);
  const int vals[11] = {kThreads, p.smem, attr.numRegs, static_cast<int>(attr.localSizeBytes),
                        ctas, p.resident ? 1 : 0, p.t1, p.t2, p.b1, p.b2, p.staging};
  for (int i = 0; i < 11; ++i) info[i] = vals[i];
  return 0;
}

// Negacyclic NTT / INTT as two modular matrix products on 8-bit tensor
// cores above n = 16384, redesigned for NVIDIA Hopper (sm_90a): one
// thread-block cluster of C CTAs a polynomial, one launch a transform, the
// first stage's result handed to the second in the cluster's shared memory.
//
// Replaces the TPU kernel K2 of troy_tpu/ops/ntt_pallas.py: _fwd_kernel_mxu /
// _inv_kernel_mxu (launcher _ntt_pallas_mxu), the transform the JAX package
// runs under set_ntt_backend("pallas_mxu"), at n = 32768, 65536 and 131072.
// The same function as ntt_mxu_wg.cu (the route to n = 16384), K1's
// butterfly kernels (ntt.cu) and K2's first form (ntt_mxu.cu, kept as a
// yardstick): input in [0, 2q), output in [0, q) in the NTT order of
// troy_tpu/ops/ntt.py, bit for bit.
//
// What it computes (ops/ntt_mxu.py), as ntt_mxu_wg.cu: each stage is
// D[m][n] = sum_k W[m][k] V[n][k], the table W (M rows, K = M deep) the
// wgmma A operand and the data V (N rows) the B operand, both in the
// K-major core-matrix layout of unsigned byte planes:
//   forward  stage 1: W = W1    (M = n1), V = X^T (N = n2)
//            stage 2: W = W2^T  (M = n2), V = stage 1's D (N = n1)
//   inverse  stage 1: W = W2i^T (M = n2), V = X   (N = n1)
//            stage 2: W = W1i   (M = n1), V = stage 1's D (N = n2)
// The 16 plane products of each 32-deep step accumulate into 7 diagonal
// sums, recombined by one wide sum and one Barrett step (recombine, as in
// ntt_mxu_wg.cu; bounds asserted at table build, ops/ntt_mxu.py:wg_barrett).
//
// What bounds it.  A stage does not fit one CTA: at n = 65536 a table is
// 256 KB, the data's planes 256 KB.  The transform's bytes (the values in
// and out) bound it in principle; the method's int8 products (2 x 16 x M x
// N x K a stage) set a higher floor above 16384, and each CTA reads both
// tables once a polynomial (from L2) and the products' operands from shared
// memory, which is what this card runs out of first.
//
// Design (ops/ntt_mxu.py:cl_plan).  A cluster of C CTAs (8 or 16) takes
// one polynomial at a time, persistent over rows cid, cid + G, ... of the
// launch (G clusters, as many as the card holds at once).  Each stage is cut
// by its data rows: CTA r holds rows [r R, (r + 1) R) of V (R = N / C, 16
// or 32, one wgmma tile wide) and computes D[:, those rows] against the
// whole table, which it streams through shared memory:
//   * The table (MxuNTTTables.cl_w: 64 x 64 blocks, so that a chunk is one
//     run) is read in chunks of 64 rows x 128 bytes of K (4 planes, 32 KB),
//     one cp.async.bulk each, into a ring of slots.  Each of the two
//     warpgroups has its own ring and takes every other 64-row tile of each
//     stage; it refills a slot as soon as its products on it are done.
//     (Small bulk copies are slow on this card: 32 copies of 512 bytes a
//     chunk took 2.6x one copy, scripts/torch_bulk_probe.py.)
//   * The products: at 16-row data tiles the table's 64 x 32 tile of a step
//     is loaded into registers once (ldmatrix) for its 16 plane products;
//     at 32 rows those registers do not fit beside the accumulators and the
//     table operand is read from shared memory.
//   * Stage 1's data: the CTA's rows of X^T (forward: a column slice of X)
//     or of X (inverse: a row slice), split into byte planes straight from
//     device memory, the next polynomial's under stage 2's products.
//   * Stage 1's epilogue recombines and twiddles each value and writes its
//     bytes (the four lanes of a quad trade them by two shuffles, 8 bytes of
//     one plane a lane) into an outgoing tile laid out as the blocks of the
//     CTAs that hold its rows in stage 2 (stage 2's V row m is stage 1's D
//     row m, held by CTA m / R2; V2 is stored by K block, then row group,
//     so each CTA's block is one run).  One bulk copy a destination and
//     plane pushes a block into that CTA's shared memory and completes on
//     its v2full barrier by byte count: nothing of stage 1 reaches device
//     memory, and no thread fences or arrives remotely.  v2empty (every
//     warpgroup of the cluster has finished its stage 2 products on V2) is
//     signalled the same way, by a 16-byte push from each warpgroup.
//   * Stage 2's epilogue writes the output.
// The cluster is launched by cudaLaunchKernelEx; where the card cannot
// hold one (cudaOccupancyMaxActiveClusters 0) the launch is refused.
//
// Layout: input (rows, n) int64 contiguous and 16-byte aligned, the limb of
// row r equal to r % L, values in [0, 2q).  Tables: MxuNTTTables.cl_w (per
// stage (L, M/64, K/64, 4, 8, 4, 8, 16) u8), wg_twiddle ((L, M1, N1, 2) u32
// (w, w') pairs in stage 1's output order) and wg_scalars ((L, 8) u32: q,
// mu, s, c4, c6).  Kernels never allocate.

#include <cstdint>

#include <cuda_runtime.h>

namespace troy {
namespace mxu_cl {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kScalarSlots = 8;
constexpr int kBlock = 4 * 64 * 64;      // a table block: 64 rows x 64 bytes of K, 4 planes
constexpr int kKc = 128;                 // K bytes of a table chunk (4 steps of 32)
constexpr int kMaxSlots = 4;             // chunks a warpgroup's ring holds
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448 - 1024;  // the H100's 227 KB a CTA, less the static part

// The cut of one direction at cluster size 2^log_c (ops/ntt_mxu.py:cl_plan).
struct Plan {
  int n1, n2, C;
  int M1, N1, K1, R1;  // stage 1: table M1 x K1, data N1 rows, R1 a CTA
  int M2, N2, K2, R2;  // stage 2: table M2 x K2 (K2 = N1), data N2 = M1 rows
  int v1, v2, out;     // the two stages' operand planes; stage 1's outgoing tiles
  int slots, smem;     // chunks a warpgroup's ring holds; shared bytes
  int per_row;         // table chunks a warpgroup consumes a polynomial
  bool ok;
};

__host__ __device__ inline bool tile_ok(int r) { return r == 16 || r == 32; }

__host__ __device__ inline Plan make_plan(bool inverse, int log_n1, int log_n2, int log_c) {
  Plan p;
  p.n1 = 1 << log_n1;
  p.n2 = 1 << log_n2;
  p.C = 1 << log_c;
  p.M1 = inverse ? p.n2 : p.n1;
  p.N1 = inverse ? p.n1 : p.n2;
  p.K1 = p.M1;
  p.M2 = p.N1;
  p.N2 = p.M1;
  p.K2 = p.M2;
  p.R1 = p.N1 >> log_c;
  p.R2 = p.N2 >> log_c;
  p.v1 = 4 * p.R1 * p.K1;
  p.v2 = 4 * p.R2 * p.K2;
  p.out = 4 * p.M1 * p.R1;
  // as many chunks a warpgroup as fit, to kMaxSlots
  const int slots = (kMaxSmem - p.v1 - p.v2 - p.out) / (2 * 256 * kKc);
  p.slots = slots < 0 ? 0 : slots > kMaxSlots ? kMaxSlots : slots;
  p.smem = 2 * p.slots * 256 * kKc + p.v1 + p.v2 + p.out;
  p.per_row = (p.M1 / 128) * (p.K1 / kKc) + (p.M2 / 128) * (p.K2 / kKc);
  p.ok = p.C >= 2 && p.C <= kMaxCluster && tile_ok(p.R1) && tile_ok(p.R2) && p.slots >= 1 &&
         p.M1 % 128 == 0 && p.M2 % 128 == 0 && p.K1 % kKc == 0 && p.K2 % kKc == 0;
  return p;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk copies, the cluster, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: prior writes released, peers' acquired.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `local` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// bytes (a multiple of 16) from this CTA's shared src to shared::cluster dst
// (in CTA `rank`), completing on that CTA's barrier at bar's offset.
__device__ __forceinline__ void bulk_push(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(map_rank(dst, rank)),
      "r"(smem_addr(src)), "r"(bytes), "r"(map_rank(smem_addr(bar), rank))
      : "memory");
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
// the next one along K `lbo` bytes on, along M / N `sbo` bytes on.
__device__ __forceinline__ uint64_t descriptor(const uint8_t* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

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

// The same with A, the 64 x 32 table tile, from registers: a thread's 4
// words are its rows 16 warp + g and + 8 at K bytes 4 t .. + 3 and 16 + 4 t
// .. + 3 (g = lane / 4, t = lane % 4), as ldmatrix gives them.
template <int NT>
__device__ __forceinline__ void wgmma_rs(int (&d)[NT / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(int (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Four 8 x 16-byte core matrices, one a register, each thread its row
// lane / 4's bytes 4 (lane % 4) .. + 3; lane l gives matrix l / 8's row l % 8.
__device__ __forceinline__ void ldmatrix4(uint32_t (&a)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(row)));
}

template <int NT>
__device__ __forceinline__ void pin(int (&acc)[7][NT / 2]) {
#pragma unroll
  for (int s = 0; s < 7; ++s)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) asm volatile("" : "+r"(acc[s][e])::"memory");
}

// The 128 threads of warpgroup `group` (named barriers 2 and 3).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + group) : "memory");
}

// ---------------------------------------------------------------------------
// Arithmetic (as ntt_mxu_wg.cu).
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
// The launch's arguments, and the table chunks a warpgroup streams.
// ---------------------------------------------------------------------------

struct Args {
  const int64_t* x;
  int64_t* out;
  const uint8_t* t1;  // stage 1's table, (L, M1/64, K1/64, 4, 8, 4, 8, 16) u8
  const uint8_t* t2;  // stage 2's
  const uint32_t* twiddle;
  const uint32_t* scalars;
  long long rows;
  int L, log_n1, log_n2, log_c;
};

// Chunk v of warpgroup `group`'s sequence: polynomial it = v / per_row of
// this cluster's run, then stage 1's tiles mt = group, group + 2, ... and
// stage 2's, each tile's K chunks in order.
struct Chunk {
  const uint8_t* src;  // the chunk: one contiguous run of the table
  uint32_t bytes;
  bool valid;
};

struct Ring {
  uint8_t* slots;  // this warpgroup's slots
  uint64_t* full;  // their barriers
  int n;           // slots a warpgroup
  int slot;        // bytes of a slot
  uint32_t v;      // the next chunk to consume
};

struct Run {
  Plan p;
  Args a;
  int group, warp, lane;  // warp within the warpgroup
  uint32_t rank, cid, clusters;
  int count;              // polynomials of this cluster
};

__device__ __forceinline__ Chunk chunk_of(const Run& r, uint32_t v) {
  Chunk ch;
  const Plan& p = r.p;
  const int it = static_cast<int>(v / p.per_row);
  int w = static_cast<int>(v % p.per_row);
  ch.valid = it < r.count;
  if (!ch.valid) return ch;
  const long long row = r.cid + static_cast<long long>(it) * r.clusters;
  const int l = static_cast<int>(row % r.a.L);
  const int first = (p.M1 / 128) * (p.K1 / kKc);
  const bool one = w < first;
  if (!one) w -= first;
  const int K = one ? p.K1 : p.K2, M = one ? p.M1 : p.M2;
  const int kcs = K / kKc;
  const int mt = 2 * (w / kcs) + r.group, j = w % kcs;
  ch.bytes = 256 * kKc;
  ch.src = (one ? r.a.t1 : r.a.t2) + static_cast<size_t>(l) * 4 * M * K +
           static_cast<size_t>(mt) * 256 * K + static_cast<size_t>(j) * ch.bytes;
  return ch;
}

// Chunk v into its slot by one bulk copy, from the warpgroup's first thread.
// The slot holds its 64 x 64 blocks in turn, each as the table holds it.
__device__ __forceinline__ void issue(const Run& r, const Ring& ring, uint32_t v) {
  if ((threadIdx.x & 127) != 0) return;
  const Chunk ch = chunk_of(r, v);
  if (!ch.valid) return;
  const int s = static_cast<int>(v % ring.n);
  mbar_expect(&ring.full[s], ch.bytes);
  bulk_load(ring.slots + s * ring.slot, ch.src, ch.bytes, &ring.full[s]);
}

// ---------------------------------------------------------------------------
// Stage 1's operand: the CTA's R1 rows of V from the staged int64 slice.
// ---------------------------------------------------------------------------

// Item i is word i of every plane: core matrix i / 32, its row (i % 32) / 4,
// its bytes 4 (i % 4) .. + 3; rounds [r0, r1) of the items i = round
// kThreads + thread, or all.  src is the CTA's slice of the input row:
// forward (V = X^T) R1 columns of X, V[row][k] = src[k n2 + row]; inverse
// (V = X) R1 rows, V[row][k] = src[row n2 + k].
template <bool kInverse>
__device__ __forceinline__ void split(uint8_t* planes, const int64_t* src, int rows, int K,
                                      int stride, uint32_t q, int r0 = 0, int r1 = 1 << 16) {
  const int KB = K >> 4;
  const int plane = rows * K;
  const int end = min(plane / 4, r1 * kThreads);
  for (int i = r0 * kThreads + threadIdx.x; i < end; i += kThreads) {
    const int cm = i >> 5, lane = i & 31;
    const int row = (cm / KB) * 8 + (lane >> 2);
    const int k = (cm % KB) * 16 + (lane & 3) * 4;
    uint32_t v[4];
    if (kInverse) {
      const longlong2* p = reinterpret_cast<const longlong2*>(src + row * stride + k);
      const longlong2 a = p[0], b = p[1];
      v[0] = static_cast<uint32_t>(a.x);
      v[1] = static_cast<uint32_t>(a.y);
      v[2] = static_cast<uint32_t>(b.x);
      v[3] = static_cast<uint32_t>(b.y);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = static_cast<uint32_t>(src[(k + j) * stride + row]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = cond_sub(v[j], q);
    const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140), lo23 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362), hi23 = __byte_perm(v[2], v[3], 0x7362);
    uint32_t* w = reinterpret_cast<uint32_t*>(planes) + i;
    w[0] = __byte_perm(lo01, lo23, 0x5410);
    w[plane / 4] = __byte_perm(lo01, lo23, 0x7632);
    w[plane / 2] = __byte_perm(hi01, hi23, 0x5410);
    w[3 * plane / 4] = __byte_perm(hi01, hi23, 0x7632);
  }
}

// The CTA's slice of polynomial it's input: forward, R1 columns [rank R1,
// + R1) of each of X's n1 rows; inverse, R1 whole rows.
template <bool kInverse>
__device__ __forceinline__ const int64_t* slice(const Run& r, int it) {
  const Plan& p = r.p;
  const long long row = r.cid + static_cast<long long>(it) * r.clusters;
  const int64_t* x = r.a.x + row * (p.n1 * p.n2);
  return x + (kInverse ? static_cast<size_t>(r.rank) * p.R1 * p.n2 : r.rank * p.R1);
}

// ---------------------------------------------------------------------------
// A stage: warpgroup `group`'s 64-row tiles of the table against the CTA's
// R data rows (one NT = R tile), K in chunks from its ring.
// ---------------------------------------------------------------------------

// Where the stage's values go: stage 1 into stage 2's operand planes in the
// cluster (twiddled), through this CTA's outgoing tiles; stage 2 into the
// output row.
struct Epilogue {
  uint8_t* out1;            // stage 1: the outgoing tiles
  uint32_t v2;              // stage 1: the local address of the V2 planes
  uint64_t* v2full;         // stage 1: the barrier the pushes complete on
  const uint32_t* twiddle;  // stage 1: this limb's (M1, N1, 2)
  int64_t* out;             // stage 2: the output row
  bool wait_empty;          // stage 1: wait for v2empty before writing
  uint32_t empty_parity;
  uint64_t* v2empty;
  bool expect_empty;        // stage 1: v2empty's next phase follows (thread 0 expects it)
  const int64_t* next;      // stage 2: the next polynomial's slice, split into V1 under
  uint32_t next_q;          //   the products (null: none)
  uint8_t* V1;
  uint8_t* sink;            // stage 2: the 16 bytes each v2empty signal pushes
};

template <int NT, bool kFirst, bool kInverse>
__device__ __forceinline__ void run_stage(const Run& r, Ring& ring, const uint8_t* B,
                                          const Epilogue& ep, const Scalars& c,
                                          uint64_t* signal) {
  // signal: stage 2's v2empty where a next polynomial follows
  const Plan& p = r.p;
  const int M = kFirst ? p.M1 : p.M2, K = kFirst ? p.K1 : p.K2;
  const int kcs = K / kKc, tiles = M / 128;
  const int g = r.lane >> 2, t = r.lane & 3;
  // V1 (stage 1) in core matrices by row group then K; V2 (stage 2) by K
  // block then row group, so that each CTA's pushed block is one run
  const int b_plane = NT * K;
  const uint32_t b_lbo = kFirst ? 128u : 16u * NT, b_sbo = kFirst ? 8u * K : 128u;
  const int b_step = kFirst ? 8 : NT;  // bytes a byte of K moves the descriptor
  // stage 2: the next polynomial's split, a share of its rounds under each
  // chunk's products
  const int rounds = p.v1 / 4 / kThreads, shares = tiles * kcs;
  for (int u = 0; u < tiles; ++u) {
    const int mt = 2 * u + r.group;
    int acc[7][NT / 2];
    // The table tile from registers (ldmatrix once a step, 16 products on
    // them) at 16-row data tiles, where the shared-memory operand re-read by
    // each product bounds the step; at 32 rows the registers do not fit
    // beside the accumulators, and it is read from shared memory.
    constexpr bool kRegisterA = NT == 16;
    // this lane's row of the ldmatrix quartet: rows 16 warp + 8 (l / 8 % 2)
    // + l % 8 of the tile, K block l / 16 of the step
    const int lrow = 16 * r.warp + 8 * ((r.lane >> 3) & 1) + (r.lane & 7);
    const int arow = (lrow >> 3) * 512 + (lrow & 7) * 16 + (r.lane >> 4) * 128;
    for (int c = 0; c < kcs; ++c) {
      const uint32_t v = ring.v++;
      const int s = static_cast<int>(v % ring.n);
      mbar_wait(&ring.full[s], (v / ring.n) & 1);
      const uint8_t* A = ring.slots + s * ring.slot;
      uint32_t a[2][4][4];  // two steps' 4 planes of the table tile
#pragma unroll
      for (int st = 0; st < kKc / 32; ++st) {
        const int ks = 32 * st;
        // at most the last step in flight: step st - 2's registers are free
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (st == 1 && c > 0 && ring.n > 1)
          issue(r, ring, v - 1 + ring.n);  // chunk v - 1's products are done
        // the slot's block ks / 64, its plane q, K block (ks % 64) / 16
        const uint8_t* at = A + (ks >> 6) * kBlock + ((ks & 63) >> 4) * 128 + arow;
        uint64_t db[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (kRegisterA) ldmatrix4(a[st & 1][q], at + q * 4096);
          db[q] = descriptor(B + q * b_plane + b_step * (c * kKc + ks), b_lbo, b_sbo);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int accumulate = c > 0 || ks > 0 || (i > 0 && j < 3);
            if (kRegisterA)
              wgmma_rs<NT>(acc[i + j], a[st & 1][i], db[j], accumulate);
            else
              wgmma<NT>(acc[i + j], descriptor(at - arow + i * 4096, 128, 512), db[j], accumulate);
          }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      if (!kFirst && ep.next) {
        const int e = u * kcs + c;  // this chunk's share of the rounds
        split<kInverse>(ep.V1, ep.next, p.R1, p.K1, p.n2, ep.next_q, e * rounds / shares,
                        (e + 1) * rounds / shares);
      }
      if (ring.n == 1) {  // the one slot is free once its products are done
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        issue(r, ring, v + 1);
      }
    }
    uint4 tw[NT / 8][2];
    if (kFirst) {  // the twiddles, loaded while the last products run
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 64 * mt + 16 * r.warp + g + 8 * h;
          const int n = r.rank * NT + 8 * j + 2 * t;
          tw[j][h] = *reinterpret_cast<const uint4*>(
              ep.twiddle + 2 * (static_cast<size_t>(m) * p.N1 + n));
        }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin<NT>(acc);
    if (ring.n > 1) issue(r, ring, ring.v - 1 + ring.n);
    if (!kFirst && u == tiles - 1 && signal) {
      // the group's products on V2 are done: the buffer may be rewritten.
      // Each CTA's v2empty counts 16 bytes pushed by every group of the
      // cluster (a bulk copy, so no release has to drain this thread's
      // stores first)
      group_sync(r.group);
      if ((threadIdx.x & 127) == 0)
        for (int d = 0; d < p.C; ++d) bulk_push(smem_addr(ep.sink), ep.sink, 16, signal, d);
    }
    if (kFirst && u == 0 && ep.wait_empty) {
      mbar_wait(ep.v2empty, ep.empty_parity);
      if (threadIdx.x == 0 && ep.expect_empty) mbar_expect(ep.v2empty, 2 * 16 * p.C);
    }
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * mt + 16 * r.warp + g + 8 * h;
        const int n = r.rank * NT + 8 * j + 2 * t;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * j + 2 * h + e;
          v[e] = recombine(acc[0][k], acc[1][k], acc[2][k], acc[3][k], acc[4][k], acc[5][k],
                           acc[6][k], c);
        }
        if (kFirst) {
          v[0] = cond_sub(shoup(v[0], tw[j][h].x, tw[j][h].y, c.q), c.q);
          v[1] = cond_sub(shoup(v[1], tw[j][h].z, tw[j][h].w, c.q), c.q);
          // planes 0, 1 (lo) and 2, 3 (hi) of values n, n + 1: the quad's four
          // lanes (n = n0 + 2 t) trade them so that lane t holds 8 bytes, n0 ..
          // n0 + 7, of one plane (t = 0, 1, 2, 3: planes 0, 2, 1, 3)
          const uint32_t lo = __byte_perm(v[0], v[1], 0x5140);
          const uint32_t hi = __byte_perm(v[0], v[1], 0x7362);
          const bool odd = t & 1, upper = t & 2;
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
          const uint32_t x = odd ? __byte_perm(got, hi, 0x5410) : __byte_perm(lo, got, 0x5410);
          const uint32_t y = odd ? __byte_perm(got, hi, 0x7632) : __byte_perm(lo, got, 0x7632);
          const uint32_t other = __shfl_xor_sync(0xffffffffu, upper ? x : y, 2);
          // into the outgoing tile: the block of destination CTA m / R2 (stage
          // 2's V rows m), K n0 .. n0 + 7 local, in the destination's layout
          const int rr = m % p.R2, k0 = n - r.rank * NT - 2 * t;
          uint8_t* o = ep.out1 + mt * (256 * NT) + ((m & 63) / p.R2) * (4 * NT * p.R2) +
                       ((t >> 1) | ((t & 1) << 1)) * (NT * p.R2) + (k0 >> 4) * (16 * p.R2) +
                       (rr >> 3) * 128 + (rr & 7) * 16 + (k0 & 15);
          *reinterpret_cast<uint2*>(o) = upper ? make_uint2(other, y) : make_uint2(x, other);
        } else {
          v[0] = cond_sub(cond_sub(v[0], c.q), c.q);
          v[1] = cond_sub(cond_sub(v[1], c.q), c.q);
          if (kInverse) {  // out[r'][c]: (m, n) and (m, n + 1) side by side
            *reinterpret_cast<longlong2*>(ep.out + static_cast<size_t>(m) * p.n2 + n) =
                make_longlong2(v[0], v[1]);
          } else {         // out[r][c']: n is the row
            ep.out[static_cast<size_t>(n) * p.n2 + m] = v[0];
            ep.out[static_cast<size_t>(n + 1) * p.n2 + m] = v[1];
          }
        }
      }
    }
    if (kFirst) {
      // the tile's blocks pushed to their CTAs by one bulk copy each (a
      // destination, a plane), completing on the destination's v2full
      fence_async_smem();
      group_sync(r.group);
      if ((threadIdx.x & 127) == 0) {
        const int per = 64 / p.R2;
        for (int d = 0; d < per; ++d)
          for (int q = 0; q < 4; ++q)
            bulk_push(ep.v2 + q * (p.R2 * p.K2) + r.rank * NT * p.R2,
                      ep.out1 + mt * (256 * NT) + d * (4 * NT * p.R2) + q * (NT * p.R2),
                      NT * p.R2, ep.v2full, (64 * mt) / p.R2 + d);
      }
    }
  }
}

// A cluster: polynomials cid, cid + G, ... of the launch (G clusters).
template <bool kInverse, int NT1, int NT2>
__global__ void __launch_bounds__(kThreads, 1) ntt_mxu_cluster_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxSlots + 2];  // rings, v2full, v2empty
  __shared__ __align__(16) uint8_t sink[16];
  Run r;
  r.p = make_plan(kInverse, a.log_n1, a.log_n2, a.log_c);
  r.a = a;
  r.group = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // warp-uniform
  r.warp = (threadIdx.x >> 5) & 3;
  r.lane = threadIdx.x & 31;
  r.rank = cluster_rank();
  r.cid = cluster_id();
  r.clusters = cluster_count();
  r.count = a.rows > r.cid ? static_cast<int>((a.rows - r.cid + r.clusters - 1) / r.clusters) : 0;
  const Plan& p = r.p;
  const int slot = 256 * kKc;
  uint8_t* V1 = smem + 2 * p.slots * slot;
  uint8_t* V2 = V1 + p.v1;
  uint8_t* out1 = V2 + p.v2;
  uint64_t* v2full = &bars[2 * kMaxSlots];
  uint64_t* v2empty = &bars[2 * kMaxSlots + 1];
  Ring ring{smem + r.group * p.slots * slot, &bars[r.group * p.slots], p.slots, slot, 0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * p.slots; ++s) mbar_init(&bars[s], 1);
    mbar_init(v2full, 1);
    mbar_init(v2empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (r.count > 0) mbar_expect(v2full, p.v2);            // polynomial 0's pushes
    if (r.count > 1) mbar_expect(v2empty, 2 * 16 * p.C);  // its stage 2's signals
  }
  cluster_sync();  // every CTA's barriers ready before any peer arrives on them
  for (uint32_t v = 0; v < static_cast<uint32_t>(ring.n); ++v) issue(r, ring, v);
  if (r.count > 0) {
    const uint32_t q0 = a.scalars[(r.cid % a.L) * kScalarSlots];
    split<kInverse>(V1, slice<kInverse>(r, 0), p.R1, p.K1, p.n2, q0);
  }

  for (int it = 0; it < r.count; ++it) {
    const long long row = r.cid + static_cast<long long>(it) * r.clusters;
    const int l = static_cast<int>(row % a.L);
    const uint32_t* sc = a.scalars + l * kScalarSlots;
    const Scalars c{sc[0], sc[1], sc[2], sc[3], sc[4]};
    fence_async_smem();
    __syncthreads();  // V1 whole (split before the loop, or under the last stage 2)
    const bool more = it + 1 < r.count;
    const Epilogue first{out1, smem_addr(V2), v2full,
                         a.twiddle + static_cast<size_t>(l) * p.M1 * p.N1 * 2, nullptr,
                         it > 0, static_cast<uint32_t>((it - 1) & 1), v2empty, more,
                         nullptr, 0, nullptr, nullptr};
    run_stage<NT1, true, kInverse>(r, ring, V1, first, c, nullptr);
    mbar_wait(v2full, it & 1);  // every CTA's block of V2 has landed
    if (threadIdx.x == 0 && more) mbar_expect(v2full, p.v2);
    const int next_l = static_cast<int>((row + r.clusters) % a.L);
    const Epilogue second{nullptr, 0, nullptr, nullptr, a.out + row * (p.n1 * p.n2), false, 0,
                          nullptr, false, more ? slice<kInverse>(r, it + 1) : nullptr,
                          a.scalars[next_l * kScalarSlots], V1, sink};
    run_stage<NT2, false, kInverse>(r, ring, V2, second, c, more ? v2empty : nullptr);
  }
  cluster_sync();  // no CTA leaves while a peer may still reach its shared memory
}

// The kernels the plans take: (R1, R2) of each direction and degree.
const void* kernel_fn(bool inverse, int R1, int R2) {
  if (inverse) {
    if (R1 == 16 && R2 == 32) return reinterpret_cast<const void*>(ntt_mxu_cluster_kernel<true, 16, 32>);
    if (R1 == 32 && R2 == 32) return reinterpret_cast<const void*>(ntt_mxu_cluster_kernel<true, 32, 32>);
    if (R1 == 16 && R2 == 16) return reinterpret_cast<const void*>(ntt_mxu_cluster_kernel<true, 16, 16>);
  } else {
    if (R1 == 32 && R2 == 16) return reinterpret_cast<const void*>(ntt_mxu_cluster_kernel<false, 32, 16>);
    if (R1 == 32 && R2 == 32) return reinterpret_cast<const void*>(ntt_mxu_cluster_kernel<false, 32, 32>);
    if (R1 == 16 && R2 == 16) return reinterpret_cast<const void*>(ntt_mxu_cluster_kernel<false, 16, 16>);
  }
  return nullptr;
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, const Plan& p,
                   int clusters, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(clusters * p.C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// fn readied for the plan (shared memory granted; a cluster above 8 CTAs, a
// size that is not portable, allowed) and the clusters the card holds at
// once into *clusters; 0 or a CUDA error.  Cached per device, kernel and
// shape.
int ready(const void* fn, const Plan& p, int* clusters) {
  struct Seen {
    const void* fn;
    int dev, smem, C, clusters;
  };
  static Seen seen[32];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev && seen[i].smem == p.smem && seen[i].C == p.C) {
      *clusters = seen[i].clusters;
      return 0;
    }
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (p.C > 8 &&
      (err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, p, 1, nullptr);
  if ((err = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg)) != cudaSuccess)
    return static_cast<int>(err);
  if (n_seen < 32) seen[n_seen++] = {fn, dev, p.smem, p.C, *clusters};
  return 0;
}

int launch(bool inverse, const void* x, void* out, const void* t1, const void* t2,
           const void* twiddle, const void* scalars, long long polys, int L, int log_n1,
           int log_n2, int log_c, void* stream) {
  const Plan p = make_plan(inverse, log_n1, log_n2, log_c);
  const void* fn = p.ok ? kernel_fn(inverse, p.R1, p.R2) : nullptr;
  if (!fn || p.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (polys <= 0) return 0;
  int clusters = 0;
  const int err = ready(fn, p, &clusters);
  if (err) return err;
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int grid = polys < clusters ? static_cast<int>(polys) : clusters;
  Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
         static_cast<const uint8_t*>(t1), static_cast<const uint8_t*>(t2),
         static_cast<const uint32_t*>(twiddle), static_cast<const uint32_t*>(scalars), polys,
         L, log_n1, log_n2, log_c};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, p, grid, static_cast<cudaStream_t>(stream));
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mxu_cl
}  // namespace troy

// polys rows of n = 2^(log_n1 + log_n2) int64 values, limb of row r = r % L,
// a polynomial a cluster of 2^log_c CTAs; t1, t2: the direction's two stage
// tables (MxuNTTTables.wg_w); twiddle: the direction's (L, M1, N1, 2);
// scalars (L, 8).
extern "C" int troy_ntt_forward_mxu_cluster(const void* x, void* out, const void* t1,
                                            const void* t2, const void* twiddle,
                                            const void* scalars, long long polys, int L,
                                            int log_n1, int log_n2, int log_c, void* stream) {
  return troy::mxu_cl::launch(false, x, out, t1, t2, twiddle, scalars, polys, L, log_n1, log_n2,
                              log_c, stream);
}

extern "C" int troy_ntt_inverse_mxu_cluster(const void* x, void* out, const void* t1,
                                            const void* t2, const void* twiddle,
                                            const void* scalars, long long polys, int L,
                                            int log_n1, int log_n2, int log_c, void* stream) {
  return troy::mxu_cl::launch(true, x, out, t1, t2, twiddle, scalars, polys, L, log_n1, log_n2,
                              log_c, stream);
}

// info: threads, dynamic shared bytes, registers, local (spill) bytes a
// thread, the clusters the card holds at once, the cluster size, the data
// rows a CTA of each stage (R1, R2), a warpgroup's slots, a chunk's K bytes
// and the bytes of the two operand plane sets and of the outgoing tiles.
extern "C" int troy_ntt_mxu_cluster_info(int inverse, int log_n1, int log_n2, int log_c,
                                         int* info) {
  using namespace troy::mxu_cl;
  const Plan p = make_plan(inverse != 0, log_n1, log_n2, log_c);
  const void* fn = p.ok ? kernel_fn(inverse != 0, p.R1, p.R2) : nullptr;
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  int err = ready(fn, p, &clusters);
  if (err) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vals[13] = {kThreads, p.smem, attr.numRegs, static_cast<int>(attr.localSizeBytes),
                        clusters, p.C, p.R1, p.R2, p.slots, kKc, p.v1, p.v2, p.out};
  for (int i = 0; i < 13; ++i) info[i] = vals[i];
  return 0;
}

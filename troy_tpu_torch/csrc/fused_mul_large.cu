// The fused negacyclic tensor product of two 2-polynomial ciphertexts at
// degrees above 32768, for NVIDIA Hopper (sm_90a):
//
//   a (B, 2, L, n), b (B, 2, L, n)  ->  INTT(NTT a (x) NTT b)  (B, 3, L, n)
//
// with (x) the dyadic convolution (a0 b0, a0 b1 + a1 b0, a1 b1) mod q.
//
// Replaces the TPU kernel troy_tpu/ops/fused_mul.py:_kernel (K4) at
// n = 65536 and 131072, where one operand polynomial does not fit a CTA, so
// fused_mul.cu's cluster of one CTA per operand cannot hold it.
//
// Bound: at (3, 2, 2, 65536) the launch moves 7 polynomials of int64 per
// (batch, limb), 22 MB (6.6 us at 3.35 TB/s), and runs 7 transforms of
// 16 * 32768 butterflies and the products per (batch, limb), 192 M int32
// operations (11.5 us on the card's int32 lanes): it is bound by operations.
//
// Design: one (batch, limb) is one thread-block cluster of C = 2^K CTAs, and
// CTA r holds block r of n2 = n / C values of all four operands a0, a1, b0,
// b1 side by side in its shared memory (ntt_phases.cuh's cluster layout), so
// the four operands' values at one coefficient of the NTT domain sit in one
// CTA and the products need no exchange.  Both limb tables of block r (the
// forward and the inverse slice of NTTTables.kernel_phases with the split)
// sit behind the operands, copied by cp.async at the start.
//   1. The forward column stages of the four operands, a column a thread,
//      loaded from device memory, written into their blocks across the
//      cluster (scatter_column) once every CTA has arrived; cluster barrier.
//   2. The forward block phases of the four, each phase shared out over the
//      CTA's threads (plan_polys), the plan known at compile time.
//   3. The three products in place, by the thread that reads the four
//      operands at a coefficient: reduced operands, 64-bit products and
//      Montgomery's REDC (mont_redc, [0, 2q)), whose 2^-32 the final scale
//      n^-1 2^32 (NTTTables.kernel_scalars rows 4, 5) undoes.
//   4. The inverse block phases of c0, c1, c2; cluster barrier.
//   5. Each column of the three products gathered from the blocks
//      (gather_column), its inverse column stages and the scale in
//      registers, stored; a last cluster barrier keeps every block in place
//      until no peer reads it.
// One launch reads a and b once and writes the product once.
//
// Instantiated per (log2 n2, K): n = 65536 as 16 blocks of 4096 (on the
// H100 faster than 8 blocks of 8192, 28.7 against 51.6 us at
// (3, 2, 2, 65536); PERF.md, PR 12), n = 131072 as 16 blocks of 8192 (8
// blocks of 16384 would need 270 KB of shared memory).  Clusters of 16 CTAs
// are not portable; the launch allows them and refuses a cluster the card
// cannot hold (cudaOccupancyMaxActiveClusters of 0), and the wrapper raises.
//
// The route it replaces (ops/fused_mul_cuda.py: the NTT's two-launch forward
// of (a, b), tensor_product.cu's product, the two-launch inverse; five
// launches) stays as its timing yardstick.  The kernel never allocates.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_phases.cuh"

namespace cg = cooperative_groups;

namespace {

// One (batch, limb) per cluster of 2^K CTAs; CTA `rank` holds block `rank`
// of 2^LogB values of each operand.  phases: (2, L, 2^K 2 E) u32 pairs;
// columns: (2, L, 2^(K+1)) u32; scalars: kernel_scalars (6, L).
template <int LogB, int K>
__global__ void __launch_bounds__(kThreads)
    fused_mul_large_kernel(const int64_t* __restrict__ a,
                           const int64_t* __restrict__ b, int64_t* __restrict__ out,
                           const uint32_t* __restrict__ phases,
                           const uint32_t* __restrict__ columns,
                           const uint32_t* __restrict__ scalars, int L,
                           int entries) {
  constexpr int C = 1 << K;
  constexpr int words = data_words(LogB);   // one operand block, padded
  constexpr int cols = 1 << (LogB - K);     // columns of a CTA
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cell = static_cast<int>(blockIdx.x >> K);
  const int batch = cell / L, limb = cell % L;
  const uint32_t q = scalars[limb];
  const uint32_t q_inv_neg = scalars[3 * L + limb];
  const uint32_t n_inv = scalars[4 * L + limb];     // n^-1 2^32 mod q
  const uint32_t n_inv_sh = scalars[5 * L + limb];
  const size_t ln = static_cast<size_t>(L) << (LogB + K);  // a poly's limbs
  const size_t off = static_cast<size_t>(limb) << (LogB + K);
  const int first = rank * cols;  // this CTA's first column

  cluster_arrive_relaxed();
  const uint2* fwd = stage_twiddles(
      s + 4 * words,
      phases + ((static_cast<size_t>(limb) << K) + rank) * 2 * entries, entries);
  const uint2* inv = stage_twiddles(
      s + 4 * words + 2 * entries,
      phases + ((static_cast<size_t>(L + limb) << K) + rank) * 2 * entries,
      entries);
  const uint4* fcol = reinterpret_cast<const uint4*>(columns) +
                      (static_cast<size_t>(limb) << (K - 1));
  const uint4* icol = reinterpret_cast<const uint4*>(columns) +
                      (static_cast<size_t>(L + limb) << (K - 1));
  uint32_t x[C];

  // 1. The column stages of operand o (a0, a1, b0, b1) into the blocks.
  bool waited = false;
  for (int w = threadIdx.x; w < 4 * cols; w += blockDim.x) {
    const int o = w / cols, j = first + w % cols;
    load_column<K>((o < 2 ? a : b) + (2 * static_cast<size_t>(batch) + (o & 1)) * ln + off,
                   j, LogB, x);
    radix_stages<K, false, false>(x, fcol, nullptr, q);
    if (!waited) cluster_wait();
    waited = true;
    scatter_column<K>(s + o * words, j, x);
  }
  if (!waited) cluster_wait();
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();

  // 2. The forward block phases, 3. the products over a0, a1, b0.
  plan_polys<LogB, false>(4, words, s, fwd, q);
  for (int i = threadIdx.x; i < (1 << LogB); i += blockDim.x) {
    const int at = pad(i);
    const uint64_t a0 = troy::reduce_from_4q(s[at], q);
    const uint64_t a1 = troy::reduce_from_4q(s[words + at], q);
    const uint64_t b0 = troy::reduce_from_4q(s[2 * words + at], q);
    const uint64_t b1 = troy::reduce_from_4q(s[3 * words + at], q);
    s[at] = mont_redc(a0 * b0, q, q_inv_neg);
    s[words + at] = mont_redc(a0 * b1 + a1 * b0, q, q_inv_neg);
    s[2 * words + at] = mont_redc(a1 * b1, q, q_inv_neg);
  }
  __syncthreads();

  // 4. The inverse block phases of the products, 5. their columns out.
  plan_polys<LogB, true>(3, words, s, inv, q);
  cluster.sync();
  for (int w = threadIdx.x; w < 3 * cols; w += blockDim.x) {
    const int p = w / cols, j = first + w % cols;
    gather_column<K>(s + p * words, j, x);
    radix_stages<K, true, false>(x, icol, nullptr, q);
    store_column<K>(out + (3 * static_cast<size_t>(batch) + p) * ln + off, j, LogB, x,
                    q, n_inv, n_inv_sh);
  }
  cluster.sync();
}

// The kernel for n = 2^(log_b + split), with the plan code it was compiled
// for; null for a shape it does not take.
struct Large {
  const void* fn;
  int plan;
};

template <int LogB, int K>
Large large() {
  return {reinterpret_cast<const void*>(fused_mul_large_kernel<LogB, K>),
          Plan<LogB>::code()};
}

Large large_for(int log_b, int split) {
  if (log_b == 12 && split == 4) return large<12, 4>();
  if (log_b == 13 && split == 4) return large<13, 4>();
  return {nullptr, 0};
}

// A CTA: 256 threads, the four operand blocks and both tables.
Shape large_shape(int log_b, int entries) {
  return {kThreads, 4 * static_cast<size_t>(data_words(log_b)) * sizeof(uint32_t) +
                        2 * static_cast<size_t>(entries) * sizeof(uint2)};
}

}  // namespace

// a, b: (n_batch, 2, L, n) int64 contiguous and 16-byte aligned, n =
// 2^(log_b + split); out: (n_batch, 3, L, n).  phases, columns: the tables'
// kernel_phases and column_phases with that split; plan: the block plan's
// code (refused unless it is the kernel's); entries: table pairs a block.
extern "C" int troy_fused_mul_large(const void* a, const void* b, void* out,
                                    const void* phases, const void* columns,
                                    const void* scalars, long long n_batch, int L,
                                    int log_b, int split, int plan, int entries,
                                    void* stream) {
  const Large k = large_for(log_b, split);
  if (!k.fn || plan != k.plan) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a, &b, &out, &phases, &columns, &scalars, &L, &entries};
  return launch_clusters(k.fn, 1 << split, large_shape(log_b, entries), n_batch * L,
                         stream, args);
}

// As troy_ntt_cluster_info, for this kernel at one (log_b, split).
extern "C" int troy_fused_mul_large_info(int log_b, int split, int entries,
                                         int* info) {
  const Large k = large_for(log_b, split);
  if (!k.fn) return static_cast<int>(cudaErrorInvalidValue);
  const Shape shape = large_shape(log_b, entries);
  int clusters = 0, blocks = 0;
  int err = cluster_ready(k.fn, 1 << split, shape, &clusters);
  if (err) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, k.fn));
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k.fn, shape.threads, shape.smem));
  if (err) return err;
  info[0] = shape.threads;
  info[1] = static_cast<int>(shape.smem);
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = blocks;
  info[5] = clusters;
  return 0;
}

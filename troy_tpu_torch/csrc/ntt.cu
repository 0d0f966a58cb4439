// Negacyclic NTT / INTT over RNS limbs for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel K1 of troy_tpu/ops/ntt_pallas.py: _fwd_kernel /
// _inv_kernel (launcher _ntt_pallas), the fused six-step transform with
// Shoup-lazy VPU butterflies.  Output in [0, q), in the NTT order "position
// p holds psi^(2*brv(p)+1)" (troy_tpu/ops/ntt.py).  K2 (_fwd_kernel_mxu,
// the same function as int8 matrix products) has its own kernel,
// ntt_mxu.cu, under set_ntt_backend("pallas_mxu").
//
// Bound: one (row, limb) polynomial of n = 8192 moves 64 KiB in and 64 KiB
// out as int64 and takes 13 * 4096 butterflies of about 8 int32 operations,
// so the transform is bound by device memory (3.35 TB/s), with int32
// arithmetic close behind.  What held the first, radix-2 kernel back was
// per-CTA latency: 13 barrier-separated radix-2 stages over shared memory, the
// twiddles loaded inside every butterfly, 1024 threads a polynomial.
//
// Design (troy_ntt_forward / troy_ntt_inverse), one CTA per polynomial:
//   * Register-resident radix-2^k phases.  ops/ntt.py:kernel_phase_plan
//     splits the log2(n) stages into phases of k <= 5 stages (n = 8192:
//     4 + 4 + 5).  In a phase each thread takes the 2^k values of a
//     sub-transform into registers, runs its k stages there and writes them
//     back, so a polynomial crosses 3 barriers, not 13.  Harvey/Shoup
//     arithmetic as before: values stay below 4q < 2^32 (q < 2^30), one
//     __umulhi per twiddle product.
//   * 16-byte device-memory accesses: the polynomial comes into shared
//     memory two int64 residues a load, 16 loads in flight per thread, and
//     leaves it two a store.  The inverse's last phase writes device memory
//     straight from registers: a thread takes the neighbouring
//     sub-transforms u and u + 1, so each store moves two residues, and no
//     barrier separates a warp's butterflies from its stores.  (The
//     forward's first phase read straight from device memory the same way
//     is faster at launches of one wave and slower at the keyswitch digits'
//     2.5 waves, so the forward stages its load: scripts/
//     torch_ntt_variants.py, fwd_fused.)
//   * Twiddles off the critical path: NTTTables.kernel_phases holds, per
//     phase and sub-transform root, the twiddles the sub-transform needs
//     (the heap subtree of psi_br or inv_psi_br) with Shoup companions, as
//     (w, w') u32 pairs read as 16-byte vectors, independent of the data.
//     The last phase, with a root per 32 values, would read as many twiddle
//     bytes as value bytes; its two deepest levels factor their twiddles
//     into the root's psi_br[v 2^l] and one of 15 per-limb constants
//     psi_br[g] (two Shoup products), which cuts its table by 3.2x.  Each
//     CTA copies its limb's table (22.8 KB at n = 8192) into shared memory
//     with cp.async while its polynomial loads, so no phase waits on L2 for
//     a twiddle.  (With the twiddles read from device memory in every phase
//     instead, every forward launch and every inverse launch of more than
//     one wave is slower, the inverses of under one wave slightly faster:
//     scripts/torch_ntt_variants.py, ldg_twiddle.)
//   * 256 threads a polynomial at n >= 8192, 2 CTAs per SM, so one CTA's
//     loads and barriers overlap another's butterflies.  Registers capped
//     for 3 CTAs an SM win at some launches and lose at others, among them
//     the multiply's inverse over base Bsk and both inverses of a Galois
//     round; for 4 they lose at every launch.
//     Shared memory is padded by one word in 32, so every phase's accesses
//     are free of bank conflicts.
//
// The device code of the phases (butterflies, phases, the table copy, the
// value loads and stores) lives in ntt_phases.cuh, which the fused
// tensor-product kernel K4 (fused_mul.cu) runs too; this file holds the
// kernel pair, its launch and its yardstick.
//
// The first kernel pair (one radix-2 stage per barrier) stays in this library
// as troy_ntt_{forward,inverse}_radix2, a yardstick that only the timing
// phase of chip_smoke.py launches; no wrapper routes to it.  Its stages live
// in ntt_common.cuh, shared with K4's own yardstick.
//
// Layout: input (rows, n) int64 contiguous and 16-byte aligned, with the
// limb of row r equal to r % L; this covers (B, L, n), (B, 2, L, n) and the
// keyswitch digit tensor (B, L, L+1, n).  Tables: phases (2, L, 2 E) u32
// (forward, inverse; E pairs per limb, ops/ntt.py:phase_rows); scalars
// (3, L) u32 = q, n^-1, n^-1 Shoup.  The forward transform accepts lazy
// input in [0, 2q); the inverse takes [0, 2q) too and scales by n^-1.
// Kernels never allocate.
//
// Degrees above 32768 (to the reference's 131072) do not fit one CTA.  Over
// n = C n2, C = 2^split (ops/ntt.py:default_split: clusters of 16 at both
// 65536 and 131072, the fastest on the H100, PERF.md), the first log2 C
// forward stages are one size-C transform of root 1 on every column
// x[e n2 + j], e < C, and the remaining stages are, on each contiguous
// block b of n2 values, the sub-transforms of roots v = C + b: the
// one-polynomial schedule above on n2 values with block b's own slice of
// the twiddle heap (NTTTables.kernel_phases, split per block by
// ops/ntt.py:phase_rows).
//   * The route (ntt_cluster_kernel, troy_ntt_cluster_*): one launch, a
//     polynomial a thread-block cluster of C CTAs, CTA b holding block b in
//     its shared memory.  The column stages run in registers straight from
//     device memory and cross the cluster once through distributed shared
//     memory (ntt_phases.cuh's cluster helpers), so device memory is read
//     once and written once: the one-pass bound.
//   * Its yardstick, the first route above 32768 (PR 6), launched only to
//     time the route against: two launches over the same split.  The column
//     kernel (ntt_columns_kernel) holds the columns j, j + 1 of one
//     polynomial in registers (2^split 16-byte loads, adjacent threads on
//     adjacent columns) and stores them reduced to [0, q); the block kernel
//     (ntt_block_kernel) is the one-polynomial kernel on block b.  The
//     inverse runs the block kernel first (scaled by 1, that is reduced to
//     [0, q), from the block scalars q, 1, floor(2^32 / q)), then the column
//     kernel with the n^-1 scale.  Each launch reads and writes the whole
//     polynomial, so the pair reaches at most half of the one-pass bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;

// One polynomial per CTA: the limb's twiddle table and the whole polynomial
// into shared memory (cp.async for the table; 16-byte loads, 16 in flight
// per thread, for the values), the phases there, and the whole polynomial
// out (16-byte stores), but for the inverse's store_phase.
// plan: depth of phase i in bits 4i..4i+3 (ops/ntt.py:kernel_plan_code; a
// plan of two or more phases starts with a phase of at most 4); entries:
// table pairs per limb.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    ntt_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
               const uint32_t* __restrict__ phases,
               const uint32_t* __restrict__ scalars, int L, int log_n,
               int plan, int entries) {
  extern __shared__ uint32_t s[];
  const int limb = blockIdx.x % L;
  const uint32_t q = scalars[limb];
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
  const uint32_t* table =
      phases + static_cast<size_t>((kInverse ? L : 0) + limb) * 2 * entries;
  const uint2* tw = stage_twiddles(s + data_words(log_n), table, entries);
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;
  const int count = phase_count(plan);
  const bool fused = kInverse && count > 1;  // phase 0 as store_phase

  load_values(s, in + base, log_n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  smem_phases<kInverse>(s, log_n, plan, count, fused, tw, q);

  if (fused) {
    run_store_phase(plan & 15, s, out + base, log_n, tw + kConstantSlots, q,
                    n_inv, n_inv_sh);
    return;
  }
  store_values<kInverse>(s, out + base, log_n, q, n_inv, n_inv_sh);
}

template <bool kInverse>
int launch_ntt(const void* in, void* out, const void* phases,
               const void* scalars, long long n_rows, int L, int log_n,
               int plan, int entries, void* stream) {
  if (n_rows <= 0) return 0;
  const Shape shape = ntt_shape(log_n, entries);
  if (shape.smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_kernel<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shape.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ntt_kernel<kInverse><<<static_cast<unsigned int>(n_rows), shape.threads,
                         shape.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(phases),
      static_cast<const uint32_t*>(scalars), L, log_n, plan, entries);
  return static_cast<int>(cudaGetLastError());
}

// ---- The first radix-2 pair: the timing yardstick -------------------------

__global__ void ntt_forward_radix2_kernel(const int64_t* __restrict__ in,
                                          int64_t* __restrict__ out,
                                          const uint32_t* __restrict__ rows,
                                          const uint32_t* __restrict__ scalars,
                                          int L, int log_n) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t q = scalars[limb];
  const uint32_t* psi = rows + static_cast<size_t>(limb) * n;
  const uint32_t* psi_sh = rows + static_cast<size_t>(L + limb) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = static_cast<uint32_t>(in[base + i]);
  __syncthreads();
  troy::forward_stages<1>(s, log_n, psi, psi_sh, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = static_cast<int64_t>(troy::reduce_from_4q(s[i], q));
}

__global__ void ntt_inverse_radix2_kernel(const int64_t* __restrict__ in,
                                          int64_t* __restrict__ out,
                                          const uint32_t* __restrict__ rows,
                                          const uint32_t* __restrict__ scalars,
                                          int L, int log_n) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int limb = blockIdx.x % L;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint32_t q = scalars[limb];
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
  const uint32_t* ipsi = rows + static_cast<size_t>(2 * L + limb) * n;
  const uint32_t* ipsi_sh = rows + static_cast<size_t>(3 * L + limb) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s[i] = static_cast<uint32_t>(in[base + i]);
  __syncthreads();
  troy::inverse_stages<1>(s, log_n, ipsi, ipsi_sh, q);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[base + i] = static_cast<int64_t>(
        troy::scale_n_inv(s[i], n_inv, n_inv_sh, q));
}

int radix2_threads(int log_n) {
  const int n = 1 << log_n;
  return n / 2 < 1024 ? (n / 2 > 0 ? n / 2 : 1) : 1024;
}

template <typename Kernel>
int launch_radix2(Kernel kernel, const void* in, void* out, const void* rows,
                  const void* scalars, long long n_rows, int L, int log_n,
                  void* stream) {
  if (n_rows <= 0) return 0;
  const size_t smem = static_cast<size_t>(1 << log_n) * sizeof(uint32_t);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(n_rows), radix2_threads(log_n), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(rows),
      static_cast<const uint32_t*>(scalars), L, log_n);
  return static_cast<int>(cudaGetLastError());
}

// ---- Degrees above 32768: the block and column kernels ---------------------

// ntt_kernel on block b of 2^log_b values of a polynomial of 2^(log_b +
// split) (blockIdx.x = polynomial row << split | b), with block b's table:
// phases (2, L, 2^split, 2 E) u32 pairs.  The inverse's scalars are the
// block scalars, so its store scales by 1.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    ntt_block_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                     const uint32_t* __restrict__ phases,
                     const uint32_t* __restrict__ scalars, int L, int log_b,
                     int split, int plan, int entries) {
  extern __shared__ uint32_t s[];
  const int limb = (blockIdx.x >> split) % L;
  const int block = blockIdx.x & ((1 << split) - 1);
  const uint32_t q = scalars[limb];
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
  const uint32_t* table =
      phases + ((static_cast<size_t>((kInverse ? L : 0) + limb) << split) + block) *
                   2 * entries;
  const uint2* tw = stage_twiddles(s + data_words(log_b), table, entries);
  const size_t base = static_cast<size_t>(blockIdx.x) << log_b;
  const int count = phase_count(plan);
  const bool fused = kInverse && count > 1;

  load_values(s, in + base, log_b);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  smem_phases<kInverse>(s, log_b, plan, count, fused, tw, q);

  if (fused) {
    run_store_phase(plan & 15, s, out + base, log_b, tw + kConstantSlots, q,
                    n_inv, n_inv_sh);
    return;
  }
  store_values<kInverse>(s, out + base, log_b, q, n_inv, n_inv_sh);
}

constexpr int kColumnThreads = 128;

// The K = split stages over the columns of polynomials of 2^(log_b + K)
// values: the forward's first K stages, or the inverse's last K and the
// n^-1 scale.  Thread i takes the columns 2j, 2j + 1 (j = i mod 2^(log_b-1))
// of polynomial i >> (log_b - 1): 2^K values each, x[e 2^log_b + 2j (+1)],
// loaded as 2^K 16-byte pairs, then the root-1 sub-transform of each in
// registers (columns: its 2^K (w, w') slots, ops/ntt.py:column_rows, read
// from device memory, where every thread of the launch reads the same
// ones).  Out in [0, q).
template <int K, bool kInverse>
__global__ void __launch_bounds__(kColumnThreads)
    ntt_columns_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                       const uint32_t* __restrict__ columns,
                       const uint32_t* __restrict__ scalars, int L, int log_b,
                       long long pairs) {
  constexpr int E = 1 << K;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int log_half = log_b - 1;
  const long long row = i >> log_half;
  const int limb = static_cast<int>(row % L);
  const uint32_t q = scalars[limb];
  const uint4* t4 = reinterpret_cast<const uint4*>(columns) +
                    (static_cast<size_t>((kInverse ? L : 0) + limb) << (K - 1));
  const size_t first = (static_cast<size_t>(row) << (log_half + K)) +
                       static_cast<size_t>(i & ((1LL << log_half) - 1));
  const longlong2* src = reinterpret_cast<const longlong2*>(in) + first;
  longlong2 v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = __ldg(src + (static_cast<size_t>(e) << log_half));
  uint32_t a[E], b[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    a[e] = static_cast<uint32_t>(v[e].x);
    b[e] = static_cast<uint32_t>(v[e].y);
  }
  radix_stages<K, kInverse, false>(a, t4, nullptr, q);
  radix_stages<K, kInverse, false>(b, t4, nullptr, q);
  longlong2* dst = reinterpret_cast<longlong2*>(out) + first;
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t x = kInverse ? troy::scale_n_inv(a[e], n_inv, n_inv_sh, q)
                                : troy::reduce_from_4q(a[e], q);
    const uint32_t y = kInverse ? troy::scale_n_inv(b[e], n_inv, n_inv_sh, q)
                                : troy::reduce_from_4q(b[e], q);
    dst[static_cast<size_t>(e) << log_half] = make_longlong2(x, y);
  }
}

template <bool kInverse>
int launch_blocks(const void* in, void* out, const void* phases,
                  const void* scalars, long long n_blocks, int L, int log_b,
                  int split, int plan, int entries, void* stream) {
  if (n_blocks <= 0) return 0;
  const Shape shape = ntt_shape(log_b, entries);
  if (shape.smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_block_kernel<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shape.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ntt_block_kernel<kInverse><<<static_cast<unsigned int>(n_blocks), shape.threads,
                               shape.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(phases),
      static_cast<const uint32_t*>(scalars), L, log_b, split, plan, entries);
  return static_cast<int>(cudaGetLastError());
}

template <int K, bool kInverse>
int launch_columns_k(const void* in, void* out, const void* columns,
                     const void* scalars, long long pairs, int L, int log_b,
                     void* stream) {
  const long long grid = (pairs + kColumnThreads - 1) / kColumnThreads;
  ntt_columns_kernel<K, kInverse><<<static_cast<unsigned int>(grid), kColumnThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(columns),
      static_cast<const uint32_t*>(scalars), L, log_b, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInverse>
int launch_columns(const void* in, void* out, const void* columns,
                   const void* scalars, long long n_rows, int L, int log_b,
                   int split, void* stream) {
  if (n_rows <= 0) return 0;
  if (log_b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = n_rows << (log_b - 1);
  switch (split) {
    case 1: return launch_columns_k<1, kInverse>(in, out, columns, scalars, pairs, L, log_b, stream);
    case 2: return launch_columns_k<2, kInverse>(in, out, columns, scalars, pairs, L, log_b, stream);
    case 3: return launch_columns_k<3, kInverse>(in, out, columns, scalars, pairs, L, log_b, stream);
    case 4: return launch_columns_k<4, kInverse>(in, out, columns, scalars, pairs, L, log_b, stream);
    case 5: return launch_columns_k<5, kInverse>(in, out, columns, scalars, pairs, L, log_b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- Degrees above 32768: one cluster a polynomial -------------------------

// One polynomial of 2^(log_b + K) values per cluster of C = 2^K CTAs
// (blockIdx.x = polynomial row << K | rank); CTA `rank` holds block `rank`
// of 2^log_b values in its shared memory, then its table: phases (2, L,
// C 2 E) u32 pairs, the block's own slice of the heap (ops/ntt.py:
// phase_rows with a split); columns (2, L, 2 C) u32, the column stages'
// slots (column_rows).  CTA `rank` runs the column stages of the columns
// [rank 2^(log_b-K), (rank + 1) 2^(log_b-K)), a column a thread.
//   Forward: a column's 2^K loads, its column stages in registers, each
//   value e into block e across the cluster (scatter_column; the first
//   store waits on the arrive every CTA makes at its start, so that no CTA
//   writes into a peer that has not started), a cluster barrier, the
//   block's phases in its own shared memory, the block out (16-byte stores,
//   reduced to [0, q)).
//   Inverse: the block in (16-byte loads), its phases unscaled, left in
//   [0, 2q), a cluster barrier, then each column's 2^K values gathered from
//   the blocks (gather_column), its column stages and the n^-1 scale in
//   registers, stored; a last cluster barrier keeps every block in place
//   until no peer reads it.
// Device memory is read once and written once.  A launch of at most two CTAs
// an SM runs 256 threads a CTA, which shortens each CTA's chain of loads,
// phases and stores; a larger one runs 128, four CTAs an SM, so that one
// CTA's loads overlap another's phases (cluster_threads).  (A column pair a
// thread, with 16-byte loads and stores, was slower: its cluster stores
// half-fill their runs; so were 256 threads at every size, 3 CTAs of 256
// an SM, 6 of 128, and the block's last phase run against device memory;
// scripts/torch_cluster_variants.py, PERF.md, PR 12.)
template <int K, bool kInverse>
__global__ void __launch_bounds__(kThreads)
    ntt_cluster_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                       const uint32_t* __restrict__ phases,
                       const uint32_t* __restrict__ columns,
                       const uint32_t* __restrict__ scalars, int L, int log_b,
                       int plan, int entries) {
  constexpr int C = 1 << K;
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x >> K;
  const int limb = static_cast<int>(row % L);
  const int dir = (kInverse ? L : 0) + limb;
  const uint32_t q = scalars[limb];
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
  const uint2* tw = stage_twiddles(
      s + data_words(log_b),
      phases + ((static_cast<size_t>(dir) << K) + rank) * 2 * entries, entries);
  const uint4* col = reinterpret_cast<const uint4*>(columns) +
                     (static_cast<size_t>(dir) << (K - 1));
  const int64_t* src = in + (row << (log_b + K));
  int64_t* dst = out + (row << (log_b + K));
  const int count = phase_count(plan);
  const int cols = 1 << (log_b - K);  // columns of this CTA
  const int first = rank * cols;      // its first column
  uint32_t x[C];

  if (!kInverse) {
    cluster_arrive_relaxed();
    bool waited = false;
    for (int j = first + threadIdx.x; j < first + cols; j += blockDim.x) {
      load_column<K>(src, j, log_b, x);
      radix_stages<K, false, false>(x, col, nullptr, q);
      if (!waited) cluster_wait();
      waited = true;
      scatter_column<K>(s, j, x);
    }
    if (!waited) cluster_wait();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    cluster.sync();
    smem_phases<false>(s, log_b, plan, count, 0, tw, q);
    store_values<false>(s, dst + (static_cast<size_t>(rank) << log_b), log_b, q,
                        n_inv, n_inv_sh);
    return;
  }

  load_values(s, src + (static_cast<size_t>(rank) << log_b), log_b);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  smem_phases<true>(s, log_b, plan, count, 0, tw, q);
  cluster.sync();
  for (int j = first + threadIdx.x; j < first + cols; j += blockDim.x) {
    gather_column<K>(s, j, x);
    radix_stages<K, true, false>(x, col, nullptr, q);
    store_column<K>(dst, j, log_b, x, q, n_inv, n_inv_sh);
  }
  // Every value this thread read from a peer has gone into a store above,
  // so its read is complete: a relaxed arrive suffices to keep each block in
  // place until no peer reads it.
  cluster_arrive_relaxed();
  cluster_wait();
}

// The cluster kernel for a split of K = 1 .. 4 (clusters of 2 to 16 CTAs).
const void* cluster_kernel(bool inverse, int split) {
  switch (split) {
    case 1: return inverse ? reinterpret_cast<const void*>(ntt_cluster_kernel<1, true>)
                           : reinterpret_cast<const void*>(ntt_cluster_kernel<1, false>);
    case 2: return inverse ? reinterpret_cast<const void*>(ntt_cluster_kernel<2, true>)
                           : reinterpret_cast<const void*>(ntt_cluster_kernel<2, false>);
    case 3: return inverse ? reinterpret_cast<const void*>(ntt_cluster_kernel<3, true>)
                           : reinterpret_cast<const void*>(ntt_cluster_kernel<3, false>);
    case 4: return inverse ? reinterpret_cast<const void*>(ntt_cluster_kernel<4, true>)
                           : reinterpret_cast<const void*>(ntt_cluster_kernel<4, false>);
    default: return nullptr;
  }
}

// Threads of a CTA of the cluster kernel for a launch of `ctas` CTAs: 256
// while the launch fits the card at two CTAs an SM, else 128; 0 if the
// device cannot be read.
int cluster_threads(long long ctas) {
  static int sms[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  if (!sms[dev] &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return ctas <= 2LL * sms[dev] ? kThreads : kThreads / 2;
}

// A CTA of the cluster kernel: `threads` threads and one block with its
// table.
Shape cluster_shape(int threads, int log_b, int entries) {
  return {threads, ntt_shape(log_b, entries).smem};
}

int launch_cluster(bool inverse, const void* in, void* out, const void* phases,
                   const void* columns, const void* scalars, long long n_rows,
                   int L, int log_b, int split, int plan, int entries,
                   void* stream) {
  const void* fn = cluster_kernel(inverse, split);
  // a CTA takes at least two columns: 2^log_b >= 2^(split + 1)
  if (!fn || log_b <= split) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cluster_threads(n_rows << split);
  if (!threads) return static_cast<int>(cudaErrorInvalidDevice);
  void* args[] = {&in, &out, &phases, &columns, &scalars, &L, &log_b, &plan, &entries};
  return launch_clusters(fn, 1 << split, cluster_shape(threads, log_b, entries), n_rows,
                         stream, args);
}

}  // namespace

extern "C" int troy_ntt_forward(const void* in, void* out, const void* phases,
                                const void* scalars, long long n_rows, int L,
                                int log_n, int plan, int entries,
                                void* stream) {
  return launch_ntt<false>(in, out, phases, scalars, n_rows, L, log_n, plan,
                           entries, stream);
}

extern "C" int troy_ntt_inverse(const void* in, void* out, const void* phases,
                                const void* scalars, long long n_rows, int L,
                                int log_n, int plan, int entries,
                                void* stream) {
  return launch_ntt<true>(in, out, phases, scalars, n_rows, L, log_n, plan,
                          entries, stream);
}

// n_blocks = polynomial rows << split; log_b: log2 of a block's values.
extern "C" int troy_ntt_blocks_forward(const void* in, void* out,
                                       const void* phases, const void* scalars,
                                       long long n_blocks, int L, int log_b,
                                       int split, int plan, int entries,
                                       void* stream) {
  return launch_blocks<false>(in, out, phases, scalars, n_blocks, L, log_b,
                              split, plan, entries, stream);
}

extern "C" int troy_ntt_blocks_inverse(const void* in, void* out,
                                       const void* phases, const void* scalars,
                                       long long n_blocks, int L, int log_b,
                                       int split, int plan, int entries,
                                       void* stream) {
  return launch_blocks<true>(in, out, phases, scalars, n_blocks, L, log_b,
                             split, plan, entries, stream);
}

extern "C" int troy_ntt_columns_forward(const void* in, void* out,
                                        const void* columns, const void* scalars,
                                        long long n_rows, int L, int log_b,
                                        int split, void* stream) {
  return launch_columns<false>(in, out, columns, scalars, n_rows, L, log_b,
                               split, stream);
}

extern "C" int troy_ntt_columns_inverse(const void* in, void* out,
                                        const void* columns, const void* scalars,
                                        long long n_rows, int L, int log_b,
                                        int split, void* stream) {
  return launch_columns<true>(in, out, columns, scalars, n_rows, L, log_b,
                              split, stream);
}

extern "C" int troy_ntt_forward_radix2(const void* in, void* out,
                                       const void* rows, const void* scalars,
                                       long long n_rows, int L, int log_n,
                                       void* stream) {
  return launch_radix2(ntt_forward_radix2_kernel, in, out, rows, scalars,
                       n_rows, L, log_n, stream);
}

extern "C" int troy_ntt_inverse_radix2(const void* in, void* out,
                                       const void* rows, const void* scalars,
                                       long long n_rows, int L, int log_n,
                                       void* stream) {
  return launch_radix2(ntt_inverse_radix2_kernel, in, out, rows, scalars,
                       n_rows, L, log_n, stream);
}

// n_rows polynomials of 2^(log_b + split) values, one cluster of 2^split
// CTAs each; phases: kernel_phases with that split; columns:
// column_phases; scalars: kernel_scalars.
extern "C" int troy_ntt_cluster_forward(const void* in, void* out,
                                        const void* phases, const void* columns,
                                        const void* scalars, long long n_rows,
                                        int L, int log_b, int split, int plan,
                                        int entries, void* stream) {
  return launch_cluster(false, in, out, phases, columns, scalars, n_rows, L,
                        log_b, split, plan, entries, stream);
}

extern "C" int troy_ntt_cluster_inverse(const void* in, void* out,
                                        const void* phases, const void* columns,
                                        const void* scalars, long long n_rows,
                                        int L, int log_b, int split, int plan,
                                        int entries, void* stream) {
  return launch_cluster(true, in, out, phases, columns, scalars, n_rows, L,
                        log_b, split, plan, entries, stream);
}

// The cluster kernel as the compiler and the occupancy calculator see it,
// at blocks of 2^log_b values, clusters of 2^split CTAs and `threads`
// threads a CTA (256 or 128): info = threads, dynamic shared bytes,
// registers a thread, local (spill) bytes a thread, CTAs resident per SM,
// clusters the card holds at once.
extern "C" int troy_ntt_cluster_info(int inverse, int log_b, int split,
                                     int entries, int threads, int* info) {
  const void* fn = cluster_kernel(inverse != 0, split);
  if (!fn || (threads != kThreads && threads != kThreads / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape shape = cluster_shape(threads, log_b, entries);
  int clusters = 0, blocks = 0;
  int err = cluster_ready(fn, 1 << split, shape, &clusters);
  if (err) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, shape.threads, shape.smem));
  if (err) return err;
  info[0] = shape.threads;
  info[1] = static_cast<int>(shape.smem);
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = blocks;
  info[5] = clusters;
  return 0;
}

// What the compiler and the occupancy calculator say of one kernel at
// degree 2^log_n with `entries` table pairs a limb: info = threads, dynamic
// shared bytes, registers a thread, local (spill) bytes a thread, CTAs
// resident per SM.  which: 0 forward, 1 inverse, 2 / 3 the radix-2
// yardstick's forward / inverse.
extern "C" int troy_ntt_kernel_info(int which, int log_n, int entries,
                                    int* info) {
  const void* fn;
  int threads;
  size_t smem;
  if (which < 2) {
    fn = which ? reinterpret_cast<const void*>(ntt_kernel<true>)
               : reinterpret_cast<const void*>(ntt_kernel<false>);
    const Shape shape = ntt_shape(log_n, entries);
    threads = shape.threads;
    smem = shape.smem;
  } else {
    fn = which == 2 ? reinterpret_cast<const void*>(ntt_forward_radix2_kernel)
                    : reinterpret_cast<const void*>(ntt_inverse_radix2_kernel);
    threads = radix2_threads(log_n);
    smem = static_cast<size_t>(1 << log_n) * sizeof(uint32_t);
  }
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = threads;
  info[1] = static_cast<int>(smem);
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = blocks;
  return 0;
}

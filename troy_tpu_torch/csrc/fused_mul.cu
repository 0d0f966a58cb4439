// Fused negacyclic tensor product of two 2-polynomial ciphertexts over one
// RNS base, for NVIDIA Hopper (sm_90a):
//
//   a (B, 2, L, n), b (B, 2, L, n)  ->  INTT(NTT a (x) NTT b)  (B, 3, L, n)
//
// with (x) the dyadic convolution (a0 b0, a0 b1 + a1 b0, a1 b1) mod q.
//
// Replaces the TPU kernel troy_tpu/ops/fused_mul.py:_kernel (K4, entry
// fused_negacyclic_multiply), which runs the four forward and three inverse
// six-step transforms and the products of one (batch, limb) in VMEM.  The
// six-step layout and its transposes were a TPU lane layout; here each
// transform is the NTT kernel's own register-radix schedule
// (ntt_phases.cuh: the phases of ops/ntt.py:kernel_phase_plan and the
// per-phase twiddles of NTTTables.kernel_phases, staged in shared memory).
//
// Bound: at the flagship (16, 2, 6, 8192) the launch reads 25 MB and writes
// 19 MB (13.1 us at 3.35 TB/s) and runs 7 transforms of 13 * 4096
// butterflies per (batch, limb), 317 M int32 operations (19.0 us on the
// card's int32 lanes), so it is bound by operations, with bytes close.
//
// Design: a thread-block cluster of 4 CTAs per (batch, limb), one per
// operand polynomial (rank 0..3: a0, a1, b0, b1), each of the NTT kernel's
// shape (256 threads at n >= 8192, its polynomial and one limb table in
// shared memory, 56 576 bytes at n = 8192), with registers capped for 3 CTAs
// an SM up to n = 8192.  Over base q that is 384 CTAs, one wave on the 396
// places of 132 SMs (with the load-balancing cluster scheduling policy:
// launch_config), where one CTA of four polynomials per (batch, limb) would
// leave 36 SMs idle and no CTA's loads overlapping another's butterflies.
//   1. Each CTA runs its polynomial's first forward phase straight from
//      device memory (load_phase: 16-byte loads, that phase's twiddles from
//      device memory too) while cp.async copies its limb's forward table,
//      then the other forward phases in its own shared memory.
//   2. The inverse table replaces the forward one in place (cp.async), once
//      the CTA is past its last forward phase: at n = 32768 the values and
//      one table take 226 560 of the 232 448 bytes a CTA may hold, so two
//      tables never sit side by side, at any degree.
//   3. Cluster barrier.  The products, split by coefficient range over the
//      four CTAs: CTA r forms c0, c1, c2 at coefficients
//      [r ceil(n/4), (r+1) ceil(n/4)), reading a0, a1, b0, b1 there from
//      the CTAs that hold them (distributed shared memory), and writes them
//      over a0, a1 and b0 in the shared memory of ranks 0, 1 and 2.  Each
//      coefficient is read and written by one thread only, so no buffer is
//      needed and no thread overwrites a value another still reads.  The
//      products take reduced operands (two conditional subtracts from
//      [0, 4q)), their 64-bit product, and Montgomery's REDC (mont_redc):
//      a b 2^-32 mod q in [0, 2q), exact for t < q 2^32, which holds for
//      a0 b1 + a1 b0 < 2 q^2 as q < 2^30; the cross term is reduced once.
//      The 2^-32 the products carry is undone by the inverse's final scale,
//      n^-1 2^32 mod q (NTTTables.kernel_scalars rows 3..5, from the host).
//   4. Cluster barrier: every product is written, and no CTA touches a
//      peer's shared memory after it, so rank 3 exits here and ranks 0..2
//      may overwrite their own.  Each runs the inverse phases on its
//      product and stores it, the last phase straight from registers with
//      16-byte stores (store_phase), scaled into [0, q).
// Every degree 64 to 32768 runs this design; n = 2 to 32, the NTT kernel's
// single-phase plans, run fused_mul_small (one warp a (batch, limb), the
// same radix_stages and tables); the wrapper refuses n > 32768.  The kernel is
// instantiated per degree (fused_mul_kernel<LogN>, the plan of
// ntt_phases.cuh:Plan at compile time; the launch refuses a plan code that
// differs from the caller's tables), so that each launch runs code with only
// its own phases: the first version, one kernel over every plan, spent
// microseconds on instruction fetch in its inverse phases and products.
// The launch goes through cudaLaunchKernelExC with a cluster dimension of 4;
// a cluster that cannot be scheduled (cudaOccupancyMaxActiveClusters of 0)
// is refused, and the wrapper raises.
//
// Tried, and slower over q and Bsk taken together (PERF.md has the times
// of scripts/torch_fused_variants.py): one CTA of 512 threads per
// (batch, limb) with the four operands side by side (single_cta); each CTA
// pushing its values into staging areas of its peers before the products
// (push); Barrett products (barrett); the load through shared memory
// before the first phase (smem_load); 2 CTAs an SM (ctas2); CTAs of 128 or
// 192 threads, 4 an SM (threads128, threads192); the default cluster
// scheduling policy (default_policy).
//
// The first kernel (one CTA of four polynomials per (batch, limb) on the
// radix-2 stages of ntt_common.cuh, staged through its output rows at
// n >= 16384) stays in this library as troy_fused_mul_radix2, a yardstick
// that only the timing phase of chip_smoke.py launches; no wrapper routes to
// it.
//
// Tables: NTTTables.kernel_phases (2, L, 2 E), as the NTT kernel, and
// kernel_scalars (6, L) (the yardstick: kernel_rows (4, L, n) and the first
// three rows of kernel_scalars).  Inputs in [0, 2q)
// are accepted; outputs are canonical in [0, q).  The kernels never
// allocate.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxLogN = 15;
constexpr int kCluster = 4;        // CTAs a (batch, limb): a0, a1, b0, b1
constexpr int kMaxProductBatch = 8;  // coefficients a thread forms at once

// One (batch, limb) per cluster of kCluster CTAs, at degree 2^LogN; CTA
// `rank` of the cluster transforms operand `rank`.  entries: the limb
// table's pairs (NTTTables.kernel_phases).
template <int LogN>
__global__ void __launch_bounds__(kThreads, LogN <= 13 ? 3 : 1)
    fused_mul_kernel(const int64_t* __restrict__ a,
                     const int64_t* __restrict__ b, int64_t* __restrict__ out,
                     const uint32_t* __restrict__ phases,
                     const uint32_t* __restrict__ scalars, int L, int entries) {
  using Pl = Plan<LogN>;
  static_assert(Pl::kCount > 1, "the plans of one phase run fused_mul_small");
  constexpr int n = 1 << LogN;
  constexpr int chunk = (n + kCluster - 1) / kCluster;
  constexpr int per_thread = chunk / cta_threads(LogN);
  constexpr int batch_size = per_thread < 1 ? 1
                             : (per_thread > kMaxProductBatch ? kMaxProductBatch
                                                              : per_thread);
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cell = static_cast<int>(blockIdx.x / kCluster);
  const int batch = cell / L, limb = cell % L;
  const uint32_t q = scalars[limb];
  const uint32_t q_inv_neg = scalars[3 * L + limb];
  const uint32_t n_inv = scalars[4 * L + limb];     // n^-1 2^32 mod q
  const uint32_t n_inv_sh = scalars[5 * L + limb];
  const size_t ln = static_cast<size_t>(L) << LogN;
  const size_t off = static_cast<size_t>(limb) << LogN;
  const int64_t* src = (rank < 2 ? a : b) +
                       (2 * static_cast<size_t>(batch) + (rank & 1)) * ln + off;
  uint32_t* table = s + data_words(LogN);

  // 1. The forward transform of this CTA's operand: its first phase straight
  // from device memory (that phase's twiddles too) while cp.async copies the
  // limb's table, the other phases in shared memory.
  const uint32_t* fwd = phases + static_cast<size_t>(limb) * 2 * entries;
  const uint2* tw = stage_twiddles(table, fwd, entries);
  load_phase<Pl::depth(0)>(
      s, src, LogN, reinterpret_cast<const uint2*>(fwd) + kConstantSlots, q);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  forward_plan<LogN, 1>(s, tw, q);

  // 2. The inverse table over the forward one: every thread of this CTA is
  // past the barrier that ends its last forward phase.
  if (rank < kCluster - 1)
    stage_twiddles(table, phases + static_cast<size_t>(L + limb) * 2 * entries,
                   entries);
  cluster.sync();

  // 3. The products of this CTA's coefficient range, from and into the
  // shared memory of the CTAs that hold each operand.
  {
    uint32_t* part[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c) part[c] = cluster.map_shared_rank(s, c);
    const int lo = rank * chunk;
    const int hi = n < lo + chunk ? n : lo + chunk;
    for (int i0 = lo + threadIdx.x; i0 < hi; i0 += batch_size * blockDim.x) {
      uint32_t x[batch_size][kCluster];
#pragma unroll
      for (int j = 0; j < batch_size; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < hi) {
#pragma unroll
          for (int c = 0; c < kCluster; ++c) x[j][c] = part[c][pad(i)];
        }
      }
#pragma unroll
      for (int j = 0; j < batch_size; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < hi) {
          const uint64_t a0 = troy::reduce_from_4q(x[j][0], q);
          const uint64_t a1 = troy::reduce_from_4q(x[j][1], q);
          const uint64_t b0 = troy::reduce_from_4q(x[j][2], q);
          const uint64_t b1 = troy::reduce_from_4q(x[j][3], q);
          part[0][pad(i)] = mont_redc(a0 * b0, q, q_inv_neg);
          part[1][pad(i)] = mont_redc(a0 * b1 + a1 * b0, q, q_inv_neg);
          part[2][pad(i)] = mont_redc(a1 * b1, q, q_inv_neg);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();
  if (rank == kCluster - 1) return;

  // 4. The inverse transform of product `rank`, scaled by n^-1 2^32 (the
  // products carry 2^-32), stored.
  int64_t* dst = out + (3 * static_cast<size_t>(batch) + rank) * ln + off;
  inverse_plan<LogN, 1>(s, tw, q);
  store_phase<Pl::depth(0)>(s, dst, LogN, tw + kConstantSlots, q, n_inv,
                            n_inv_sh);
}

// n <= 32, the plan's single phase: one CTA of a warp per (batch, limb),
// no cluster.  The four operands and both limb tables sit in its shared
// memory; thread r transforms operand r in registers (radix_stages, the
// NTT kernel's single-phase code and twiddles), the products are formed in
// place, and thread r < 3 transforms product r back and stores it.  Two
// cluster barriers and the cluster launch would cost more than the whole
// transform here.
template <int LogN>
__global__ void __launch_bounds__(32)
    fused_mul_small(const int64_t* __restrict__ a,
                    const int64_t* __restrict__ b, int64_t* __restrict__ out,
                    const uint32_t* __restrict__ phases,
                    const uint32_t* __restrict__ scalars, int L, int entries) {
  constexpr int n = 1 << LogN;
  extern __shared__ uint32_t s[];
  const int batch = blockIdx.x / L, limb = blockIdx.x % L;
  const uint32_t q = scalars[limb];
  const uint32_t q_inv_neg = scalars[3 * L + limb];
  const uint32_t n_inv = scalars[4 * L + limb];     // n^-1 2^32 mod q
  const uint32_t n_inv_sh = scalars[5 * L + limb];
  const size_t ln = static_cast<size_t>(L) << LogN;
  const size_t off = static_cast<size_t>(limb) << LogN;
  const uint2* fwd = stage_twiddles(
      s + 4 * n, phases + static_cast<size_t>(limb) * 2 * entries, entries);
  const uint2* inv = stage_twiddles(
      s + 4 * n + 2 * entries,
      phases + static_cast<size_t>(L + limb) * 2 * entries, entries);
#pragma unroll
  for (int k = 0; k < (4 * n + 31) / 32; ++k) {  // every load in flight
    const int i = threadIdx.x + 32 * k, r = i >> LogN;
    if (i < 4 * n)
      s[i] = static_cast<uint32_t>(
          (r < 2 ? a : b)[(2 * static_cast<size_t>(batch) + (r & 1)) * ln +
                          off + (i & (n - 1))]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int r = threadIdx.x;
  uint32_t x[n];
  if (r < 4) {
#pragma unroll
    for (int j = 0; j < n; ++j) x[j] = s[r * n + j];
    radix_stages<LogN, false, true>(
        x, reinterpret_cast<const uint4*>(fwd + kConstantSlots),
        reinterpret_cast<const uint4*>(fwd), q);
#pragma unroll
    for (int j = 0; j < n; ++j) s[r * n + j] = x[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t a0 = troy::reduce_from_4q(s[i], q);
    const uint64_t a1 = troy::reduce_from_4q(s[n + i], q);
    const uint64_t b0 = troy::reduce_from_4q(s[2 * n + i], q);
    const uint64_t b1 = troy::reduce_from_4q(s[3 * n + i], q);
    s[i] = mont_redc(a0 * b0, q, q_inv_neg);
    s[n + i] = mont_redc(a0 * b1 + a1 * b0, q, q_inv_neg);
    s[2 * n + i] = mont_redc(a1 * b1, q, q_inv_neg);
  }
  __syncthreads();
  if (r < 3) {
#pragma unroll
    for (int j = 0; j < n; ++j) x[j] = s[r * n + j];
    radix_stages<LogN, true, true>(
        x, reinterpret_cast<const uint4*>(inv + kConstantSlots),
        reinterpret_cast<const uint4*>(inv), q);
    int64_t* dst = out + (3 * static_cast<size_t>(batch) + r) * ln + off;
#pragma unroll
    for (int j = 0; j < n; ++j)
      dst[j] = static_cast<int64_t>(troy::scale_n_inv(x[j], n_inv, n_inv_sh, q));
  }
}

// The kernel at one degree, the plan code it was compiled for, and its
// CTAs a (batch, limb): kCluster, or 1 for the single-phase plans.
struct Variant {
  const void* fn;
  int plan;
  int ctas;
};

template <int LogN>
Variant variant() {
  if constexpr (Plan<LogN>::kCount == 1)
    return {reinterpret_cast<const void*>(fused_mul_small<LogN>),
            Plan<LogN>::code(), 1};
  else
    return {reinterpret_cast<const void*>(fused_mul_kernel<LogN>),
            Plan<LogN>::code(), kCluster};
}

Variant variant_for(int log_n) {
  switch (log_n) {
    case 1: return variant<1>();
    case 2: return variant<2>();
    case 3: return variant<3>();
    case 4: return variant<4>();
    case 5: return variant<5>();
    case 6: return variant<6>();
    case 7: return variant<7>();
    case 8: return variant<8>();
    case 9: return variant<9>();
    case 10: return variant<10>();
    case 11: return variant<11>();
    case 12: return variant<12>();
    case 13: return variant<13>();
    case 14: return variant<14>();
    case 15: return variant<15>();
    default: return {nullptr, 0, 0};
  }
}

// Threads and shared memory of one CTA of the variant: the NTT kernel's
// shape (one polynomial and one limb table), or for the single-phase plans
// a warp with four polynomials and both tables.
Shape variant_shape(const Variant& v, int log_n, int entries) {
  if (v.ctas == 1)
    return {32, (static_cast<size_t>(4) << log_n) * sizeof(uint32_t) +
                    2 * static_cast<size_t>(entries) * sizeof(uint2)};
  return ntt_shape(log_n, entries);
}

// The launch configuration: v.ctas CTAs per (batch, limb), as a cluster of
// that many when there are more than one, under the load-balancing cluster
// scheduling policy.  With it the H100 holds 96 clusters of the kernel at
// n = 8192 at once, against 92 under the default policy, so that all 96 of
// the launch over base q run in one wave.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
};

void launch_config(Launch& l, const Variant& v, const Shape& shape,
                   long long n_cells, cudaStream_t stream) {
  l.cfg = {};
  l.cfg.gridDim = dim3(static_cast<unsigned int>(n_cells * v.ctas));
  l.cfg.blockDim = dim3(shape.threads);
  l.cfg.dynamicSmemBytes = shape.smem;
  l.cfg.stream = stream;
  l.attr[0] = {};
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = v.ctas;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.attr[1] = {};
  l.attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  l.attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = v.ctas > 1 ? 2 : 0;
}

// The dynamic shared memory the kernel asks for, granted (above 48 KiB it
// must be); 0 or a CUDA error.
int grant_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Clusters of one degree's kernel the device holds at once at this shape
// (0 for a variant without clusters).
int active_clusters(const Variant& v, const Shape& shape, int* clusters) {
  *clusters = 0;
  if (v.ctas == 1) return 0;
  Launch l;
  launch_config(l, v, shape, 1, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, v.fn, &l.cfg));
}

int launch_fused(const void* a, const void* b, void* out, const void* phases,
                 const void* scalars, long long n_batch, int L, int log_n,
                 int plan, int entries, void* stream) {
  if (n_batch <= 0) return 0;
  const Variant v = variant_for(log_n);
  // The plan the caller's tables were laid out for must be the kernel's.
  if (!v.fn || plan != v.plan) return static_cast<int>(cudaErrorInvalidValue);
  const Shape shape = variant_shape(v, log_n, entries);
  int err = grant_smem(v.fn, shape.smem);
  if (err) return err;
  // A cluster that cannot be scheduled is refused, not shrunk: checked once
  // per device and degree.
  static bool fits[16][kMaxLogN + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (v.ctas > 1 && !fits[dev][log_n]) {
    int clusters = 0;
    err = active_clusters(v, shape, &clusters);
    if (err) return err;
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    fits[dev][log_n] = true;
  }
  Launch l;
  launch_config(l, v, shape, n_batch * L, static_cast<cudaStream_t>(stream));
  const int64_t* pa = static_cast<const int64_t*>(a);
  const int64_t* pb = static_cast<const int64_t*>(b);
  int64_t* po = static_cast<int64_t*>(out);
  const uint32_t* pp = static_cast<const uint32_t*>(phases);
  const uint32_t* ps = static_cast<const uint32_t*>(scalars);
  void* args[] = {&pa, &pb, &po, &pp, &ps, &L, &entries};
  err = static_cast<int>(cudaLaunchKernelExC(&l.cfg, v.fn, args));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// ---- The first kernel: the timing yardstick ---------------------------------
//
// One CTA per (batch, limb) on the radix-2 stages of ntt_common.cuh.  Up to
// n = 8192 the four polynomials a0, a1, b0, b1 sit in shared memory together
// (128 KiB at n = 8192), are transformed together (one barrier per stage
// for all four), multiplied in place, and the three products transformed
// back together.  At n = 16384 and 32768 one polynomial lives in shared
// memory at a time; the NTT forms of a0, a1, b0 go to the kernel's own
// output rows, the products are formed there against b1, and each product
// row is transformed back from there.  Tables: kernel_rows (4, L, n).

__global__ void fused_mul_radix2_kernel(const int64_t* __restrict__ a,
                                        const int64_t* __restrict__ b,
                                        int64_t* __restrict__ out,
                                        const uint32_t* __restrict__ rows,
                                        const uint32_t* __restrict__ scalars,
                                        int L, int log_n, int staged) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int batch = blockIdx.x / L;
  const int limb = blockIdx.x % L;
  const uint32_t q = scalars[limb];
  const uint64_t ratio = ~0ull / q;
  const auto reduce = [q, ratio](uint64_t x) {
    return troy::barrett_reduce64(x, q, ratio);
  };
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
  const uint32_t* psi = rows + static_cast<size_t>(limb) * n;
  const uint32_t* psi_sh = rows + static_cast<size_t>(L + limb) * n;
  const uint32_t* ipsi = rows + static_cast<size_t>(2 * L + limb) * n;
  const uint32_t* ipsi_sh = rows + static_cast<size_t>(3 * L + limb) * n;

  // Rows of this (batch, limb): inputs a0, a1, b0, b1 and outputs c0, c1, c2.
  const size_t ln = static_cast<size_t>(L) * n;
  const size_t off = static_cast<size_t>(limb) * n;
  const int64_t* src[4] = {a + (2 * batch) * ln + off,
                           a + (2 * batch + 1) * ln + off,
                           b + (2 * batch) * ln + off,
                           b + (2 * batch + 1) * ln + off};
  int64_t* dst[3] = {out + (3 * batch) * ln + off,
                     out + (3 * batch + 1) * ln + off,
                     out + (3 * batch + 2) * ln + off};

  if (!staged) {
    for (int p = 0; p < 4; ++p)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        s[p * n + i] = static_cast<uint32_t>(src[p][i]);
    __syncthreads();
    troy::forward_stages<4>(s, log_n, psi, psi_sh, q);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint64_t a0 = troy::reduce_from_4q(s[i], q);
      const uint64_t a1 = troy::reduce_from_4q(s[n + i], q);
      const uint64_t b0 = troy::reduce_from_4q(s[2 * n + i], q);
      const uint64_t b1 = troy::reduce_from_4q(s[3 * n + i], q);
      s[i] = static_cast<uint32_t>(reduce(a0 * b0));
      s[n + i] = static_cast<uint32_t>(reduce(a0 * b1 + a1 * b0));
      s[2 * n + i] = static_cast<uint32_t>(reduce(a1 * b1));
    }
    __syncthreads();
    troy::inverse_stages<3>(s, log_n, ipsi, ipsi_sh, q);
    for (int p = 0; p < 3; ++p)
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        dst[p][i] = static_cast<int64_t>(
            troy::scale_n_inv(s[p * n + i], n_inv, n_inv_sh, q));
    return;
  }

  // Staged: forward a0, a1, b0 into the output rows, keep NTT(b1) in s.
  for (int p = 0; p < 4; ++p) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s[i] = static_cast<uint32_t>(src[p][i]);
    __syncthreads();
    troy::forward_stages<1>(s, log_n, psi, psi_sh, q);
    if (p < 3) {
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        dst[p][i] = static_cast<int64_t>(troy::reduce_from_4q(s[i], q));
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t a0 = static_cast<uint64_t>(dst[0][i]);
    const uint64_t a1 = static_cast<uint64_t>(dst[1][i]);
    const uint64_t b0 = static_cast<uint64_t>(dst[2][i]);
    const uint64_t b1 = troy::reduce_from_4q(s[i], q);
    dst[0][i] = static_cast<int64_t>(reduce(a0 * b0));
    dst[1][i] = static_cast<int64_t>(reduce(a0 * b1 + a1 * b0));
    dst[2][i] = static_cast<int64_t>(reduce(a1 * b1));
  }
  __syncthreads();
  for (int p = 0; p < 3; ++p) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      s[i] = static_cast<uint32_t>(dst[p][i]);
    __syncthreads();
    troy::inverse_stages<1>(s, log_n, ipsi, ipsi_sh, q);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[p][i] = static_cast<int64_t>(
          troy::scale_n_inv(s[i], n_inv, n_inv_sh, q));
    __syncthreads();
  }
}

Shape radix2_shape(int log_n) {
  const int n = 1 << log_n;
  const size_t poly = static_cast<size_t>(n) * sizeof(uint32_t);
  return {2 * n < 1024 ? 2 * n : 1024, 4 * poly > kMaxSmem ? poly : 4 * poly};
}

}  // namespace

// a, b: (n_batch, 2, L, n) int64 contiguous and 16-byte aligned; out:
// (n_batch, 3, L, n).  phases, plan, entries: as troy_ntt_forward.
extern "C" int troy_fused_mul(const void* a, const void* b, void* out,
                              const void* phases, const void* scalars,
                              long long n_batch, int L, int log_n, int plan,
                              int entries, void* stream) {
  return launch_fused(a, b, out, phases, scalars, n_batch, L, log_n, plan,
                      entries, stream);
}

// The first kernel, the timing yardstick: rows = NTTTables.kernel_rows.
extern "C" int troy_fused_mul_radix2(const void* a, const void* b, void* out,
                                     const void* rows, const void* scalars,
                                     long long n_batch, int L, int log_n,
                                     void* stream) {
  if (n_batch <= 0) return 0;
  if (log_n < 1 || log_n > kMaxLogN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape shape = radix2_shape(log_n);
  const int err = grant_smem(
      reinterpret_cast<const void*>(fused_mul_radix2_kernel), shape.smem);
  if (err) return err;
  const int staged = shape.smem < 4 * (sizeof(uint32_t) << log_n) ? 1 : 0;
  fused_mul_radix2_kernel<<<static_cast<unsigned int>(n_batch * L),
                            shape.threads, shape.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(rows),
      static_cast<const uint32_t*>(scalars), L, log_n, staged);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler and the occupancy calculator say of one kernel at
// degree 2^log_n with `entries` table pairs a limb: info = threads, dynamic
// shared bytes, registers a thread, local (spill) bytes a thread, CTAs
// resident per SM, clusters the device holds at once (0 for the yardstick
// and the single-phase degrees, which have none).  which: 0 the kernel, 1
// the radix-2 yardstick.
extern "C" int troy_fused_mul_kernel_info(int which, int log_n, int entries,
                                          int* info) {
  if (log_n < 1 || log_n > kMaxLogN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Variant v = variant_for(log_n);
  const void* fn = which ? reinterpret_cast<const void*>(fused_mul_radix2_kernel)
                         : v.fn;
  const Shape shape =
      which ? radix2_shape(log_n) : variant_shape(v, log_n, entries);
  int err = grant_smem(fn, shape.smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err) return err;
  int blocks = 0, clusters = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, shape.threads, shape.smem));
  if (err) return err;
  if (!which) {
    err = active_clusters(v, shape, &clusters);
    if (err) return err;
  }
  info[0] = shape.threads;
  info[1] = static_cast<int>(shape.smem);
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = blocks;
  info[5] = clusters;
  return 0;
}

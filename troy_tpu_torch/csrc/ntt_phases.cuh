// The register-radix NTT phases over one polynomial in shared memory, for
// NVIDIA Hopper (sm_90a): the device code of the NTT kernels (ntt.cu) and
// of the fused tensor-product kernels K4 (fused_mul.cu, fused_mul_large.cu),
// kept in one place so that the kernels run one schedule and cannot drift
// apart.  tests/test_torch_ntt.py::emulate_kernel replays this schedule in
// PyTorch (tests/test_torch_fused_mul.py replays K4 on it,
// tests/test_torch_cluster.py the cluster kernels); change them with it.
//
// Schedule: ops/ntt.py:kernel_phase_plan splits the log2(n) stages into
// phases of k <= 5 stages (n = 8192: 4 + 4 + 5).  In a phase each thread
// takes the 2^k values of a sub-transform into registers, runs its k stages
// there (Harvey/Shoup butterflies: values below 4q < 2^32 for q < 2^30, one
// __umulhi per twiddle product) and writes them back, so a polynomial
// crosses one barrier a phase.  The inverse's last phase (the plan's phase
// 0) may instead write device memory straight from registers, two int64
// residues a 16-byte store (store_phase), and the forward's first phase
// read it the same way (load_phase, which only K4 runs).
//
// Twiddles: NTTTables.kernel_phases holds, per limb and direction, 16
// constants psi_br[g] and then, per phase and sub-transform root, the (w, w')
// u32 pairs of the heap subtree of psi_br the root needs (the last phase's
// two deepest levels factored into psi_br[v 2^l] and a constant psi_br[g]).
// A CTA copies its limb's table into shared memory behind the values with
// cp.async (stage_twiddles), so no phase waits on L2 for a twiddle.
//
// Shared memory: n values padded by one word in 32 (pad), so every phase's
// accesses are free of bank conflicts, then the table (ntt_shape).
//
// Above n = 32768 a polynomial does not fit a CTA.  There it is one
// thread-block cluster of C = 2^K CTAs (the cluster kernels of ntt.cu and
// fused_mul_large.cu): n = C n2, and CTA r holds block r of n2 values in
// its shared memory, laid out and padded as above.  The first K forward
// stages are one size-C transform of root 1 over each column
// x[e n2 + j], e < C; a CTA runs them for its share of the columns in
// registers, straight from device memory (load_column), and writes value e
// of each column into CTA e's block over distributed shared memory
// (scatter_column).  The other stages are the sub-transforms of block r's
// own roots, so they run on the block alone, with its own slice of the
// twiddle heap.  The inverse mirrors it (gather_column, store_column).
// The helpers for that close this header.

#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;    // threads of a CTA at n >= 8192
constexpr int kMaxPhases = 8;
constexpr int kLoadBatch = 16;   // 16-byte loads in flight per thread
constexpr int kFactorLevel = 3;  // ops/ntt.py FACTOR_LEVEL
constexpr int kConstantSlots = 16;

// Shared-memory index of value i: one word of padding every 32.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Words of the padded values, rounded up to 16 bytes: the twiddle table
// follows them.
__host__ __device__ constexpr int data_words(int log_n) {
  return ((1 << log_n) + ((1 << log_n) >> 5) + 3) & ~3;
}

// Two table slots (w, w') as one 16-byte vector, from the staged table.
__device__ __forceinline__ uint4 twiddles(const uint4* p) { return *p; }

// The limb's table of `entries` pairs (an even count) into shared memory at
// dst, by 16-byte cp.async copies that the caller waits for with
// cp.async.wait_all before its first barrier.
__device__ __forceinline__ const uint2* stage_twiddles(uint32_t* dst,
                                                       const uint32_t* table,
                                                       int entries) {
  const uint4* src = reinterpret_cast<const uint4*>(table);
  for (int i = threadIdx.x; i < entries / 2; i += blockDim.x) {
    const unsigned to = static_cast<unsigned>(
        __cvta_generic_to_shared(reinterpret_cast<uint4*>(dst) + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return reinterpret_cast<const uint2*>(dst);
}

// y * w mod q in [0, 2q), for any y < 2^32: one Shoup product, or two for a
// factored twiddle c * w (c first).
template <bool kTwo>
__device__ __forceinline__ uint32_t twiddle_mul(uint32_t y, uint32_t w,
                                                uint32_t ws, uint32_t c,
                                                uint32_t cs, uint32_t q) {
  if (kTwo) y = troy::shoup_lazy(y, c, cs, q);
  return troy::shoup_lazy(y, w, ws, q);
}

// Forward (Cooley-Tukey) butterfly: in and out [0, 4q).  Inverse
// (Gentleman-Sande): in and out [0, 2q).
template <bool kInverse, bool kTwo = false>
__device__ __forceinline__ void butterfly(uint32_t& x, uint32_t& y,
                                          uint32_t w, uint32_t ws, uint32_t q,
                                          uint32_t two_q, uint32_t c = 0,
                                          uint32_t cs = 0) {
  if (kInverse) {
    const uint32_t u = x, v = y;
    const uint32_t sum = u + v;
    x = sum >= two_q ? sum - two_q : sum;
    y = twiddle_mul<kTwo>(u + two_q - v, w, ws, c, cs, q);
  } else {
    const uint32_t u = x >= two_q ? x - two_q : x;
    const uint32_t v = twiddle_mul<kTwo>(y, w, ws, c, cs, q);
    x = u + v;
    y = u + two_q - v;
  }
}

// Table slots (u32 pairs) of one sub-transform root (ops/ntt.py:phase_slots).
template <int K, bool kFactor>
constexpr int kRootSlots =
    kFactor && K > kFactorLevel ? (1 << kFactorLevel) + 2 : 1 << K;

// K stages of one sub-transform held in registers.  x[j] is value
// base + j * s of the polynomial; level l pairs x[a] with x[a + h],
// h = 2^(K-1-l), under the twiddle of group g = a / 2h.  t4 is the root's
// table (ops/ntt.py:phase_nodes): slot 2^l + g holds that twiddle, or, for a
// factored level (kFactor, l >= 3), slot 8 + l - 3 holds psi_br[v 2^l] and
// the twiddle is that times the constant slot g of c4 (psi_br[g]).  Forward
// levels run 0 .. K-1, inverse K-1 .. 0.  Each 16-byte read brings the
// (w, w') pairs of two neighbouring slots; level 0 reads slots 0 (padding)
// and 1.
template <int K, bool kInverse, bool kFactor, int kStep = 0>
__device__ __forceinline__ void radix_stages(uint32_t (&x)[1 << K],
                                             const uint4* __restrict__ t4,
                                             const uint4* __restrict__ c4,
                                             uint32_t q) {
  if constexpr (kStep < K) {
    constexpr int l = kInverse ? K - 1 - kStep : kStep;
    constexpr int h = (1 << K) >> (l + 1);
    const uint32_t two_q = q << 1;
    if constexpr (l == 0) {
      const uint4 w = twiddles(t4);
#pragma unroll
      for (int i = 0; i < h; ++i)
        butterfly<kInverse>(x[i], x[i + h], w.z, w.w, q, two_q);
    } else if constexpr (kFactor && l >= kFactorLevel) {
      const uint4 a = twiddles(t4 + 4);  // slots 8, 9
      const uint32_t w = l == kFactorLevel ? a.x : a.z;
      const uint32_t ws = l == kFactorLevel ? a.y : a.w;
#pragma unroll
      for (int g = 0; g < (1 << l); g += 2) {
        const uint4 c = twiddles(c4 + (g >> 1));
#pragma unroll
        for (int i = 0; i < h; ++i) {
          const int lo = g * 2 * h + i, hi = lo + 2 * h;
          if (g == 0)
            butterfly<kInverse>(x[lo], x[lo + h], w, ws, q, two_q);
          else
            butterfly<kInverse, true>(x[lo], x[lo + h], w, ws, q, two_q, c.x,
                                      c.y);
          butterfly<kInverse, true>(x[hi], x[hi + h], w, ws, q, two_q, c.z,
                                    c.w);
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < (1 << l); g += 2) {
        const uint4 w = twiddles(t4 + (((1 << l) + g) >> 1));
#pragma unroll
        for (int i = 0; i < h; ++i) {
          const int lo = g * 2 * h + i, hi = lo + 2 * h;
          butterfly<kInverse>(x[lo], x[lo + h], w.x, w.y, q, two_q);
          butterfly<kInverse>(x[hi], x[hi + h], w.z, w.w, q, two_q);
        }
      }
    }
    radix_stages<K, kInverse, kFactor, kStep + 1>(x, t4, c4, q);
  }
}

// A phase (r, K) on values in shared memory: sub-transform u has root
// u >> log_s and values base + j s, s = 2^log_s = n / 2^(r+K).  kFactor:
// the last phase, whose deep levels factor their twiddles.
template <int K, bool kInverse, bool kFactor>
__device__ __forceinline__ void smem_phase(uint32_t* s, int log_n, int r,
                                           const uint2* __restrict__ tw,
                                           const uint2* __restrict__ consts,
                                           uint32_t q) {
  constexpr int E = 1 << K;
  const int log_s = log_n - r - K;
  const int s_mask = (1 << log_s) - 1;
  const int n_sub = 1 << (log_n - K);
  for (int u = threadIdx.x; u < n_sub; u += blockDim.x) {
    const int root = u >> log_s;
    const int base = (root << (log_s + K)) + (u & s_mask);
    uint32_t x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = s[pad(base + (j << log_s))];
    radix_stages<K, kInverse, kFactor>(
        x, reinterpret_cast<const uint4*>(tw + root * kRootSlots<K, kFactor>),
        reinterpret_cast<const uint4*>(consts), q);
#pragma unroll
    for (int j = 0; j < E; ++j) s[pad(base + (j << log_s))] = x[j];
  }
}

// The inverse's last phase (the plan's phase 0: r = 0, root 0) when the
// plan has two or more: it reads shared memory and writes the output
// polynomial `out` directly, scaled by n^-1 into [0, q).  A thread takes
// the sub-transforms u and u + 1 (values u + j s and u + 1 + j s,
// s = n / 2^K >= 32), so each of its 2^K stores moves two int64 residues in
// 16 bytes, and no barrier separates a warp's butterflies from its stores.
template <int K>
__device__ __forceinline__ void store_phase(const uint32_t* s, int64_t* out,
                                            int log_n,
                                            const uint2* __restrict__ tw,
                                            uint32_t q, uint32_t n_inv,
                                            uint32_t n_inv_sh) {
  constexpr int E = 1 << K;
  const int log_s = log_n - K;
  const uint4* t4 = reinterpret_cast<const uint4*>(tw);
  longlong2* dst = reinterpret_cast<longlong2*>(out);
  for (int u = 2 * threadIdx.x; u < (1 << log_s); u += 2 * blockDim.x) {
    uint32_t a[E], b[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      a[j] = s[pad((j << log_s) + u)];
      b[j] = s[pad((j << log_s) + u + 1)];
    }
    radix_stages<K, true, false>(a, t4, nullptr, q);
    radix_stages<K, true, false>(b, t4, nullptr, q);
#pragma unroll
    for (int j = 0; j < E; ++j)
      dst[((j << log_s) + u) >> 1] =
          make_longlong2(troy::scale_n_inv(a[j], n_inv, n_inv_sh, q),
                         troy::scale_n_inv(b[j], n_inv, n_inv_sh, q));
  }
}

// The forward's first phase (r = 0, root 0) when the plan has two or more,
// read straight from device memory: store_phase's mirror.  A thread takes
// the sub-transforms u and u + 1, so each of its 2^K loads brings two int64
// residues in 16 bytes, and writes its values into shared memory after the
// phase's butterflies.  K4 runs it (fused_mul.cu); the NTT kernel stages
// its load instead (ntt.cu's note).
template <int K>
__device__ __forceinline__ void load_phase(uint32_t* s, const int64_t* in,
                                           int log_n,
                                           const uint2* __restrict__ tw,
                                           uint32_t q) {
  constexpr int E = 1 << K;
  const int log_s = log_n - K;
  const uint4* t4 = reinterpret_cast<const uint4*>(tw);
  const longlong2* src = reinterpret_cast<const longlong2*>(in);
  for (int u = 2 * threadIdx.x; u < (1 << log_s); u += 2 * blockDim.x) {
    longlong2 v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = __ldg(src + (((j << log_s) + u) >> 1));
    uint32_t a[E], b[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      a[j] = static_cast<uint32_t>(v[j].x);
      b[j] = static_cast<uint32_t>(v[j].y);
    }
    radix_stages<K, false, false>(a, t4, nullptr, q);
    radix_stages<K, false, false>(b, t4, nullptr, q);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      s[pad((j << log_s) + u)] = a[j];
      s[pad((j << log_s) + u + 1)] = b[j];
    }
  }
}

template <bool kInverse, bool kFactor>
__device__ __forceinline__ void run_smem_phase(int k, uint32_t* s, int log_n,
                                               int r, const uint2* tw,
                                               const uint2* consts,
                                               uint32_t q) {
  switch (k) {
    case 1: smem_phase<1, kInverse, kFactor>(s, log_n, r, tw, consts, q); break;
    case 2: smem_phase<2, kInverse, kFactor>(s, log_n, r, tw, consts, q); break;
    case 3: smem_phase<3, kInverse, kFactor>(s, log_n, r, tw, consts, q); break;
    case 4: smem_phase<4, kInverse, kFactor>(s, log_n, r, tw, consts, q); break;
    default: smem_phase<5, kInverse, kFactor>(s, log_n, r, tw, consts, q); break;
  }
}

__device__ __forceinline__ void run_store_phase(int k, const uint32_t* s,
                                                int64_t* out, int log_n,
                                                const uint2* tw, uint32_t q,
                                                uint32_t n_inv,
                                                uint32_t n_inv_sh) {
  switch (k) {
    case 1: store_phase<1>(s, out, log_n, tw, q, n_inv, n_inv_sh); break;
    case 2: store_phase<2>(s, out, log_n, tw, q, n_inv, n_inv_sh); break;
    case 3: store_phase<3>(s, out, log_n, tw, q, n_inv, n_inv_sh); break;
    default: store_phase<4>(s, out, log_n, tw, q, n_inv, n_inv_sh); break;
  }
}

// Phases of a plan: depth of phase i in bits 4i..4i+3
// (ops/ntt.py:kernel_plan_code; a plan of two or more phases starts with a
// phase of at most 4).
__device__ __forceinline__ int phase_count(int plan) {
  int count = 0;
  while (count < kMaxPhases && ((plan >> (4 * count)) & 15)) ++count;
  return count;
}

// The phases in shared memory, forward in plan order, inverse reversed,
// each followed by a barrier, but for the plan's first `skip` phases (the
// inverse runs its phase 0 as store_phase).
template <bool kInverse>
__device__ __forceinline__ void smem_phases(uint32_t* s, int log_n, int plan,
                                            int count, int skip,
                                            const uint2* tw, uint32_t q) {
  for (int step = 0; step < count - skip; ++step) {
    const int p = kInverse ? count - 1 - step : step + skip;
    int r = 0, off = kConstantSlots;  // phase p's first stage, table offset
    for (int i = 0; i < p; ++i) {
      const int d = (plan >> (4 * i)) & 15;
      off += 1 << (r + d);
      r += d;
    }
    const int k = (plan >> (4 * p)) & 15;
    if (p == count - 1)
      run_smem_phase<kInverse, true>(k, s, log_n, r, tw + off, tw, q);
    else
      run_smem_phase<kInverse, false>(k, s, log_n, r, tw + off, tw, q);
    __syncthreads();
  }
}

// The plan of ops/ntt.py:kernel_phase_plan at compile time, for a kernel
// instantiated per degree (K4): depth(i) and start(i) of phase i, offset(i)
// of its twiddles in the limb's table, code() the packed plan the runtime
// loop above reads (the launch checks the two agree).
template <int LogN>
struct Plan {
  static constexpr int kLast = LogN < 5 ? LogN : 5;
  static constexpr int kRest = LogN - kLast;
  static constexpr int kFirst = kRest < 4 ? kRest : 4;
  static constexpr int kMid = kRest - kFirst;
  static constexpr int kMidCount = (kMid + 4) / 5;
  static constexpr int kCount = (kFirst > 0 ? 1 : 0) + kMidCount + 1;
  __host__ __device__ static constexpr int depth(int i) {
    if (kFirst > 0 && i == 0) return kFirst;
    const int m = i - (kFirst > 0 ? 1 : 0);
    constexpr int count = kMidCount > 0 ? kMidCount : 1;  // no division by 0
    return m < kMidCount ? kMid / count + (m < kMid % count ? 1 : 0) : kLast;
  }
  __host__ __device__ static constexpr int start(int i) {
    int r = 0;
    for (int j = 0; j < i; ++j) r += depth(j);
    return r;
  }
  __host__ __device__ static constexpr int offset(int i) {
    int off = kConstantSlots;
    for (int j = 0; j < i; ++j) off += 1 << (start(j) + depth(j));
    return off;
  }
  __host__ __device__ static constexpr int code() {
    int c = 0;
    for (int i = 0; i < kCount; ++i) c |= depth(i) << (4 * i);
    return c;
  }
};

// Phases P .. kCount - 1 of Plan<LogN> in shared memory, each followed by a
// barrier: smem_phases with the plan known at compile time.
template <int LogN, int P = 0>
__device__ __forceinline__ void forward_plan(uint32_t* s, const uint2* tw,
                                             uint32_t q) {
  using Pl = Plan<LogN>;
  if constexpr (P < Pl::kCount) {
    smem_phase<Pl::depth(P), false, P == Pl::kCount - 1>(
        s, LogN, Pl::start(P), tw + Pl::offset(P), tw, q);
    __syncthreads();
    forward_plan<LogN, P + 1>(s, tw, q);
  }
}

// The inverse phases P down to Stop of Plan<LogN>, each followed by a
// barrier (Stop = 1 when phase 0 is the store phase).
template <int LogN, int Stop, int P = Plan<LogN>::kCount - 1>
__device__ __forceinline__ void inverse_plan(uint32_t* s, const uint2* tw,
                                             uint32_t q) {
  using Pl = Plan<LogN>;
  if constexpr (P >= Stop) {
    smem_phase<Pl::depth(P), true, P == Pl::kCount - 1>(
        s, LogN, Pl::start(P), tw + Pl::offset(P), tw, q);
    __syncthreads();
    inverse_plan<LogN, Stop, P - 1>(s, tw, q);
  }
}

// Threads of a CTA that transforms one polynomial of 2^log_n values: one per
// 32 values, at least a warp, at most kThreads.
__host__ __device__ constexpr int cta_threads(int log_n) {
  return (1 << log_n) >> 5 < 32 ? 32
                                 : ((1 << log_n) >> 5 > kThreads ? kThreads
                                                                 : (1 << log_n) >> 5);
}

// The polynomial `in` (n int64 residues, 16-byte aligned) into shared
// memory as u32: two residues a 16-byte load, kLoadBatch loads in flight
// per thread.
__device__ __forceinline__ void load_values(uint32_t* s, const int64_t* in,
                                            int log_n) {
  const int pairs = 1 << (log_n - 1);
  const longlong2* src = reinterpret_cast<const longlong2*>(in);
  for (int i0 = threadIdx.x; i0 < pairs; i0 += kLoadBatch * blockDim.x) {
    longlong2 v[kLoadBatch];
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < pairs) v[b] = __ldg(src + i);
    }
#pragma unroll
    for (int b = 0; b < kLoadBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < pairs) {
        s[pad(2 * i)] = static_cast<uint32_t>(v[b].x);
        s[pad(2 * i + 1)] = static_cast<uint32_t>(v[b].y);
      }
    }
  }
}

// The polynomial in shared memory out to `out` as int64, two residues a
// 16-byte store: forward values [0, 4q) reduced, inverse values [0, 2q)
// scaled by n^-1, both into [0, q).
template <bool kInverse>
__device__ __forceinline__ void store_values(const uint32_t* s, int64_t* out,
                                             int log_n, uint32_t q,
                                             uint32_t n_inv,
                                             uint32_t n_inv_sh) {
  const int pairs = 1 << (log_n - 1);
  longlong2* dst = reinterpret_cast<longlong2*>(out);
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    uint32_t a = s[pad(2 * i)], b = s[pad(2 * i + 1)];
    if (kInverse) {
      a = troy::scale_n_inv(a, n_inv, n_inv_sh, q);
      b = troy::scale_n_inv(b, n_inv, n_inv_sh, q);
    } else {
      a = troy::reduce_from_4q(a, q);
      b = troy::reduce_from_4q(b, q);
    }
    dst[i] = make_longlong2(a, b);
  }
}

struct Shape {
  int threads;
  size_t smem;
};

// Threads and shared memory of a CTA that transforms one polynomial: n
// padded u32 values, then one limb's table of `entries` pairs (226 560
// bytes at n = 32768).
Shape ntt_shape(int log_n, int entries) {
  return {cta_threads(log_n),
          static_cast<size_t>(data_words(log_n)) * sizeof(uint32_t) +
              static_cast<size_t>(entries) * sizeof(uint2)};
}

// ---- Thread-block clusters above n = 32768 ---------------------------------

// Montgomery's REDC: t 2^-32 mod q in [0, 2q) for t < q 2^32, with
// q_inv_neg = -q^-1 mod 2^32.  t + m q is 0 mod 2^32 and below 2q 2^32 <
// 2^63, so the shift is exact and below 2q.  (K4's products, fused_mul.cu
// and fused_mul_large.cu.)
__device__ __forceinline__ uint32_t mont_redc(uint64_t t, uint32_t q,
                                              uint32_t q_inv_neg) {
  const uint32_t m = static_cast<uint32_t>(t) * q_inv_neg;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
}

// The two halves of a cluster barrier (PTX barrier.cluster).  The relaxed
// arrive orders no memory access: it only tells the peers that this CTA
// runs, so that a peer past the matching wait may write into its shared
// memory.  Every thread arrives once and then waits once.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Column j of a polynomial `row` of 2^K blocks of 2^log_b values into
// registers: x[e] = x_row[e 2^log_b + j].  A thread takes one column and
// neighbouring threads neighbouring columns, so a warp's load of value e is
// one 256-byte run.
template <int K>
__device__ __forceinline__ void load_column(const int64_t* __restrict__ row,
                                            int j, int log_b,
                                            uint32_t (&x)[1 << K]) {
  int64_t v[1 << K];
#pragma unroll
  for (int e = 0; e < (1 << K); ++e)
    v[e] = __ldg(row + (static_cast<size_t>(e) << log_b) + j);
#pragma unroll
  for (int e = 0; e < (1 << K); ++e) x[e] = static_cast<uint32_t>(v[e]);
}

// Value e of column j into block e: the shared memory of cluster rank e, at
// the offset `s` has in this CTA, at pad(j).  A warp's 32 columns start at a
// multiple of 32, so each of its stores is one 128-byte run of the peer's
// block, no padding word inside.  (One thread a column pair would store two
// half-filled runs: pad(j) is odd when j / 32 is, so a pair cannot go as
// one 8-byte store.)
template <int K>
__device__ __forceinline__ void scatter_column(uint32_t* s, int j,
                                               const uint32_t (&x)[1 << K]) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int at = pad(j);
#pragma unroll
  for (int e = 0; e < (1 << K); ++e) cluster.map_shared_rank(s, e)[at] = x[e];
}

// scatter_column's inverse: value e of column j from block e.
template <int K>
__device__ __forceinline__ void gather_column(uint32_t* s, int j,
                                              uint32_t (&x)[1 << K]) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int at = pad(j);
#pragma unroll
  for (int e = 0; e < (1 << K); ++e) x[e] = cluster.map_shared_rank(s, e)[at];
}

// Column j out to `row` after the inverse's column stages: [0, 2q) scaled by
// n_inv into [0, q).
template <int K>
__device__ __forceinline__ void store_column(int64_t* __restrict__ row, int j,
                                             int log_b,
                                             const uint32_t (&x)[1 << K],
                                             uint32_t q, uint32_t n_inv,
                                             uint32_t n_inv_sh) {
#pragma unroll
  for (int e = 0; e < (1 << K); ++e)
    row[(static_cast<size_t>(e) << log_b) + j] =
        troy::scale_n_inv(x[e], n_inv, n_inv_sh, q);
}

// A phase (r, K) on `polys` polynomials `stride` words apart in shared
// memory (K4's cluster route holds its four operand blocks side by side):
// smem_phase with the sub-transforms of every polynomial shared out over
// the CTA's threads.
template <int K, bool kInverse, bool kFactor>
__device__ __forceinline__ void smem_phase_polys(int polys, int stride,
                                                 uint32_t* s, int log_n, int r,
                                                 const uint2* __restrict__ tw,
                                                 const uint2* __restrict__ consts,
                                                 uint32_t q) {
  constexpr int E = 1 << K;
  const int log_s = log_n - r - K;
  const int s_mask = (1 << log_s) - 1;
  const int log_sub = log_n - K;
  for (int w = threadIdx.x; w < (polys << log_sub); w += blockDim.x) {
    uint32_t* p = s + (w >> log_sub) * stride;
    const int u = w & ((1 << log_sub) - 1);
    const int root = u >> log_s;
    const int base = (root << (log_s + K)) + (u & s_mask);
    uint32_t x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = p[pad(base + (j << log_s))];
    radix_stages<K, kInverse, kFactor>(
        x, reinterpret_cast<const uint4*>(tw + root * kRootSlots<K, kFactor>),
        reinterpret_cast<const uint4*>(consts), q);
#pragma unroll
    for (int j = 0; j < E; ++j) p[pad(base + (j << log_s))] = x[j];
  }
}

// Every phase of Plan<LogN> on `polys` polynomials, forward in plan order
// or inverse in reverse, each followed by a barrier.
template <int LogN, bool kInverse, int Step = 0>
__device__ __forceinline__ void plan_polys(int polys, int stride, uint32_t* s,
                                           const uint2* tw, uint32_t q) {
  using Pl = Plan<LogN>;
  if constexpr (Step < Pl::kCount) {
    constexpr int P = kInverse ? Pl::kCount - 1 - Step : Step;
    smem_phase_polys<Pl::depth(P), kInverse, P == Pl::kCount - 1>(
        polys, stride, s, LogN, Pl::start(P), tw + Pl::offset(P), tw, q);
    __syncthreads();
    plan_polys<LogN, kInverse, Step + 1>(polys, stride, s, tw, q);
  }
}

constexpr size_t kSmemDefault = 48 * 1024;  // shared bytes without an opt-in
constexpr size_t kSmemLimit = 232448;       // the most a CTA may opt into

struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
};

// `cells` clusters of `ctas` CTAs of `shape`, under the load-balancing
// cluster scheduling policy (as fused_mul.cu:launch_config).
void cluster_config(ClusterLaunch& l, int ctas, const Shape& shape,
                    long long cells, cudaStream_t stream) {
  l.cfg = {};
  l.cfg.gridDim = dim3(static_cast<unsigned int>(cells * ctas));
  l.cfg.blockDim = dim3(shape.threads);
  l.cfg.dynamicSmemBytes = shape.smem;
  l.cfg.stream = stream;
  l.attr[0] = {};
  l.attr[0].id = cudaLaunchAttributeClusterDimension;
  l.attr[0].val.clusterDim.x = ctas;
  l.attr[0].val.clusterDim.y = 1;
  l.attr[0].val.clusterDim.z = 1;
  l.attr[1] = {};
  l.attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  l.attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  l.cfg.attrs = l.attr;
  l.cfg.numAttrs = 2;
}

// `fn` readied for clusters of `ctas` CTAs of `shape` (shared memory above
// 48 KiB granted; above 8 CTAs, a size that is not portable, allowed), and
// the clusters the card holds at once (cudaOccupancyMaxActiveClusters) into
// *clusters; 0 or a CUDA error.
int cluster_ready(const void* fn, int ctas, const Shape& shape, int* clusters) {
  *clusters = 0;
  if (shape.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (shape.smem > kSmemDefault) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shape.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (ctas > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ClusterLaunch l;
  cluster_config(l, ctas, shape, 1, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &l.cfg));
}

// One launch of `cells` clusters: fn readied once per device, kernel and
// shape, and refused (cudaErrorLaunchOutOfResources) where the card holds no
// cluster of it, never shrunk.
int launch_clusters(const void* fn, int ctas, const Shape& shape,
                    long long cells, void* stream, void** args) {
  if (cells <= 0) return 0;
  struct Ready {
    const void* fn;
    int dev;
    int threads;
    size_t smem;
  };
  static Ready ready[64];
  static int n_ready = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return static_cast<int>(cudaErrorInvalidDevice);
  bool seen = false;
  for (int i = 0; i < n_ready && !seen; ++i)
    seen = ready[i].fn == fn && ready[i].dev == dev && ready[i].threads == shape.threads &&
           ready[i].smem == shape.smem;
  if (!seen) {
    int clusters = 0;
    const int err = cluster_ready(fn, ctas, shape, &clusters);
    if (err) return err;
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (n_ready < 64) ready[n_ready++] = {fn, dev, shape.threads, shape.smem};
  }
  ClusterLaunch l;
  cluster_config(l, ctas, shape, cells, static_cast<cudaStream_t>(stream));
  const int err = static_cast<int>(cudaLaunchKernelExC(&l.cfg, fn, args));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

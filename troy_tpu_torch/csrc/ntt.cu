// Negacyclic NTT / INTT over RNS limbs for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of troy_tpu/ops/ntt_pallas.py:
//   K1  _fwd_kernel / _inv_kernel (launcher _ntt_pallas): the fused six-step
//       transform with Shoup-lazy VPU butterflies;
//   K2  _fwd_kernel_mxu / _inv_kernel_mxu (launcher _ntt_pallas_mxu): the
//       same transform with both sub-transforms as int8 MXU matmuls, which
//       the TPU needed because it has no 32-bit mulhi.
// Both compute one function; so do these kernels: output in [0, q), in the
// NTT order "position p holds psi^(2*brv(p)+1)" (troy_tpu/ops/ntt.py).
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
// The first kernel pair (one radix-2 stage per barrier) stays in this library
// as troy_ntt_{forward,inverse}_radix2, a yardstick that only the timing
// phase of chip_smoke.py launches; no wrapper routes to it.  Its stages live
// in ntt_common.cuh, shared with fused_mul.cu (K4).
//
// Layout: input (rows, n) int64 contiguous and 16-byte aligned, with the
// limb of row r equal to r % L; this covers (B, L, n), (B, 2, L, n) and the
// keyswitch digit tensor (B, L, L+1, n).  Tables: phases (2, L, 2 E) u32
// (forward, inverse; E pairs per limb, ops/ntt.py:phase_rows); scalars
// (3, L) u32 = q, n^-1, n^-1 Shoup.  The forward transform accepts lazy
// input in [0, 2q); the inverse takes [0, 2q) too and scales by n^-1.
// Kernels never allocate.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPhases = 8;
constexpr int kLoadBatch = 16;   // 16-byte loads in flight per thread
constexpr int kFactorLevel = 3;  // ops/ntt.py FACTOR_LEVEL
constexpr int kConstantSlots = 16;
constexpr size_t kDefaultSmem = 48 * 1024;

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
  const int pairs = 1 << (log_n - 1);
  int count = 0;
  while (count < kMaxPhases && ((plan >> (4 * count)) & 15)) ++count;
  const bool fused = kInverse && count > 1;  // phase 0 as store_phase

  const longlong2* src = reinterpret_cast<const longlong2*>(in + base);
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
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The phases in shared memory, forward in plan order, inverse reversed.
  for (int step = 0; step < count - fused; ++step) {
    const int p = kInverse ? count - 1 - step : step;
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

  if (fused) {
    run_store_phase(plan & 15, s, out + base, log_n, tw + kConstantSlots, q,
                    n_inv, n_inv_sh);
    return;
  }
  longlong2* dst = reinterpret_cast<longlong2*>(out + base);
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

// Threads and shared memory of a CTA: n padded u32 values, then the limb's
// table of `entries` pairs (226 560 bytes at n = 32768).
Shape ntt_shape(int log_n, int entries) {
  const int n = 1 << log_n;
  const int threads = n >> 5 < 32 ? 32 : (n >> 5 > kThreads ? kThreads : n >> 5);
  return {threads, static_cast<size_t>(data_words(log_n)) * sizeof(uint32_t) +
                       static_cast<size_t>(entries) * sizeof(uint2)};
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

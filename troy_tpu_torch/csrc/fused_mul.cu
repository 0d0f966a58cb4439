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
// transform is the radix-2 Shoup schedule of the NTT kernel
// (ntt_common.cuh).
//
// Design: one CTA per (batch, limb).
//   * n <= 8192 ("resident"): the four polynomials a0, a1, b0, b1 are loaded
//     into shared memory (4 x 4n bytes, 128 KiB at n = 8192: dynamic shared
//     memory above 48 KiB), transformed together (one barrier per stage for
//     all four), multiplied in place, the three products transformed back
//     together, and stored.  Device memory sees one int64 load per input
//     value and one int64 store per output value, as the unfused path's
//     first load and last store.
//   * n = 16384 and 32768 ("staged"): four polynomials need 256 KiB and
//     more, over the 227 KB a block may hold.  One polynomial lives in
//     shared memory at a time (64 or 128 KiB); the NTT forms of a0, a1, b0
//     go to the kernel's own output rows as int64, the products are formed
//     in place against b1 in shared memory, and each product row is
//     transformed back from there.  That costs three extra row round trips
//     through device memory (L2 mostly) but needs no scratch tensor.
//   The wrapper refuses n > 32768, as the NTT wrapper does.
//
// Products use the 64-bit product and a Barrett reduction by
// floor((2^64 - 1) / q) (ntt_common.cuh); a0 b1 + a1 b0 < 2^61 is reduced
// once.  Outputs are canonical in [0, q).
//
// Bound: at the flagship (16, 2, 6, 8192) the kernel launches 96 CTAs of
// 128 KiB, one per SM, so 36 of the H100's 132 SMs stay idle, and each CTA
// runs 13 + 13 barrier-separated stages over shared memory.  Shared-memory
// bandwidth and the idle SMs bound it, not device memory (25 MB in, 19 MB
// out).  Splitting a CTA's work, or two CTAs per polynomial pair, comes later.
//
// Tables: NTTTables.kernel_rows (4, L, n) and kernel_scalars (3, L), as the
// NTT kernel.  Inputs in [0, 2q) are accepted.  The kernel never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void fused_mul_kernel(const int64_t* __restrict__ a,
                                 const int64_t* __restrict__ b,
                                 int64_t* __restrict__ out,
                                 const uint32_t* __restrict__ rows,
                                 const uint32_t* __restrict__ scalars, int L,
                                 int log_n, int staged) {
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

}  // namespace

// a, b: (n_batch, 2, L, n) int64 contiguous; out: (n_batch, 3, L, n).
extern "C" int troy_fused_mul(const void* a, const void* b, void* out,
                              const void* rows, const void* scalars,
                              long long n_batch, int L, int log_n,
                              void* stream) {
  if (n_batch <= 0) return 0;
  const int n = 1 << log_n;
  const size_t poly = static_cast<size_t>(n) * sizeof(uint32_t);
  const int staged = 4 * poly > kMaxSmem ? 1 : 0;
  const size_t smem = staged ? poly : 4 * poly;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 2 * n < 1024 ? 2 * n : 1024;
  fused_mul_kernel<<<static_cast<unsigned int>(n_batch * L), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(rows),
      static_cast<const uint32_t*>(scalars), L, log_n, staged);
  return static_cast<int>(cudaGetLastError());
}

// The NTT-domain tensor product of two size-2 ciphertexts for NVIDIA Hopper
// (sm_90a):
//
//   (c0, c1, c2) = (a0 b0, a0 b1 + a1 b0, a1 b1) mod q, coefficient-wise
//
// for input x = (a0, a1, b0, b1) as (B, 4, L, n) residues in [0, q) and
// output (B, 3, L, n) in [0, q).
//
// The middle kernel of the five-launch route of the fused tensor product at
// degrees above 32768 (ops/fused_mul_cuda.py:run_five_launch): the NTT's
// two-launch forward of (a, b) as one (B, 4, L, n) call, this kernel, then
// the two-launch inverse.  That route was K4's (troy_tpu/ops/fused_mul.py:
// _kernel) above 32768 until the one-launch cluster kernel of
// fused_mul_large.cu replaced it; it stays as that kernel's timing
// yardstick, and this kernel is launched by nothing else.
//
// Design: a CTA per 512 coefficient pairs of one (batch, limb) (grid y), so
// q and its Barrett ratio floor((2^64 - 1) / q) are loaded once; a thread
// reads the pair (k, k + 1) of the four operands as 16-byte loads, forms the
// three products in 64 bits (the cross sum is below 2 q^2 < 2^61) and
// reduces each by one Barrett step (ntt_common.cuh:barrett_reduce64).
// Bound: device memory, 56 bytes a coefficient against a few 64-bit
// multiplies.  The kernel never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerThread = 2;

__global__ void __launch_bounds__(kThreads)
    tensor_product_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                          const uint32_t* __restrict__ scalars,
                          const uint64_t* __restrict__ ratios, int L,
                          int log_n) {
  const int limb = blockIdx.y % L;
  const size_t batch = blockIdx.y / L;
  const uint64_t q = scalars[limb];
  const uint64_t ratio = ratios[limb];
  const size_t poly_pairs = static_cast<size_t>(1) << (log_n - 1);
  const size_t in_base = (batch * 4 * L + limb) * poly_pairs;
  const size_t out_base = (batch * 3 * L + limb) * poly_pairs;
  const size_t stride = static_cast<size_t>(L) * poly_pairs;  // one polynomial
  const longlong2* src = reinterpret_cast<const longlong2*>(x) + in_base;
  longlong2* dst = reinterpret_cast<longlong2*>(out) + out_base;
  const size_t first =
      static_cast<size_t>(blockIdx.x) * kThreads * kPairsPerThread + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    const size_t k = first + static_cast<size_t>(p) * kThreads;
    if (k >= poly_pairs) return;
    const longlong2 a0 = __ldg(src + k), a1 = __ldg(src + stride + k);
    const longlong2 b0 = __ldg(src + 2 * stride + k), b1 = __ldg(src + 3 * stride + k);
    const uint64_t a0x = a0.x, a0y = a0.y, a1x = a1.x, a1y = a1.y;
    const uint64_t b0x = b0.x, b0y = b0.y, b1x = b1.x, b1y = b1.y;
    dst[k] = make_longlong2(troy::barrett_reduce64(a0x * b0x, q, ratio),
                            troy::barrett_reduce64(a0y * b0y, q, ratio));
    dst[stride + k] = make_longlong2(
        troy::barrett_reduce64(a0x * b1x + a1x * b0x, q, ratio),
        troy::barrett_reduce64(a0y * b1y + a1y * b0y, q, ratio));
    dst[2 * stride + k] = make_longlong2(troy::barrett_reduce64(a1x * b1x, q, ratio),
                                         troy::barrett_reduce64(a1y * b1y, q, ratio));
  }
}

}  // namespace

// x (n_batch, 4, L, 2^log_n) -> out (n_batch, 3, L, 2^log_n); scalars: the
// NTT tables' kernel_scalars (q in row 0); ratios: (L,) u64 Barrett ratios.
extern "C" int troy_tensor_product(const void* x, void* out, const void* scalars,
                                   const void* ratios, long long n_batch, int L,
                                   int log_n, void* stream) {
  if (n_batch <= 0) return 0;
  if (log_n < 1 || n_batch * L > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = 1LL << (log_n - 1);
  const long long per_cta = static_cast<long long>(kThreads) * kPairsPerThread;
  const dim3 grid(static_cast<unsigned int>((pairs + per_cta - 1) / per_cta),
                  static_cast<unsigned int>(n_batch * L));
  tensor_product_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(scalars), static_cast<const uint64_t*>(ratios), L,
      log_n);
  return static_cast<int>(cudaGetLastError());
}

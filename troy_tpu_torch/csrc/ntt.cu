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
// Design: one CTA per (row, limb) polynomial, the whole polynomial held in
// shared memory as u32 (32 KiB at n = 8192, dynamic shared memory above
// 48 KiB, up to n = 32768).  log2(n) radix-2 stages of Harvey butterflies
// with Shoup multiplication: __umulhi(x, w_shoup) gives the quotient, so a
// twiddle product costs one mulhi and two low multiplies.  Stage values stay
// below 4q < 2^32 (q < 2^30), so nothing leaves 32 bits between stages.
// Twiddles are the radix-2 tables psi^brv(i) with Shoup companions, read
// from global memory (they stay in L1/L2: one (L, n) table serves every row).
// The stages live in ntt_common.cuh, shared with the fused tensor-product
// kernel (fused_mul.cu).
//
// Bound: at these sizes the kernel is bound by device-memory traffic (one
// 8-byte load and store per coefficient; residues travel as int64, the
// port's residue type) and by shared-memory bandwidth across log2(n)
// __syncthreads()-separated stages.  Fusing several stages per pass in
// registers, and a tensor-core (mma/wgmma s8) variant after K2, come later.
//
// Layout: input (rows, n) int64 contiguous, with the limb of row r equal to
// r % L; this covers (B, L, n), (B, 2, L, n) and the keyswitch digit tensor
// (B, L, L+1, n).  Tables: rows (4, L, n) u32 = psi_br, psi_br_shoup,
// inv_psi_br, inv_psi_br_shoup; scalars (3, L) u32 = q, n^-1, n^-1 Shoup.
// The forward transform accepts lazy input in [0, 2q); the inverse takes
// [0, 2q) too and scales by n^-1.  Kernels never allocate.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

__global__ void ntt_forward_kernel(const int64_t* __restrict__ in,
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

__global__ void ntt_inverse_kernel(const int64_t* __restrict__ in,
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

constexpr size_t kDefaultSmem = 48 * 1024;

template <typename Kernel>
int launch(Kernel kernel, const void* in, void* out, const void* rows,
           const void* scalars, long long n_rows, int L, int log_n,
           void* stream) {
  if (n_rows <= 0) return 0;
  const int n = 1 << log_n;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n / 2 < 1024 ? (n / 2 > 0 ? n / 2 : 1) : 1024;
  kernel<<<static_cast<unsigned int>(n_rows), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(rows),
      static_cast<const uint32_t*>(scalars), L, log_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int troy_ntt_forward(const void* in, void* out, const void* rows,
                                const void* scalars, long long n_rows, int L,
                                int log_n, void* stream) {
  return launch(ntt_forward_kernel, in, out, rows, scalars, n_rows, L, log_n,
                stream);
}

extern "C" int troy_ntt_inverse(const void* in, void* out, const void* rows,
                                const void* scalars, long long n_rows, int L,
                                int log_n, void* stream) {
  return launch(ntt_inverse_kernel, in, out, rows, scalars, n_rows, L, log_n,
                stream);
}

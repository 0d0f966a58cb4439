// Device helpers shared by the NTT kernel pair (ntt.cu), the fused
// tensor-product kernel (fused_mul.cu) and the base-conversion kernel
// (bconv.cu): Shoup and Barrett products, and the radix-2 negacyclic
// butterfly stages over polynomials held in shared memory.
//
// Values are u32 residues of moduli q < 2^30, so lazy values below 4q fit
// 32 bits.  Twiddle rows are NTTTables.kernel_rows (ops/ntt.py): psi^brv(i)
// and inv_psi^brv(i) with their Shoup companions floor(w * 2^32 / q).

#pragma once

#include <cstdint>

namespace troy {

// x * w mod q in [0, 2q) for any x < 2^32, w < q, ws = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t ws, uint32_t q) {
  return x * w - __umulhi(x, ws) * q;
}

// x mod p for any x < 2^64 and 2 <= p < 2^63, with
// ratio = floor((2^64 - 1) / p): the quotient estimate __umul64hi(x, ratio)
// is floor(x / p) or one less, so one conditional subtract finishes.  The
// ratio form also holds for p a power of two (m~ = 2^16).
__device__ __forceinline__ uint64_t barrett_reduce64(uint64_t x, uint64_t p,
                                                     uint64_t ratio) {
  const uint64_t r = x - __umul64hi(x, ratio) * p;
  return r >= p ? r - p : r;
}

// [0, 4q) -> [0, q).
__device__ __forceinline__ uint32_t reduce_from_4q(uint32_t v, uint32_t q) {
  const uint32_t two_q = q << 1;
  v = v >= two_q ? v - two_q : v;
  return v >= q ? v - q : v;
}

// Butterfly jj of a stage over kPolys polynomials back to back: the
// polynomial it touches and its index j within that polynomial.  With one
// polynomial both are free.
template <int kPolys>
__device__ __forceinline__ uint32_t* poly_of(uint32_t* s, int jj, int log_n,
                                             int& j) {
  if (kPolys == 1) {
    j = jj;
    return s;
  }
  j = jj & ((1 << (log_n - 1)) - 1);
  return s + ((jj >> (log_n - 1)) << log_n);
}

// Forward Cooley-Tukey stages over kPolys polynomials of n = 2^log_n values
// stored back to back in s, all under one modulus q.  In: [0, 4q) natural
// order; out: [0, 4q) NTT order.  Stage m = 2^log_m has groups of
// t = n / 2m butterflies: pairs (a, a + t) with a = 2 g t + k and twiddle
// psi_br[m + g].  One barrier per stage serves every polynomial.
template <int kPolys>
__device__ __forceinline__ void forward_stages(uint32_t* s, int log_n,
                                               const uint32_t* psi,
                                               const uint32_t* psi_sh,
                                               uint32_t q) {
  const int half = 1 << (log_n - 1);
  const uint32_t two_q = q << 1;
  for (int log_m = 0; log_m < log_n; ++log_m) {
    const int log_t = log_n - 1 - log_m;
    const int t_mask = (1 << log_t) - 1;
    for (int jj = threadIdx.x; jj < kPolys * half; jj += blockDim.x) {
      int j;
      uint32_t* sp = poly_of<kPolys>(s, jj, log_n, j);
      const int g = j >> log_t;
      const int a = ((g << 1) << log_t) + (j & t_mask);
      const int b = a + (1 << log_t);
      const int w = (1 << log_m) + g;
      uint32_t u = sp[a];                                  // [0, 4q)
      u = u >= two_q ? u - two_q : u;                      // [0, 2q)
      const uint32_t v = shoup_lazy(sp[b], psi[w], psi_sh[w], q);  // [0, 2q)
      sp[a] = u + v;                                       // [0, 4q)
      sp[b] = u + two_q - v;                               // [0, 4q)
    }
    __syncthreads();
  }
}

// Inverse Gentleman-Sande stages (m = n/2 down to 1) over kPolys
// polynomials back to back in s.  In: [0, 2q) NTT order; out: [0, 2q)
// natural order, not yet scaled by n^-1.
template <int kPolys>
__device__ __forceinline__ void inverse_stages(uint32_t* s, int log_n,
                                               const uint32_t* ipsi,
                                               const uint32_t* ipsi_sh,
                                               uint32_t q) {
  const int half = 1 << (log_n - 1);
  const uint32_t two_q = q << 1;
  for (int log_m = log_n - 1; log_m >= 0; --log_m) {
    const int log_t = log_n - 1 - log_m;
    const int t_mask = (1 << log_t) - 1;
    for (int jj = threadIdx.x; jj < kPolys * half; jj += blockDim.x) {
      int j;
      uint32_t* sp = poly_of<kPolys>(s, jj, log_n, j);
      const int g = j >> log_t;
      const int a = ((g << 1) << log_t) + (j & t_mask);
      const int b = a + (1 << log_t);
      const int w = (1 << log_m) + g;
      const uint32_t u = sp[a];
      const uint32_t v = sp[b];
      uint32_t x0 = u + v;
      x0 = x0 >= two_q ? x0 - two_q : x0;
      sp[a] = x0;
      sp[b] = shoup_lazy(u + two_q - v, ipsi[w], ipsi_sh[w], q);
    }
    __syncthreads();
  }
}

// The inverse transform's last step: [0, 2q) times n^-1 -> [0, q).
__device__ __forceinline__ uint32_t scale_n_inv(uint32_t v, uint32_t n_inv,
                                                uint32_t n_inv_sh,
                                                uint32_t q) {
  v = shoup_lazy(v, n_inv, n_inv_sh, q);
  return v >= q ? v - q : v;
}

}  // namespace troy

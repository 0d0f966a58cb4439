// Fast RNS base conversion (BEHZ fast_convert_array) for NVIDIA Hopper
// (sm_90a):
//
//   y[r, o, k] = sum_i [x[r, i, k] * ip_i]_{q_i} * M[o, i]  mod p_o
//
// for input (rows, L_in, n) residues in [0, q_i) and output
// (rows, L_out, n) in [0, p_o).
//
// Replaces the TPU kernel troy_tpu/ops/ntt_pallas.py:_bconv_kernel (K3,
// entry bconv_pallas).  That kernel split the scaled input into int8 digit
// planes and ran the limb contraction on the MXU, because the TPU has no
// 32-bit mulhi and no 64-bit integer multiply.  Hopper has both, and the
// contraction is only L_in <= ~15 deep (an s8 mma would pad K to 32), so
// this kernel runs it on the CUDA cores in 64-bit integers.
//
// Design: one thread per (row, coefficient k) column computes all L_out
// outputs of that column; neighbouring threads take neighbouring k, so every
// int64 load and store is coalesced.  The Shoup product [x_i ip_i]_{q_i}
// (__umulhi and one conditional subtract) lands in shared memory, one
// (L_in, 128) tile per block, and each output o accumulates
// sum_i tmp_i M[o, i] in u64, reduced every R terms and once at the end, by
// Barrett with floor((2^64 - 1) / p_o) (exact for any p_o >= 2, including
// m~ = 2^16, the plain modulus t and t = 2^k of the ring2k encoder).  A
// product is below 2^30 p_o, so R terms and a reduced sum stay below 2^64
// with R = 16 for p_o < 2^30, 8 for p_o < 2^31 and 4 for p_o < 2^32.
// The tables (q_in, ip, ip Shoup, p_out, M: a few hundred words) are copied
// to shared memory by every block.
//
// Bound: device memory.  One column reads 8 L_in bytes and writes
// 8 L_out bytes (residues travel as int64, the port's residue type) against
// L_in L_out 64-bit multiply-adds and L_out Barrett reductions.
//
// Tables: one u32 array [q_in (L_in), ip (L_in), ip_shoup (L_in),
// p_out (L_out), M (L_out x L_in, row-major)], from ops/bconv.BConvTables.
// Every input modulus is below 2^30 and every output modulus below 2^32;
// L_in and L_out are at most 64 (the wrapper checks all three).  The kernel
// never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

size_t smem_bytes(int L_in, int L_out) {
  return sizeof(uint64_t) * L_out +
         sizeof(uint32_t) * (3 * L_in + L_out + L_out * L_in) +
         sizeof(uint32_t) * L_in * kThreads;
}

__global__ void bconv_kernel(const int64_t* __restrict__ x,
                             int64_t* __restrict__ y,
                             const uint32_t* __restrict__ tables, int L_in,
                             int L_out, int n, int blocks_per_row) {
  extern __shared__ uint64_t smem[];
  uint64_t* ratio = smem;                                   // (L_out)
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + L_out);
  const int n_tab = 3 * L_in + L_out + L_out * L_in;
  uint32_t* tmp = tab + n_tab;                              // (L_in, kThreads)
  const uint32_t* q_in = tab;
  const uint32_t* ip = tab + L_in;
  const uint32_t* ip_sh = tab + 2 * L_in;
  const uint32_t* p_out = tab + 3 * L_in;
  const uint32_t* mat = p_out + L_out;

  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  for (int o = threadIdx.x; o < L_out; o += blockDim.x)
    ratio[o] = ~0ull / p_out[o];
  __syncthreads();

  const long long row = blockIdx.x / blocks_per_row;
  const int k = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  if (k >= n) return;
  const int64_t* xr = x + row * L_in * n + k;
  int64_t* yr = y + row * L_out * n + k;
  uint32_t* t = tmp + threadIdx.x;

  for (int i = 0; i < L_in; ++i) {
    const uint32_t q = q_in[i];
    const uint32_t xi = static_cast<uint32_t>(xr[static_cast<size_t>(i) * n]);
    const uint32_t v = troy::shoup_lazy(xi, ip[i], ip_sh[i], q);
    t[i * kThreads] = v >= q ? v - q : v;
  }
  for (int o = 0; o < L_out; ++o) {
    const uint64_t p = p_out[o];
    const uint32_t* m = mat + o * L_in;
    const int every = p < (1ull << 30) ? 15 : (p < (1ull << 31) ? 7 : 3);
    uint64_t acc = 0;
    for (int i = 0; i < L_in; ++i) {
      acc += static_cast<uint64_t>(t[i * kThreads]) * m[i];
      if ((i & every) == every) acc = troy::barrett_reduce64(acc, p, ratio[o]);
    }
    acc = troy::barrett_reduce64(acc, p, ratio[o]);
    yr[static_cast<size_t>(o) * n] = static_cast<int64_t>(acc);
  }
}

}  // namespace

// x: (n_rows, L_in, n) int64 contiguous; y: (n_rows, L_out, n).
extern "C" int troy_bconv(const void* x, void* y, const void* tables,
                          long long n_rows, int L_in, int L_out, int n,
                          void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  const int blocks_per_row = (n + kThreads - 1) / kThreads;
  const long long blocks = n_rows * blocks_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L_in, L_out);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        bconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bconv_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(y),
      static_cast<const uint32_t*>(tables), L_in, L_out, n, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}

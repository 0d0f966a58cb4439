// A probe of the wgmma operand layout csrc/ntt_mxu_wg.cu relies on: one
// warpgroup computes D[m][n] = sum_k A[m][k] B[n][k] (64 x 32, u8 x u8 ->
// s32, m64n32k32) from A (64 x Kp) and B (32 x Kp) in the no-swizzle
// K-major core-matrix layout, and writes D by the accumulator fragment
// layout the kernel's epilogues assume.  Mode 0 builds the descriptors as
// the kernel does (LBO = 128 bytes along K, SBO = 8 Kp bytes between 8-row
// groups), mode 1 with the two swapped (expected wrong).  Built and run by
// scripts/torch_mxu_wg_check.py.
#include "../troy_tpu_torch/csrc/ntt_mxu_wg.cu"
using namespace troy::mxu_wg;
__device__ uint64_t desc2(const uint8_t* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
__global__ void probe(const uint8_t* A, const uint8_t* B, int* D, int mode, int Kp) {
  __shared__ __align__(128) uint8_t sa[64 * 64];
  __shared__ __align__(128) uint8_t sb[32 * 64];
  for (int i = threadIdx.x; i < 64 * Kp; i += 128) sa[i] = A[i];
  for (int i = threadIdx.x; i < 32 * Kp; i += 128) sb[i] = B[i];
  fence_async_smem();
  __syncthreads();
  int acc[16];
  for (int i = 0; i < 16; ++i) acc[i] = 0;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int k = 0; k < Kp; k += 32) {
    uint64_t da, db;
    if (mode == 0) { da = descriptor(sa + 8 * k, 8 * Kp); db = descriptor(sb + 8 * k, 8 * Kp); }
    else { da = desc2(sa + 8 * k, 8 * Kp, 128); db = desc2(sb + 8 * k, 8 * Kp, 128); }
    wgmma<32>(acc, da, db, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(acc[i])::"memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * warp + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      D[m * 32 + n] = acc[4 * j + e];
    }
}
extern "C" int run_probe(const void* A, const void* B, void* D, int mode, int Kp) {
  probe<<<1, 128>>>((const uint8_t*)A, (const uint8_t*)B, (int*)D, mode, Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return cudaDeviceSynchronize();
}

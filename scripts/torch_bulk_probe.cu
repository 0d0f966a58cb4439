// A probe of cp.async.bulk's rate from L2 into one SM's shared memory, as
// the cluster kernel of K2 (troy_tpu_torch/csrc/ntt_mxu_cluster.cu) streams
// its table chunks: one warp a CTA keeps `depth` chunks of `chunk` bytes in
// flight, each chunk `copies` bulk copies (one a lane), over `rounds`
// chunks read round-robin from a 1 MB buffer that stays in L2.  Launched
// with or without a cluster.  Built and run by scripts/torch_bulk_probe.py.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mode 0: bulk copies, waits by mbarrier.try_wait; 1: the same, waits by a
// test_wait spin; 2: cp.async 16-byte copies by every thread of the CTA
// (no TMA), cp.async.wait_group for the chunk `depth` - 1 back.
__global__ void bulk_probe(const uint8_t* src, int src_bytes, int chunk, int depth, int copies,
                           int rounds, int cta_stride, int mode) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[16];
  if (threadIdx.x == 0) {
    for (int d = 0; d < depth; ++d)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[d])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * cta_stride;
  if (mode == 2) {
    for (int i = 0; i < rounds; ++i) {
      const int s = i % depth;
      const size_t off = (base + static_cast<size_t>(i) * chunk) % (src_bytes - chunk);
      for (int c = threadIdx.x * 16; c < chunk; c += blockDim.x * 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(smem + s * chunk + c)),
                     "l"(src + off + c)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (i >= depth - 1) {
        if (depth == 3) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
        else asm volatile("cp.async.wait_group 5;\n" ::: "memory");
        __syncthreads();
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int piece = chunk / copies;
  for (int i = 0; i < rounds + depth; ++i) {
    if (i >= depth) {
      const int j = i - depth;
      uint32_t done = 0;
      do {
        if (mode == 0)
          asm volatile(
              "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              "selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(smem_addr(&full[j % depth])), "r"((j / depth) & 1)
              : "memory");
        else
          asm volatile(
              "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
              "selp.u32 %0, 1, 0, p;\n}\n"
              : "=r"(done)
              : "r"(smem_addr(&full[j % depth])), "r"((j / depth) & 1)
              : "memory");
      } while (!done);
    }
    if (i < rounds) {
      const int s = i % depth;
      if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         smem_addr(&full[s])),
                     "r"(chunk)
                     : "memory");
      __syncwarp();
      const size_t off = (base + static_cast<size_t>(i) * chunk) % (src_bytes - chunk);
      for (int c = lane; c < copies; c += 32)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(smem + s * chunk + c * piece)),
            "l"(src + off + static_cast<size_t>(c) * piece), "r"(piece),
            "r"(smem_addr(&full[s]))
            : "memory");
    }
  }
}

}  // namespace

// Device microseconds of one launch of `ctas` CTAs (clusters of `cluster`
// CTAs, or none at 0), by CUDA events; negative a CUDA error.
extern "C" float troy_bulk_probe(const void* src, int src_bytes, int chunk, int depth,
                                 int copies, int rounds, int ctas, int cluster, int cta_stride,
                                 int mode) {
  const int smem = chunk * depth;
  cudaFuncSetAttribute(bulk_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster > 0 ? cluster : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  if (cluster > 8) cudaFuncSetAttribute(bulk_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = -1;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(a);
    cudaError_t e = cudaLaunchKernelEx(&cfg, bulk_probe, s, src_bytes, chunk, depth, copies,
                                       rounds, cta_stride, mode);
    cudaEventRecord(b);
    if (e != cudaSuccess) return -static_cast<float>(e);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  cudaError_t e = cudaGetLastError();
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return e != cudaSuccess ? -static_cast<float>(e) : ms * 1e3f;
}

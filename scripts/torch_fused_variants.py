#!/usr/bin/env python3
"""Variants of the fused tensor-product kernel K4
(troy_tpu_torch/csrc/fused_mul.cu), built side by side and timed in turns
on one GPU, to show where its time goes and what the other design costs.

    python3 scripts/torch_fused_variants.py [variant ...]

Each variant is csrc/fused_mul.cu, with the phase header ntt_phases.cuh
written in place, under textual substitutions, compiled by nvcc (the flags
of ops/_cuda_build.py, all variants in parallel) into its own library under
troy_tpu_torch/build/variants/ (scripts/torch_ntt_variants.py:build).  At
the flagship's two tensor-product launches, over base q (16, 2, 6, 8192) and
over Bsk (16, 2, 9, 8192), and at two of chip_smoke.py's K4_DEGREES,
(3, 2, 2, 16) and (3, 2, 2, 1024), random 30-bit primes, every variant is launched
on the same lazy [0, 2q) input and timed by CUDA events around a CUDA graph
of 50 launches, in the order listed and then in reverse, keeping the lower
of the two, beside the first (radix-2) kernel of the committed library and
the launch's bound (chip_smoke.fused_bound); "(wrong)" marks a result that
differs from the plain version, as the measurement-only variants do.

  committed      csrc/fused_mul.cu as it is: per degree, a cluster of 4
                 CTAs per (batch, limb), one per operand, 3 CTAs an SM at
                 n <= 8192, the load-balancing cluster scheduling policy,
                 the forward's first phase read from device memory,
                 products across the cluster's shared memory by
                 Montgomery reduction;
  first          the cluster design's first version: the operand loaded
                 into shared memory before the first phase, 2 CTAs an SM,
                 the default cluster scheduling policy;
  smem_load      the operand loaded into shared memory before the first
                 phase (16-byte loads, 16 in flight a thread);
  ctas2          registers capped for 2 CTAs an SM, not 3;
  threads128     CTAs of 128 threads, 4 an SM (the shared memory of 4 fits);
  threads192     CTAs of 192 threads, 4 an SM: the threads of 3 CTAs of 256;
  default_policy the default cluster scheduling policy (the launch sets no
                 cudaLaunchAttributeClusterSchedulingPolicyPreference): 92
                 clusters resident at n = 8192, not 96;
  single_cta     the other design: one CTA of 512 threads per (batch, limb)
                 with the four operands side by side in shared memory
                 (n <= 8192), every phase over all of them (the runtime
                 plan), the products in place (Barrett), the inverse table
                 staged over the forward one;
  no_butterfly   every phase loads and stores its values but runs no
                 butterfly: the memory path, the products and the barriers;
  const_twiddle  every twiddle a constant, no table copies;
  no_products    the cluster barriers without the products between them;
  push           each CTA pushes its values at a peer's coefficient range into
                 a staging area of that peer (16-byte stores into distributed
                 shared memory) before the first cluster barrier, and forms
                 its products from its own staging area (n <= 8192: the
                 staging area takes n words more);
  barrett        the products by the Barrett reduction of the first
                 version (ratio floor((2^64 - 1) / q) formed in the kernel);
  timeline       the committed kernel with %globaltimer stamps by thread 0
                 of each CTA at its steps (start, first phase done, forward
                 done, first cluster barrier, products done, second
                 barrier, inverse phases done, stored): printed as the
                 spread of the CTAs' starts and ends and, over the first
                 wave, the median and largest time of each step;
  timeline_threads128  the same stamps on threads128.

Needs one CUDA device and nvcc; imports nothing of jax.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402  (bounds, graph timing, nvidia-smi line)
import torch_ntt_variants  # noqa: E402  (variant build)
from troy_tpu_torch.core.modulus import Modulus  # noqa: E402
from troy_tpu_torch.ops import fused_mul as FM, fused_mul_cuda, ntt as NTT  # noqa: E402
from troy_tpu_torch.utils import numth  # noqa: E402

SHAPES = {"base q": (16, 6, 13), "base Bsk": (16, 9, 13),  # (batch, limbs, log2 n)
          "n=16": (3, 2, 4), "n=1024": (3, 2, 10)}

_SINGLE_CTA = r'''// single_cta: one CTA per (batch, limb), the four operands side by side in
// shared memory (words apart), each phase over all of them.
constexpr int kPolys = 4;
constexpr int kSingleThreads = 512;

template <int K, bool kInverse, bool kFactor>
__device__ __forceinline__ void multi_phase(uint32_t* s, int words, int polys,
                                            int log_n, int r,
                                            const uint2* __restrict__ tw,
                                            const uint2* __restrict__ consts,
                                            uint32_t q) {
  constexpr int E = 1 << K;
  const int log_s = log_n - r - K;
  const int s_mask = (1 << log_s) - 1;
  const int log_sub = log_n - K;
  for (int uu = threadIdx.x; uu < (polys << log_sub); uu += blockDim.x) {
    uint32_t* sp = s + (uu >> log_sub) * words;
    const int u = uu & ((1 << log_sub) - 1);
    const int root = u >> log_s;
    const int base = (root << (log_s + K)) + (u & s_mask);
    uint32_t x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = sp[pad(base + (j << log_s))];
    radix_stages<K, kInverse, kFactor>(
        x, reinterpret_cast<const uint4*>(tw + root * kRootSlots<K, kFactor>),
        reinterpret_cast<const uint4*>(consts), q);
#pragma unroll
    for (int j = 0; j < E; ++j) sp[pad(base + (j << log_s))] = x[j];
  }
}

template <bool kInverse, bool kFactor>
__device__ __forceinline__ void run_multi_phase(int k, uint32_t* s, int words,
                                                int polys, int log_n, int r,
                                                const uint2* tw,
                                                const uint2* consts,
                                                uint32_t q) {
  switch (k) {
    case 1: multi_phase<1, kInverse, kFactor>(s, words, polys, log_n, r, tw, consts, q); break;
    case 2: multi_phase<2, kInverse, kFactor>(s, words, polys, log_n, r, tw, consts, q); break;
    case 3: multi_phase<3, kInverse, kFactor>(s, words, polys, log_n, r, tw, consts, q); break;
    case 4: multi_phase<4, kInverse, kFactor>(s, words, polys, log_n, r, tw, consts, q); break;
    default: multi_phase<5, kInverse, kFactor>(s, words, polys, log_n, r, tw, consts, q); break;
  }
}

template <bool kInverse>
__device__ __forceinline__ void multi_phases(uint32_t* s, int words, int polys,
                                             int log_n, int plan, int count,
                                             int skip, const uint2* tw,
                                             uint32_t q) {
  for (int step = 0; step < count - skip; ++step) {
    const int p = kInverse ? count - 1 - step : step + skip;
    int r = 0, off = kConstantSlots;
    for (int i = 0; i < p; ++i) {
      const int d = (plan >> (4 * i)) & 15;
      off += 1 << (r + d);
      r += d;
    }
    const int k = (plan >> (4 * p)) & 15;
    if (p == count - 1)
      run_multi_phase<kInverse, true>(k, s, words, polys, log_n, r, tw + off, tw, q);
    else
      run_multi_phase<kInverse, false>(k, s, words, polys, log_n, r, tw + off, tw, q);
    __syncthreads();
  }
}

// store_phase over the three products, `stride` int64 apart in out.
template <int K>
__device__ __forceinline__ void multi_store_phase(const uint32_t* s, int words,
                                                  int64_t* out, size_t stride,
                                                  int log_n,
                                                  const uint2* __restrict__ tw,
                                                  uint32_t q, uint32_t n_inv,
                                                  uint32_t n_inv_sh) {
  constexpr int E = 1 << K;
  const int log_s = log_n - K;
  const uint4* t4 = reinterpret_cast<const uint4*>(tw);
  for (int uu = 2 * threadIdx.x; uu < (3 << log_s); uu += 2 * blockDim.x) {
    const int p = uu >> log_s, u = uu & ((1 << log_s) - 1);
    const uint32_t* sp = s + p * words;
    longlong2* dst = reinterpret_cast<longlong2*>(out + p * stride);
    uint32_t a[E], b[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      a[j] = sp[pad((j << log_s) + u)];
      b[j] = sp[pad((j << log_s) + u + 1)];
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

__device__ __forceinline__ void run_multi_store_phase(
    int k, const uint32_t* s, int words, int64_t* out, size_t stride,
    int log_n, const uint2* tw, uint32_t q, uint32_t n_inv, uint32_t n_inv_sh) {
  switch (k) {
    case 1: multi_store_phase<1>(s, words, out, stride, log_n, tw, q, n_inv, n_inv_sh); break;
    case 2: multi_store_phase<2>(s, words, out, stride, log_n, tw, q, n_inv, n_inv_sh); break;
    case 3: multi_store_phase<3>(s, words, out, stride, log_n, tw, q, n_inv, n_inv_sh); break;
    default: multi_store_phase<4>(s, words, out, stride, log_n, tw, q, n_inv, n_inv_sh); break;
  }
}

__global__ void __launch_bounds__(kSingleThreads, 1)
    fused_mul_single_kernel(const int64_t* __restrict__ a,
                            const int64_t* __restrict__ b,
                            int64_t* __restrict__ out,
                            const uint32_t* __restrict__ phases,
                            const uint32_t* __restrict__ scalars, int L,
                            int log_n, int plan, int entries) {
  extern __shared__ uint32_t s[];
  const int batch = blockIdx.x / L, limb = blockIdx.x % L;
  const int n = 1 << log_n;
  const int words = data_words(log_n);
  const uint32_t q = scalars[limb];
  const uint32_t n_inv = scalars[L + limb];
  const uint32_t n_inv_sh = scalars[2 * L + limb];
  const size_t ln = static_cast<size_t>(L) << log_n;
  const size_t off = static_cast<size_t>(limb) << log_n;
  uint32_t* table = s + kPolys * words;
  const int count = phase_count(plan);
  const uint2* tw = stage_twiddles(
      table, phases + static_cast<size_t>(limb) * 2 * entries, entries);
  for (int p = 0; p < kPolys; ++p)
    load_values(s + p * words,
                (p < 2 ? a : b) + (2 * static_cast<size_t>(batch) + (p & 1)) * ln + off,
                log_n);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  multi_phases<false>(s, words, kPolys, log_n, plan, count, 0, tw, q);
  stage_twiddles(table, phases + static_cast<size_t>(L + limb) * 2 * entries,
                 entries);
  const uint64_t ratio = ~0ull / q;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t a0 = troy::reduce_from_4q(s[pad(i)], q);
    const uint64_t a1 = troy::reduce_from_4q(s[words + pad(i)], q);
    const uint64_t b0 = troy::reduce_from_4q(s[2 * words + pad(i)], q);
    const uint64_t b1 = troy::reduce_from_4q(s[3 * words + pad(i)], q);
    s[pad(i)] = static_cast<uint32_t>(troy::barrett_reduce64(a0 * b0, q, ratio));
    s[words + pad(i)] =
        static_cast<uint32_t>(troy::barrett_reduce64(a0 * b1 + a1 * b0, q, ratio));
    s[2 * words + pad(i)] =
        static_cast<uint32_t>(troy::barrett_reduce64(a1 * b1, q, ratio));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  int64_t* dst = out + 3 * static_cast<size_t>(batch) * ln + off;
  if (count > 1) {
    multi_phases<true>(s, words, 3, log_n, plan, count, 1, tw, q);
    run_multi_store_phase(plan & 15, s, words, dst, ln, log_n, tw + kConstantSlots,
                          q, n_inv, n_inv_sh);
  } else {
    multi_phases<true>(s, words, 3, log_n, plan, count, 0, tw, q);
    for (int p = 0; p < 3; ++p)
      store_values<true>(s + p * words, dst + p * ln, log_n, q, n_inv, n_inv_sh);
  }
}

int launch_fused(const void* a, const void* b, void* out, const void* phases,
                 const void* scalars, long long n_batch, int L, int log_n,
                 int plan, int entries, void* stream) {
  if (n_batch <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(kPolys) * data_words(log_n) * sizeof(uint32_t) +
      static_cast<size_t>(entries) * sizeof(uint2);
  const int err = grant_smem(
      reinterpret_cast<const void*>(fused_mul_single_kernel), smem);
  if (err) return err;
  const int n = 1 << log_n;
  const int threads = n >> 4 < 32 ? 32 : (n >> 4 > kSingleThreads ? kSingleThreads : n >> 4);
  fused_mul_single_kernel<<<static_cast<unsigned int>(n_batch * L), threads,
                            smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(phases),
      static_cast<const uint32_t*>(scalars), L, log_n, plan, entries);
  return static_cast<int>(cudaGetLastError());
}

'''

_BOUNDS = "__launch_bounds__(kThreads, LogN <= 13 ? 3 : 1)"  # the cluster kernel's

VARIANTS = {
    "committed": [],
    "single_cta": [("REGION", "int launch_fused(",
                    "// ---- The first kernel: the timing yardstick", _SINGLE_CTA)],
    "no_butterfly": [("radix_stages<K, kInverse, kFactor>(",
                      "if (q == 7) radix_stages<K, kInverse, kFactor>("),
                     ("radix_stages<K, true, false>(", "if (q == 7) radix_stages<K, true, false>(")],
    "const_twiddle": [("{ return *p; }", "{ return make_uint4(3u, 5u, 7u, 11u); }"),
                      ("  const uint2* tw = stage_twiddles(table, fwd, entries);",
                       "  const uint2* tw = reinterpret_cast<const uint2*>(table);"),
                      ("  if (rank < kCluster - 1)\n    stage_twiddles(",
                       "  if (q == 7)\n    stage_twiddles(")],
    "no_products": [("const int hi = n < lo + chunk ? n : lo + chunk;",
                     "const int hi = q == 7 ? n : lo;")],
    "barrett": [
        ("  const uint32_t q_inv_neg = scalars[3 * L + limb];\n",
         "  const uint32_t q_inv_neg = scalars[3 * L + limb];\n  const uint64_t ratio = ~0ull / q;\n"),
        ("mont_redc(a0 * b0, q, q_inv_neg)",
         "static_cast<uint32_t>(troy::barrett_reduce64(a0 * b0, q, ratio))"),
        ("mont_redc(a0 * b1 + a1 * b0, q, q_inv_neg)",
         "static_cast<uint32_t>(troy::barrett_reduce64(a0 * b1 + a1 * b0, q, ratio))"),
        ("mont_redc(a1 * b1, q, q_inv_neg)",
         "static_cast<uint32_t>(troy::barrett_reduce64(a1 * b1, q, ratio))"),
        ("scalars[4 * L + limb]", "scalars[L + limb]"),
        ("scalars[5 * L + limb]", "scalars[2 * L + limb]")],
    "smem_load": [
        ("  load_phase<Pl::depth(0)>(\n"
         "      s, src, LogN, reinterpret_cast<const uint2*>(fwd) + kConstantSlots, q);\n",
         "  load_values(s, src, LogN);\n"),
        ("  forward_plan<LogN, 1>(s, tw, q);", "  forward_plan<LogN>(s, tw, q);")],
    "ctas2": [(_BOUNDS, "__launch_bounds__(kThreads, LogN <= 13 ? 2 : 1)")],
    "threads128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
                   (_BOUNDS, "__launch_bounds__(kThreads, LogN <= 13 ? 4 : 1)")],
    "threads192": [("constexpr int kThreads = 256;", "constexpr int kThreads = 192;"),
                   (_BOUNDS, "__launch_bounds__(kThreads, LogN <= 13 ? 4 : 1)")],
    "default_policy": [("l.cfg.numAttrs = v.ctas > 1 ? 2 : 0;",
                        "l.cfg.numAttrs = v.ctas > 1 ? 1 : 0;")],
}
# The cluster design's first version: the load through shared memory, no
# register cap (2 CTAs an SM at n = 8192), the default scheduling policy.
VARIANTS["first"] = (VARIANTS["smem_load"] + VARIANTS["default_policy"]
                     + [(_BOUNDS, "__launch_bounds__(kThreads)")])

_STAMPS = r"""// timeline: %globaltimer by thread 0 of each CTA at its steps.
__device__ unsigned long long g_stamps[1 << 14];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * 8 + k] = t;
  }
}

"""
STEPS = ("load phase", "other forward phases", "table + barrier 1", "products", "barrier 2",
         "inverse phases", "store phase")
TIMELINE = [
    ("// One (batch, limb) per cluster", _STAMPS + "// One (batch, limb) per cluster"),
    ("  uint32_t* table = s + data_words(LogN);\n",
     "  uint32_t* table = s + data_words(LogN);\n  stamp(0);\n"),
    ("  __syncthreads();\n  forward_plan<LogN, 1>(s, tw, q);\n",
     "  __syncthreads();\n  stamp(1);\n  forward_plan<LogN, 1>(s, tw, q);\n  stamp(2);\n"),
    ("                   entries);\n  cluster.sync();\n",
     "                   entries);\n  cluster.sync();\n  stamp(3);\n"),
    ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  cluster.sync();\n"
     "  if (rank == kCluster - 1) return;",
     "  stamp(4);\n  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  cluster.sync();\n"
     "  stamp(5);\n  if (rank == kCluster - 1) {\n    stamp(6);\n    stamp(7);\n    return;\n  }"),
    ("  inverse_plan<LogN, 1>(s, tw, q);\n", "  inverse_plan<LogN, 1>(s, tw, q);\n  stamp(6);\n"),
    ("                            n_inv_sh);\n}\n",
     "                            n_inv_sh);\n  stamp(7);\n}\n"),
    ("// What the compiler and the occupancy calculator say",
     "extern \"C\" int troy_fused_stamps(void* dst, int count) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, count * 8));\n}\n\n"
     "// What the compiler and the occupancy calculator say")]
_PUSH = r"""  // 2. The inverse table over the forward one.
  if (rank < kCluster - 1)
    stage_twiddles(table, phases + static_cast<size_t>(L + limb) * 2 * entries,
                   entries);
  // push: this CTA's values at CTA c's coefficients into row `rank` of c's
  // staging area, four a 16-byte store.
  uint32_t* staging = table + 2 * entries;
  {
    uint32_t* peer[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c) peer[c] = cluster.map_shared_rank(staging, c);
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
      const int c = i / chunk, k = i - c * chunk;
      *reinterpret_cast<uint4*>(peer[c] + rank * chunk + k) =
          make_uint4(s[pad(i)], s[pad(i + 1)], s[pad(i + 2)], s[pad(i + 3)]);
    }
  }
  cluster.sync();

  // 3. The products of this CTA's coefficients from its own staging area.
  {
    uint32_t* part[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c) part[c] = cluster.map_shared_rank(s, c);
    const int lo = rank * chunk;
    for (int k = 4 * threadIdx.x; k < chunk; k += 4 * blockDim.x) {
      uint32_t x[kCluster][4];
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(staging + c * chunk + k);
        x[c][0] = v.x; x[c][1] = v.y; x[c][2] = v.z; x[c][3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = lo + k + e;
        const uint64_t a0 = troy::reduce_from_4q(x[0][e], q);
        const uint64_t a1 = troy::reduce_from_4q(x[1][e], q);
        const uint64_t b0 = troy::reduce_from_4q(x[2][e], q);
        const uint64_t b1 = troy::reduce_from_4q(x[3][e], q);
        part[0][pad(i)] = mont_redc(a0 * b0, q, q_inv_neg);
        part[1][pad(i)] = mont_redc(a0 * b1 + a1 * b0, q, q_inv_neg);
        part[2][pad(i)] = mont_redc(a1 * b1, q, q_inv_neg);
      }
    }
  }
"""
VARIANTS["push"] = [
    ("REGION", "  // 2. The inverse table over the forward one",
     "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  cluster.sync();\n"
     "  if (rank == kCluster - 1) return;", _PUSH),
    ("  return ntt_shape(log_n, entries);\n}",
     "  Shape sh = ntt_shape(log_n, entries);\n"
     "  sh.smem += (static_cast<size_t>(1) << log_n) * sizeof(uint32_t);\n  return sh;\n}")]
VARIANTS["timeline"] = TIMELINE
VARIANTS["timeline_threads128"] = VARIANTS["threads128"] + TIMELINE
SMALL_ONLY = {"single_cta": 13, "push": 13}  # largest log_n the variant takes


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_fused_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = torch_ntt_variants.build(names, "fused_mul.cu", VARIANTS,
                                    ("fused_mul_kernelILi13E", "fused_mul_single_kernel"))
    gen = torch.Generator(device=dev).manual_seed(11)
    info_fn = ("troy_fused_mul_kernel_info",
               [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    for name in names:
        if name in SMALL_ONLY:  # its kernel is not the one kernel_info reports
            continue
        fn = getattr(libs[name], info_fn[0])
        fn.argtypes, fn.restype = info_fn[1], ctypes.c_int
        info = (ctypes.c_int * 6)()
        if fn(0, 13, NTT.phase_entries(13), info):
            raise RuntimeError(f"[variants] {name}: kernel info failed")
        print(f"[occupancy] {name} at n = 8192: {info[0]} threads, {info[4]} CTAs an SM, "
              f"{info[5]} clusters on the card", flush=True)

    def launch(lib, symbol, argtypes, a, b, t, table, *extra):
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out = torch.empty((*a.shape[:-3], 3, t.size, t.n), dtype=torch.int64, device=dev)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), table.data_ptr(),
                 t.kernel_scalars.data_ptr(), a.shape[0], t.size, t.log_n, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {symbol} launch failed: CUDA error {err}")
        return out

    def variant(name, a, b, t):
        return launch(libs[name], "troy_fused_mul", fused_mul_cuda._ARGTYPES, a, b, t,
                      t.kernel_phases, t.plan_code, t.kernel_phases.shape[-1] // 2)

    def yardstick(a, b, t):
        return launch(libs[names[0]], "troy_fused_mul_radix2", fused_mul_cuda._RADIX2_ARGTYPES,
                      a, b, t, t.kernel_rows)

    for label, (batch, limbs, log_n) in SHAPES.items():
        primes = numth.get_primes(2 << log_n, 30, limbs)
        t = NTT.NTTTables(log_n, [Modulus(p) for p in primes], dev)
        shape = (batch, 2, limbs, 1 << log_n)
        a, b = (torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64, device=dev)
                % (2 * t.q.view(-1, 1)) for _ in range(2))
        want = FM.fused_negacyclic_multiply_plain(a, b, t)
        runs = [n for n in names if log_n <= SMALL_ONLY.get(n, log_n)]
        right = {n: torch.equal(variant(n, a, b, t), want) for n in runs}
        times = {}
        for name in runs + runs[::-1]:
            us = chip_smoke.graph_us(lambda: variant(name, a, b, t))
            times[name] = min(us, times.get(name, us))
        old = min(chip_smoke.graph_us(lambda: yardstick(a, b, t)) for _ in range(2))
        bound, by = chip_smoke.fused_bound(shape)
        print(f"[variants] {gpu}: fused_negacyclic_multiply {label} {shape}, bound "
              f"{bound:.3f} us ({by}), radix-2 yardstick {old:.3f} us: " + ", ".join(
                  f"{n} {times[n]:.3f} us{'' if right[n] else ' (wrong)'}" for n in runs),
              flush=True)
        for name in runs:
            if name.startswith("timeline") and log_n > 5:
                timeline(libs[name], lambda: variant(name, a, b, t), f"{name} {label}", shape)
    return 0


def timeline(lib, launch, label: str, shape):
    """One launch of a timeline variant; prints the spread of the CTAs' starts
    and ends, and per step the median and largest microseconds over the CTAs
    that started in the first microsecond (the first wave; the inverse steps
    over ranks 0..2 only)."""
    import numpy as np

    launch()
    torch.cuda.synchronize()
    ctas = shape[0] * shape[2] * fused_mul_cuda.CLUSTER
    buf = np.zeros(ctas * 8, dtype=np.uint64)
    fn = lib.troy_fused_stamps
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    if fn(buf.ctypes.data, ctas * 8):
        raise RuntimeError("[variants] reading the timeline failed")
    st = buf.reshape(ctas, 8).astype(np.int64)
    st -= st[:, 0].min()
    steps = np.diff(st, axis=1) / 1e3
    start, end = st[:, 0] / 1e3, st[:, 7] / 1e3
    first = start < 1.0
    worker = first & (np.arange(ctas) % fused_mul_cuda.CLUSTER < fused_mul_cuda.CLUSTER - 1)
    q = lambda v: "/".join(f"{x:.2f}" for x in np.percentile(v, [0, 25, 50, 75, 90, 100]))
    parts = []
    for k, name in enumerate(STEPS):
        v = steps[worker if k >= 5 else first, k]
        parts.append(f"{name} {np.median(v):.2f} / {v.max():.2f}")
    print(f"[timeline] {label} {shape}: {ctas} CTAs, {int(first.sum())} in the first wave, "
          f"span {end.max():.2f} us; CTA start (min/25/50/75/90/max %) {q(start)} us, end "
          f"{q(end)} us; first wave, per step median / max us: " + ", ".join(parts), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

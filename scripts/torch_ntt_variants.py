#!/usr/bin/env python3
"""Variants of the NTT kernel (troy_tpu_torch/csrc/ntt.cu), built side by
side and timed in turns on one GPU, to show where its time goes and what
the rejected designs cost.

    python3 scripts/torch_ntt_variants.py [variant ...]

Each variant is csrc/ntt.cu with textual substitutions, compiled by nvcc
(the flags of ops/_cuda_build.py, all variants in parallel) into its own
library under troy_tpu_torch/build/variants/.  At each NTT shape of the
flagship HPS step and Galois round (chip_smoke.py's configuration, random
30-bit primes), every variant is launched on the same input and timed by
CUDA events around a CUDA graph of 50 launches, in the order listed and
then in reverse, keeping the lower of the two; "(wrong)" marks a result that
differs from the plain transform, as the measurement-only variants do.

  committed      csrc/ntt.cu as it is;
  no_butterfly   every phase loads and stores its values but runs no
                 butterfly: the memory and shared-memory path alone;
  ldg_twiddle    every phase reads its twiddles from device memory (__ldg)
                 instead of the table the CTA copies into shared memory;
  const_twiddle  every twiddle a constant, no table loads or copy;
  skip_phase0, skip_phase1, skip_phase2
                 the plan's phase 0, 1 or 2 (n = 8192: 4, 4 and 5 stages)
                 left out of the phases in shared memory, to price each (the
                 inverse's phase 0 is its store and stays);
  depth4         phases of at most 4 stages (n = 8192: 3 + 3 + 3 + 4);
  ctas3, ctas4   __launch_bounds__(256, 3 or 4): registers capped so that
                 3 or 4 CTAs share an SM (ptxas then spills);
  fwd_fused      the forward's first phase reads device memory straight
                 into registers, two sub-transforms a thread (16-byte
                 loads), instead of staging the polynomial in shared memory;
  fwd_cluster2, fwd_cluster4
                 the forward splits each polynomial over a thread-block
                 cluster of 2 or 4 CTAs: each loads and holds n / C values,
                 the first phase reads and writes its partners' shared
                 memory (distributed shared memory), the later phases are
                 local.  Only for launches of fewer polynomials than SMs;
  persistent     a launch of more polynomials than resident CTAs runs a
                 grid of resident CTAs that each loop over rows, copying the
                 next row with cp.async into an int64 staging buffer while
                 transforming the current one.

fwd_fused, the clusters and persistent were built on ldg_twiddle and are
measured on it.

Needs one CUDA device and nvcc; imports nothing of jax.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (bounds, graph timing, nvidia-smi line)
from troy_tpu_torch.core.modulus import Modulus  # noqa: E402
from troy_tpu_torch.ops import _cuda_build, ntt as NTT, ntt_cuda  # noqa: E402
from troy_tpu_torch.utils import numth  # noqa: E402

N_LOG = 13
# (kernel, leading shape, limbs): the HPS step's and the Galois round's NTT
# launches at the flagship, then the two small forwards a cluster is for.
SHAPES = [("forward", (16, 2), 6), ("forward", (16, 2), 9), ("inverse", (16, 3), 6),
          ("inverse", (16, 3), 9), ("forward", (16, 6), 7), ("inverse", (16, 2), 1),
          ("inverse", (16, 2), 6), ("forward", (16,), 6), ("forward", (1,), 1)]

_LOAD_PHASE = '''
// fwd_fused: the forward's first phase (r = 0, K <= 4) straight from device
// memory (ntt_phases.cuh:load_phase, which K4 runs).
__device__ __forceinline__ void run_load_phase(int k, uint32_t* s,
                                               const int64_t* in, int log_n,
                                               const uint2* tw, uint32_t q) {
  switch (k) {
    case 1: load_phase<1>(s, in, log_n, tw, q); break;
    case 2: load_phase<2>(s, in, log_n, tw, q); break;
    case 3: load_phase<3>(s, in, log_n, tw, q); break;
    default: load_phase<4>(s, in, log_n, tw, q); break;
  }
}

'''

_CLUSTER_KERNEL = '''
// fwd_cluster: phase 0 (r = 0) over the cluster's shared memories: value j
// of sub-transform u lies in CTA j / (E / C) at local index (j % (E / C)) s + u.
template <int K>
__device__ __forceinline__ void cluster_phase(uint32_t* const (&parts)[kC],
                                              int log_n,
                                              const uint2* __restrict__ tw,
                                              uint32_t q, int u0, int u1) {
  constexpr int E = 1 << K;
  if constexpr (E >= kC) {
    constexpr int kPer = E / kC;
    const int log_s = log_n - K;
    for (int u = u0 + threadIdx.x; u < u1; u += blockDim.x) {
      uint32_t x[E];
#pragma unroll
      for (int j = 0; j < E; ++j) x[j] = parts[j / kPer][pad(((j % kPer) << log_s) + u)];
      radix_stages<K, false, false>(x, reinterpret_cast<const uint4*>(tw), nullptr, q);
#pragma unroll
      for (int j = 0; j < E; ++j) parts[j / kPer][pad(((j % kPer) << log_s) + u)] = x[j];
    }
  } else {
    __trap();
  }
}

__global__ void __launch_bounds__(kThreads)
    ntt_forward_cluster_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ phases,
                               const uint32_t* __restrict__ scalars, int L,
                               int log_n, int plan, int entries) {
  extern __shared__ uint32_t s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x % kC);
  const int row = static_cast<int>(blockIdx.x / kC);
  const int limb = row % L;
  const int log_local = log_n - (kC == 4 ? 2 : 1);
  const int first = rank << log_local;
  const uint32_t q = scalars[limb];
  const uint2* tw = reinterpret_cast<const uint2*>(phases) +
                    static_cast<size_t>(limb) * entries;
  const size_t base = (static_cast<size_t>(row) << log_n) + first;
  const int pairs = 1 << (log_local - 1);
  int count = 0;
  while (count < kMaxPhases && ((plan >> (4 * count)) & 15)) ++count;
  const longlong2* src = reinterpret_cast<const longlong2*>(in + base);
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    const longlong2 v = __ldg(src + i);
    s[pad(2 * i)] = static_cast<uint32_t>(v.x);
    s[pad(2 * i + 1)] = static_cast<uint32_t>(v.y);
  }
  cluster.sync();
  uint32_t* parts[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) parts[c] = cluster.map_shared_rank(s, c);
  int r = 0, off = kConstantSlots;
  for (int p = 0; p < count; ++p) {
    const int k = (plan >> (4 * p)) & 15;
    const int n_sub = 1 << (log_n - k);
    const int u0 = rank * (n_sub / kC), u1 = u0 + n_sub / kC;
    if (p == 0) {
      switch (k) {
        case 1: cluster_phase<1>(parts, log_n, tw + off, q, u0, u1); break;
        case 2: cluster_phase<2>(parts, log_n, tw + off, q, u0, u1); break;
        case 3: cluster_phase<3>(parts, log_n, tw + off, q, u0, u1); break;
        default: cluster_phase<4>(parts, log_n, tw + off, q, u0, u1); break;
      }
      cluster.sync();
    } else {
      if (p == count - 1)
        run_smem_phase<false, true>(k, s, log_n, r, tw + off, tw, q, u0, u1, first);
      else
        run_smem_phase<false, false>(k, s, log_n, r, tw + off, tw, q, u0, u1, first);
      __syncthreads();
    }
    off += 1 << (r + k);
    r += k;
  }
  longlong2* dst = reinterpret_cast<longlong2*>(out + base);
  for (int i = threadIdx.x; i < pairs; i += blockDim.x)
    dst[i] = make_longlong2(troy::reduce_from_4q(s[pad(2 * i)], q),
                            troy::reduce_from_4q(s[pad(2 * i + 1)], q));
}

'''

_CLUSTER_LAUNCH = '''  if (!kInverse) {
    const int n_local = (1 << log_n) / kC;
    const int threads = n_local >> 5 < 32 ? 32 : (n_local >> 5 > kThreads ? kThreads : n_local >> 5);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned int>(n_rows * kC));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(n_local + (n_local >> 5)) * 4;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kC;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, ntt_forward_cluster_kernel, static_cast<const int64_t*>(in),
        static_cast<int64_t*>(out), static_cast<const uint32_t*>(phases),
        static_cast<const uint32_t*>(scalars), L, log_n, plan, entries);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  ntt_kernel<kInverse><<<'''


_PERSISTENT = r'''__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// Polynomial `row` into the int64 staging buffer, asynchronously.
__device__ __forceinline__ void prefetch(int64_t* stage, const int64_t* in,
                                         int row, int log_n) {
  const longlong2* src =
      reinterpret_cast<const longlong2*>(in + (static_cast<size_t>(row) << log_n));
  longlong2* dst = reinterpret_cast<longlong2*>(stage);
  for (int i = threadIdx.x; i < 1 << (log_n - 1); i += blockDim.x)
    cp_async16(dst + i, src + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// One polynomial at a time per CTA: the polynomial into shared memory
// (16-byte loads, 16 in flight per thread), the phases there, and the
// polynomial out (16-byte stores), but for the inverse's store_phase.  A
// launch of more polynomials than fit on the card at once runs a grid of
// resident CTAs, each taking rows blockIdx.x, + gridDim.x, ...: while it
// transforms one, cp.async copies its next into the int64 staging buffer
// `stage` behind the values, so only its first row waits for device memory.
// plan: depth of phase i in bits 4i..4i+3 (ops/ntt.py:kernel_plan_code; a
// plan of two or more phases starts with a phase of at most 4); entries:
// table pairs per limb.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    ntt_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
               const uint32_t* __restrict__ phases,
               const uint32_t* __restrict__ scalars, int L, int log_n,
               int plan, int entries, int rows) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  int64_t* stage = reinterpret_cast<int64_t*>(s + data_words(log_n));
  const int pairs = n >> 1;
  int count = 0;
  while (count < kMaxPhases && ((plan >> (4 * count)) & 15)) ++count;
  const bool fused = kInverse && count > 1;  // phase 0 as store_phase

  int row = blockIdx.x;
  const longlong2* src =
      reinterpret_cast<const longlong2*>(in + (static_cast<size_t>(row) << log_n));
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
  __syncthreads();
  if (row + static_cast<int>(gridDim.x) < rows)
    prefetch(stage, in, row + gridDim.x, log_n);

  while (true) {
    const int limb = row % L;
    const uint32_t q = scalars[limb];
    const uint32_t n_inv = scalars[L + limb];
    const uint32_t n_inv_sh = scalars[2 * L + limb];
    const uint2* tw = reinterpret_cast<const uint2*>(phases) +
                      static_cast<size_t>((kInverse ? L : 0) + limb) * entries;
    int64_t* dst_row = out + (static_cast<size_t>(row) << log_n);

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
      run_store_phase(plan & 15, s, dst_row, log_n, tw + kConstantSlots, q,
                      n_inv, n_inv_sh);
    } else {
      longlong2* dst = reinterpret_cast<longlong2*>(dst_row);
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

    row += gridDim.x;
    if (row >= rows) break;
    // The next row: wait for its copy, and for every thread to be done
    // with this one, then move it from the staging buffer into place.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const longlong2* st = reinterpret_cast<const longlong2*>(stage);
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const longlong2 v = st[i];
      s[pad(2 * i)] = static_cast<uint32_t>(v.x);
      s[pad(2 * i + 1)] = static_cast<uint32_t>(v.y);
    }
    __syncthreads();
    if (row + static_cast<int>(gridDim.x) < rows)
      prefetch(stage, in, row + gridDim.x, log_n);
  }
}

// CTAs of `kernel` resident on the whole card with smem bytes each, per
// device (queried once).
template <bool kInverse>
int resident_ctas(int threads, size_t smem, int log_n) {
  static int cached[16][2][kMaxLogN + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  int& slot = cached[dev][kInverse][log_n];
  if (slot == 0) {
    int sms = 0, blocks = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, ntt_kernel<kInverse>, threads, smem) != cudaSuccess)
      return 0;
    slot = sms * blocks;
  }
  return slot;
}

template <bool kInverse>
int launch_ntt(const void* in, void* out, const void* phases,
               const void* scalars, long long n_rows, int L, int log_n,
               int plan, int entries, void* stream) {
  if (n_rows <= 0) return 0;
  Shape shape = ntt_shape(log_n, entries);
  // Rows beyond one wave stream through resident CTAs, with the staging
  // buffer, where two such CTAs still fit an SM (n <= 8192).
  // The attribute is raised once to the most any launch asks for.
  static size_t granted = kDefaultSmem;
  const size_t staged = shape.smem + (static_cast<size_t>(8) << log_n);
  const size_t most = log_n <= kMaxStagedLogN ? staged : shape.smem;
  if (most > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        ntt_kernel<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = most;
  }
  long long grid = n_rows;
  if (log_n <= kMaxStagedLogN) {
    const int resident = resident_ctas<kInverse>(shape.threads, staged, log_n);
    if (resident > 0 && n_rows > resident) {
      grid = resident;
      shape.smem = staged;
    }
  }
  ntt_kernel<kInverse><<<static_cast<unsigned int>(grid), shape.threads,
                         shape.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(phases),
      static_cast<const uint32_t*>(scalars), L, log_n, plan, entries,
      static_cast<int>(n_rows));
  return static_cast<int>(cudaGetLastError());
}

'''


def _cluster(c: int) -> list[tuple[str, str]]:
    return [
        ('#include "ntt_common.cuh"\n',
         '#include "ntt_common.cuh"\n#include <cooperative_groups.h>\n'
         f'namespace cg = cooperative_groups;\nconstexpr int kC = {c};\n'),
        # smem_phase and its dispatch take a range of sub-transforms and the
        # first value a CTA holds (defaults: all, 0)
        ('''                                           const uint2* __restrict__ consts,
                                           uint32_t q) {''',
         '''                                           const uint2* __restrict__ consts,
                                           uint32_t q, int u0 = 0, int u1 = 1 << 30,
                                           int first = 0) {'''),
        ('for (int u = threadIdx.x; u < n_sub; u += blockDim.x) {\n    const int root = u >> log_s;\n'
         '    const int base = (root << (log_s + K)) + (u & s_mask);',
         'for (int u = u0 + threadIdx.x; u < (n_sub < u1 ? n_sub : u1); u += blockDim.x) {\n'
         '    const int root = u >> log_s;\n'
         '    const int base = (root << (log_s + K)) + (u & s_mask) - first;'),
        ('''                                               const uint2* consts,
                                               uint32_t q) {''',
         '''                                               const uint2* consts,
                                               uint32_t q, int u0 = 0, int u1 = 1 << 30,
                                               int first = 0) {'''),
        *[(f"smem_phase<{k}, kInverse, kFactor>(s, log_n, r, tw, consts, q);",
           f"smem_phase<{k}, kInverse, kFactor>(s, log_n, r, tw, consts, q, u0, u1, first);")
          for k in range(1, 6)],
        ("template <bool kInverse>\nint launch_ntt(",
         _CLUSTER_KERNEL + "template <bool kInverse>\nint launch_ntt("),
        ("  ntt_kernel<kInverse><<<", _CLUSTER_LAUNCH),
    ]


# The twiddles read from device memory (__ldg) in every phase, no table in
# shared memory: the design before the table was staged, and the base of the
# variants below that were built on it.
_LDG_TWIDDLE = [
    ("{ return *p; }", "{ return __ldg(p); }"),
    ("stage_twiddles(s + data_words(log_n), table, entries)",
     "reinterpret_cast<const uint2*>(table)"),
    (" +\n              static_cast<size_t>(entries) * sizeof(uint2)};", "};"),
]

VARIANTS = {
    "committed": [],
    "ldg_twiddle": _LDG_TWIDDLE,
    "no_butterfly": [("radix_stages<K, kInverse, kFactor>(", "if (q == 7) radix_stages<K, kInverse, kFactor>("),
                     ("radix_stages<K, true, false>(", "if (q == 7) radix_stages<K, true, false>(")],
    "const_twiddle": [*_LDG_TWIDDLE[1:],
                      ("{ return *p; }", "{ return make_uint4(3u, 5u, 7u, 11u); }")],
    **{f"skip_phase{p}": [("    const int k = (plan >> (4 * p)) & 15;\n",
                           "    const int k = (plan >> (4 * p)) & 15;\n"
                           f"    if (p == {p}) {{ __syncthreads(); continue; }}\n")]
       for p in range(3)},
    "depth4": [],
    "ctas3": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")],
    "ctas4": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 4)")],
    "fwd_fused": [
        *_LDG_TWIDDLE,
        ("// One polynomial per CTA:", _LOAD_PHASE + "// One polynomial per CTA:"),
        ("const bool fused = kInverse && count > 1;", "const bool fused = count > 1;"),
        ("  load_values(s, in + base, log_n);\n",
         "  if (!kInverse && fused)\n    run_load_phase(plan & 15, s, in + base, log_n, "
         "tw + kConstantSlots, q);\n  else\n    load_values(s, in + base, log_n);\n"),
        ("  if (fused) {\n    run_store_phase", "  if (kInverse && fused) {\n    run_store_phase")],
    "persistent": [
        *_LDG_TWIDDLE,
        ("constexpr int kMaxPhases = 8;",
         "constexpr int kMaxPhases = 8;\nconstexpr int kMaxLogN = 15;\n"
         "constexpr int kMaxStagedLogN = 13;"),
        ("REGION", "// One polynomial per CTA:",
         "// ---- The first radix-2 pair: the timing yardstick", _PERSISTENT)],
    "fwd_cluster2": [*_LDG_TWIDDLE, *_cluster(2)],
    "fwd_cluster4": [*_LDG_TWIDDLE, *_cluster(4)],
}
FORWARD_ONLY = {"fwd_fused", "fwd_cluster2", "fwd_cluster4"}
CLUSTER_ROWS = 132  # a cluster variant runs only at launches of fewer polynomials


PHASES_INCLUDE = '#include "ntt_phases.cuh"\n'


def variant_source(name: str, source: str = "ntt.cu", variants: dict = VARIANTS) -> str:
    """csrc/<source> with the shared phase header written in place of its
    include (so that a substitution reaches the phases too), then the
    variant's substitutions applied in order; raises if one finds no text."""
    text = (_cuda_build.CSRC / source).read_text()
    header = (_cuda_build.CSRC / "ntt_phases.cuh").read_text().replace("#pragma once\n", "")
    text = text.replace(PHASES_INCLUDE, header)
    for sub in variants[name]:
        if sub[0] == "REGION":  # the text from one marker to the next
            _, start, end, new = sub
            if start not in text or end not in text:
                raise RuntimeError(f"[variants] {name}: {start[:60]!r} not in {source}")
            text = text[:text.index(start)] + new + text[text.index(end):]
            continue
        old, new = sub
        if old not in text:
            raise RuntimeError(f"[variants] {name}: {old[:60]!r} not in {source}")
        text = text.replace(old, new)
    return text


def build(names: list[str], source: str = "ntt.cu", variants: dict = VARIANTS,
          kernels: tuple = ()) -> dict:
    """Each variant of csrc/<source> compiled into its own library under
    troy_tpu_torch/build/variants/, all in parallel; their ptxas registers
    printed (of the kernels whose mangled names contain one of `kernels`,
    or of the first two)."""
    root = _cuda_build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        text = variant_source(name, source, variants)
        d = root / name
        d.mkdir(parents=True)
        (d / source).write_text(text)
        shutil.copy(_cuda_build.CSRC / "ntt_common.cuh", d)
        cmd = [_cuda_build._nvcc(), *_cuda_build.COMPILE_FLAGS, "-Xptxas", "-v", "-shared",
               "-o", str(d / "lib.so"), str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"[variants] {name} does not build:\n{err[-4000:]}")
        regs, entry = [], ""
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "registers" in line and (not kernels or any(k in entry for k in kernels)):
                regs.append(line.split(":", 1)[-1].strip())
        print(f"[build] {name}: {'; '.join(regs[:2])}", flush=True)
        libs[name] = ctypes.CDLL(str(root / name / "lib.so"))
    return libs


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_ntt_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = build(names)
    gen = torch.Generator(device=dev).manual_seed(9)
    tables = {}

    def table(limbs: int, depth: int) -> NTT.NTTTables:
        if (limbs, depth) not in tables:
            saved = NTT.KERNEL_MAX_DEPTH
            NTT.KERNEL_MAX_DEPTH = depth
            NTT.NTTTables._row_cache.clear()
            primes = numth.get_primes(2 << N_LOG, 30, limbs)
            tables[(limbs, depth)] = NTT.NTTTables(N_LOG, [Modulus(p) for p in primes], dev)
            NTT.KERNEL_MAX_DEPTH = saved
            NTT.NTTTables._row_cache.clear()
        return tables[(limbs, depth)]

    def launch(name: str, kernel: str, x: torch.Tensor, t: NTT.NTTTables) -> torch.Tensor:
        fn = getattr(libs[name], f"troy_ntt_{kernel}")
        fn.argtypes = ntt_cuda._ARGTYPES
        fn.restype = ctypes.c_int
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), t.kernel_phases.data_ptr(),
                 t.kernel_scalars.data_ptr(), x.numel() // t.n, t.size, t.log_n, t.plan_code,
                 t.kernel_phases.shape[-1] // 2, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {name} launch failed: CUDA error {err}")
        return out

    for kernel, lead, limbs in SHAPES:
        rows = int(torch.tensor(lead).prod()) * limbs
        shape = (*lead, limbs, 1 << N_LOG)
        runs = [n for n in names
                if (n not in FORWARD_ONLY or kernel == "forward")
                and (not n.startswith("fwd_cluster") or rows < CLUSTER_ROWS)]
        inputs, times = {}, {}
        for name in runs + runs[::-1]:
            t = table(limbs, 4 if name == "depth4" else 5)
            if name not in inputs:
                x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                                  device=dev) % t.q.view(-1, 1)
                plain = NTT.ntt_forward_plain if kernel == "forward" else NTT.ntt_inverse_plain
                right = torch.equal(launch(name, kernel, x, t), plain(x, t))
                inputs[name] = (x, right)
            x = inputs[name][0]
            us = chip_smoke.graph_us(lambda: launch(name, kernel, x, t))
            times[name] = min(us, times.get(name, us))
        bound, by = chip_smoke.ntt_bound(shape)
        print(f"[variants] {gpu}: ntt_{kernel} {shape}, bound {bound:.3f} us ({by}): " + ", ".join(
            f"{n} {times[n]:.3f} us{'' if inputs[n][1] else ' (wrong)'}" for n in runs),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

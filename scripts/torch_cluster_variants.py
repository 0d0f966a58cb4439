#!/usr/bin/env python3
"""Variants of the cluster NTT kernel (troy_tpu_torch/csrc/ntt.cu:
ntt_cluster_kernel, the route above n = 32768), built side by side and
timed in turns on the card.

    python3 scripts/torch_cluster_variants.py [variant ...]

Each variant is csrc/ntt.cu with textual substitutions (the shared phase
header written in place, as scripts/torch_ntt_variants.py builds them),
compiled by nvcc into troy_tpu_torch/build/variants/<name>/; every variant
is held to the plain transform at each shape (a variant that changes the
result says so: it measures a cost, not a design):

  committed    csrc/ntt.cu as it is;
  pair         a column pair a thread (16-byte loads and stores, two 4-byte
               cluster stores a value pair, since pad(j) is odd when j / 32
               is), the first design;
  threads256   256 threads a CTA at every launch size;
  threads128   128 threads a CTA at every launch size;
  ctas3        256 threads, registers capped for 3 CTAs an SM;
  sync_end     the inverse's last barrier a full cluster.sync();
  local        each column's values written to, and read from, the CTA's
               own block instead of its peers' (wrong results): the cost of
               the exchange across the cluster;
  edges        the block's last phase (32 neighbouring values a thread)
               against device memory: the forward stores from registers,
               the inverse loads into them, no staging pass;
  t128_regs80  128 threads a CTA at every size, registers capped for 6 CTAs
               an SM.

Shapes: (3, 2, n) at n = 65536 and 131072 and the n = 65536 BFV step's
transforms, (2, 2, 8), (2, 3, 11) and (2, 8, 9) limbs of 65536, in clusters
of 16 (ops/ntt.py:default_split).  Device microseconds a call by CUDA
events around a CUDA graph of 20 calls, each the lower of two turns
(variants in order, then reversed), beside the one-pass bound, with the
card's name and power limit.  About 60 s of command time.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torch_ntt_variants as TV  # noqa: E402
from troy_tpu_torch.core.modulus import Modulus  # noqa: E402
from troy_tpu_torch.ops import ntt as NTT, ntt_cuda  # noqa: E402
from troy_tpu_torch.utils import numth  # noqa: E402

_PAIR_HELPERS = '''template <int K>
__device__ __forceinline__ void load_columns(const int64_t* __restrict__ row, int j,
                                             int log_b, uint32_t (&a)[1 << K],
                                             uint32_t (&b)[1 << K]) {
  const longlong2* src = reinterpret_cast<const longlong2*>(row) + (j >> 1);
  longlong2 v[1 << K];
#pragma unroll
  for (int e = 0; e < (1 << K); ++e)
    v[e] = __ldg(src + (static_cast<size_t>(e) << (log_b - 1)));
#pragma unroll
  for (int e = 0; e < (1 << K); ++e) {
    a[e] = static_cast<uint32_t>(v[e].x);
    b[e] = static_cast<uint32_t>(v[e].y);
  }
}

template <int K>
__device__ __forceinline__ void scatter_columns(uint32_t* s, int j,
                                                const uint32_t (&a)[1 << K],
                                                const uint32_t (&b)[1 << K]) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int at = pad(j);
#pragma unroll
  for (int e = 0; e < (1 << K); ++e) {
    uint32_t* block = cluster.map_shared_rank(s, e);
    block[at] = a[e];
    block[at + 1] = b[e];
  }
}

template <int K>
__device__ __forceinline__ void gather_columns(uint32_t* s, int j, uint32_t (&a)[1 << K],
                                               uint32_t (&b)[1 << K]) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int at = pad(j);
#pragma unroll
  for (int e = 0; e < (1 << K); ++e) {
    const uint32_t* block = cluster.map_shared_rank(s, e);
    a[e] = block[at];
    b[e] = block[at + 1];
  }
}

template <int K>
__device__ __forceinline__ void store_columns(int64_t* __restrict__ row, int j, int log_b,
                                              const uint32_t (&a)[1 << K],
                                              const uint32_t (&b)[1 << K], uint32_t q,
                                              uint32_t n_inv, uint32_t n_inv_sh) {
  longlong2* dst = reinterpret_cast<longlong2*>(row) + (j >> 1);
#pragma unroll
  for (int e = 0; e < (1 << K); ++e)
    dst[static_cast<size_t>(e) << (log_b - 1)] =
        make_longlong2(troy::scale_n_inv(a[e], n_inv, n_inv_sh, q),
                       troy::scale_n_inv(b[e], n_inv, n_inv_sh, q));
}

'''

_FORWARD = '''    for (int j = first + threadIdx.x; j < first + cols; j += blockDim.x) {
      load_column<K>(src, j, log_b, x);
      radix_stages<K, false, false>(x, col, nullptr, q);
      if (!waited) cluster_wait();
      waited = true;
      scatter_column<K>(s, j, x);
    }'''
_INVERSE = '''  for (int j = first + threadIdx.x; j < first + cols; j += blockDim.x) {
    gather_column<K>(s, j, x);
    radix_stages<K, true, false>(x, col, nullptr, q);
    store_column<K>(dst, j, log_b, x, q, n_inv, n_inv_sh);
  }'''
_THREADS = "return ctas <= 2LL * sms[dev] ? kThreads : kThreads / 2;"

_EDGE_HELPERS = '''template <bool kInverse>
__device__ __forceinline__ void phases_range(uint32_t* s, int log_n, int plan, int count,
                                             int lo, int hi, const uint2* tw, uint32_t q) {
  for (int step = 0; step < hi - lo; ++step) {
    const int p = kInverse ? hi - 1 - step : lo + step;
    int r = 0, off = kConstantSlots;
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
}

template <bool kInverse>
__device__ __forceinline__ void last_phase_io(uint32_t* s, const int64_t* in, int64_t* out,
                                              int log_n, int plan, int count,
                                              const uint2* tw, uint32_t q) {
  constexpr int K = 5, E = 32;
  int r = 0, off = kConstantSlots;
  for (int i = 0; i < count - 1; ++i) {
    const int d = (plan >> (4 * i)) & 15;
    off += 1 << (r + d);
    r += d;
  }
  for (int u = threadIdx.x; u < (1 << (log_n - K)); u += blockDim.x) {
    uint32_t x[E];
    if (kInverse) {
      const longlong2* src = reinterpret_cast<const longlong2*>(in) + (u << (K - 1));
      longlong2 v[E / 2];
#pragma unroll
      for (int j = 0; j < E / 2; ++j) v[j] = __ldg(src + j);
#pragma unroll
      for (int j = 0; j < E / 2; ++j) {
        x[2 * j] = static_cast<uint32_t>(v[j].x);
        x[2 * j + 1] = static_cast<uint32_t>(v[j].y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) x[j] = s[pad((u << K) + j)];
    }
    radix_stages<K, kInverse, true>(
        x, reinterpret_cast<const uint4*>(tw + off + u * kRootSlots<K, true>),
        reinterpret_cast<const uint4*>(tw), q);
    if (kInverse) {
#pragma unroll
      for (int j = 0; j < E; ++j) s[pad((u << K) + j)] = x[j];
    } else {
      longlong2* dst = reinterpret_cast<longlong2*>(out) + (u << (K - 1));
#pragma unroll
      for (int j = 0; j < E / 2; ++j)
        dst[j] = make_longlong2(troy::reduce_from_4q(x[2 * j], q),
                                troy::reduce_from_4q(x[2 * j + 1], q));
    }
  }
}

'''

VARIANTS = {
    "committed": [],
    "pair": [
        ("REGION", "// Column j of a polynomial `row` of 2^K blocks",
         "// A phase (r, K) on `polys` polynomials", _PAIR_HELPERS),
        (_FORWARD, '''    for (int j = first + 2 * threadIdx.x; j < first + cols; j += 2 * blockDim.x) {
      uint32_t y[C];
      load_columns<K>(src, j, log_b, x, y);
      radix_stages<K, false, false>(x, col, nullptr, q);
      radix_stages<K, false, false>(y, col, nullptr, q);
      if (!waited) cluster_wait();
      waited = true;
      scatter_columns<K>(s, j, x, y);
    }'''),
        (_INVERSE, '''  for (int j = first + 2 * threadIdx.x; j < first + cols; j += 2 * blockDim.x) {
    uint32_t y[C];
    gather_columns<K>(s, j, x, y);
    radix_stages<K, true, false>(x, col, nullptr, q);
    radix_stages<K, true, false>(y, col, nullptr, q);
    store_columns<K>(dst, j, log_b, x, y, q, n_inv, n_inv_sh);
  }''')],
    "threads256": [(_THREADS, "return kThreads;")],
    "threads128": [(_THREADS, "return kThreads / 2;")],
    "ctas3": [(_THREADS, "return kThreads;"),
              ("__launch_bounds__(kThreads)\n    ntt_cluster_kernel(",
               "__launch_bounds__(kThreads, 3)\n    ntt_cluster_kernel(")],
    "sync_end": [("  // place until no peer reads it.\n  cluster_arrive_relaxed();\n  cluster_wait();",
                  "  // place until no peer reads it.\n  cluster.sync();")],
    "local": [("cluster.map_shared_rank(s, e)", "s")],
    "edges": [
        ("// ---- Degrees above 32768: one cluster a polynomial",
         _EDGE_HELPERS + "// ---- Degrees above 32768: one cluster a polynomial"),
        ("""    smem_phases<false>(s, log_b, plan, count, 0, tw, q);
    store_values<false>(s, dst + (static_cast<size_t>(rank) << log_b), log_b, q,
                        n_inv, n_inv_sh);""",
         """    phases_range<false>(s, log_b, plan, count, 0, count - 1, tw, q);
    last_phase_io<false>(s, nullptr, dst + (static_cast<size_t>(rank) << log_b), log_b,
                         plan, count, tw, q);"""),
        ("""  load_values(s, src + (static_cast<size_t>(rank) << log_b), log_b);
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncthreads();
  smem_phases<true>(s, log_b, plan, count, 0, tw, q);""",
         """  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncthreads();
  last_phase_io<true>(s, src + (static_cast<size_t>(rank) << log_b), nullptr, log_b, plan,
                      count, tw, q);
  __syncthreads();
  phases_range<true>(s, log_b, plan, count, 0, count - 1, tw, q);""")],
    "t128_regs80": [(_THREADS, "return kThreads / 2;"),
                    ("__launch_bounds__(kThreads)\n    ntt_cluster_kernel(",
                     "__launch_bounds__(kThreads / 2, 6)\n    ntt_cluster_kernel(")],
}
SHAPES = (((3,), 2, 16), ((3,), 2, 17), ((2, 2), 8, 16), ((2, 3), 11, 16), ((2, 8), 9, 16))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_cluster_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = TV.build(names, "ntt.cu", VARIANTS, kernels=("ntt_cluster",))
    gen = torch.Generator(device=dev).manual_seed(11)

    def launch(name: str, inverse: bool, x: torch.Tensor, t: NTT.NTTTables) -> torch.Tensor:
        fn = getattr(libs[name], f"troy_ntt_cluster_{'inverse' if inverse else 'forward'}")
        fn.argtypes = ntt_cuda._CLUSTER_ARGTYPES
        fn.restype = ctypes.c_int
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), t.kernel_phases.data_ptr(),
                 t.column_phases.data_ptr(), t.kernel_scalars.data_ptr(), x.numel() // t.n,
                 t.size, t.block_log_n, t.split, t.plan_code, t.entries,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {name} launch failed: CUDA error {err}")
        return out

    for lead, limbs, log_n in SHAPES:
        primes = numth.get_primes(2 << log_n, 30, limbs)
        t = NTT.NTTTables(log_n, [Modulus(p) for p in primes], dev)
        shape = (*lead, limbs, 1 << log_n)
        x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                          device=dev) % t.q.view(-1, 1)
        for inverse in (False, True):
            plain = (NTT.ntt_inverse_plain if inverse else NTT.ntt_forward_plain)(x, t)
            times, right = {}, {}
            for name in names + names[::-1]:
                right[name] = torch.equal(launch(name, inverse, x, t), plain)
                us = chip_smoke.graph_us(lambda: launch(name, inverse, x, t), 20)
                times[name] = min(us, times.get(name, us))
            bound, by = chip_smoke.ntt_bound(shape)
            print(f"[variants] {gpu}: ntt_{'inverse' if inverse else 'forward'}_cluster {shape}, "
                  f"clusters of {1 << t.split}, bound {bound:.3f} us ({by}): " + ", ".join(
                      f"{n} {times[n]:.3f} us{'' if right[n] else ' (wrong)'}" for n in names),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

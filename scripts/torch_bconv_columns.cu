// The base-conversion kernel K3 (troy_tpu_torch/csrc/bconv.cu) in the
// form its design first planned, kept for scripts/torch_bconv_variants.py's
// ablations; no path of the port builds it.  It computes the same function
// with the same tables and C entries (troy_bconv, troy_bconv_info) and
// differs from csrc/bconv.cu in two ways:
//
//   * V columns a thread (cols_for): V = 1 as the port's kernel, or V = 2
//     (a 16-byte column pair a thread, where n is even and the row 16-byte
//     aligned; the scalar path elsewhere), or 4 (two pairs 2 kThreads
//     apart), set by the variants script's substitutions;
//   * a grid-stride loop over the tiles, so that a grid below the tile
//     count (the persistent grid: the SM count times the CTAs an SM holds)
//     walks them all.  The grid here is one CTA a tile, as csrc/bconv.cu's.
//
// troy_bconv_info reports out[0..7] = threads, columns a thread, registers,
// local bytes, shared bytes, CTAs an SM, SMs, columns a tile.  Everything
// else (arithmetic, tables, strided input) is as csrc/bconv.cu describes.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRegLimbs = 16;   // L_in held in registers up to this
constexpr int kMaxLimbs = 64;

struct Args {
  const int64_t* x;
  int64_t* y;
  const uint4* tables;
  long long x_row;   // elements between two input rows
  long long tiles;   // rows * tiles_per_row
  int tiles_per_row;
  int L_in, L_out, n;
};

__host__ __device__ constexpr int mat_vecs(int L_in) { return (L_in + 3) / 4; }

// Columns a thread, V, for L_in limbs held in registers (0: the
// shared-memory form).
__host__ __device__ constexpr int cols_for(int L) { return 1; }

size_t smem_bytes(int L_in, int L_out, bool shared_inputs, int V) {
  return sizeof(uint4) * (L_in + L_out * (1 + mat_vecs(L_in))) +
         (shared_inputs ? sizeof(uint32_t) * V * L_in * kThreads : 0);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// [x ip]_q in [0, q) for c = {q, ip, ip Shoup, 0}.
__device__ __forceinline__ uint32_t scale(int64_t x, const uint4& c) {
  const uint32_t v = troy::shoup_lazy(static_cast<uint32_t>(x), c.y, c.z, c.x);
  return v >= c.x ? v - c.x : v;
}

// A tile's place: its row's input and output, and this thread's columns:
// V single columns kThreads apart, or, with V > 1 where n is even and the
// row 16-byte aligned, V / 2 pairs of adjacent columns 2 kThreads apart.
template <int V>
struct Place {
  const int64_t* x;
  int64_t* y;
  int col[V];
  bool pairs;
};

template <int V>
__device__ __forceinline__ Place<V> place(const Args& a, long long tile) {
  Place<V> pl;
  const long long row = tile / a.tiles_per_row;
  const int c0 = static_cast<int>(tile - row * a.tiles_per_row) * (kThreads * V);
  pl.x = a.x + row * a.x_row;
  pl.y = a.y + row * a.L_out * static_cast<long long>(a.n);
  pl.pairs = V > 1 && (a.n & 1) == 0 &&
             ((reinterpret_cast<uintptr_t>(pl.x) | reinterpret_cast<uintptr_t>(pl.y)) & 15) == 0;
#pragma unroll
  for (int j = 0; j < V; ++j)
    pl.col[j] = pl.pairs
                    ? c0 + 2 * static_cast<int>(threadIdx.x) + (j >> 1) * 2 * kThreads + (j & 1)
                    : c0 + static_cast<int>(threadIdx.x) + j * kThreads;
  return pl;
}

// Every input load of a tile, issued together.
template <int L, int V>
__device__ __forceinline__ void load(const Place<V>& pl, long long n, int64_t (&raw)[L][V]) {
  if (pl.pairs) {
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int h = 0; h < V / 2; ++h) {
        longlong2 r = make_longlong2(0, 0);
        if (pl.col[2 * h] < n)
          r = __ldg(reinterpret_cast<const longlong2*>(pl.x + i * n + pl.col[2 * h]));
        raw[i][2 * h] = r.x;
        raw[i][2 * h + 1] = r.y;
      }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) raw[i][j] = pl.col[j] < n ? __ldg(pl.x + i * n + pl.col[j]) : 0;
  }
}

template <int V>
__device__ __forceinline__ void store(const Place<V>& pl, long long n, int64_t* yo,
                                      const uint64_t (&acc)[V]) {
  if (pl.pairs) {
#pragma unroll
    for (int h = 0; h < V / 2; ++h)
      if (pl.col[2 * h] < n)
        *reinterpret_cast<longlong2*>(yo + pl.col[2 * h]) = make_longlong2(
            static_cast<long long>(acc[2 * h]), static_cast<long long>(acc[2 * h + 1]));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (pl.col[j] < n) yo[pl.col[j]] = static_cast<int64_t>(acc[j]);
  }
}

// A tile's outputs from its scaled inputs t, held in registers.
template <int L, int V>
__device__ __forceinline__ void outputs(const Args& a, const Place<V>& pl,
                                        const uint32_t (&t)[L][V], const uint4* out_tab,
                                        const uint4* mat) {
  for (int o = 0; o < a.L_out; ++o) {
    const uint4 oc = out_tab[o];
    const uint64_t p = oc.x;
    const uint64_t ratio = (static_cast<uint64_t>(oc.z) << 32) | oc.y;
    const int every = static_cast<int>(oc.w);
    const uint4* m = mat + o * mat_vecs(L);
    uint64_t acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0;
    if (every >= L) {  // the whole sum below 2^64
#pragma unroll
      for (int i4 = 0; i4 < mat_vecs(L); ++i4) {
        const uint4 w = m[i4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i4 + k < L)
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[j] += static_cast<uint64_t>(t[4 * i4 + k][j]) * word(w, k);
      }
    } else {
      int left = every;
#pragma unroll
      for (int i4 = 0; i4 < mat_vecs(L); ++i4) {
        const uint4 w = m[i4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i4 + k < L) {
#pragma unroll
            for (int j = 0; j < V; ++j)
              acc[j] += static_cast<uint64_t>(t[4 * i4 + k][j]) * word(w, k);
            if (--left == 0) {
#pragma unroll
              for (int j = 0; j < V; ++j) acc[j] = troy::barrett_reduce64(acc[j], p, ratio);
              left = every;
            }
          }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = troy::barrett_reduce64(acc[j], p, ratio);
    store<V>(pl, a.n, pl.y + o * static_cast<long long>(a.n), acc);
  }
}

// A tile's outputs from its loaded inputs: every load is issued (load())
// before the first product.
template <int L, int V>
__device__ __forceinline__ void convert(const Args& a, const Place<V>& pl,
                                        const int64_t (&raw)[L][V], const uint4* in_tab,
                                        const uint4* out_tab, const uint4* mat) {
  uint32_t t[L][V];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) t[i][j] = scale(raw[i][j], in_tab[i]);
  outputs<L, V>(a, pl, t, out_tab, mat);
}

// The same from scaled inputs in shared memory, tmp[(i kThreads + thread)
// V + j] (the runtime-L_in form).
template <int V>
__device__ __forceinline__ void outputs_shared(const Args& a, const Place<V>& pl,
                                               const uint32_t* tmp, const uint4* out_tab,
                                               const uint4* mat) {
  const int Lv = mat_vecs(a.L_in);
  for (int o = 0; o < a.L_out; ++o) {
    const uint4 oc = out_tab[o];
    const uint64_t p = oc.x;
    const uint64_t ratio = (static_cast<uint64_t>(oc.z) << 32) | oc.y;
    const int every = static_cast<int>(oc.w);
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(mat + o * Lv);
    const bool mid = every < a.L_in;
    uint64_t acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0;
    int left = every;
    for (int i = 0; i < a.L_in; ++i) {
      const uint32_t* s = tmp + (i * kThreads + threadIdx.x) * V;
      const uint32_t w = mw[i];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += static_cast<uint64_t>(s[j]) * w;
      if (mid && --left == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = troy::barrett_reduce64(acc[j], p, ratio);
        left = every;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = troy::barrett_reduce64(acc[j], p, ratio);
    store<V>(pl, a.n, pl.y + o * static_cast<long long>(a.n), acc);
  }
}

template <int L, int V>
__global__ void __launch_bounds__(kThreads) bconv_kernel(const Args a) {
  extern __shared__ uint4 smem[];
  const int L_in = L > 0 ? L : a.L_in;
  const int n_tab = L_in + a.L_out * (1 + mat_vecs(L_in));
  const uint4* in_tab = smem;
  const uint4* out_tab = smem + L_in;
  const uint4* mat = out_tab + a.L_out;
  const long long n = a.n;
  long long tile = blockIdx.x;

  if constexpr (L > 0) {
    if (tile >= a.tiles) return;
    const Place<V> pl = place<V>(a, tile);
    int64_t raw[L][V];
    load<L, V>(pl, n, raw);  // in flight while the tables are copied
    for (int i = threadIdx.x; i < n_tab; i += kThreads) smem[i] = a.tables[i];
    __syncthreads();
    convert<L, V>(a, pl, raw, in_tab, out_tab, mat);
    for (tile += gridDim.x; tile < a.tiles; tile += gridDim.x) {  // a grid below the tiles
      const Place<V> next = place<V>(a, tile);
      int64_t more[L][V];
      load<L, V>(next, n, more);
      convert<L, V>(a, next, more, in_tab, out_tab, mat);
    }
  } else {
    for (int i = threadIdx.x; i < n_tab; i += kThreads) smem[i] = a.tables[i];
    __syncthreads();
    uint32_t* tmp = reinterpret_cast<uint32_t*>(smem + n_tab);  // (L_in, kThreads, V)
    for (; tile < a.tiles; tile += gridDim.x) {
      const Place<V> pl = place<V>(a, tile);
#pragma unroll 4
      for (int i = 0; i < L_in; ++i) {
        int64_t raw[1][V];
        Place<V> row = pl;
        row.x += i * n;
        load<1, V>(row, n, raw);
#pragma unroll
        for (int j = 0; j < V; ++j)
          tmp[(i * kThreads + threadIdx.x) * V + j] = scale(raw[0][j], in_tab[i]);
      }
      outputs_shared<V>(a, pl, tmp, out_tab, mat);
    }
  }
}

using Kernel = void (*)(const Args);

#define TROY_BCONV(L) &bconv_kernel<L, cols_for(L)>
// kKernels[L_in] for L_in <= kRegLimbs; kKernels[0] the shared-memory form.
const Kernel kKernels[kRegLimbs + 1] = {
    TROY_BCONV(0),  TROY_BCONV(1),  TROY_BCONV(2),  TROY_BCONV(3),  TROY_BCONV(4),
    TROY_BCONV(5),  TROY_BCONV(6),  TROY_BCONV(7),  TROY_BCONV(8),  TROY_BCONV(9),
    TROY_BCONV(10), TROY_BCONV(11), TROY_BCONV(12), TROY_BCONV(13), TROY_BCONV(14),
    TROY_BCONV(15), TROY_BCONV(16)};
#undef TROY_BCONV
const int kCols[kRegLimbs + 1] = {cols_for(0),  cols_for(1),  cols_for(2),  cols_for(3),
                                  cols_for(4),  cols_for(5),  cols_for(6),  cols_for(7),
                                  cols_for(8),  cols_for(9),  cols_for(10), cols_for(11),
                                  cols_for(12), cols_for(13), cols_for(14), cols_for(15),
                                  cols_for(16)};

int form_of(int L_in) { return L_in <= kRegLimbs ? L_in : 0; }

// The most dynamic shared memory a form's launch asks for (L_out up to
// kMaxLimbs; the shared-memory form also L_in up to kMaxLimbs): the
// occupancy the grid is sized by.
size_t most_smem(int form) {
  return form == 0 ? smem_bytes(kMaxLimbs, kMaxLimbs, true, kCols[0])
                   : smem_bytes(form, kMaxLimbs, false, kCols[form]);
}

// Lets the form ask for its most dynamic shared memory (above 48 KB only
// the shared-memory form does).
cudaError_t prepare(int form) {
  const size_t smem = most_smem(form);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kKernels[form], cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The form's CTAs an SM at its most shared memory (cached).
cudaError_t ctas_per_sm(int form, int* out) {
  static int cached[kRegLimbs + 1] = {};
  cudaError_t err = prepare(form);
  if (err == cudaSuccess && !cached[form])
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[form], kKernels[form], kThreads,
                                                         most_smem(form));
  *out = cached[form];
  return err;
}

}  // namespace

// x: (n_rows, L_in, n) int64, rows x_row elements apart (>= L_in n), limbs
// n apart, coefficients contiguous; y: (n_rows, L_out, n) contiguous.
extern "C" int troy_bconv(const void* x, void* y, const void* tables, long long n_rows,
                          long long x_row, int L_in, int L_out, int n, void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (L_in < 1 || L_out < 1 || L_in > kMaxLimbs || L_out > kMaxLimbs || x_row < 1LL * L_in * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int form = form_of(L_in);
  const int per_tile = kThreads * kCols[form];
  const cudaError_t err = prepare(form);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_per_row = (n + per_tile - 1) / per_tile;
  const Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(y),
               static_cast<const uint4*>(tables), x_row, n_rows * tiles_per_row,
               tiles_per_row, L_in, L_out, n};
  const long long grid = std::min<long long>(a.tiles, 0x7fffffffLL);  // one CTA a tile
  kKernels[form]<<<static_cast<unsigned int>(grid), kThreads,
                   smem_bytes(L_in, L_out, form == 0, kCols[form]),
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of the form that takes L_in limbs: out[0..7] = threads,
// columns a thread, registers, local (spill) bytes a thread, the most
// dynamic shared bytes a CTA, CTAs an SM, SMs, tiles' columns.
extern "C" int troy_bconv_info(int L_in, int* out) {
  const int form = form_of(L_in);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kKernels[form]);
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) err = ctas_per_sm(form, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = kCols[form];
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = static_cast<int>(most_smem(form));
  out[5] = per_sm;
  out[6] = sms;
  out[7] = kThreads * kCols[form];
  return 0;
}

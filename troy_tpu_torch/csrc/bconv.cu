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
// contraction is only L_in deep, so this kernel runs it on the CUDA cores:
// one IMAD.WIDE.U32 a term into a u64 sum.
//
// Bound: device memory.  One column reads 8 L_in bytes and writes 8 L_out
// bytes (residues travel as int64, the port's residue type) against L_in
// Shoup products, L_in L_out 64-bit multiply-adds and L_out Barrett
// reductions: at the floor's (rows, 6) -> 9 about 150 instructions a
// column, a quarter of the int32 rate's time at the memory rate.
//
// Design (the first kernel, csrc/bconv_first.cu, is the yardstick; each
// choice below was measured against its alternative on the H100 by
// scripts/torch_bconv_variants.py):
//   * Constants built on the host.  Each output's Barrett constant and
//     reduction cadence come with the tables, built and checked by
//     ops/bconv.BConvTables: no division runs on the card, and a CTA's
//     prologue is one copy of the tables into shared memory and a barrier,
//     with the CTA's first input loads already in flight.
//   * One CTA a tile of kThreads columns of one row, a column a thread,
//     neighbouring threads on neighbouring columns: each warp access is 256
//     contiguous bytes, and the CTAs of a launch start at different times,
//     so some load while others multiply.  A persistent grid (the SM count
//     times the CTAs an SM holds, walking the tiles), 16-byte column pairs
//     and two pairs a thread each measured slower (PERF.md, K3; their
//     source is scripts/torch_bconv_columns.cu).
//   * Scaled inputs in registers.  L_in is a template parameter from 1 to
//     kRegLimbs, so the L_in scaled inputs stay in registers, all of a
//     tile's loads issued before any product; the matrix rows come from
//     shared memory as 16-byte broadcasts.  Above kRegLimbs one
//     instantiation with a runtime L_in keeps them in shared memory.
//   * A strided input.  Input rows sit x_row elements apart (at least
//     L_in n), the limbs n apart: y[..., :-1, :] of a contiguous tensor (the
//     Shenoy-Kumaresan conversion's B rows) is read where it lies.
//
// Arithmetic: [x ip]_q by shoup_lazy and one conditional subtract (x below
// 2^32, q below 2^31); each output's sum is reduced after every `every`
// products (no reduction inside the sum when every >= L_in) and once at
// the end, by barrett_reduce64 with ratio = floor((2^64 - 1) / p), which
// needs one correction for any sum below 2^64.  `every` products plus a
// reduced value stay below 2^64: BConvTables asserts it per output, and
// tests/test_torch_bconv_kernel.py replays this schedule on the CPU.
//
// Tables (u32 words, from ops/bconv.BConvTables.kernel_tables), in 16-byte
// vectors: L_in of {q_i, ip_i, Shoup companion of ip_i, 0}; L_out of
// {p_o, ratio_o low, ratio_o high, every_o}; then M, each row padded to
// mat_vecs(L_in) vectors with zeros.  The wrapper (ops/bconv_cuda.py)
// checks the moduli's bounds, L_in and L_out <= kMaxLimbs and the strides.
// The kernel never allocates.

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
  int tiles_per_row;
  int L_in, L_out, n;
};

__host__ __device__ constexpr int mat_vecs(int L_in) { return (L_in + 3) / 4; }

size_t smem_bytes(int L_in, int L_out, bool shared_inputs) {
  return sizeof(uint4) * (L_in + L_out * (1 + mat_vecs(L_in))) +
         (shared_inputs ? sizeof(uint32_t) * L_in * kThreads : 0);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// [x ip]_q in [0, q) for c = {q, ip, ip Shoup, 0}.
__device__ __forceinline__ uint32_t scale(int64_t x, const uint4& c) {
  const uint32_t v = troy::shoup_lazy(static_cast<uint32_t>(x), c.y, c.z, c.x);
  return v >= c.x ? v - c.x : v;
}

// A CTA's place: its tile's row of input and output, and this thread's
// column.
struct Place {
  const int64_t* x;
  int64_t* y;
  int col;
};

__device__ __forceinline__ Place place(const Args& a) {
  const long long row = blockIdx.x / a.tiles_per_row;
  const int tile = static_cast<int>(blockIdx.x - row * a.tiles_per_row);
  return {a.x + row * a.x_row, a.y + row * a.L_out * static_cast<long long>(a.n),
          tile * kThreads + static_cast<int>(threadIdx.x)};
}

// Output o's sum reduced by Barrett, stored.
__device__ __forceinline__ void store(const Place& pl, long long n, int o, uint64_t acc,
                                      uint64_t p, uint64_t ratio) {
  acc = troy::barrett_reduce64(acc, p, ratio);
  if (pl.col < n) pl.y[o * n + pl.col] = static_cast<int64_t>(acc);
}

// A column's outputs from its scaled inputs t, held in registers.
template <int L>
__device__ __forceinline__ void outputs(const Args& a, const Place& pl, const uint32_t (&t)[L],
                                        const uint4* out_tab, const uint4* mat) {
  for (int o = 0; o < a.L_out; ++o) {
    const uint4 oc = out_tab[o];
    const uint64_t p = oc.x;
    const uint64_t ratio = (static_cast<uint64_t>(oc.z) << 32) | oc.y;
    const int every = static_cast<int>(oc.w);
    const uint4* m = mat + o * mat_vecs(L);
    uint64_t acc = 0;
    if (every >= L) {  // the whole sum below 2^64
#pragma unroll
      for (int i4 = 0; i4 < mat_vecs(L); ++i4) {
        const uint4 w = m[i4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i4 + k < L) acc += static_cast<uint64_t>(t[4 * i4 + k]) * word(w, k);
      }
    } else {
      int left = every;
#pragma unroll
      for (int i4 = 0; i4 < mat_vecs(L); ++i4) {
        const uint4 w = m[i4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i4 + k < L) {
            acc += static_cast<uint64_t>(t[4 * i4 + k]) * word(w, k);
            if (--left == 0) {
              acc = troy::barrett_reduce64(acc, p, ratio);
              left = every;
            }
          }
      }
    }
    store(pl, a.n, o, acc, p, ratio);
  }
}

// The same from scaled inputs in shared memory, tmp[i kThreads + thread]
// (the runtime-L_in form).
__device__ __forceinline__ void outputs_shared(const Args& a, const Place& pl,
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
    uint64_t acc = 0;
    int left = every;
    for (int i = 0; i < a.L_in; ++i) {
      acc += static_cast<uint64_t>(tmp[i * kThreads + threadIdx.x]) * mw[i];
      if (mid && --left == 0) {
        acc = troy::barrett_reduce64(acc, p, ratio);
        left = every;
      }
    }
    store(pl, a.n, o, acc, p, ratio);
  }
}

// One CTA a tile of kThreads columns of one row.
template <int L>
__global__ void __launch_bounds__(kThreads) bconv_kernel(const Args a) {
  extern __shared__ uint4 smem[];
  const int L_in = L > 0 ? L : a.L_in;
  const int n_tab = L_in + a.L_out * (1 + mat_vecs(L_in));
  const uint4* in_tab = smem;
  const uint4* out_tab = smem + L_in;
  const uint4* mat = out_tab + a.L_out;
  const long long n = a.n;
  const Place pl = place(a);

  if constexpr (L > 0) {
    // Every input load issued before the first product, in flight while
    // the tables are copied.
    int64_t raw[L];
#pragma unroll
    for (int i = 0; i < L; ++i) raw[i] = pl.col < n ? __ldg(pl.x + i * n + pl.col) : 0;
    for (int i = threadIdx.x; i < n_tab; i += kThreads) smem[i] = a.tables[i];
    __syncthreads();
    uint32_t t[L];
#pragma unroll
    for (int i = 0; i < L; ++i) t[i] = scale(raw[i], in_tab[i]);
    outputs<L>(a, pl, t, out_tab, mat);
  } else {
    for (int i = threadIdx.x; i < n_tab; i += kThreads) smem[i] = a.tables[i];
    __syncthreads();
    uint32_t* tmp = reinterpret_cast<uint32_t*>(smem + n_tab);  // (L_in, kThreads)
#pragma unroll 4
    for (int i = 0; i < L_in; ++i)
      tmp[i * kThreads + threadIdx.x] =
          scale(pl.col < n ? __ldg(pl.x + i * n + pl.col) : 0, in_tab[i]);
    outputs_shared(a, pl, tmp, out_tab, mat);
  }
}

using Kernel = void (*)(const Args);

// kKernels[L_in] for L_in <= kRegLimbs; kKernels[0] the shared-memory form.
const Kernel kKernels[kRegLimbs + 1] = {
    &bconv_kernel<0>,  &bconv_kernel<1>,  &bconv_kernel<2>,  &bconv_kernel<3>,
    &bconv_kernel<4>,  &bconv_kernel<5>,  &bconv_kernel<6>,  &bconv_kernel<7>,
    &bconv_kernel<8>,  &bconv_kernel<9>,  &bconv_kernel<10>, &bconv_kernel<11>,
    &bconv_kernel<12>, &bconv_kernel<13>, &bconv_kernel<14>, &bconv_kernel<15>,
    &bconv_kernel<16>};

int form_of(int L_in) { return L_in <= kRegLimbs ? L_in : 0; }

// The most dynamic shared memory a form's launch asks for (L_out up to
// kMaxLimbs; the shared-memory form also L_in up to kMaxLimbs).
size_t most_smem(int form) {
  return form == 0 ? smem_bytes(kMaxLimbs, kMaxLimbs, true)
                   : smem_bytes(form, kMaxLimbs, false);
}

// Lets the form ask for its most dynamic shared memory (above 48 KB only
// the shared-memory form does).
cudaError_t prepare(int form) {
  const size_t smem = most_smem(form);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kKernels[form], cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// x: (n_rows, L_in, n) int64, rows x_row elements apart (>= L_in n), limbs
// n apart, coefficients contiguous; y: (n_rows, L_out, n) contiguous.
extern "C" int troy_bconv(const void* x, void* y, const void* tables, long long n_rows,
                          long long x_row, int L_in, int L_out, int n, void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  if (L_in < 1 || L_out < 1 || L_in > kMaxLimbs || L_out > kMaxLimbs || x_row < 1LL * L_in * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_row = (n + kThreads - 1) / kThreads;
  const long long tiles = n_rows * tiles_per_row;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int form = form_of(L_in);
  const cudaError_t err = prepare(form);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int64_t*>(x), static_cast<int64_t*>(y),
               static_cast<const uint4*>(tables), x_row, tiles_per_row, L_in, L_out, n};
  kKernels[form]<<<static_cast<unsigned int>(tiles), kThreads, smem_bytes(L_in, L_out, form == 0),
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of the form that takes L_in limbs: out[0..5] = threads
// (columns) a CTA, registers, local (spill) bytes a thread, the most
// dynamic shared bytes a CTA, CTAs an SM at that, SMs.
extern "C" int troy_bconv_info(int L_in, int* out) {
  const int form = form_of(L_in);
  cudaFuncAttributes attr;
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = prepare(form);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kKernels[form]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernels[form], kThreads,
                                                         most_smem(form));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = static_cast<int>(most_smem(form));
  out[4] = per_sm;
  out[5] = sms;
  return 0;
}

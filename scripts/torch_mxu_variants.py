#!/usr/bin/env python3
"""Variants of the matrix-product NTT kernels K2, built side by side and
timed in turns on one GPU, to show where their time goes.

    python3 scripts/torch_mxu_variants.py [variant ...]            # csrc/ntt_mxu_wg.cu
    python3 scripts/torch_mxu_variants.py --first [variant ...]    # csrc/ntt_mxu.cu
    python3 scripts/torch_mxu_variants.py --cluster [variant ...]  # csrc/ntt_mxu_cluster.cu

Each variant is the kernel's source with textual substitutions, built as
scripts/torch_ntt_variants.py builds its variants (its build(), all in
parallel, into troy_tpu_torch/build/variants/).  At the keyswitch digits
(96, 7, 8192) and base q (16, 6, 8192) of the flagship HPS step
(chip_smoke.py's configuration), every variant's forward and inverse run on
the same input and are timed by CUDA events around a CUDA graph of 50
launches, in the order listed and then in reverse, keeping the lower;
"(wrong)" marks a result other than the plain transform's, as every
measurement-only variant gives.

The redesigned kernel (csrc/ntt_mxu_wg.cu, the route to n = 16384):

  committed     the source as it is;
  no_mma        no wgmma runs (each product replaced by one integer add of
                its two descriptors into its accumulator): the kernel
                without its tensor-core work;
  no_recombine  each epilogue takes the sum of three diagonals for the
                recombined value (no wide sum, no Barrett step);
  no_split      no operand split: stage 1 reads the planes left from the
                last polynomial (the staging row still arrives);
  no_twiddle    stage 1's epilogue skips the twiddle's load and Shoup
                product;
  no_stagger    both warpgroups start their first products at once (no
                named barrier between them);
  no_store      stage 2's epilogue writes nothing to device memory.

The first form (csrc/ntt_mxu.cu, with --first; the yardstick):

  committed     csrc/ntt_mxu.cu as it is;
  no_mma        the fragments load but no mma.sync runs (each product
                replaced by one integer add of its fragments): the kernel
                without its tensor-core work;
  no_recombine  the epilogue stores a diagonal sum instead of recombining
                the 7 sums mod q (no Shoup products, no scalars read);
  no_split      the data loads keep the low byte of each value in every
                plane instead of its balanced digits;
  no_twiddle    the first stage's epilogue skips the twiddle's Shoup
                product and its table load.

The cluster kernel (csrc/ntt_mxu_cluster.cu, the route above 16384, with
--cluster), at (3, 2, 65536) and the n = 65536 step's digits (16, 9, 65536)
in every cluster size it takes there:

  committed     the source as it is;
  no_mma        no wgmma runs (each product one integer add into its
                accumulator): the kernel without its tensor-core work;
  smem_a        the table operand read from shared memory at every tile
                width (the source: from registers at 16-row tiles);
  register_a    the table operand from registers at every tile width;
  no_stream     no table chunk is copied (each slot's barrier completes
                with no bytes): the kernel without the tables' traffic;
  no_recombine  each epilogue takes the sum of three diagonals for the
                recombined value;
  no_store      stage 2's epilogue writes nothing to device memory;
  timeline      clock64 stamps of CTA 0's two warpgroups (a row's start,
                V1 ready, each chunk ready, each tile's products done and
                start, v2full, the end), printed for one launch a shape.

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

import chip_smoke  # noqa: E402
import torch_ntt_variants as V  # noqa: E402
from troy_tpu_torch.core.modulus import Modulus  # noqa: E402
from troy_tpu_torch.ops import ntt_mxu as MX, ntt_mxu_cuda  # noqa: E402
from troy_tpu_torch.utils import numth  # noqa: E402

WG_VARIANTS = {
    "committed": [],
    "no_mma": [("        wgmma<NT>(acc[i + j], da[i], db[j], k > 0 || (i > 0 && j < 3));",
                "        acc[i + j][0] += static_cast<int>(da[i] ^ db[j]);")],
    "no_recombine": [("          v[e] = recombine(acc[0][r], acc[1][r], acc[2][r], acc[3][r], "
                      "acc[4][r], acc[5][r],\n                           acc[6][r], c);",
                      "          v[e] = acc[0][r] + acc[3][r] + acc[6][r];")],
    "no_split": [("__device__ __forceinline__ void split_item(const Split& sp, int i) {\n",
                  "__device__ __forceinline__ void split_item(const Split& sp, int i) {\n"
                  "  if (sp.rows >= 0) return;\n")],
    "no_twiddle": [("          tw[j][h] = m < M ? *reinterpret_cast<const uint4*>(\n"
                    "                                 ep.twiddle + 2 * (static_cast<size_t>(m) * "
                    "N + n))\n                           : make_uint4(0, 0, 0, 0);",
                    "          tw[j][h] = make_uint4(0, 0, 0, 0);"),
                   ("          v[0] = cond_sub(shoup(v[0], tw[j][h].x, tw[j][h].y, c.q), c.q);\n"
                    "          v[1] = cond_sub(shoup(v[1], tw[j][h].z, tw[j][h].w, c.q), c.q);\n",
                    "")],
    "no_stagger": [("  asm volatile(\"bar.arrive 1, %0;\\n\" ::\"n\"(kThreads) : \"memory\");", ""),
                   ("  asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kThreads) : \"memory\");", "")],
    "no_store": [("              *reinterpret_cast<longlong2*>(ep.out + static_cast<size_t>(m) * "
                  "ep.n2 + n) =\n                  make_longlong2(v[0], v[1]);",
                  "              if (v[0] == 0xFFFFFFFFu) ep.out[0] = v[1];"),
                 ("              ep.out[static_cast<size_t>(n) * ep.n2 + m] = v[0];\n"
                  "              ep.out[static_cast<size_t>(n + 1) * ep.n2 + m] = v[1];",
                  "              if (v[0] == 0xFFFFFFFFu) ep.out[0] = v[1];")],
}
VARIANTS = {
    "committed": [],
    "no_mma": [("              mma_s8(acc[j][i + jp], af[i], bf[jp][j][0], bf[jp][j][1]);",
                "              acc[j][i + jp][0] += af[i][0] + bf[jp][j][0];")],
    "no_recombine": [("          v[e] = recombine(P, fold, sc);",
                      "          v[e] = static_cast<uint32_t>(P[0] + P[3] + P[6]);")],
    "no_split": [("        split_digits(static_cast<uint32_t>(v), q, d);",
                  "        d[0] = d[1] = d[2] = d[3] = static_cast<uint32_t>(v) & 255;")],
    "no_twiddle": [("        if (a.twiddle) {", "        if (false) {")],
}
CL_VARIANTS = {
    "committed": [],
    "no_mma": [("            if (kRegisterA)\n              wgmma_rs<NT>(acc[i + j], a[st & 1][i], db[j], accumulate);\n"
                "            else\n              wgmma<NT>(acc[i + j], descriptor(at - arow + i * 4096, 128, 512), db[j], accumulate);",
                "            acc[i + j][0] += static_cast<int>(db[j]) + accumulate;")],
    "smem_a": [("    constexpr bool kRegisterA = NT == 16;", "    constexpr bool kRegisterA = false;")],
    "register_a": [("    constexpr bool kRegisterA = NT == 16;", "    constexpr bool kRegisterA = true;")],
    "no_stream": [("  mbar_expect(&ring.full[s], ch.bytes);\n"
                   "  bulk_load(ring.slots + s * ring.slot, ch.src, ch.bytes, &ring.full[s]);",
                   "  mbar_expect(&ring.full[s], 0);")],
    "no_recombine": [("          v[e] = recombine(acc[0][k], acc[1][k], acc[2][k], acc[3][k], acc[4][k], "
                      "acc[5][k],\n                           acc[6][k], c);",
                      "          v[e] = acc[0][k] + acc[3][k] + acc[6][k];")],
    "timeline": [  # clock64 stamps of CTA 0's two warpgroups (the first thread of each)
        ("namespace troy {\nnamespace mxu_cl {\n",
         "__device__ unsigned long long troy_tl[2][4096];\n__device__ int troy_tl_n[2];\n"
         "__device__ __forceinline__ void stamp(int kind, int a) {\n"
         "  if ((threadIdx.x & 127) == 0 && blockIdx.x == 0) {\n"
         "    const int g = threadIdx.x >> 7, i = troy_tl_n[g]++;\n"
         "    long long t; asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t));\n"
         "    if (i < 4096) troy_tl[g][i] = (static_cast<unsigned long long>(t) << 16) | (kind << 8) | (a & 255);\n"
         "  }\n}\n"
         "extern \"C\" int troy_cl_timeline(unsigned long long* out, int* n) {\n"
         "  cudaMemcpyFromSymbol(out, troy_tl, sizeof(troy_tl));\n"
         "  cudaMemcpyFromSymbol(n, troy_tl_n, sizeof(troy_tl_n));\n"
         "  int zero[2] = {0, 0};\n"
         "  return static_cast<int>(cudaMemcpyToSymbol(troy_tl_n, zero, sizeof(zero)));\n}\n"
         "namespace troy {\nnamespace mxu_cl {\n"),
        ("    const Scalars c{sc[0], sc[1], sc[2], sc[3], sc[4]};\n",
         "    const Scalars c{sc[0], sc[1], sc[2], sc[3], sc[4]};\n    stamp(0, it);\n"),
        ("    const bool more = it + 1 < r.count;\n", "    const bool more = it + 1 < r.count;\n    stamp(1, it);\n"),
        ("      mbar_wait(&ring.full[s], (v / ring.n) & 1);\n",
         "      mbar_wait(&ring.full[s], (v / ring.n) & 1);\n      stamp(2, c);\n"),
        ("    pin<NT>(acc);\n", "    pin<NT>(acc);\n    stamp(3, mt);\n"),
        ("    const int mt = 2 * u + r.group;\n", "    const int mt = 2 * u + r.group;\n    stamp(4, mt);\n"),
        ("    mbar_wait(v2full, it & 1);  // every CTA's block of V2 has landed\n",
         "    mbar_wait(v2full, it & 1);\n    stamp(5, it);\n"),
        ("  cluster_sync();  // no CTA leaves", "  stamp(6, 0);\n  cluster_sync();  // no CTA leaves")],
    "no_store": [("            *reinterpret_cast<longlong2*>(ep.out + static_cast<size_t>(m) * p.n2 + n) =\n"
                  "                make_longlong2(v[0], v[1]);",
                  "            if (v[0] == 0xFFFFFFFFu) ep.out[0] = v[1];"),
                 ("            ep.out[static_cast<size_t>(n) * p.n2 + m] = v[0];\n"
                  "            ep.out[static_cast<size_t>(n + 1) * p.n2 + m] = v[1];",
                  "            if (v[0] == 0xFFFFFFFFu) ep.out[0] = v[1];")],
}
SHAPES = (("keyswitch digits", (96, 7)), ("base q", (16, 6)))
CL_SHAPES = (("(3, 2, 65536)", (3, 2, 16)), ("digits (16, 9, 65536)", (16, 9, 16)))
N_LOG = 13


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_mxu_variants: no CUDA device", file=sys.stderr)
        return 1
    first = "--first" in argv
    if "--cluster" in argv:
        return cluster_main([a for a in argv if a != "--cluster"])
    argv = [a for a in argv if a != "--first"]
    variants = VARIANTS if first else WG_VARIANTS
    names = argv or list(variants)
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if first:
        libs = V.build(names, "ntt_mxu.cu", variants, ("ntt_mxu_kernel",))
    else:
        libs = V.build(names, "ntt_mxu_wg.cu", variants, ("ntt_mxu_wg_kernelILb0ELb1",
                                                          "ntt_mxu_wg_kernelILb1ELb1"))
    gen = torch.Generator(device=dev).manual_seed(10)
    kernel = "ntt_mxu" if first else "ntt_mxu_wg"

    def launch_wg(name: str, inverse: bool, x: torch.Tensor, t: MX.MxuNTTTables):
        fn = getattr(libs[name], f"troy_ntt_{'inverse' if inverse else 'forward'}_mxu_wg")
        fn.argtypes = ntt_mxu_cuda._WG_ARGTYPES
        fn.restype = ctypes.c_int
        out = torch.empty_like(x)
        t1, t2 = t.wg_w[2:] if inverse else t.wg_w[:2]
        err = fn(x.data_ptr(), out.data_ptr(), t1.data_ptr(), t2.data_ptr(),
                 t.wg_twiddle[int(inverse)].data_ptr(), t.wg_scalars.data_ptr(),
                 x.numel() // t.n, t.size, t.a, t.b, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {name} launch failed: CUDA error {err}")
        return out

    def launch(name: str, inverse: bool, x: torch.Tensor, t: MX.MxuNTTTables) -> torch.Tensor:
        if not first:
            return launch_wg(name, inverse, x, t)
        fn = getattr(libs[name], f"troy_ntt_{'inverse' if inverse else 'forward'}_mxu")
        fn.argtypes = ntt_mxu_cuda._ARGTYPES
        fn.restype = ctypes.c_int
        out = torch.empty_like(x)
        w_left, w_right = t.kernel_w[2:] if inverse else t.kernel_w[:2]
        plan = (ctypes.c_int * 6)(*ntt_mxu_cuda.plan_words(t))
        err = fn(x.data_ptr(), out.data_ptr(), out.data_ptr(), w_left.data_ptr(),
                 w_right.data_ptr(), t.kernel_twiddle.data_ptr(), t.kernel_scalars.data_ptr(),
                 x.numel() // t.n, t.size, t.a, t.b, t.plan["launches"], plan,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {name} launch failed: CUDA error {err}")
        return out

    for label, (rows, limbs) in SHAPES:
        primes = numth.get_primes(2 << N_LOG, 30, limbs)
        t = MX.MxuNTTTables(N_LOG, [Modulus(p) for p in primes], dev)
        shape = (rows, limbs, 1 << N_LOG)
        x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                          device=dev) % MX.plain_tables(t)["q"].view(-1, 1)
        for inverse in (False, True):
            plain = (MX.ntt_inverse_mxu if inverse else MX.ntt_forward_mxu)(x, t)
            right = {n: torch.equal(launch(n, inverse, x, t), plain) for n in names}
            times = {}
            for name in names + names[::-1]:
                us = chip_smoke.graph_us(lambda: launch(name, inverse, x, t))
                times[name] = min(us, times.get(name, us))
            bound, by = chip_smoke.ntt_bound(shape)
            print(f"[variants] {gpu}: {kernel} {'inverse' if inverse else 'forward'} {label} "
                  f"{shape}, bound {bound:.3f} us ({by}): " + ", ".join(
                      f"{n} {times[n]:.3f} us{'' if right[n] else ' (wrong)'}" for n in names),
                  flush=True)
    return 0


def cluster_main(names: list[str]) -> int:
    """The cluster kernel's variants at (3, 2, 65536) and the n = 65536
    step's digits, at each cluster size it takes there."""
    names = names or list(CL_VARIANTS)
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = V.build(names, "ntt_mxu_cluster.cu", CL_VARIANTS, ("ntt_mxu_cluster_kernelILb0ELi32ELi32E",
                                                                "ntt_mxu_cluster_kernelILb0ELi16ELi16E"))
    gen = torch.Generator(device=dev).manual_seed(10)

    def launch(name: str, inverse: bool, x: torch.Tensor, t: MX.MxuNTTTables, log_c: int):
        fn = getattr(libs[name], f"troy_ntt_{'inverse' if inverse else 'forward'}_mxu_cluster")
        fn.argtypes = ntt_mxu_cuda._CL_ARGTYPES
        fn.restype = ctypes.c_int
        out = torch.empty_like(x)
        t1, t2 = t.cl_w[2:] if inverse else t.cl_w[:2]
        err = fn(x.data_ptr(), out.data_ptr(), t1.data_ptr(), t2.data_ptr(),
                 t.wg_twiddle[int(inverse)].data_ptr(), t.wg_scalars.data_ptr(),
                 x.numel() // t.n, t.size, t.a, t.b, log_c, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"[variants] {name} launch failed: CUDA error {err}")
        return out

    timeline = {}
    for label, (rows, limbs, lg) in CL_SHAPES:
        primes = numth.get_primes(2 << lg, 30, limbs)
        t = MX.MxuNTTTables(lg, [Modulus(p) for p in primes], dev)
        shape = (rows, limbs, 1 << lg)
        x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                          device=dev) % MX.plain_tables(t)["q"].view(-1, 1)
        for inverse in (False, True):
            plain = (MX.ntt_inverse_mxu if inverse else MX.ntt_forward_mxu)(x, t)
            for log_c in MX.CL_SWEEP[lg]:
                right = {n: torch.equal(launch(n, inverse, x, t, log_c), plain) for n in names}
                times = {}
                for name in names + names[::-1]:
                    us = chip_smoke.graph_us(lambda: launch(name, inverse, x, t, log_c), 20)
                    times[name] = min(us, times.get(name, us))
                bound, by = chip_smoke.ntt_bound(shape)
                print(f"[variants] {gpu}: ntt_mxu_cluster {'inverse' if inverse else 'forward'} "
                      f"{label}, clusters of {1 << log_c}, bound {bound:.3f} us ({by}): " + ", ".join(
                          f"{n} {times[n]:.3f} us{'' if right[n] else ' (wrong)'}" for n in names),
                      flush=True)
                if "timeline" in names:
                    timeline[(label, inverse, log_c)] = events(libs["timeline"], lambda: launch(
                        "timeline", inverse, x, t, log_c))
    for (label, inverse, log_c), ev in timeline.items():
        print(f"[timeline] {gpu}: {'inverse' if inverse else 'forward'} {label}, clusters of "
              f"{1 << log_c}, CTA 0, kernel cycles from its first stamp (kinds: R row, S split done, "
              f"C chunk ready, P products done, T tile start, V v2full, E end):", flush=True)
        for g, seq in enumerate(ev):
            print(f"[timeline] group {g}: " + " ".join(f"{k}{a}@{c}" for k, a, c in seq[:160]),
                  flush=True)
    return 0


def events(lib, launch) -> list:
    """One launch of the timeline variant: each warpgroup's (kind, argument,
    cycles from the CTA's first stamp)."""
    fn = lib.troy_cl_timeline
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (2 * 4096))()
    count = (ctypes.c_int * 2)()
    launch()
    torch.cuda.synchronize()
    fn(buf, count)   # resets the counters
    launch()
    torch.cuda.synchronize()
    fn(buf, count)
    raw = [[buf[g * 4096 + i] for i in range(min(count[g], 4096))] for g in range(2)]
    t0 = min(v >> 16 for seq in raw for v in seq[:1])
    kinds = "RSCPTVE"
    return [[(kinds[(v >> 8) & 255], v & 255, (v >> 16) - t0) for v in seq] for seq in raw]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

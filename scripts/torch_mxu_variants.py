#!/usr/bin/env python3
"""Variants of the matrix-product NTT kernels K2, built side by side and
timed in turns on one GPU, to show where their time goes.

    python3 scripts/torch_mxu_variants.py [variant ...]          # csrc/ntt_mxu_wg.cu
    python3 scripts/torch_mxu_variants.py --first [variant ...]  # csrc/ntt_mxu.cu

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
SHAPES = (("keyswitch digits", (96, 7)), ("base q", (16, 6)))
N_LOG = 13


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_mxu_variants: no CUDA device", file=sys.stderr)
        return 1
    first = "--first" in argv
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

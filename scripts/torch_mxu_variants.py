#!/usr/bin/env python3
"""Variants of the matrix-product NTT kernel K2 (troy_tpu_torch/csrc/ntt_mxu.cu),
built side by side and timed in turns on one GPU, to show where its time
goes.

    python3 scripts/torch_mxu_variants.py [variant ...]

Each variant is csrc/ntt_mxu.cu with textual substitutions, built as
scripts/torch_ntt_variants.py builds its variants (its build(), all in
parallel, into troy_tpu_torch/build/variants/).  At the keyswitch digits
(96, 7, 8192) and base q (16, 6, 8192) of the flagship HPS step
(chip_smoke.py's configuration), every variant's forward and inverse run on
the same input and are timed by CUDA events around a CUDA graph of 50
launches, in the order listed and then in reverse, keeping the lower;
"(wrong)" marks a result other than the plain transform's, as every
measurement-only variant gives.

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
    names = argv or list(VARIANTS)
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs = V.build(names, "ntt_mxu.cu", VARIANTS, ("ntt_mxu_kernel",))
    gen = torch.Generator(device=dev).manual_seed(10)

    def launch(name: str, inverse: bool, x: torch.Tensor, t: MX.MxuNTTTables) -> torch.Tensor:
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
            print(f"[variants] {gpu}: ntt_{'inverse' if inverse else 'forward'}_mxu {label} "
                  f"{shape}, bound {bound:.3f} us ({by}): " + ", ".join(
                      f"{n} {times[n]:.3f} us{'' if right[n] else ' (wrong)'}" for n in names),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

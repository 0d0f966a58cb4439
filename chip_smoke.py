#!/usr/bin/env python3
"""Smoke run of the PyTorch port (troy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's server paths at n = 8192 on a 7 x 30-bit chain (the last
prime special, so data level L = 6), plain modulus
PlainModulus.batching(8192, 20), batch 16: the batched BFV multiply +
relinearize step under both lifts of base q to the auxiliary base Bsk (the
default HPS lift and the reference-exact BEHZ lift, Evaluator(ctx,
lift="behz")), the batched Galois rotations and the mod switch; the client
flow of examples/99_quickstart.py; bench.py's CKKS configuration (the same
chain, scale 2^25, batch 16: multiply + relinearize, rescale, rotate_vector
and complex_conjugate); the same chain under BGV (multiply and square +
relinearize, rotate_rows, rotate_columns, the mod switch, the flow of
examples/4_bgv_basics.py, exponentiate and, in BFV, multiply_plain_contract);
a BFV multiply + relinearize at n = 65536, where
the NTT and the fused tensor product take their two-launch routes; LWE
extraction and packing on the BFV chain; the app layer's matmul and
conv2d at the reference's app-bench sizes; the client's batched steps and
the device CKKS encoder at bench.py's chain; the client and the server
over bytes (seed-compressed inputs, the helpers' wire format); the ring2k
encoder at the app bench's ring2k sizes; and the wide path at bench.py's
{60, 40, 40, 60} chain.  In phases:

  1. device   the card's name and power limit (fails without CUDA);
  2. build    nvcc builds every csrc/*.cu into one library under
              troy_tpu_torch/build/; beside it, nvcc -Xptxas -v on ntt.cu
              and fused_mul.cu prints each kernel's registers and spills,
              and the occupancy calculator its CTAs per SM (and K4's
              clusters on the card);
  3. kernels  each kernel against its plain PyTorch version, bit for bit:
              the NTT pair (and the earlier radix-2 pair that [times] uses
              as its yardstick) at every shape the path gives it and at every
              degree 2 to 131072 (above 32768 the column and block kernels,
              each launch also against its plain partial transform); the
              base conversion (K3) at every conversion of
              both lifts, the floor, Shenoy-Kumaresan and decrypt, at a
              15 -> 9 contraction, at one input limb, and into ring2k's
              {t, gamma} with t = 2^30 and 2^31 (output moduli past 2^30); the fused tensor
              product (K4, and its earlier radix-2 kernel, the yardstick of
              [times]) on lazy [0, 2q) input over base q and Bsk and at every
              degree 2 to 131072 (above 32768 its route through the NTT
              kernels and the tensor-product kernel, which is also held to
              dyadic_convolute).  Each wrapper refuses input its kernel
              cannot take, every degree above 131072, and a wide (40-60-bit)
              modulus;
  4. main     keygen, encode, encrypt 16 distinct pairs; one HPS step and
              one BEHZ step.  Each must launch the NTT kernels and K3, equal
              the same step with every kernel dispatch (NTT.ntt_forward,
              NTT.ntt_inverse, bconv.base_convert) patched to its plain
              version, decrypt to the slot-wise products m1 * m2 mod t (the
              decryptions launch K3 too) and keep a positive noise budget.
              K4 is driven at its own entry point, the tensor-product stage
              of the same multiply: it must launch, equal the evaluator's
              unfused stage, and give the step's product through the floor;
  5. rotate   Galois keys for steps 1, 4, -1 and the conjugation element, a
              public key, 16 distinct messages encrypted under it; the
              batched rotate_rows(1) (one keyswitch round), rotate_rows(3)
              (NAF -1 + 4: two rounds) and rotate_columns.  Each must launch
              the NTT kernels, equal its all-plain run, and decrypt to the
              rotated slots; row 0 of rotate_rows(3) must equal
              Evaluator.rotate_rows on ciphertext 0;
  6. modswitch the batched mod switch from L = 6 to L = 5, then
              rotate_rows(1) at L = 5: equal to the all-plain run, decrypting
              right, with K3 launched by decrypt at (5, 8192);
  7. quickstart examples/99_quickstart.py's flow (public key,
              encrypt_asymmetric, add, decrypt, decode), multiply_plain in
              coefficient and NTT form, add_plain, and one special-prime
              encryption, each decrypting right;
  8. ckks     bench.py's CKKS configuration (n = 8192, 7 x 30-bit primes,
              seed 0xBEEF, scale 2^25, batch 16, messages uniform(-1, 1) from
              numpy seed 7): keys and symmetric encryptions from
              RandomGenerator(seed, mode="aes") streams (the host AES build),
              then the batched multiply + relinearize, the rescale, and
              rotate_vector(1) and complex_conjugate in NTT form on complex
              messages.  Each must launch the NTT kernels, equal its
              all-plain run and decode to the expected slots, the rms error
              within 4 times the noise's expected rms, the largest within 32
              times it (plus, for the keyswitches, a term on a few slots;
              each printed beside the error); then its chained time, the profiler's launches,
              device time and busy share, and the NTT kernels' share of
              their bound;
  9. bgv      bench.py's chain under SchemeType.BGV (t as above, seed
              0xBEEF, batch 16, messages uniform in [0, t) from numpy seed 7):
              keys and symmetric encryptions from RandomGenerator(seed,
              mode="aes") streams, in NTT form; the batched multiply +
              relinearize, square + relinearize, rotate_rows(1),
              rotate_columns and the mod switch L = 6 -> 5 (the division by
              the last prime that keeps the payload mod t).  Each must launch
              the NTT kernels, equal its all-plain run, decrypt through the
              BGV decrypt (the exact centred phase mod t, times cf^-1) to the
              expected slots with its correction factor (q_last^-1 mod t
              after the mod switch) and keep a positive noise budget; row 0
              equals the Evaluator's.  Then examples/4_bgv_basics.py's flow
              with special-prime encryption (factor q_sp^-1 mod t), square,
              relinearize, mod switch and an add of unequal factors;
              exponentiate(ct, 3) and a 2 x 2 BFV multiply_plain_contract,
              each equal to its all-plain run and decrypting right; then
              each step's chained time, profiler launches, device time, busy
              share and NTT share of its bound;
 10. large_n  BFV multiply + relinearize at n = 65536 (9 x 30-bit primes, t =
              PlainModulus.batching(65536, 20), batch 2): it must launch the
              column and block NTT kernels and K3, equal its all-plain run
              and decrypt right; K4 at its entry point at the step's q and
              Bsk shapes (its large route) equals the unfused stage and its
              floor the multiply; then each large-n launch's device time
              beside its bound at (3, 2, n) for n = 65536 and 131072, and the
              two-launch NTT with blocks of 4096, 8192 and 32768 in turns, at
              (3, 2, 65536) and at the step's keyswitch digits;
 11. lwe      bench.py's BFV chain (seed 0xBEEF, AES streams): the 13
              automorphism keys (2^j + 1), one public-key encryption of
              coefficients uniform in [0, t) (numpy seed 7); extract_lwe of 64
              coefficients and pack_lwe_ciphertexts (63 merges, 7 trace
              rounds), then pack_lwe_ciphertexts_batched over 4 groups of 64
              as one stacked (4, 2, L, n) tree.  Each must launch the NTT
              kernels and equal its all-plain run; group 0 of the batched
              pack equals the sequential pack; every packed ciphertext
              decrypts to its coefficients at stride n/64 with a positive
              noise budget;
 12. app      the reference's app-bench sizes (scripts/matmul_bench.py,
              scripts/app_bench.py) on n = 8192, 4 x 30-bit primes, seed
              0xBEEF, EncryptLeft: the BFV matmul 100 x 105 x 110 with
              pack_lwe (one multiply_plain_contract, then pack_outputs over the
              stacked groups), decrypting to x @ w mod t exactly; the same
              matmul in CKKS at scale 2^25, decoding within the noise-derived
              tolerance of app_ckks_rms; the BFV conv2d of the CIFAR-like layer
              (4 x 3 x 32 x 32 -> 16 channels, 3 x 3), decrypting to the valid
              convolution mod t.  Each must launch the NTT kernels and equal
              its all-plain run.  Both phases print each flow's block choice,
              the wall time of its kernel run and all-plain twin, and its
              time a call, profiler launches, device time, NTT launches and
              busy share beside the card's name and power limit;
 13. client   bench.py's chain (n = 8192, 7 x 30-bit primes, seed 0xBEEF,
              batch 16), every key from the context's default threefry
              stream: threefry2x32's known answers on the card and its bits
              at (2, 16, 6, 8192) against the CPU's; BatchedClient's batch
              encode and decode (an NTT mod t), its symmetric and asymmetric
              encrypt steps, 3 calls chained through the state's probe, and
              its decrypt step, each equal to its all-plain run, every
              chained batch decrypting to its message; each step's time,
              launches, device time and busy share, and threefry's alone.
              Then the device CKKS encoder at the CKKS configuration (16 x
              4096 complex slots, scale 2^25): encode_device equal to its
              all-plain run, decoding through the host decode within 1e-5,
              its coefficients those of the host encode but fewer than n/64
              one unit off; decode_device (at 4 primes, margin 95 bits) within
              1e-5, and of a multiply + relinearize + rescale + mod switch
              within 2^-38 of the host decode;
 14. wire     the app-bench sizes (4 x 30-bit primes, seed 0xBEEF, EncryptLeft),
              each protocol run whole: the client encrypts seed-compressed
              inputs under the context's default stream and saves Zstd
              frames, the server loads them (c1 expanded from each seed on
              the card), computes and sends its outputs back by the helpers'
              wire format, the client loads and decrypts: the BFV matmul 100
              x 105 x 110 with pack_lwe (examples/10_bfv_matmul.py's protocol)
              and with its outputs as sparse terms, both x @ w mod t exactly;
              the CKKS matmul's terms in NTT form (K1 on both ends), within
              app_ckks_rms; the BFV conv2d.  Each run equals its all-plain run,
              frames byte for byte; the bytes on the wire, seeded against not,
              and each frame's mode byte; the automorphism keys and a seeded
              public key through the wire; threefry's time for one seed;
 15. ring2k   scripts/app_bench.py's ring2k configurations (n = 8192, 30-bit
              primes, t = PlainModulus.batching(8192, 25), which ring2k
              bypasses, seed 0xBEEF, EncryptLeft, inputs uniform below
              min(2^k, 2^63) from numpy seed 7): the matmul 100 x 105 x 110
              without packing at k = 32 (4 primes), 64 (6) and 128 (11), the
              conv2d 4 x 3 x 32 x 32 -> 16, 3 x 3 at k = 64; then
              examples/13_ring2k.py's flow on 16 messages at k = 24 and 31
              (scale_up, encrypt, add_plain, decrypt_scale_down, whose {t,
              gamma} conversion launches K3 into t = 2^k).  Each must launch
              the NTT kernels (the helper flows K3 too), equal its all-plain
              run and decrypt exactly to (x @ w), the convolution or m1 + m2
              mod 2^k; each flow's time a call, launches, device time and
              busy share;
 16. wide     bench.py's wide configuration (n = 8192, CoeffModulus.create(8192,
              [60, 40, 40, 60]), batch 16, seed 0xBEEF, keys from the
              context's threefry streams): the BFV multiply + relinearize step
              (t = PlainModulus.batching(8192, 20)) and rotate_rows(1), the
              CKKS multiply + relinearize + rescale and rotate_vector(1) at
              scale 2^40, the BGV multiply + relinearize; the client's
              symmetric and asymmetric encryptions and decrypt; one wide
              ciphertext, seeded and not, over Zstd bytes.  No step may
              launch a fast-path kernel (the wide NTT is int64 torch passes,
              ops/ntt64.py); each decrypts or decodes right (CKKS by the
              [ckks] tolerances at scale 2^40) and its ciphertext 0 equals the
              same step run on the CPU bit for bit (the client's keys and
              ciphertexts too); each step's chained time, launches, device
              time, busy share, and the wide NTT's share of the launches and
              device time (each of its calls timed alone);
 17. times    CUDA-event times of the chained steps against their all-plain
              versions (multiply + relinearize, the three rotations, the mod
              switch), the profiler's launches, device time, NTT kernel time
              and busy share of the HPS step and of one rotate_rows(1) and
              one rotate_columns step, one Galois round split into its
              stages (gather, keyswitch, add), each kernel against its plain
              version (K4 also against the unfused kernel path), and the NTT
              kernel against the earlier radix-2 kernel in turns (new, old,
              old, new) at every NTT shape of the HPS step and the Galois round,
              and K4 against its earlier radix-2 kernel the same way over q,
              over Bsk and at the degrees of K4_DEGREES: device microseconds
              per launch from CUDA events around a CUDA graph of 50 launches,
              beside the launch's bound.

Bounds: the least time the card could take for a launch's work, the larger
of its bytes (each input read once, each output written once) over
3.35 TB/s and its int32 operations over 132 SMs x 64 lanes x 1.98 GHz
(the H100 SXM's published memory rate and boost clock).

Prints one JSON line of kernel results (each kernel's launches on the path
that runs it, with every path's count under "paths"), then the nvidia-smi
line, then {"ok": true, "device": {...}} as the last line.  Any failure raises, so the
exit code is not 0 and no result line is printed.  Imports nothing of jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

N = 8192
Q_BITS = [30] * 7
L_DATA = len(Q_BITS) - 1   # the special prime is dropped at the data levels
LOG_T = 20
BATCH = 16
KEY_SEED = 0xBEEF
MSG_SEED = 7
REPS = 20
GRAPH_LAUNCHES = 50
PLAIN_REPS = 5
PROFILE_STEPS = 5
ROT_KEY_STEPS = [1, 4, -1]
QUICKSTART_BITS = [30] * 4
K4_DEGREES = (16, 1024, 16384, 32768)
LARGE_DEGREES = (65536, 131072)   # the two-launch routes (F3)
REFUSED_DEGREE = 262144           # above the reference's largest degree
CKKS_SCALE = 2.0 ** 25
N_LARGE = 65536
LARGE_BITS = [30] * 9             # 8 data primes + the special prime
LARGE_BATCH = 2
SPLIT_BLOCKS = (12, 13, 15)       # log2 n2 of the two-launch NTT, timed at N_LARGE
LWE_COUNT, LWE_GROUPS = 64, 4        # [lwe]: LWEs packed, and groups of them batched
APP_BITS = [30] * 4                   # [app]: the reference's app-bench chain
APP_MATMUL = (100, 105, 110)          # batch x input x output (matmul_bench.py)
APP_CONV = (4, 3, 16, 32, 32, 3, 3)   # B, Ci, Co, H, W, kh, kw (app_bench.py)
_FWD = "troy_tpu/ops/ntt_pallas.py:74, troy_tpu/ops/ntt_pallas.py:206"
_INV = "troy_tpu/ops/ntt_pallas.py:89, troy_tpu/ops/ntt_pallas.py:228"
KERNELS = {  # name: (source, the TPU kernels it replaces: K1 and K2 for the NTT)
    "ntt_forward": ("troy_tpu_torch/csrc/ntt.cu", _FWD),
    "ntt_inverse": ("troy_tpu_torch/csrc/ntt.cu", _INV),
    "ntt_forward_columns": ("troy_tpu_torch/csrc/ntt.cu", _FWD),
    "ntt_forward_blocks": ("troy_tpu_torch/csrc/ntt.cu", _FWD),
    "ntt_inverse_blocks": ("troy_tpu_torch/csrc/ntt.cu", _INV),
    "ntt_inverse_columns": ("troy_tpu_torch/csrc/ntt.cu", _INV),
    "base_convert": ("troy_tpu_torch/csrc/bconv.cu", "troy_tpu/ops/ntt_pallas.py:413"),
    "fused_negacyclic_multiply": ("troy_tpu_torch/csrc/fused_mul.cu",
                                  "troy_tpu/ops/fused_mul.py:75"),
    "tensor_product": ("troy_tpu_torch/csrc/tensor_product.cu",
                       "troy_tpu/ops/fused_mul.py:75"),
}
NTT_KERNELS = [k for k in KERNELS if k.startswith("ntt_")]


MEM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock
NTT_BUTTERFLY_OPS = 8                 # Shoup product (3) + 2 adds + 2 reductions + 1


def log(msg: str):
    print(msg, flush=True)


def bound_us(nbytes: float, ops: float) -> tuple[float, str]:
    """The launch's least time in microseconds and what sets it."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def ntt_bound(shape) -> tuple[float, str]:
    """An NTT of (..., n) int64: n values in and out, n/2 log2 n butterflies."""
    polys, n = int(np.prod(shape[:-1])), shape[-1]
    return bound_us(2 * polys * n * 8, polys * (n // 2) * (n.bit_length() - 1) * NTT_BUTTERFLY_OPS)


def bconv_bound(shape, l_out: int) -> tuple[float, str]:
    """K3 on (..., L_in, n) -> (..., L_out, n): per column a Shoup scale of
    each input (3 ops), a 64-bit multiply-add per input and output (2), one
    Barrett reduction per output (6)."""
    l_in, cols = shape[-2], int(np.prod(shape[:-2])) * shape[-1]
    return bound_us((l_in + l_out) * cols * 8, cols * (3 * l_in + 2 * l_in * l_out + 6 * l_out))


def stages_bound(shape, stages: int) -> tuple[float, str]:
    """One launch of the two-launch NTT route: every value in and out, and
    `stages` of its log2 n stages."""
    polys, n = int(np.prod(shape[:-1])), shape[-1]
    return bound_us(2 * polys * n * 8, polys * (n // 2) * stages * NTT_BUTTERFLY_OPS)


def product_bound(shape) -> tuple[float, str]:
    """The tensor product on (B, 4, L, n) -> (B, 3, L, n): 7 polynomials of
    int64 moved, four 64-bit products (about 4 int32 multiplies each), an add
    and three Barrett reductions (about 8 int32 ops each) a coefficient."""
    cols = shape[0] * shape[2] * shape[3]
    return bound_us(7 * cols * 8, cols * (4 * 4 + 2 + 3 * 8))


def fused_bound(shape) -> tuple[float, str]:
    """K4 on a, b (B, 2, L, n) -> (B, 3, L, n): 7 transforms and the
    dyadic products (about 40 ops a coefficient) per (batch, limb)."""
    polys, n = shape[0] * shape[2], shape[-1]
    ops = polys * (7 * (n // 2) * (n.bit_length() - 1) * NTT_BUTTERFLY_OPS + 40 * n)
    return bound_us(7 * polys * n * 8, ops)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


PTXAS_NAMES = {  # a part of each kernel's mangled name: the name printed
    "ntt_kernelILb0": "ntt_forward", "ntt_kernelILb1": "ntt_inverse",
    "ntt_block_kernelILb0": "ntt_forward_blocks", "ntt_block_kernelILb1": "ntt_inverse_blocks",
    "ntt_columns_kernelILi3ELb0": "ntt_forward_columns (split 3)",
    "ntt_columns_kernelILi3ELb1": "ntt_inverse_columns (split 3)",
    "ntt_columns_kernelILi4ELb0": "ntt_forward_columns (split 4)",
    "tensor_product_kernel": "tensor_product",
    "ntt_forward_radix2": "ntt_forward radix-2 yardstick",
    "ntt_inverse_radix2": "ntt_inverse radix-2 yardstick",
    "fused_mul_kernelILi13E": "fused_negacyclic_multiply at n = 8192",
    "fused_mul_radix2": "fused_negacyclic_multiply radix-2 yardstick"}


def ptxas_start(source: str) -> subprocess.Popen:
    """nvcc -Xptxas -v on one csrc/ source, started in the background."""
    from troy_tpu_torch.ops import _cuda_build

    return subprocess.Popen(
        [_cuda_build._nvcc(), *_cuda_build.COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(_cuda_build.BUILD_DIR / f"{source}.ptxas.o"), str(_cuda_build.CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_report(proc: subprocess.Popen):
    """Registers, stack and spills of each kernel of one source, as
    nvcc -Xptxas -v prints them."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"[build] nvcc -Xptxas -v failed:\n{out}\n{err}")
    current = None
    for line in err.splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in PTXAS_NAMES.items() if k in line), None)
        elif current and ("spill" in line or "registers" in line):
            log(f"[build] ptxas, {current}: {line.split(':', 1)[-1].strip()}")


def cuda_device() -> torch.device:
    return torch.device("cuda", 0)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_counts() -> dict:
    from troy_tpu_torch.ops import ntt_cuda, bconv_cuda, fused_mul_cuda

    return {**ntt_cuda.LAUNCHES, **bconv_cuda.LAUNCHES, **fused_mul_cuda.LAUNCHES}


def reset_launch_counts():
    from troy_tpu_torch.ops import ntt_cuda, bconv_cuda, fused_mul_cuda

    for mod in (ntt_cuda, bconv_cuda, fused_mul_cuda):
        mod.reset_launches()


def all_plain():
    """Every kernel dispatch of the path patched to its plain version."""
    from contextlib import ExitStack
    from troy_tpu_torch.ops import ntt as NTT, bconv as BC

    stack = ExitStack()
    stack.enter_context(mock.patch.object(NTT, "ntt_forward", NTT.ntt_forward_plain))
    stack.enter_context(mock.patch.object(NTT, "ntt_inverse", NTT.ntt_inverse_plain))
    stack.enter_context(mock.patch.object(BC, "base_convert", BC.base_convert_plain))
    return stack


def build_context(dev):
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, Q_BITS))
    parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
    return HeContext.create(parms, dev, sec_level=SecurityLevel.Nil)


def residues(shape, q: torch.Tensor, gen, factor: int = 1) -> torch.Tensor:
    """Uniform int64 residues of shape (..., L, n) below factor * q."""
    return torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                         device=q.device) % (q.view(-1, 1) * factor)


def phase_ntt(dev, tables: dict) -> dict:
    """NTT kernels vs plain, and the radix-2 yardstick of [times] too;
    returns max |err| per kernel.  The inverse also takes lazy [0, 2q).
    With a split (n > 32768) each of the two launches is also held to its
    plain partial transform."""
    from troy_tpu_torch.ops import ntt as NTT, ntt_cuda

    gen = torch.Generator(device=dev).manual_seed(1)
    err = {k: 0 for k in NTT_KERNELS}
    for label, (lead, t, lazy) in tables.items():
        shape = (*lead, t.size, t.n)
        x = residues(shape, t.q, gen, 2 if lazy else 1)
        canon = x % t.q.view(-1, 1)
        y = ntt_cuda.ntt_forward(x, t)
        y_ref = NTT.ntt_forward_plain(x, t)
        z = ntt_cuda.ntt_inverse(y, t)
        z_ref = NTT.ntt_inverse_plain(y, t)
        z_lazy = ntt_cuda.ntt_inverse(x, t)
        z_lazy_ref = NTT.ntt_inverse_plain(canon, t)
        e_f = int((y - y_ref).abs().max())
        e_i = max(int((z - z_ref).abs().max()), int((z_lazy - z_lazy_ref).abs().max()))
        if t.split:
            fwd, inv = ("ntt_forward_columns", "ntt_forward_blocks"), (
                "ntt_inverse_blocks", "ntt_inverse_columns")
            c_ref = NTT.forward_stages_plain(x, t, 0, t.split)
            b_ref = NTT.inverse_stages_plain(canon, t, t.split, t.log_n, False)
            launch_err = {
                "ntt_forward_columns": (ntt_cuda.columns(False, x, t), c_ref),
                "ntt_forward_blocks": (ntt_cuda.blocks(False, c_ref, t),
                                       NTT.forward_stages_plain(c_ref, t, t.split, t.log_n)),
                "ntt_inverse_blocks": (ntt_cuda.blocks(True, x, t), b_ref),
                "ntt_inverse_columns": (ntt_cuda.columns(True, b_ref, t),
                                        NTT.inverse_stages_plain(b_ref, t, 0, t.split, True))}
            launch_err = {k: int((a - b).abs().max()) for k, (a, b) in launch_err.items()}
            yard = f"each launch against its plain partial transform: {launch_err}"
            bad = any(launch_err.values())
            for k, e in launch_err.items():
                err[k] = max(err[k], e, e_f if k in fwd else e_i)
        else:
            fwd, inv = ("ntt_forward",), ("ntt_inverse",)
            ok = (torch.equal(ntt_cuda.run_radix2(False, x, t), y_ref)
                  and torch.equal(ntt_cuda.run_radix2(True, y, t), z_ref))
            yard, bad = f"radix-2 yardstick equal: {ok}", not ok
            err["ntt_forward"] = max(err["ntt_forward"], e_f)
            err["ntt_inverse"] = max(err["ntt_inverse"], e_i)
        torch.cuda.synchronize()
        back = bool(torch.equal(z, canon))
        log(f"[kernels] ntt {label} {shape}: forward max|err| {e_f}, "
            f"inverse max|err| {e_i}, inverse(forward(x)) == x: {back}, {yard}")
        if e_f or e_i or not back or bad:
            raise AssertionError(f"[kernels] ntt {label}: kernel disagrees with plain")
    return err


def phase_bconv(dev, cases: dict) -> int:
    """Base-conversion kernel vs plain; returns max |err|."""
    from troy_tpu_torch.ops import bconv as BC, bconv_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0
    for label, (lead, tabs) in cases.items():
        x = residues((*lead, tabs.L_in, N), tabs.q_in, gen)
        y = bconv_cuda.base_convert(x, tabs)
        y_ref = BC.base_convert_plain(x, tabs)
        torch.cuda.synchronize()
        e = int((y - y_ref).abs().max())
        in_range = bool((y < tabs.p_out.view(-1, 1)).all() and (y >= 0).all())
        log(f"[kernels] base_convert {label} {tuple(x.shape)} -> {tuple(y.shape)}: "
            f"max|err| {e}, output in [0, p): {in_range}")
        if e or not in_range or y.shape != y_ref.shape:
            raise AssertionError(f"[kernels] base_convert {label}: kernel disagrees")
        worst = max(worst, e)
    return worst


def phase_fused(dev, cases: dict) -> dict:
    """Fused tensor-product kernel vs plain on lazy [0, 2q) input, and the
    radix-2 yardstick of [times] too (n <= 32768); above, its route and the
    tensor-product kernel against dyadic_convolute.  Returns max |err| of
    K4 and of the tensor-product kernel."""
    from troy_tpu_torch.ops import dyadic as D, fused_mul as FM, fused_mul_cuda, ntt as NTT

    gen = torch.Generator(device=dev).manual_seed(4)
    err = {"fused_negacyclic_multiply": 0, "tensor_product": 0}
    for label, (lead, t) in cases.items():
        shape = (*lead, 2, t.size, t.n)
        a, b = residues(shape, t.q, gen, 2), residues(shape, t.q, gen, 2)
        c = fused_mul_cuda.fused_negacyclic_multiply(a, b, t)
        c_ref = FM.fused_negacyclic_multiply_plain(a, b, t)
        if t.split:
            y = NTT.ntt_forward_plain(torch.cat([a, b], dim=-3), t)
            e_tp = int((fused_mul_cuda.tensor_product(y, t)
                        - D.dyadic_convolute(y[..., :2, :, :], y[..., 2:, :, :], t)).abs().max())
            err["tensor_product"] = max(err["tensor_product"], e_tp)
            yard, bad = f"tensor-product kernel max|err| {e_tp}", e_tp != 0
        else:
            ok = torch.equal(fused_mul_cuda.run_radix2(a, b, t), c_ref)
            yard, bad = f"radix-2 yardstick equal: {ok}", not ok
        torch.cuda.synchronize()
        e = int((c - c_ref).abs().max())
        log(f"[kernels] fused_negacyclic_multiply {label} {shape} -> "
            f"{tuple(c.shape)}: max|err| {e}, {yard}")
        if e or c.shape != c_ref.shape or bad:
            raise AssertionError(f"[kernels] fused {label}: kernel disagrees with plain")
        err["fused_negacyclic_multiply"] = max(err["fused_negacyclic_multiply"], e)
    return err


def other_degrees(dev) -> dict:
    """NTT tables off the main path, every n = 2 to the reference's largest
    degree 131072 (above 48 KiB of dynamic shared memory from n = 4096, two
    launches from n = 65536), and n = 262144 (one limb), which the wrappers
    refuse."""
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.ops.ntt import NTTTables
    from troy_tpu_torch.utils import numth

    out = {}
    for log_n in range(1, 19):
        n = 1 << log_n
        mods = [Modulus(p) for p in numth.get_primes(2 * n, 30, 2 if n <= 131072 else 1)]
        out[n] = NTTTables(log_n, mods, dev)
    return out


def expect_refusals(label: str, fn, cases: dict):
    """fn(bad) raises the expected exception for every case, launching nothing."""
    before = launch_counts()
    for what, (bad, exc) in cases.items():
        try:
            fn(bad)
        except exc:
            continue
        raise AssertionError(f"[kernels] {label} took a {what} input")
    if launch_counts() != before:
        raise AssertionError(f"[kernels] {label}: a refused input was launched")
    log(f"[kernels] {label} refuses: {', '.join(cases)}")


def phase_refusals(dev, t, bconv_tabs, big):
    """Each wrapper raises, without launching, on input its kernel cannot take,
    a wide (40-60-bit) modulus included."""
    from troy_tpu_torch.ops import ntt_cuda, bconv_cuda, fused_mul_cuda
    from troy_tpu_torch.ops.bconv import BConvTables
    from troy_tpu_torch.ops.ntt64 import NTT64Tables
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus

    wide = NTT64Tables(t.log_n, CoeffModulus.create(t.n, WIDE_BITS[:2]), dev)
    xw = torch.zeros((2, wide.size, wide.n), dtype=torch.int64, device=dev)
    expect_refusals("ntt_forward and ntt_inverse on wide tables",
                    lambda v: ntt_cuda.ntt_forward(v, wide) + ntt_cuda.ntt_inverse(v, wide), {
                        "wide moduli": (xw, ValueError)})
    aw = torch.zeros((2, 2, wide.size, wide.n), dtype=torch.int64, device=dev)
    expect_refusals("fused_negacyclic_multiply on wide tables",
                    lambda v: fused_mul_cuda.fused_negacyclic_multiply(v, v, wide), {
                        "wide moduli": (aw, ValueError)})
    q31 = (1 << 31) - 1
    tabs31 = BConvTables([q31], [1], [bconv_tabs.p_out.tolist()[0]], [[1]], dev)
    expect_refusals("base_convert from a 31-bit input modulus",
                    lambda v: bconv_cuda.base_convert(v, tabs31), {
                        "input modulus >= 2^30": (
                            torch.zeros((2, 1, N), dtype=torch.int64, device=dev), ValueError)})

    x = torch.zeros((2, t.size, t.n), dtype=torch.int64, device=dev)
    expect_refusals("ntt_forward", lambda v: ntt_cuda.ntt_forward(v, t), {
        "int32": (x.to(torch.int32), TypeError),
        "not contiguous": (x.transpose(0, 1), ValueError),
        "wrong limb count": (x[:, :1].contiguous(), ValueError),
        "CPU tensor": (x.cpu(), ValueError)})
    expect_refusals(f"ntt_forward at n = {big.n}",
                    lambda v: ntt_cuda.ntt_forward(v, big), {
                        "n above 131072": (torch.zeros((1, big.size, big.n), dtype=torch.int64,
                                                       device=dev), ValueError)})
    xb = torch.zeros((2, bconv_tabs.L_in, N), dtype=torch.int64, device=dev)
    expect_refusals("base_convert", lambda v: bconv_cuda.base_convert(v, bconv_tabs), {
        "int32": (xb.to(torch.int32), TypeError),
        "not contiguous": (xb.transpose(0, 1), ValueError),
        "wrong limb count": (xb[:, :1].contiguous(), ValueError),
        "CPU tensor": (xb.cpu(), ValueError)})
    a = torch.zeros((2, 2, t.size, t.n), dtype=torch.int64, device=dev)
    shifted = torch.zeros(a.numel() + 1, dtype=torch.int64, device=dev)[1:].view(a.shape)
    expect_refusals("fused_negacyclic_multiply",
                    lambda v: fused_mul_cuda.fused_negacyclic_multiply(v, a, t), {
                        "int32": (a.to(torch.int32), TypeError),
                        "not contiguous": (a.transpose(0, 1), ValueError),
                        "not 16-byte aligned": (shifted, ValueError),
                        "three polynomials": (torch.zeros((2, 3, t.size, t.n), dtype=torch.int64,
                                                          device=dev), ValueError),
                        "CPU tensor": (a.cpu(), ValueError)})
    ab = torch.zeros((1, 2, big.size, big.n), dtype=torch.int64, device=dev)
    expect_refusals(f"fused_negacyclic_multiply at n = {big.n}",
                    lambda v: fused_mul_cuda.fused_negacyclic_multiply(v, v, big), {
                        "n above 131072": (ab, ValueError)})


def run_step(phase: str, label: str, fn, required) -> tuple[torch.Tensor, dict]:
    """fn() once with the launch counts set to 0 just before and read just
    after; it must launch every kernel named in required and equal the same
    call with every kernel dispatch patched to its plain version."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = launch_counts()
    log(f"[{phase}] {label} -> {tuple(out.shape)}; kernel launches {launches}")
    for name in required:
        if launches[name] == 0:
            raise AssertionError(f"[{phase}] {label} did not launch {name}")
    with all_plain():
        ref = fn()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if launch_counts() != launches:
        raise AssertionError(f"[{phase}] the plain run of {label} launched a kernel")
    if not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise AssertionError(f"[{phase}] {label}: kernel run != plain run at {bad} residues")
    log(f"[{phase}] {label} equals the all-plain run bit for bit (first kernel run "
        f"{t1 - t0:.3f} s, all-plain twin {t2 - t1:.3f} s of wall time)")
    return out, launches


def check_decrypts(phase: str, label: str, out: torch.Tensor, parms_id, expected,
                   encoder, decryptor, k3_shape=None, n: int | None = None) -> int:
    """Every ciphertext of the batch out decrypts to its row of expected;
    returns how often decrypt launched K3, which must be at least once per
    ciphertext (at k3_shape, if given)."""
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.ops import bconv as BC

    shapes = []
    convert = BC.base_convert

    def recording(x, tabs):
        shapes.append(tuple(x.shape))
        return convert(x, tabs)

    reset_launch_counts()
    with mock.patch.object(BC, "base_convert", recording):
        for b in range(out.shape[0]):
            got = encoder.decode(decryptor.decrypt(Ciphertext(out[b], parms_id)))
            got = got.cpu().numpy()
            if got.shape != (n or N,) or not np.array_equal(got, np.asarray(expected[b], np.int64)):
                raise AssertionError(f"[{phase}] {label}: ciphertext {b} decrypts wrong")
    k3 = launch_counts()["base_convert"]
    if k3 < out.shape[0]:
        raise AssertionError(f"[{phase}] {label}: decrypt launched base_convert {k3} times")
    if k3_shape is not None and k3_shape not in shapes:
        raise AssertionError(f"[{phase}] {label}: decrypt's K3 shapes {set(shapes)} "
                             f"lack {k3_shape}")
    log(f"[{phase}] {label}: all {out.shape[0]} ciphertexts decrypt right "
        f"(decrypt launched base_convert {k3} times, at {sorted(set(shapes))})")
    return k3


def rotated(msgs: np.ndarray, steps) -> np.ndarray:
    """Slots after rotate_rows(steps): each row of N/2 slots cyclically
    rotated left; after rotate_columns (steps None): the two rows swapped."""
    rows = msgs.astype(np.int64).reshape(*msgs.shape[:-1], 2, N // 2)
    rows = rows[..., ::-1, :] if steps is None else np.roll(rows, -steps, axis=-1)
    return rows.reshape(msgs.shape)


def phase_rotate(ctx, keygen, gen, encoder, decryptor, batched_ev) -> dict:
    """The batched rotations on 16 public-key ciphertexts; returns their
    steps, inputs, keys and launch counts for the later phases."""
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.ops.galois import GaloisTool

    cd = batched_ev.cd
    t0 = time.perf_counter()
    elts = sorted({GaloisTool.get_element_from_step(s, N) for s in ROT_KEY_STEPS}
                  | {GaloisTool.conjugate_element(N)})
    glk = keygen.create_galois_keys_from_elements(elts)
    pk = keygen.create_public_key()
    encryptor = Encryptor(ctx, pk=pk, generator=gen)
    msgs = np.random.default_rng(MSG_SEED + 1).integers(
        0, encoder.t.value, size=(BATCH, N), dtype=np.int64)
    d = torch.stack([encryptor.encrypt_asymmetric(encoder.encode(m)).data for m in msgs])
    torch.cuda.synchronize()
    key_shapes = {g: tuple(k.shape) for g, k in glk.keys.items()}
    log(f"[rotate] Galois keys {key_shapes} ({sum(k.numel() for k in glk.keys.values()) * 8 / 2**20:.1f} "
        f"MiB), public key {tuple(pk.data().shape)}, {BATCH} public-key ciphertexts "
        f"{tuple(d.shape)} in {time.perf_counter() - t0:.3f} s")
    steps = {"rotate_rows(1)": (batched_ev.build_rotate_rows_step(1), 1),
             "rotate_rows(3)": (batched_ev.build_rotate_rows_step(3), 3),
             "rotate_columns": (batched_ev.build_rotate_columns_step(), None)}
    out = {}
    for label, ((step, step_elts), rot) in steps.items():
        keys = tuple(glk.key(e) for e in step_elts)
        res, launches = run_step("rotate", f"{label} step {tuple(d.shape)}, {len(keys)} "
                                 f"keyswitch round(s), elements {step_elts}",
                                 lambda: step(d, keys), ("ntt_forward", "ntt_inverse"))
        check_decrypts("rotate", label, res, cd.parms_id, rotated(msgs, rot),
                       encoder, decryptor, (L_DATA, N))
        out[label] = dict(step=step, keys=keys, launches=launches, result=res)
    obj = Evaluator(ctx).rotate_rows(Ciphertext(d[0], cd.parms_id), 3, glk)
    if not torch.equal(obj.data, out["rotate_rows(3)"]["result"][0]):
        raise AssertionError("[rotate] row 0 of the batched rotate_rows(3) != "
                             "Evaluator.rotate_rows(ct, 3, glk)")
    log("[rotate] row 0 of the batched rotate_rows(3) equals Evaluator.rotate_rows(ct, 3, glk)")
    return dict(steps=out, d=d, msgs=msgs, glk=glk)


def phase_modswitch(ctx, evaluator, rot: dict, encoder, decryptor) -> dict:
    """Mod switch L = 6 -> 5, then rotate_rows(1) at L = 5."""
    from troy_tpu_torch.parallel.batched import BatchedEvaluator

    cd = ctx.first_context_data()
    ms = BatchedEvaluator(evaluator, cd).build_mod_switch_step()
    low = BatchedEvaluator(evaluator, cd.next)
    rot1, elts = low.build_rotate_rows_step(1)
    keys = tuple(rot["glk"].key(e) for e in elts)
    d5 = ms(rot["d"])
    out, launches = run_step(
        "modswitch", f"mod switch {tuple(rot['d'].shape)} -> {tuple(d5.shape)}, then "
        f"rotate_rows(1) at L = {cd.next.coeff_modulus_size}",
        lambda: rot1(ms(rot["d"]), keys), ("ntt_forward", "ntt_inverse"))
    check_decrypts("modswitch", "rotate_rows(1) after the mod switch", out,
                   cd.next.parms_id, rotated(rot["msgs"], 1), encoder, decryptor,
                   (L_DATA - 1, N))
    return dict(step=ms, launches=launches, rot1=rot1, keys=keys)


def phase_quickstart(dev, gen) -> dict:
    """examples/99_quickstart.py's flow on the card, the plaintext ops and a
    special-prime encryption, at the example's parameters."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.batch_encoder import BatchEncoder

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, QUICKSTART_BITS))
    parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
    context = HeContext.create(parms, dev, SecurityLevel.Classical128)
    reset_launch_counts()
    keygen = KeyGenerator(context, gen)
    encryptor = Encryptor(context, pk=keygen.create_public_key(), generator=gen)
    decryptor = Decryptor(context, keygen.secret_key)
    evaluator = Evaluator(context)
    encoder = BatchEncoder(context)
    t = parms.plain_modulus.value
    x = np.arange(N, dtype=np.uint64)
    y = np.arange(N, dtype=np.uint64)[::-1].copy()
    ct_x = encryptor.encrypt_asymmetric(encoder.encode(x))
    ct_y = encryptor.encrypt_asymmetric(encoder.encode(y))
    ct_sum = evaluator.add(ct_x, ct_y)
    result = encoder.decode(decryptor.decrypt(ct_sum)).cpu().numpy()
    torch.cuda.synchronize()
    launches = launch_counts()
    if not np.array_equal(result, ((x + y) % t).astype(np.int64)):
        raise AssertionError("[quickstart] the quickstart sum decrypts wrong")
    log(f"[quickstart] quickstart flow (n={N}, {QUICKSTART_BITS} bits, Classical128): public "
        f"key, encrypt_asymmetric x2, add, decrypt, decode = (x + y) mod t; slots 0..3 "
        f"{result[:4].tolist()}; kernel launches {launches}")
    for name in ("ntt_forward", "ntt_inverse", "base_convert"):
        if launches[name] == 0:
            raise AssertionError(f"[quickstart] the quickstart flow did not launch {name}")

    pid = context.first_parms_id
    p_y = encoder.encode(y)
    xy = ((x.astype(object) * y) % t).astype(np.int64)
    ntt_x = evaluator.transform_to_ntt(ct_x)
    cases = {
        "multiply_plain, coefficient form": (evaluator.multiply_plain(ct_x, p_y), xy),
        "multiply_plain, NTT form": (evaluator.transform_from_ntt(evaluator.multiply_plain(
            ntt_x, evaluator.transform_plain_to_ntt(p_y, pid))), xy),
        "add_plain": (evaluator.add_plain(ct_x, p_y), ((x + y) % t).astype(np.int64)),
    }
    parms.set_use_special_prime_for_encryption(True)
    context_sp = HeContext.create(parms, dev, SecurityLevel.Classical128)
    pk_sp = KeyGenerator(context_sp, gen, sk=keygen.secret_key).create_public_key()
    ct_sp = Encryptor(context_sp, pk=pk_sp, generator=gen).encrypt_asymmetric(encoder.encode(x))
    cases["special-prime encrypt_asymmetric"] = (ct_sp, x.astype(np.int64))
    for label, (ct, want) in cases.items():
        got = encoder.decode(decryptor.decrypt(ct)).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"[quickstart] {label} decrypts wrong")
        log(f"[quickstart] {label}: decrypts right (noise budget "
            f"{decryptor.invariant_noise_budget(ct)} bits)")
    return dict(launches=launches)


def round_stages(gpu: str, evaluator, cd, rot: dict):
    """One Galois round split into its stages, each timed alone by events:
    the gather of both polys (x -> x^g with sign), the keyswitch of c1 from
    s(x^g) back to s, and the add of the switched c0."""
    from troy_tpu_torch.ops import poly as P
    from troy_tpu_torch.ops.galois import GaloisTool

    tool, qtab, d = GaloisTool.for_context(cd), cd.qtab(), rot["d"]
    elt, conj = GaloisTool.get_element_from_step(1, N), GaloisTool.conjugate_element(N)
    key = rot["glk"].key(elt)
    g = tool.apply_coeff(d, elt, qtab)
    sw = evaluator._switch_key_impl(cd, g[:, 1], key)
    step, keys = rot["steps"]["rotate_rows(1)"]["step"], rot["steps"]["rotate_rows(1)"]["keys"]
    stages = {
        "rotate_rows(1) step, whole": lambda: step(d, keys),
        "Galois gather, element 3, both polys": lambda: tool.apply_coeff(d, elt, qtab),
        "Galois gather, conjugation, both polys": lambda: tool.apply_coeff(d, conj, qtab),
        "keyswitch of c1": lambda: evaluator._switch_key_impl(cd, g[:, 1], key),
        "add switched c0, stack": lambda: torch.stack(
            [P.add(sw[:, 0], g[:, 0], qtab), sw[:, 1]], dim=-3),
    }
    whole = None
    for label, fn in stages.items():
        fn()
        ms = cuda_ms(fn, REPS)
        whole = whole or ms
        log(f"[times] {gpu}: Galois round stage, alone: {label} {ms:.4f} ms "
            f"({100 * ms / whole:.1f}% of the whole step)")


PROFILED = {  # kernel: parts of its name in the profiler
    "ntt_forward": ("ntt_kernel<false>",), "ntt_inverse": ("ntt_kernel<true>",),
    "ntt_forward_columns": ("ntt_columns_kernel<", ", false>"),
    "ntt_inverse_columns": ("ntt_columns_kernel<", ", true>"),
    "ntt_forward_blocks": ("ntt_block_kernel<false>",),
    "ntt_inverse_blocks": ("ntt_block_kernel<true>",),
    "base_convert": ("bconv_kernel",), "fused_negacyclic_multiply": ("fused_mul_kernel",),
    "tensor_product": ("tensor_product_kernel",)}


def profile_step(fn, calls: int) -> dict:
    """Per call of fn, from the profiler's device events: kernel launches,
    device milliseconds, and each port kernel's launches and milliseconds."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            # the profiler at times drops a session's first kernel: let that be
            # this spin_kernel, which is not counted either way
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                   and "spin_kernel" not in e.key]
        if kernels:
            break
        # and at times a short session's every kernel
        log(f"[times] the profiler recorded no device kernels (attempt {attempt} of 3)")
    else:
        raise AssertionError("[times] the profiler recorded no device kernels")
    out = {"launches": sum(e.count for e in kernels) / calls,
           "ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls}
    for name, parts in PROFILED.items():
        mine = [e for e in kernels if all(p in e.key for p in parts)]
        out[name] = (sum(e.count for e in mine) / calls,
                     sum(e.self_device_time_total for e in mine) / 1e3 / calls)
    return out


def record_launches(fn) -> list:
    """fn() once with the NTT and K3 dispatch attributes recording each
    call's kernel, input shape and tables."""
    from contextlib import ExitStack
    from troy_tpu_torch.ops import ntt as NTT, bconv as BC

    calls = []

    def recording(name, impl):
        def call(x, t):
            calls.append((name, tuple(x.shape), t))
            return impl(x, t)
        return call

    with ExitStack() as stack:
        for mod, name in ((NTT, "ntt_forward"), (NTT, "ntt_inverse"), (BC, "base_convert")):
            stack.enter_context(mock.patch.object(mod, name, recording(name, getattr(mod, name))))
        fn()
    torch.cuda.synchronize()
    return calls


def launch_bound(name: str, shape, t) -> tuple[float, str]:
    """The bound of one launch of kernel `name` on a dispatch call's input."""
    if name == "base_convert":
        return bconv_bound(shape, t.L_out)
    if name.endswith("_columns"):
        return stages_bound(shape, t.split)
    if name.endswith("_blocks"):
        return stages_bound(shape, t.log_n - t.split)
    return ntt_bound(shape)


def graph_us(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device microseconds per call of fn: CUDA events around one replay of
    a CUDA graph of `launches` calls, so no host time falls between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches * 1e3


def phase_ntt_ab(gpu: str, dev, shapes: dict) -> dict:
    """The NTT kernel against the earlier radix-2 kernel, in turns (new, old,
    old, new), at each (kernel, shape) of shapes; returns
    {(name, shape): (new us, old us)}, each the lower of its two turns."""
    from troy_tpu_torch.ops import ntt_cuda

    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for (name, shape), t in shapes.items():
        inverse = name == "ntt_inverse"
        x = residues(shape, t.q, g)
        new = lambda: (ntt_cuda.ntt_inverse if inverse else ntt_cuda.ntt_forward)(x, t)
        old = lambda: ntt_cuda.run_radix2(inverse, x, t)
        n1, o1, o2, n2 = graph_us(new), graph_us(old), graph_us(old), graph_us(new)
        bound, by = ntt_bound(shape)
        new_us, old_us = min(n1, n2), min(o1, o2)
        out[(name, shape)] = (new_us, old_us)
        log(f"[times] {gpu}: {name} {shape}: register-radix kernel {n1:.3f} / {n2:.3f} us, "
            f"radix-2 yardstick {o1:.3f} / {o2:.3f} us a launch (graph of "
            f"{GRAPH_LAUNCHES}); bound {bound:.3f} us ({by}); share of the bound "
            f"{100 * bound / new_us:.1f}% against {100 * bound / old_us:.1f}%; "
            f"new <= old: {new_us <= old_us}")
    return out


def phase_fused_ab(gpu: str, dev, cases: dict) -> dict:
    """K4 against its earlier radix-2 kernel, in turns (new, old, old, new),
    on lazy [0, 2q) input at each case (lead, tables); returns
    {label: (new us, old us)}, each the lower of its two turns."""
    from troy_tpu_torch.ops import fused_mul_cuda

    g = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for label, (lead, t) in cases.items():
        shape = (*lead, 2, t.size, t.n)
        a, b = residues(shape, t.q, g, 2), residues(shape, t.q, g, 2)
        new = lambda: fused_mul_cuda.fused_negacyclic_multiply(a, b, t)
        old = lambda: fused_mul_cuda.run_radix2(a, b, t)
        n1, o1, o2, n2 = graph_us(new), graph_us(old), graph_us(old), graph_us(new)
        bound, by = fused_bound(shape)
        new_us, old_us = min(n1, n2), min(o1, o2)
        out[label] = (new_us, old_us)
        log(f"[times] {gpu}: fused_negacyclic_multiply {label} {shape}: cluster kernel "
            f"{n1:.3f} / {n2:.3f} us, radix-2 yardstick {o1:.3f} / {o2:.3f} us a launch "
            f"(graph of {GRAPH_LAUNCHES}); bound {bound:.3f} us ({by}); share of the bound "
            f"{100 * bound / new_us:.1f}% against {100 * bound / old_us:.1f}%; "
            f"{old_us / new_us:.2f}x; new <= old: {new_us <= old_us}")
    return out


def unfused_stage(a, b, t):
    """The evaluator's unfused tensor-product stage: NTT kernel,
    dyadic_convolute, NTT kernel."""
    from troy_tpu_torch.ops import dyadic as D, ntt as NTT

    return NTT.ntt_inverse(D.dyadic_convolute(NTT.ntt_forward(a, t),
                                              NTT.ntt_forward(b, t), t), t)


def ntt_totals(prof: dict) -> tuple[float, float]:
    """Launches and device ms of every NTT kernel in a profile_step result."""
    return (sum(prof[k][0] for k in NTT_KERNELS), sum(prof[k][1] for k in NTT_KERNELS))


def step_report(phase: str, gpu: str, label: str, fn, chained_ms: float, calls: int):
    """The profiler's launches, device ms and busy share of fn() against its
    chained time, and the NTT kernels' share of the bound of the NTT calls
    fn makes (one pass over each transform's values)."""
    prof = profile_step(fn, calls)
    ntt_n, ntt_ms = ntt_totals(prof)
    bound_ms = sum(ntt_bound(shape)[0] for name, shape, _ in record_launches(fn)
                   if name != "base_convert") / 1e3
    share = f"{100 * bound_ms / ntt_ms:.1f}%" if ntt_ms else "no NTT kernel in the profile"
    log(f"[{phase}] {gpu}: {label}: chained {chained_ms:.4f} ms a step; profiler, {calls} "
        f"steps: {prof['launches']:.0f} kernel launches and {prof['ms']:.4f} ms of device "
        f"kernel time a step, busy share {100 * prof['ms'] / chained_ms:.1f}%; NTT kernels "
        f"{ntt_n:.0f} launches {ntt_ms:.4f} ms against a bound of {bound_ms:.4f} ms "
        f"({share}); K3 {prof['base_convert'][0]:.0f} launches "
        f"{prof['base_convert'][1]:.4f} ms")
    return prof


NOISE_SIGMA = (21 / 2) ** 0.5  # standard deviation of the centred binomial noise


def ckks_noise(n: int, levels: int, q_max: int, q_special: int,
               scale: float = CKKS_SCALE) -> dict:
    """Expected rms of one decoded slot's error after each CKKS step, at
    `scale` (2^25 by default; a coefficient-domain error polynomial of coefficient
    deviation d gives slots of rms d sqrt(n)); at n = 1024 the port's CPU
    run gives within 3% of these for fresh, multiplied and rescaled
    ciphertexts, and 1.7x below the rotation's:
      fresh: the encryption noise e, d = sigma;
      multiply: m1 e2 + m2 e1 with m uniform(-1, 1), sqrt(2/3) fresh (the
        relinearization adds about 2^11 at scale 2^50, nothing);
      rescale: plus the division's rounding of c0 + c1 s, d = sqrt((1 + 2n/3)
        / 12), at the scale 2^50 / q_last;
      rotate: plus the keyswitch, L digits below q_max times noise over the
        special prime, d = sqrt(L n / 3) sigma q_max / q_special, and its
        division's rounding.
    digit_mean: the keyswitch's digits lie in [0, q), so their mean q/2
    times the all-ones polynomial, 2 / (1 - zeta) = about 2n / pi at the
    slot of zeta itself, puts sqrt(L) (q_max / 2) (2n / pi) sigma sqrt(n) /
    q_special / scale on that slot and its neighbours alone: the rotation's
    largest errors (2^-8.6 at n = 1024, where the CPU run's largest is
    2^-9.0)."""
    root_n = n ** 0.5
    fresh = NOISE_SIGMA * root_n / scale
    mul = (2 / 3) ** 0.5 * fresh
    rounding = ((1 + 2 * n / 3) / 12) ** 0.5
    keyswitch = (levels * n / 3) ** 0.5 * NOISE_SIGMA * q_max / q_special + rounding
    digit_mean = (levels ** 0.5 * q_max / 2 / q_special * (2 * n / np.pi) * NOISE_SIGMA
                  * root_n / scale)
    return {"mul": mul, "rounding": rounding * root_n, "digit_mean": digit_mean,
            "rotate": (fresh ** 2 + (keyswitch * root_n / scale) ** 2) ** 0.5}


def check_ckks(label: str, out: torch.Tensor, parms_id, scale: float, expected,
               rms: float, encoder, decryptor, peak: float = 0.0, phase: str = "ckks") -> float:
    """Every ciphertext of the batch out decodes to its row of expected: the
    rms slot error within 4 times the expected rms `rms`, the largest within
    32 times it plus 4 times `peak`, the expected size of a noise term that
    sits on a few slots only (ckks_noise's digit_mean); returns the largest
    slot error."""
    from troy_tpu_torch.core.ciphertext import Ciphertext

    worst, sq, count = 0.0, 0.0, 0
    for b in range(out.shape[0]):
        got = encoder.decode(decryptor.decrypt(Ciphertext(out[b], parms_id, True, scale)))
        diff = np.abs(got - expected[b])
        worst, sq, count = max(worst, float(diff.max())), sq + float((diff ** 2).sum()), count + diff.size
    got_rms = (sq / count) ** 0.5
    rms_tol, max_tol = 4 * rms, 32 * rms + 4 * peak
    log(f"[{phase}] {label}: all {out.shape[0]} ciphertexts decode (scale 2^{np.log2(scale):.2f}): "
        f"rms error 2^{np.log2(got_rms):.2f} against the tolerance 2^{np.log2(rms_tol):.2f} "
        f"(4 x the expected rms 2^{np.log2(rms):.2f}); max |err| {worst:.3e} = "
        f"2^{np.log2(worst):.2f} against {max_tol:.3e} = 2^{np.log2(max_tol):.2f} (32 x the rms"
        + (f" + 4 x the digit-mean term 2^{np.log2(peak):.2f})" if peak else ")"))
    if not (got_rms < rms_tol and worst < max_tol):
        raise AssertionError(f"[{phase}] {label}: decodes off: rms {got_rms:.3e}, "
                             f"max {worst:.3e}")
    return worst


def phase_ckks(dev, gpu: str) -> dict:
    """bench.py's CKKS configuration: AES-keyed keys and encryptions, then
    the batched multiply + relinearize, rescale, rotate_vector(1) and
    complex_conjugate, each checked, then timed."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
    from troy_tpu_torch.ops.galois import GaloisTool
    from troy_tpu_torch.parallel.batched import BatchedEvaluator
    from troy_tpu_torch.utils.random import RandomGenerator

    t0 = time.perf_counter()
    parms = EncryptionParameters(SchemeType.CKKS)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, Q_BITS))
    ctx = HeContext.create(parms, dev, SecurityLevel.Nil, seed=KEY_SEED)
    keygen = KeyGenerator(ctx, prng=RandomGenerator(KEY_SEED, "aes", "keygen"))
    rlk = keygen.create_relin_keys().key(2)
    glk = keygen.create_galois_keys_from_elements(sorted(
        {GaloisTool.get_element_from_step(1, N), GaloisTool.conjugate_element(N)}))
    encoder = CKKSEncoder(ctx)
    encryptor = Encryptor(ctx, sk=keygen.secret_key,
                          prng=RandomGenerator(KEY_SEED, "aes", "encryptor"))
    decryptor = Decryptor(ctx, keygen.secret_key)
    rng = np.random.default_rng(MSG_SEED)
    m1 = rng.uniform(-1, 1, (BATCH, encoder.slot_count))
    m2 = rng.uniform(-1, 1, (BATCH, encoder.slot_count))
    mc = m1 + 1j * m2

    def encrypt(msgs):
        return torch.stack([encryptor.encrypt_symmetric(
            encoder.encode(m, scale=CKKS_SCALE)).data for m in msgs])

    d1, d2, dc = encrypt(m1), encrypt(m2), encrypt(mc)
    torch.cuda.synchronize()
    log(f"[ckks] context n={N}, {len(Q_BITS)} x 30-bit primes, scale 2^25, seed {KEY_SEED:#x}: "
        f"secret, relin and 2 Galois keys from RandomGenerator(mode='aes', 'keygen') "
        f"({keygen.generator.counter} AES blocks), {3 * BATCH} symmetric encryptions "
        f"{tuple(d1.shape)} from its 'encryptor' stream ({encryptor.generator.counter} blocks) "
        f"in {time.perf_counter() - t0:.3f} s")
    cd = ctx.first_context_data()
    batched = BatchedEvaluator(Evaluator(ctx), cd)
    q = [m.value for m in parms.coeff_modulus]
    L = cd.coeff_modulus_size
    noise = ckks_noise(N, L, max(q[:L]), q[-1])
    mul, rescale = batched.build_mul_relin_step(rlk), batched.build_rescale_step()
    rot, rot_elts = batched.build_rotate_rows_step(1)
    conj, conj_elts = batched.build_rotate_columns_step()
    rot_keys = tuple(glk.key(e) for e in rot_elts)
    conj_keys = tuple(glk.key(e) for e in conj_elts)
    need = ("ntt_forward", "ntt_inverse")
    out, launches = {}, {}
    out["mul"], launches["mul"] = run_step(
        "ckks", f"multiply + relinearize step {tuple(d1.shape)} x {tuple(d2.shape)}",
        lambda: mul(d1, d2, rlk), need)
    check_ckks("multiply + relinearize", out["mul"], cd.parms_id, CKKS_SCALE ** 2, m1 * m2,
               noise["mul"], encoder, decryptor)
    out["rescale"], launches["rescale"] = run_step(
        "ckks", f"rescale step {tuple(out['mul'].shape)}", lambda: rescale(out["mul"]), need)
    after = CKKS_SCALE ** 2 / q[L - 1]
    check_ckks("rescale", out["rescale"], cd.next.parms_id, after, m1 * m2,
               (noise["mul"] ** 2 + (noise["rounding"] / after) ** 2) ** 0.5, encoder, decryptor)
    out["rotate"], launches["rotate"] = run_step(
        "ckks", f"rotate_vector(1) step {tuple(dc.shape)}, elements {rot_elts}",
        lambda: rot(dc, rot_keys), need)
    check_ckks("rotate_vector(1)", out["rotate"], cd.parms_id, CKKS_SCALE,
               np.roll(mc, -1, axis=-1), noise["rotate"], encoder, decryptor,
               noise["digit_mean"])
    out["conjugate"], launches["conjugate"] = run_step(
        "ckks", f"complex_conjugate step {tuple(dc.shape)}, element {conj_elts}",
        lambda: conj(dc, conj_keys), need)
    check_ckks("complex_conjugate", out["conjugate"], cd.parms_id, CKKS_SCALE, np.conj(mc),
               noise["rotate"], encoder, decryptor, noise["digit_mean"])
    ev = batched.ev
    ct0 = Ciphertext(dc[0], cd.parms_id, True, CKKS_SCALE)
    if not (torch.equal(ev.rotate_vector(ct0, 1, glk).data, out["rotate"][0])
            and torch.equal(ev.complex_conjugate(ct0, glk).data, out["conjugate"][0])):
        raise AssertionError("[ckks] row 0 of the batched rotations != Evaluator's")
    log("[ckks] row 0 of the batched rotate_vector(1) and complex_conjugate equals "
        "Evaluator.rotate_vector / complex_conjugate")

    profiles = time_steps("ckks", gpu, {  # label: (one step, chained call, first input)
        "multiply + relinearize": (lambda: mul(d1, d2, rlk), lambda d: mul(d, d2, rlk), d1),
        "rescale": (lambda: rescale(out["mul"]), None, None),
        "rotate_vector(1)": (lambda: rot(dc, rot_keys), lambda d: rot(d, rot_keys), dc),
        "complex_conjugate": (lambda: conj(dc, conj_keys), lambda d: conj(d, conj_keys), dc),
    })
    return dict(launches=launches, profiles=profiles)


def time_steps(phase: str, gpu: str, steps: dict, calls: int = PROFILE_STEPS) -> dict:
    """Each step's event-timed ms, chained (each output the next input) or,
    without a chained call, repeated on one input, and its step_report over
    `calls` profiled calls; steps: {label: (one step, chained call or None,
    first input)}."""
    profiles = {}
    for label, (fn, chain, first) in steps.items():
        for _ in range(3):
            fn()
        state = {"cur": first}

        def call(fn=fn, chain=chain):
            if chain is None:
                fn()
            else:
                state["cur"] = chain(state["cur"])

        ms = cuda_ms(call, REPS)
        profiles[label] = (ms, step_report(phase, gpu, f"{label} step, batch {BATCH}"
                                           + ("" if chain else " (repeated on one input)"),
                                           fn, ms, calls))
    return profiles


def check_bgv(label: str, out: torch.Tensor, parms_id, cf: int, expected, encoder,
              decryptor, n: int | None = None) -> int:
    """Every ciphertext of the batch out (NTT form, correction factor cf)
    decrypts through the BGV decrypt to its row of expected, launching the
    inverse NTT kernel at least once each; ciphertext 0 keeps a positive
    noise budget.  Returns the budget."""
    from troy_tpu_torch.core.ciphertext import Ciphertext

    reset_launch_counts()
    for b in range(out.shape[0]):
        got = encoder.decode(decryptor.decrypt(Ciphertext(out[b], parms_id, True,
                                                          correction_factor=cf)))
        got = got.cpu().numpy()
        if got.shape != (n or N,) or not np.array_equal(got, np.asarray(expected[b], np.int64)):
            raise AssertionError(f"[bgv] {label}: ciphertext {b} decrypts wrong")
    inv = launch_counts()["ntt_inverse"]
    if inv < out.shape[0]:
        raise AssertionError(f"[bgv] {label}: decrypt launched ntt_inverse {inv} times")
    budget = decryptor.invariant_noise_budget(Ciphertext(out[0], parms_id, True,
                                                         correction_factor=cf))
    log(f"[bgv] {label}: all {out.shape[0]} ciphertexts decrypt right with correction "
        f"factor {cf} (decrypt launched ntt_inverse {inv} times); noise budget of "
        f"ciphertext 0: {budget} bits")
    if budget <= 0:
        raise AssertionError(f"[bgv] {label}: no noise budget left")
    return budget


def phase_bgv(dev, gpu: str, bfv: dict) -> dict:
    """bench.py's chain under SchemeType.BGV: AES-keyed keys and encryptions,
    the batched multiply + relinearize, square + relinearize, rotate_rows(1),
    rotate_columns and the mod switch, each checked, then timed; the
    object-API flow of examples/4_bgv_basics.py with special-prime
    encryption; exponentiate in BGV and a 2 x 2 multiply_plain_contract in
    BFV (bfv: the main path's BFV context, encryptor, encoder, decryptor)."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.ops.galois import GaloisTool
    from troy_tpu_torch.parallel.batched import BatchedEvaluator
    from troy_tpu_torch.utils.random import RandomGenerator

    def bgv_parms(special: bool):
        parms = EncryptionParameters(SchemeType.BGV)
        parms.set_poly_modulus_degree(N)
        parms.set_coeff_modulus(CoeffModulus.create(N, Q_BITS))
        parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
        parms.set_use_special_prime_for_encryption(special)
        return parms

    t0 = time.perf_counter()
    ctx = HeContext.create(bgv_parms(False), dev, SecurityLevel.Nil, seed=KEY_SEED)
    keygen = KeyGenerator(ctx, prng=RandomGenerator(KEY_SEED, "aes", "keygen"))
    rlk_obj = keygen.create_relin_keys()
    rlk = rlk_obj.key(2)
    glk = keygen.create_galois_keys_from_elements(sorted(
        {GaloisTool.get_element_from_step(1, N), GaloisTool.conjugate_element(N)}))
    encoder = BatchEncoder(ctx)
    encryptor = Encryptor(ctx, sk=keygen.secret_key,
                          prng=RandomGenerator(KEY_SEED, "aes", "encryptor"))
    decryptor = Decryptor(ctx, keygen.secret_key)
    evaluator = Evaluator(ctx)
    t_val = encoder.t.value
    rng = np.random.default_rng(MSG_SEED)
    m1, m2, m3 = (rng.integers(0, t_val, (BATCH, N), dtype=np.int64) for _ in range(3))

    def encrypt(msgs):
        return torch.stack([encryptor.encrypt_symmetric(encoder.encode(m)).data for m in msgs])

    d1, d2, d3 = encrypt(m1), encrypt(m2), encrypt(m3)
    torch.cuda.synchronize()
    cd = ctx.first_context_data()
    log(f"[bgv] context n={N}, {len(Q_BITS)} x 30-bit primes, t={t_val}, seed {KEY_SEED:#x}: "
        f"secret, relin and 2 Galois keys from RandomGenerator(mode='aes', 'keygen') "
        f"({keygen.generator.counter} AES blocks), {3 * BATCH} symmetric encryptions "
        f"{tuple(d1.shape)} in NTT form from its 'encryptor' stream "
        f"({encryptor.generator.counter} blocks) in {time.perf_counter() - t0:.3f} s")
    batched = BatchedEvaluator(evaluator, cd)
    mul, sq = batched.build_mul_relin_step(rlk), batched.build_square_relin_step(rlk)
    rot, rot_elts = batched.build_rotate_rows_step(1)
    cols, cols_elts = batched.build_rotate_columns_step()
    down = batched.build_mod_switch_step()
    rot_keys = tuple(glk.key(e) for e in rot_elts)
    cols_keys = tuple(glk.key(e) for e in cols_elts)
    need = ("ntt_forward", "ntt_inverse")
    t = t_val
    q_last = cd.parms.coeff_modulus[-1].value
    cf_down = pow(q_last, -1, t)
    prod = (m1.astype(object) * m2 % t).astype(np.int64)
    cases = {  # label: (one step, chained call or None, parms_id, cf, expected)
        "multiply + relinearize": (lambda: mul(d1, d2, rlk), lambda d: mul(d, d2, rlk),
                                   cd.parms_id, 1, prod),
        "square + relinearize": (lambda: sq(d3, rlk), lambda d: sq(d, rlk), cd.parms_id, 1,
                                 (m3.astype(object) ** 2 % t).astype(np.int64)),
        "rotate_rows(1)": (lambda: rot(d1, rot_keys), lambda d: rot(d, rot_keys),
                           cd.parms_id, 1, rotated(m1, 1)),
        "rotate_columns": (lambda: cols(d1, cols_keys), lambda d: cols(d, cols_keys),
                           cd.parms_id, 1, rotated(m1, None)),
    }
    out, launches = {}, {}

    def check_step(label):
        fn, _, pid, cf, want = cases[label]
        out[label], launches[label] = run_step("bgv", f"{label} step {tuple(d1.shape)}", fn, need)
        check_bgv(label, out[label], pid, cf, want, encoder, decryptor)

    for label in list(cases):
        check_step(label)
    mul_out = out["multiply + relinearize"]
    # the products, L = 6 -> 5
    cases["mod switch"] = (lambda: down(mul_out), None, cd.next.parms_id, cf_down, prod)
    check_step("mod switch")
    ct0 = Ciphertext(d1[0], cd.parms_id, True)
    obj = {"rotate_rows(1)": evaluator.rotate_rows(ct0, 1, glk),
           "rotate_columns": evaluator.rotate_columns(ct0, glk),
           "mod switch": evaluator.mod_switch_to_next(Ciphertext(mul_out[0], cd.parms_id, True))}
    for label, ct in obj.items():
        if not torch.equal(ct.data, out[label][0]):
            raise AssertionError(f"[bgv] row 0 of the batched {label} != the Evaluator's")
    if obj["mod switch"].correction_factor != cf_down:
        raise AssertionError("[bgv] Evaluator.mod_switch_to_next's factor != q_last^-1 mod t")
    log(f"[bgv] row 0 of the batched rotate_rows(1), rotate_columns and mod switch equals "
        f"the Evaluator's; its mod switch's correction factor is q_last^-1 mod t = {cf_down}")

    # ---- the object-API flow of examples/4_bgv_basics.py, special prime on
    sp_ctx = HeContext.create(bgv_parms(True), dev, SecurityLevel.Nil, seed=KEY_SEED)
    sp_keygen = KeyGenerator(sp_ctx, prng=RandomGenerator(KEY_SEED, "aes", "keygen"))
    sp_ev = Evaluator(sp_ctx)
    sp_dec = Decryptor(sp_ctx, sp_keygen.secret_key)
    sp_rlk = sp_keygen.create_relin_keys()
    m = np.arange(N, dtype=np.int64)
    reset_launch_counts()
    ct = Encryptor(sp_ctx, pk=sp_keygen.create_public_key(),
                   prng=RandomGenerator(KEY_SEED, "aes", "encryptor")).encrypt_asymmetric(
        encoder.encode(m))
    sq_ct = sp_ev.relinearize(sp_ev.square(ct), sp_rlk)
    low = sp_ev.mod_switch_to_next(sq_ct)
    mixed = sp_ev.add(sq_ct, ct)
    flow = {"x^2 after relinearize + mod switch": (low, m * m % t),
            "x^2 + x (unequal factors)": (mixed, (m * m + m) % t)}
    for label, (c, want) in flow.items():
        got = encoder.decode(sp_dec.decrypt(c)).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"[bgv] 4_bgv_basics: {label} decrypts wrong")
    torch.cuda.synchronize()
    flow_launches = launch_counts()
    if not (ct.is_ntt_form and ct.correction_factor != 1
            and sq_ct.correction_factor != ct.correction_factor):
        raise AssertionError("[bgv] 4_bgv_basics: special-prime encryption left factor 1")
    for name in need:
        if flow_launches[name] == 0:
            raise AssertionError(f"[bgv] 4_bgv_basics did not launch {name}")
    log(f"[bgv] 4_bgv_basics at n={N}, special-prime encryption: public-key ct "
        f"(factor {ct.correction_factor}), square + relinearize (factor "
        f"{sq_ct.correction_factor}), mod switch (factor {low.correction_factor}), add of "
        f"factors {sq_ct.correction_factor} and {ct.correction_factor} -> "
        f"{mixed.correction_factor}; all decrypt right; kernel launches {flow_launches}")

    # ---- surface: exponentiate in BGV, a 2 x 2 multiply_plain_contract in BFV
    cube, _ = run_step("bgv", "exponentiate(ct, 3) on ciphertext 0",
                       lambda: evaluator.exponentiate(ct0, 3, rlk_obj).data[None], need)
    check_bgv("exponentiate(ct, 3)", cube, cd.parms_id, 1,
              (m1[:1].astype(object) ** 3 % t).astype(np.int64), encoder, decryptor)
    ev_b, enc_b = Evaluator(bfv["ctx"]), bfv["encoder"]
    pid_b = bfv["ctx"].first_parms_id
    xs = rng.integers(0, t, (2, 2, N), dtype=np.int64)
    ws = rng.integers(0, t, (2, 2, N), dtype=np.int64)
    grid = [[bfv["encryptor"].encrypt_symmetric(enc_b.encode(x)) for x in row] for row in xs]
    plains = [[enc_b.encode(w) for w in row] for row in ws]
    contract, _ = run_step("bgv", "BFV multiply_plain_contract, 2 x 2 blocks",
                           lambda: torch.stack([o.data for row in ev_b.multiply_plain_contract(
                               grid, plains) for o in row]), need)
    want = np.stack([sum(xs[b, i].astype(object) * ws[i, j] for i in range(2)) % t
                     for b in range(2) for j in range(2)]).astype(np.int64)
    check_decrypts("bgv", "BFV multiply_plain_contract out[b][j] = sum_i x[b][i] w[i][j]",
                   contract, pid_b, want, enc_b, bfv["decryptor"])

    profiles = time_steps("bgv", gpu, {
        label: (fn, chain, d3 if label.startswith("square") else d1)
        for label, (fn, chain, _, _, _) in cases.items()})
    return dict(launches=launches, profiles=profiles)


def phase_large_n(dev, gpu: str, degrees: dict) -> dict:
    """BFV multiply + relinearize at n = 65536 through the two-launch NTT,
    K4's large route at its entry point, then each large-n launch timed."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.parallel.batched import BatchedEvaluator
    from troy_tpu_torch.ops import (dyadic as D, fused_mul as FM, fused_mul_cuda,
                                    ntt as NTT, ntt_cuda)

    t0 = time.perf_counter()
    n = N_LARGE
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, LARGE_BITS))
    parms.set_plain_modulus(PlainModulus.batching(n, LOG_T))
    ctx = HeContext.create(parms, dev, SecurityLevel.Nil)
    cd = ctx.first_context_data()
    gen = torch.Generator(device=dev).manual_seed(KEY_SEED)
    keygen = KeyGenerator(ctx, gen)
    rlk = keygen.create_relin_keys().key(2)
    encryptor = Encryptor(ctx, keygen.secret_key, gen)
    decryptor = Decryptor(ctx, keygen.secret_key)
    encoder = BatchEncoder(ctx)
    t_val = encoder.t.value
    msgs = np.random.default_rng(MSG_SEED + 2).integers(0, t_val, size=(2 * LARGE_BATCH, n),
                                                        dtype=np.int64)
    cts = [encryptor.encrypt_symmetric(encoder.encode(m)).data for m in msgs]
    d1, d2 = torch.stack(cts[:LARGE_BATCH]), torch.stack(cts[LARGE_BATCH:])
    expected = (msgs[:LARGE_BATCH].astype(object) * msgs[LARGE_BATCH:]) % t_val
    batched = BatchedEvaluator(Evaluator(ctx), cd)
    tool, qtab = cd.rns_tool, cd.qtab()
    bsk = tool.bsk_ntt
    torch.cuda.synchronize()
    log(f"[large_n] context n={n} L={cd.coeff_modulus_size} |Bsk|={bsk.size} t={t_val}, "
        f"NTT split {qtab.split} (blocks of {1 << qtab.block_log_n}), keys and "
        f"{2 * LARGE_BATCH} encryptions in {time.perf_counter() - t0:.3f} s")
    step = batched.build_mul_relin_step(rlk)
    need = ("ntt_forward_columns", "ntt_forward_blocks", "ntt_inverse_blocks",
            "ntt_inverse_columns", "base_convert")
    out, launches = run_step("large_n", f"HPS step {tuple(d1.shape)} x {tuple(d2.shape)}",
                             lambda: step(d1, d2, rlk), need)
    check_decrypts("large_n", "HPS products m1 * m2 mod t", out, cd.parms_id, expected,
                   encoder, decryptor, n=n)
    budget = decryptor.invariant_noise_budget(Ciphertext(out[0], cd.parms_id))
    log(f"[large_n] noise budget of product 0: {budget} bits")
    if budget <= 0:
        raise AssertionError("[large_n] product has no noise budget left")

    lift = {k: tool.fast_b_conv_hps(d) for k, d in (("d1", d1), ("d2", d2))}
    torch.cuda.synchronize()
    reset_launch_counts()
    fused_q = FM.fused_negacyclic_multiply(d1, d2, qtab)
    fused_b = FM.fused_negacyclic_multiply(lift["d1"], lift["d2"], bsk)
    torch.cuda.synchronize()
    k4 = launch_counts()
    log(f"[large_n] tensor-product stage through K4's large route: launches {k4}")
    if k4["tensor_product"] != 2 or k4["fused_negacyclic_multiply"]:
        raise AssertionError("[large_n] K4 did not take its large route twice")
    if not (torch.equal(fused_q, unfused_stage(d1, d2, qtab))
            and torch.equal(fused_b, unfused_stage(lift["d1"], lift["d2"], bsk))):
        raise AssertionError("[large_n] K4 != the unfused tensor-product stage")
    if not torch.equal(tool.fast_floor_scale_fast_b_conv_sk(fused_q, fused_b),
                       batched.multiply(d1, d2)):
        raise AssertionError("[large_n] the floor of K4's stage != the HPS multiply")
    log("[large_n] K4's large route equals the unfused stage over q and Bsk, and its "
        "floor equals the HPS multiply")
    for _ in range(2):
        step(d1, d2, rlk)
    state = {"cur": d1}

    def chained():
        state["cur"] = step(state["cur"], d2, rlk)

    ms = cuda_ms(chained, 5)
    profile = step_report("large_n", gpu, f"HPS multiply + relinearize step, batch {LARGE_BATCH}",
                          lambda: step(d1, d2, rlk), ms, 2)
    calls = record_launches(lambda: step(d1, d2, rlk))

    # each large-n launch alone, by CUDA graphs, beside its bound
    g = torch.Generator(device=dev).manual_seed(8)
    times = {}
    for deg in LARGE_DEGREES:
        t = degrees[deg]
        shape = (3, t.size, deg)
        x = residues(shape, t.q, g)
        ab = residues((3, 4, t.size, deg), t.q, g)
        a2, b2 = ab[:, :2].contiguous(), ab[:, 2:].contiguous()
        split, log_n = t.split, t.log_n
        cases = {
            "ntt_forward_columns": (lambda: ntt_cuda.columns(False, x, t),
                                    lambda: NTT.forward_stages_plain(x, t, 0, split),
                                    stages_bound(shape, split)),
            "ntt_forward_blocks": (lambda: ntt_cuda.blocks(False, x, t),
                                   lambda: NTT.forward_stages_plain(x, t, split, log_n),
                                   stages_bound(shape, log_n - split)),
            "ntt_inverse_blocks": (lambda: ntt_cuda.blocks(True, x, t),
                                   lambda: NTT.inverse_stages_plain(x, t, split, log_n, False),
                                   stages_bound(shape, log_n - split)),
            "ntt_inverse_columns": (lambda: ntt_cuda.columns(True, x, t),
                                    lambda: NTT.inverse_stages_plain(x, t, 0, split, True),
                                    stages_bound(shape, split)),
            "ntt_forward (two launches)": (lambda: ntt_cuda.ntt_forward(x, t),
                                           lambda: NTT.ntt_forward_plain(x, t), ntt_bound(shape)),
            "ntt_inverse (two launches)": (lambda: ntt_cuda.ntt_inverse(x, t),
                                           lambda: NTT.ntt_inverse_plain(x, t), ntt_bound(shape)),
            "tensor_product": (lambda: fused_mul_cuda.tensor_product(ab, t),
                               lambda: D.dyadic_convolute(ab[:, :2], ab[:, 2:], t),
                               product_bound((3, 4, t.size, deg))),
            "fused_negacyclic_multiply (large route, 5 launches)": (
                lambda: fused_mul_cuda.fused_negacyclic_multiply(a2, b2, t),
                lambda: FM.fused_negacyclic_multiply_plain(a2, b2, t),
                fused_bound((3, 2, t.size, deg))),
        }
        for label, (kernel, plain, (bound, by)) in cases.items():
            us, plain_us = graph_us(kernel), graph_us(plain, PLAIN_REPS)
            times[(label, deg)] = (us / 1e3, plain_us / 1e3, bound / 1e3, by)
            arg = {"tensor_product": tuple(ab.shape)}.get(
                label, tuple(a2.shape) if label.startswith("fused") else shape)
            log(f"[large_n] {gpu}: {label} at {arg}: kernel {us:.3f} us, plain "
                f"{plain_us:.3f} us a call (graph); bound {bound:.3f} us ({by}), share "
                f"{100 * bound / us:.1f}%")
    # the block size of the route at N_LARGE, in turns (a, b, c, c, b, a), at
    # (3, 2, n) and at the step's keyswitch digits (batch, L, L + 1, n)
    log_n = N_LARGE.bit_length() - 1
    cases = {"(3, 2, n)": ((3,), degrees[N_LARGE].moduli),
             "the step's digits": ((LARGE_BATCH, cd.coeff_modulus_size),
                                   ctx.key_context_data().parms.coeff_modulus)}
    for label, (lead, mods) in cases.items():
        by_split = {}
        for log_b in SPLIT_BLOCKS:
            t = NTT.NTTTables(log_n, mods, dev, split=log_n - log_b)
            x = residues((*lead, t.size, N_LARGE), t.q, g)
            by_split[log_b] = (lambda t=t, x=x: ntt_cuda.ntt_inverse(ntt_cuda.ntt_forward(x, t), t))
        got = {}
        for log_b in list(SPLIT_BLOCKS) + list(SPLIT_BLOCKS)[::-1]:
            got.setdefault(log_b, []).append(graph_us(by_split[log_b], 20))
        del by_split
        shape = (*lead, len(mods), N_LARGE)
        bound = 2 * ntt_bound(shape)[0]
        log(f"[large_n] {gpu}: forward + inverse NTT at {shape} ({label}) by block size, in "
            "turns: " + "; ".join(
                f"blocks of {1 << b} (split {log_n - b}): {' / '.join(f'{v:.3f}' for v in got[b])} "
                f"us, share of the one-pass bound {100 * bound / min(got[b]):.1f}%"
                for b in SPLIT_BLOCKS))
    return dict(launches=launches, k4=k4, times=times, profile=profile, calls=calls)


def aes_context(dev, scheme: str, bits):
    """A context at N on `bits` under `scheme` (t = PlainModulus.batching(N,
    20) but for CKKS), seed KEY_SEED, with its keygen and encryptor drawn
    from the RandomGenerator(KEY_SEED, mode="aes") streams."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.utils.random import RandomGenerator

    parms = EncryptionParameters(SchemeType[scheme])
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, bits))
    if scheme != "CKKS":
        parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
    ctx = HeContext.create(parms, dev, SecurityLevel.Nil, seed=KEY_SEED)
    keygen = KeyGenerator(ctx, prng=RandomGenerator(KEY_SEED, "aes", "keygen"))
    encryptor = Encryptor(ctx, sk=keygen.secret_key, pk=keygen.create_public_key(),
                          prng=RandomGenerator(KEY_SEED, "aes", "encryptor"))
    return dict(ctx=ctx, keygen=keygen, encryptor=encryptor,
                decryptor=Decryptor(ctx, keygen.secret_key), ev=Evaluator(ctx))


def mib(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 2 ** 20


def flow_report(phase: str, gpu: str, label: str, fn, reps: int = 3) -> dict:
    """A flow's event-timed ms per call (repeated on one input) and its
    step_report: profiler launches, device ms, busy share, NTT launches."""
    fn()
    ms = cuda_ms(fn, reps)
    return dict(ms=ms, prof=step_report(phase, gpu, f"{label} (repeated on one input)", fn,
                                        ms, 1))


def phase_lwe(dev, gpu: str) -> dict:
    """bench.py's BFV chain: extract LWE_COUNT coefficients of one encryption
    and pack them, then LWE_GROUPS groups of them as one stacked tree."""
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext

    t0 = time.perf_counter()
    s = aes_context(dev, "BFV", Q_BITS)
    ctx, ev, decryptor = s["ctx"], s["ev"], s["decryptor"]
    glk = s["keygen"].create_automorphism_keys()
    encoder = BatchEncoder(ctx)
    t_val = encoder.t.value
    coeffs = np.random.default_rng(MSG_SEED).integers(0, t_val, N, dtype=np.uint64)
    ct = s["encryptor"].encrypt_asymmetric(encoder.encode_polynomial(coeffs))
    pid = ctx.first_parms_id
    torch.cuda.synchronize()
    keys = list(glk.keys.values())
    log(f"[lwe] context n={N}, {len(Q_BITS)} x 30-bit primes, t={t_val}, seed {KEY_SEED:#x}: "
        f"{len(keys)} automorphism keys (elements {sorted(glk.keys)}) of "
        f"{tuple(keys[0].shape)} int64, {mib(keys):.1f} MiB on the card, and one public-key "
        f"encryption of {N} coefficients in {time.perf_counter() - t0:.3f} s")

    def extract(g):
        return [ev.extract_lwe(ct, g * LWE_COUNT + i) for i in range(LWE_COUNT)]

    need = ("ntt_forward", "ntt_inverse")
    seq, seq_launches = run_step(
        "lwe", f"extract_lwe x {LWE_COUNT} + pack_lwe_ciphertexts ({LWE_COUNT - 1} merges, "
        f"{N.bit_length() - 1 - (LWE_COUNT - 1).bit_length()} trace rounds)",
        lambda: ev.pack_lwe_ciphertexts(extract(0), glk).data[None], need)
    bat, bat_launches = run_step(
        "lwe", f"pack_lwe_ciphertexts_batched, {LWE_GROUPS} groups of {LWE_COUNT} stacked",
        lambda: torch.stack([o.data for o in ev.pack_lwe_ciphertexts_batched(
            [extract(g) for g in range(LWE_GROUPS)], glk)]), need)
    if not torch.equal(bat[0], seq[0]):
        raise AssertionError("[lwe] group 0 of the batched pack != the sequential pack")
    log("[lwe] group 0 of the batched pack equals the sequential pack bit for bit")
    stride = N // LWE_COUNT
    budgets = []
    for label, out in (("sequential", seq), ("batched", bat)):
        for g in range(out.shape[0]):
            packed = Ciphertext(out[g], pid)
            got = encoder.decode_polynomial(decryptor.decrypt(packed))
            want = coeffs[g * LWE_COUNT:(g + 1) * LWE_COUNT]
            if not np.array_equal(got[::stride], want):
                raise AssertionError(f"[lwe] {label} pack {g} decrypts wrong")
            budgets.append(decryptor.invariant_noise_budget(packed))
    log(f"[lwe] every packed ciphertext decrypts to its {LWE_COUNT} extracted coefficients "
        f"at stride {stride}; noise budgets {budgets} bits")
    if min(budgets) <= 0:
        raise AssertionError("[lwe] a packed ciphertext has no noise budget left")
    flows = {
        "pack_lwe_ciphertexts": flow_report(
            "lwe", gpu, f"extract + pack of {LWE_COUNT} LWEs",
            lambda: ev.pack_lwe_ciphertexts(extract(0), glk)),
        "pack_lwe_ciphertexts_batched": flow_report(
            "lwe", gpu, f"extract + batched pack, {LWE_GROUPS} x {LWE_COUNT} LWEs",
            lambda: ev.pack_lwe_ciphertexts_batched([extract(g) for g in range(LWE_GROUPS)],
                                                    glk))}
    return dict(launches={"seq": seq_launches, "batched": bat_launches}, flows=flows)


def app_ckks_rms(inputs: int, out_block: int) -> float:
    """Expected rms of one decoded CKKS matmul output (at scale^2) after the
    pack: the fresh noise e of each input block (deviation NOISE_SIGMA) times
    the weight polynomials, whose inputs x out_block nonzero coefficients in
    an output's column are uniform(-1, 1) at CKKS_SCALE (variance 1/3), plus
    the rounding of the encodings (1/12 a coefficient, on at most as many
    terms); the packing's keyswitches add about 2^8 at scale 2^50 a round,
    below 2^-40 in the output, and its division by the input block is undone
    exactly on the payload.  At n = 8192, 105 inputs and output blocks of 5
    this is 43 / 2^25 = 1.3e-6."""
    terms = inputs * out_block
    return (NOISE_SIGMA ** 2 * terms / 3 + 2 * terms / 36) ** 0.5 / CKKS_SCALE


def phase_app(dev, gpu: str) -> dict:
    """The reference's app-bench sizes on a 4 x 30-bit chain: the BFV and
    CKKS BumbleBee matmul 100 x 105 x 110 with pack_lwe (EncryptLeft), and
    the BFV Cheetah conv2d of the CIFAR-like layer."""
    from troy_tpu_torch.app.cipher2d import Cipher2d
    from troy_tpu_torch.app.conv2d import Conv2dHelper
    from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter, CKKSEncoderAdapter
    from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.core.ckks_encoder import CKKSEncoder

    need = ("ntt_forward", "ntt_inverse")
    rng = np.random.default_rng(MSG_SEED)
    launches, flows = {}, {}
    B, I, O = APP_MATMUL
    t0 = time.perf_counter()
    bfv = aes_context(dev, "BFV", APP_BITS)
    bfv_glk = bfv["keygen"].create_automorphism_keys()
    encoder = BatchEncoder(bfv["ctx"])
    t_val = encoder.t.value
    adapter = BatchEncoderAdapter(encoder)
    ev, pid = bfv["ev"], bfv["ctx"].first_parms_id
    torch.cuda.synchronize()
    keys = list(bfv_glk.keys.values())
    log(f"[app] BFV context n={N}, {len(APP_BITS)} x 30-bit primes, t={t_val}, seed "
        f"{KEY_SEED:#x}: {len(keys)} automorphism keys of {tuple(keys[0].shape)} int64, "
        f"{mib(keys):.1f} MiB, in {time.perf_counter() - t0:.3f} s")

    def packed_matmul(helper, x_enc, w_enc, glk, ev):
        return torch.stack([c.data for c in helper.pack_outputs(
            ev, glk, helper.matmul(ev, x_enc, w_enc))[0]])

    # ---- 1. BFV matmul, pack_lwe
    helper = MatmulHelper(B, I, O, N, MatmulObjective.EncryptLeft, pack_lwe=True)
    x = rng.integers(0, t_val, (B, I), dtype=np.int64)
    w = rng.integers(0, t_val, (I, O), dtype=np.int64)
    x_enc = helper.encrypt_inputs(bfv["encryptor"], adapter, x)
    w_enc = helper.encode_weights(adapter, w)
    bs, is_, os_ = helper._counts()
    groups = [min(helper.input_block, bs * os_ - g) for g in range(0, bs * os_, helper.input_block)]
    log(f"[app] BFV matmul {B} x {I} x {O}, pack_lwe: blocks (batch, input, output) = "
        f"({helper.batch_block}, {helper.input_block}, {helper.output_block}); "
        f"multiply_plain_contract of {bs} x {is_} input ciphertexts by {is_} x {os_} weight "
        f"plaintexts ({mib(c.data for row in x_enc.data for c in row):.1f} MiB and "
        f"{mib(p.data for row in w_enc.data for p in row):.1f} MiB on the card), then "
        f"pack_outputs of {bs * os_} outputs in groups {groups}")
    label = f"BFV matmul {B} x {I} x {O} + pack_outputs"
    out, launches["bfv_matmul"] = run_step(
        "app", label, lambda: packed_matmul(helper, x_enc, w_enc, bfv_glk, ev), need)
    packed = Cipher2d([[Ciphertext(o, pid) for o in out]])
    dec = helper.decrypt_outputs(adapter, bfv["decryptor"], packed)
    if not np.array_equal(dec.astype(np.int64), (x @ w) % t_val):
        raise AssertionError(f"[app] {label} decrypts wrong")
    budgets = [bfv["decryptor"].invariant_noise_budget(c) for c in packed[0]]
    log(f"[app] {label}: decrypts to x @ w mod t exactly; noise budgets {budgets} bits")
    if min(budgets) <= 0:
        raise AssertionError(f"[app] {label}: no noise budget left")
    flows["bfv_matmul"] = flow_report(
        "app", gpu, label, lambda: packed_matmul(helper, x_enc, w_enc, bfv_glk, ev))

    # ---- 2. CKKS matmul, pack_lwe (from NTT form, merge, back to NTT form)
    t0 = time.perf_counter()
    ckks = aes_context(dev, "CKKS", APP_BITS)
    ckks_glk = ckks["keygen"].create_automorphism_keys()
    cenc = CKKSEncoder(ckks["ctx"])
    cad = CKKSEncoderAdapter(cenc, CKKS_SCALE)
    xf, wf = rng.uniform(-1, 1, (B, I)), rng.uniform(-1, 1, (I, O))
    cx_enc = helper.encrypt_inputs(ckks["encryptor"], cad, xf)
    cw_enc = helper.encode_weights(cad, wf)
    torch.cuda.synchronize()
    log(f"[app] CKKS context (the same chain, scale 2^25): keys and {bs * is_} encryptions "
        f"in {time.perf_counter() - t0:.3f} s; weights {mib(p.data for row in cw_enc.data for p in row):.1f} "
        f"MiB in NTT form")
    label = f"CKKS matmul {B} x {I} x {O} + pack_outputs"
    out, launches["ckks_matmul"] = run_step(
        "app", label, lambda: packed_matmul(helper, cx_enc, cw_enc, ckks_glk, ckks["ev"]), need)
    cpid = ckks["ctx"].first_parms_id
    cpacked = Cipher2d([[Ciphertext(o, cpid, True, CKKS_SCALE ** 2) for o in out]])
    if not all(c.is_ntt_form for c in cpacked[0]):
        raise AssertionError(f"[app] {label}: packed outputs left the NTT form")
    got = helper.decrypt_outputs(CKKSEncoderAdapter(cenc, CKKS_SCALE ** 2), ckks["decryptor"],
                                 cpacked)
    err = np.abs(got - xf @ wf)
    rms = app_ckks_rms(I, helper.output_block)
    got_rms, worst = float(np.sqrt((err ** 2).mean())), float(err.max())
    log(f"[app] {label}: decodes (scale 2^50) with rms error {got_rms:.3e} against the "
        f"tolerance {4 * rms:.3e} (4 x the expected rms {rms:.3e}) and max |err| {worst:.3e} "
        f"against {32 * rms:.3e} (32 x)")
    if not (got_rms < 4 * rms and worst < 32 * rms):
        raise AssertionError(f"[app] {label}: decodes off")
    flows["ckks_matmul"] = flow_report(
        "app", gpu, label, lambda: packed_matmul(helper, cx_enc, cw_enc, ckks_glk, ckks["ev"]))

    # ---- 3. BFV conv2d, the CIFAR-like layer
    Bc, Ci, Co, H, W, kh, kw = APP_CONV
    conv = Conv2dHelper(Bc, Ci, Co, H, W, kh, kw, N, MatmulObjective.EncryptLeft)
    xc = rng.integers(0, t_val, (Bc, Ci, H, W), dtype=np.int64)
    kc = rng.integers(0, t_val, (Co, Ci, kh, kw), dtype=np.int64)
    xc_enc = conv.encrypt_inputs(bfv["encryptor"], adapter, xc)
    kc_enc = conv.encode_weights(adapter, kc)
    total, ocg, icg = conv._groups()
    log(f"[app] BFV conv2d B={Bc} {Ci} -> {Co} channels, {H} x {W}, {kh} x {kw} kernels: blocks "
        f"(batch, height, width, in, out) = ({conv.batch_block}, {conv.image_height_block}, "
        f"{conv.image_width_block}, {conv.input_channel_block}, {conv.output_channel_block}), "
        f"{total} batch tile(s); multiply_plain_contract of {total} x {icg} inputs by "
        f"{icg} x {ocg} weights")
    label = f"BFV conv2d {Bc} x {Ci} x {H} x {W} -> {Co}"
    out, launches["bfv_conv2d"] = run_step(
        "app", label, lambda: torch.stack([c.data for row in conv.conv2d(ev, xc_enc, kc_enc).data
                                           for c in row]), need)
    convolved = Cipher2d([[Ciphertext(out[e * ocg + j], pid) for j in range(ocg)]
                          for e in range(total)])
    dec = conv.decrypt_outputs(adapter, bfv["decryptor"], convolved)
    windows = np.lib.stride_tricks.sliding_window_view(xc, (kh, kw), axis=(2, 3))
    want = np.einsum("bchwij,ocij->bohw", windows, kc) % t_val
    if not np.array_equal(dec.astype(np.int64), want):
        raise AssertionError(f"[app] {label} decrypts wrong")
    log(f"[app] {label}: decrypts to the valid convolution mod t exactly, "
        f"{dec.shape} outputs")
    flows["bfv_conv2d"] = flow_report(
        "app", gpu, label, lambda: conv.conv2d(ev, xc_enc, kc_enc))
    return dict(launches=launches, flows=flows)


CLIENT_STEPS = 3                      # [client]: chained calls of each BatchedClient step
THREEFRY_KNOWN = [  # (key, counter) -> output of Threefry-2x32-20, as jax.random's tests hold it
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3), (0xc4923a9c, 0x483df7a0)),
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1cb996fc, 0xbb002be7))]


def seeded_context(dev, scheme: str, bits) -> dict:
    """A context at N on `bits` under `scheme` (t = PlainModulus.batching(N,
    20) but for CKKS), seed KEY_SEED; its keygen, and every encryptor made
    from it, draw from the context's default threefry streams."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator

    parms = EncryptionParameters(SchemeType[scheme])
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, bits))
    if scheme != "CKKS":
        parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
    ctx = HeContext.create(parms, dev, SecurityLevel.Nil, seed=KEY_SEED)
    keygen = KeyGenerator(ctx)
    return dict(ctx=ctx, keygen=keygen, decryptor=Decryptor(ctx, keygen.secret_key),
                ev=Evaluator(ctx))


def threefry_report(phase: str, gpu: str, label: str, fn) -> dict:
    """Threefry alone (fn draws the words a path draws): event-timed ms a
    call, the profiler's launches and device time, and the busy share."""
    fn()
    ms = cuda_ms(fn, 3)
    prof = profile_step(fn, 2)
    log(f"[{phase}] {gpu}: threefry, {label}: {ms:.4f} ms a call; profiler: "
        f"{prof['launches']:.0f} launches and {prof['ms']:.4f} ms of device time a call, "
        f"busy {100 * prof['ms'] / ms:.1f}%")
    return dict(ms=ms, launches=prof["launches"], device_ms=prof["ms"])


def centred_coeffs(pt, cd) -> np.ndarray:
    """A plaintext's integer coefficients, centred (host CRT)."""
    from troy_tpu_torch.ops import ntt as NTT

    arr = NTT.ntt_inverse(pt.data.contiguous(), cd.qtab()).cpu().numpy()
    comp = np.array(cd.base_q.compose_array_host(arr), dtype=object)
    return np.where(comp > cd.base_q.prod // 2, comp - cd.base_q.prod, comp)


def phase_client(dev, gpu: str) -> dict:
    """Threefry on the card; BatchedClient's steps at bench.py's BFV chain,
    chained; the device CKKS encoder at bench.py's CKKS configuration."""
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.plaintext import Plaintext
    from troy_tpu_torch.parallel.batched import BatchedClient
    from troy_tpu_torch.utils import random as R

    # ---- threefry's known answers and the card's bits against the CPU's
    for k, x, y in THREEFRY_KNOWN:
        got = R.threefry2x32(*(torch.tensor(v, device=dev) for v in (*k, *x)))
        if tuple(int(v) for v in got) != y:
            raise AssertionError(f"[client] threefry2x32{k}{x} = {got} on the card, not {y}")
    shape = (2, BATCH, L_DATA, N)
    key = R.fold_in(R.key(KEY_SEED), torch.tensor(7, device=dev))
    card = R.bits(key, shape, dev)
    host = R.bits(tuple(int(v) for v in key), shape, "cpu")
    if not torch.equal(card.cpu(), host):
        raise AssertionError(f"[client] threefry bits at {shape}: the card's != the CPU's")
    log(f"[client] threefry2x32's three known answers on the card; bits {shape} under a key "
        f"folded with a device counter equal the CPU's ({card.numel()} words)")

    # ---- BatchedClient at bench.py's BFV chain
    rng = np.random.default_rng(MSG_SEED + 2)
    t0 = time.perf_counter()
    s = seeded_context(dev, "BFV", Q_BITS)
    ctx, keygen = s["ctx"], s["keygen"]
    cd = ctx.first_context_data()
    encoder = BatchEncoder(ctx)
    pk = keygen.create_public_key()
    client = BatchedClient(ctx, cd)
    base_keys = R.RandomGenerator(KEY_SEED, domain="bench").base_keys
    t_val = encoder.t.value
    vals = torch.from_numpy(rng.integers(0, t_val, (BATCH, N), dtype=np.int64)).to(dev)
    torch.cuda.synchronize()
    log(f"[client] BFV context n={N}, {len(Q_BITS)} x 30-bit primes, seed {KEY_SEED:#x}: secret "
        f"and public key from the context's threefry stream ({keygen.generator.counter} draws) "
        f"in {time.perf_counter() - t0:.3f} s")
    launches = {}
    encode, decode = client.build_batch_encode_step(encoder), client.build_batch_decode_step(encoder)
    coeffs, launches["encode"] = run_step(
        "client", f"batch encode step {tuple(vals.shape)} (inverse NTT mod t)",
        lambda: encode(vals), ("ntt_inverse",))
    back, launches["decode"] = run_step(
        "client", f"batch decode step {tuple(coeffs.shape)} (forward NTT mod t)",
        lambda: decode(coeffs), ("ntt_forward",))
    if not torch.equal(back, vals):
        raise AssertionError("[client] batch decode(encode(v)) != v")
    plain = coeffs[:1]  # the steps add one message to every ciphertext, as the JAX steps do
    steps = {"symmetric": (client.build_encrypt_symmetric_step(base_keys, plain),
                           keygen.secret_key.data, ("ntt_inverse",)),
             "asymmetric": (client.build_encrypt_asymmetric_step(base_keys, plain),
                            pk.data(), ("ntt_forward", "ntt_inverse"))}
    start = residues((BATCH, 2, L_DATA, N), cd.qtab().q, torch.Generator(device=dev).manual_seed(3))
    decrypt = client.build_decrypt_step([keygen.secret_key.data])

    def chain(step, arg):
        cur, outs = start, []
        for _ in range(CLIENT_STEPS):
            cur = step(cur, arg)
            outs.append(cur)
        return torch.stack(outs)

    for label, (step, arg, need) in steps.items():
        outs, launches[label] = run_step(
            "client", f"encrypt_{label} step, {CLIENT_STEPS} chained calls of batch {BATCH}",
            lambda: chain(step, arg), need)
        for i in range(CLIENT_STEPS):
            m = decrypt(outs[i])
            got = decode(m)
            if not (torch.equal(m, plain.expand_as(m)) and torch.equal(got, vals[:1].expand_as(got))):
                raise AssertionError(f"[client] chained {label} batch {i} decrypts wrong")
        if any(torch.equal(outs[i][:, 1], outs[i + 1][:, 1]) for i in range(CLIENT_STEPS - 1)):
            raise AssertionError(f"[client] chained {label} batches share their c1")
        log(f"[client] every one of the {CLIENT_STEPS} chained {label} batches decrypts to the "
            f"message and decodes to its slots; no two share a c1")
    m, launches["decrypt"] = run_step(
        "client", f"decrypt step {tuple(start.shape)}", lambda: decrypt(outs[-1]),
        ("ntt_forward", "ntt_inverse", "base_convert"))
    timed = time_steps("client", gpu, {
        "encrypt_symmetric": (lambda: steps["symmetric"][0](start, keygen.secret_key.data),
                              lambda d: steps["symmetric"][0](d, keygen.secret_key.data), start),
        "encrypt_asymmetric": (lambda: steps["asymmetric"][0](start, pk.data()),
                               lambda d: steps["asymmetric"][0](d, pk.data()), start),
        "decrypt": (lambda: decrypt(outs[-1]), None, None),
        "batch encode": (lambda: encode(vals), None, None),
        "batch decode": (lambda: decode(coeffs), None, None)},
        calls=1)  # an encrypt step makes 1800-2600 launches: one call profiles enough
    threefry = {"encrypt_symmetric draws": threefry_report(
        "client", gpu, f"the symmetric step's draws, uniform {(2, BATCH, L_DATA, N)} and CBD "
        f"{(2, BATCH, N)} words, two keys each",
        lambda: (R._bits2(base_keys, (2, BATCH, L_DATA, N), dev),
                 R._bits2(base_keys, (2, BATCH, N), dev)))}

    # ---- the device CKKS encoder at bench.py's CKKS configuration
    t0 = time.perf_counter()
    c = seeded_context(dev, "CKKS", Q_BITS)
    cctx, cdec, cev = c["ctx"], c["decryptor"], c["ev"]
    ccd = cctx.first_context_data()
    cenc = CKKSEncoder(cctx)
    slots = cenc.slot_count
    v = rng.uniform(-1, 1, (BATCH, slots)) + 1j * rng.uniform(-1, 1, (BATCH, slots))
    data, launches["encode_device"] = run_step(
        "client", f"encode_device of {BATCH} x {slots} complex slots, scale 2^25",
        lambda: cenc.encode_device(v, scale=CKKS_SCALE).data, ("ntt_forward",))
    pt = Plaintext(data, ccd.parms_id, True, CKKS_SCALE)
    worst, moved = 0.0, []
    for b in range(BATCH):
        row = Plaintext(data[b], ccd.parms_id, True, CKKS_SCALE)
        worst = max(worst, float(np.abs(cenc.decode(row) - v[b]).max()))
        if b < 2:
            diff = np.abs((centred_coeffs(row, ccd) - centred_coeffs(
                cenc.encode(v[b], scale=CKKS_SCALE), ccd)).astype(np.int64))
            moved.append(int((diff != 0).sum()))
            if diff.max() > 1 or moved[-1] >= N // 64:
                raise AssertionError(f"[client] encode_device row {b}: {moved[-1]} coefficients "
                                     f"off the host encode's, by up to {diff.max()}")
    if worst >= 1e-5:
        raise AssertionError(f"[client] encode_device decodes (host) off by {worst:.3e}")
    log(f"[client] encode_device: every row decodes through the host decode within {worst:.3e} "
        f"(tolerance 1e-5); rows 0-1 differ from the host encode at {moved} of {N} coefficients, "
        f"by one unit (tolerance {N // 64})")
    # decode_device needs log2(Q / scale) <= 120: the encodings with their limbs
    # dropped to 4 primes (a CKKS mod switch), margin 120 - 25
    low = ccd
    while low.coeff_modulus_size > 4:
        low = low.next
    pt = Plaintext(data[..., :low.coeff_modulus_size, :].contiguous(), low.parms_id, True,
                   CKKS_SCALE)
    got, launches["decode_device"] = run_step(
        "client", f"decode_device of the {BATCH} encodings at {low.coeff_modulus_size} primes",
        lambda: torch.from_numpy(cenc.decode_device(pt)), ("ntt_inverse",))
    err = float(np.abs(got.numpy() - v).max())
    if err >= 1e-5:
        raise AssertionError(f"[client] decode_device off by {err:.3e}")
    encr = Encryptor(cctx, sk=c["keygen"].secret_key)
    cts = [encr.encrypt_symmetric(Plaintext(data[b], ccd.parms_id, True, CKKS_SCALE))
           for b in range(2)]
    prod = cev.mod_switch_to_next(cev.rescale_to_next(cev.relinearize(
        cev.multiply(cts[0], cts[1]), c["keygen"].create_relin_keys())))
    plain_prod = cdec.decrypt(prod)
    dev_dec, host_dec = cenc.decode_device(plain_prod), cenc.decode(plain_prod)
    rel = float(np.abs(dev_dec - host_dec).max() / np.abs(host_dec).max())
    prod_err = float(np.abs(dev_dec - v[0] * v[1]).max())
    # the product's noise as [ckks] rescale's, twice the multiply's share:
    # complex messages carry noise in both parts
    q = [m.value for m in ccd.parms.coeff_modulus]
    L = ccd.coeff_modulus_size
    noise = ckks_noise(N, L, max(q[:L]), q[-1])
    after = CKKS_SCALE ** 2 / q[L - 1]
    prod_tol = 32 * (2 * noise["mul"] ** 2 + (noise["rounding"] / after) ** 2) ** 0.5
    if rel >= 2.0 ** -38 or prod_err >= prod_tol:
        raise AssertionError(f"[client] decode_device of multiply + rescale: {rel:.3e} off the "
                             f"host decode, {prod_err:.3e} off the product")
    pcd = cctx.get_context_data(plain_prod.parms_id)
    log(f"[client] decode_device: {err:.3e} off the values; of a multiply + relinearize + "
        f"rescale + mod switch (scale 2^{np.log2(plain_prod.scale):.2f}, {pcd.coeff_modulus_size} "
        f"primes) 2^{np.log2(max(rel, 2.0 ** -60)):.1f} relative off the host decode (tolerance "
        f"2^-38) and {prod_err:.3e} off v0 * v1 (tolerance {prod_tol:.3e}, 32 x the noise's rms); "
        f"context and keys in {time.perf_counter() - t0:.3f} s")
    flows = {"encode_device": flow_report("client", gpu, f"encode_device, {BATCH} x {slots} slots",
                                          lambda: cenc.encode_device(v, scale=CKKS_SCALE)),
             "decode_device": flow_report("client", gpu, f"decode_device, {BATCH} x {slots} slots",
                                          lambda: cenc.decode_device(pt))}
    return dict(launches=launches, timed=timed, flows=flows, threefry=threefry)


def run_protocol(phase: str, label: str, fn, required) -> tuple[torch.Tensor, dict, list]:
    """run_step of fn() -> (frames, tensor): the frames of the kernel run
    must equal the all-plain run's byte for byte too."""
    frames = []

    def call():
        f, out = fn()
        frames.append(f)
        return out

    out, launches = run_step(phase, label, call, required)
    if frames[0] != frames[1]:
        raise AssertionError(f"[{phase}] {label}: the frames differ from the all-plain run's")
    log(f"[{phase}] {label}: its frames equal the all-plain run's byte for byte")
    return out, launches, frames[0]


def frame_modes(frames) -> list:
    """The mode byte of each frame (0 raw, 1 zstd, 2 zlib), once each."""
    return sorted({f[0] for f in frames})


def phase_wire(dev, gpu: str) -> dict:
    """The client and the server over bytes at the app-bench sizes: the
    BumbleBee matmul of examples/10_bfv_matmul.py (packed and as sparse
    terms), the CKKS matmul's terms, the conv2d, and the keys."""
    from troy_tpu_torch.app.cipher2d import Cipher2d
    from troy_tpu_torch.app.conv2d import Conv2dHelper
    from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter, CKKSEncoderAdapter
    from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.utils import random as R, serialize as S

    zstd = S.CompressionMode.Zstd
    need = ("ntt_forward", "ntt_inverse")
    rng = np.random.default_rng(MSG_SEED + 3)
    B, I, O = APP_MATMUL
    launches, flows, wire_bytes = {}, {}, {}
    t0 = time.perf_counter()
    bfv = seeded_context(dev, "BFV", APP_BITS)
    ckks = seeded_context(dev, "CKKS", APP_BITS)
    torch.cuda.synchronize()
    log(f"[wire] BFV and CKKS contexts n={N}, {len(APP_BITS)} x 30-bit primes, seed {KEY_SEED:#x}, "
        f"keys from the contexts' threefry streams, in {time.perf_counter() - t0:.3f} s")

    def send(s, helper, adapter, x, seeded=True) -> list:
        """The client: encode, encrypt_symmetric under the context's default
        stream (a fresh Encryptor a call, so a rerun draws the same bits),
        one Zstd frame a ciphertext."""
        encr = Encryptor(s["ctx"], sk=s["keygen"].secret_key)
        cts = helper.encode_inputs(adapter, x).encrypt_symmetric(encr, save_seed=seeded)
        return [[S.save_ciphertext(c, s["ctx"], zstd) for c in row] for row in cts.data]

    def serve(s, helper, frames, weights, glk=None) -> list:
        """The server: load (c1 expanded from each seed on the card),
        multiply, pack with pack_lwe, frames back."""
        x = Cipher2d([[S.load_ciphertext(b, s["ctx"]) for b in row] for row in frames])
        y = (helper.matmul(s["ev"], x, weights) if isinstance(helper, MatmulHelper)
             else helper.conv2d(s["ev"], x, weights))
        if getattr(helper, "pack_lwe", False):
            y = helper.pack_outputs(s["ev"], glk, y)
        return helper.serialize_outputs(s["ctx"], y, zstd)

    def protocol(s, helper, adapter, x, weights, glk=None):
        frames_in = send(s, helper, adapter, x)
        frames_out = serve(s, helper, frames_in, weights, glk)
        y = helper.deserialize_outputs(s["ctx"], frames_out)
        return (frames_in, frames_out), torch.stack([c.data for row in y.data for c in row])

    def report(key, label, s, helper, adapter, x, weights, glk=None):
        _, launches[key], frames = run_protocol(
            "wire", label, lambda: protocol(s, helper, adapter, x, weights, glk), need)
        frames_in, frames_out = frames
        flat_in = [b for row in frames_in for b in row]
        whole = sum(len(b) for b in (S.save_ciphertext(c, s["ctx"], zstd) for row in
                    helper.deserialize_outputs(s["ctx"], frames_out).data for c in row))
        unseeded = sum(len(b) for row in send(s, helper, adapter, x, seeded=False) for b in row)
        wire_bytes[key] = dict(inputs=sum(map(len, flat_in)), inputs_unseeded=unseeded,
                               outputs=sum(map(len, frames_out)), outputs_whole=whole,
                               modes_in=frame_modes(flat_in), modes_out=frame_modes(frames_out))
        w = wire_bytes[key]
        log(f"[wire] {label}: {len(flat_in)} input frames {w['inputs']} bytes seeded against "
            f"{w['inputs_unseeded']} unseeded (mode bytes {w['modes_in']}); {len(frames_out)} "
            f"output frames {w['outputs']} bytes against {w['outputs_whole']} whole (mode bytes "
            f"{w['modes_out']})")
        flows[key] = flow_report("wire", gpu, label,
                                 lambda: protocol(s, helper, adapter, x, weights, glk))
        return helper.deserialize_outputs(s["ctx"], frames_out)

    # ---- 1. BFV matmul, examples/10_bfv_matmul.py's protocol, packed and as terms
    encoder = BatchEncoder(bfv["ctx"])
    t_val = encoder.t.value
    adapter = BatchEncoderAdapter(encoder)
    glk = bfv["keygen"].create_automorphism_keys()
    x = rng.integers(0, t_val, (B, I), dtype=np.int64)
    w = rng.integers(0, t_val, (I, O), dtype=np.int64)
    want = (x.astype(object) @ w.astype(object)) % t_val
    for pack in (True, False):
        helper = MatmulHelper(B, I, O, N, MatmulObjective.EncryptLeft, pack_lwe=pack)
        label = f"BFV matmul {B} x {I} x {O}, " + ("pack_lwe" if pack else "outputs as terms")
        y = report(f"bfv_matmul_{'packed' if pack else 'terms'}", label, bfv, helper, adapter,
                   x, helper.encode_weights(adapter, w), glk)
        dec = helper.decrypt_outputs(adapter, bfv["decryptor"], y)
        if not np.array_equal(dec.astype(object) % t_val, want):
            raise AssertionError(f"[wire] {label}: decrypts wrong")
        log(f"[wire] {label}: the client decrypts x @ w mod t exactly")

    # ---- 2. CKKS matmul, outputs as terms in NTT form (K1 on both ends)
    cenc = CKKSEncoder(ckks["ctx"])
    cad = CKKSEncoderAdapter(cenc, CKKS_SCALE)
    xf, wf = rng.uniform(-1, 1, (B, I)), rng.uniform(-1, 1, (I, O))
    helper = MatmulHelper(B, I, O, N, MatmulObjective.EncryptLeft, pack_lwe=False)
    label = f"CKKS matmul {B} x {I} x {O}, outputs as terms (NTT form)"
    y = report("ckks_matmul_terms", label, ckks, helper, cad, xf, helper.encode_weights(cad, wf))
    if not all(c.is_ntt_form for row in y.data for c in row):
        raise AssertionError(f"[wire] {label}: outputs left the NTT form")
    err = np.abs(helper.decrypt_outputs(CKKSEncoderAdapter(cenc, CKKS_SCALE ** 2),
                                        ckks["decryptor"], y) - xf @ wf)
    rms, got_rms = app_ckks_rms(I, helper.output_block), float(np.sqrt((err ** 2).mean()))
    if not (got_rms < 4 * rms and err.max() < 32 * rms):
        raise AssertionError(f"[wire] {label}: decodes off: rms {got_rms:.3e}, max {err.max():.3e}")
    log(f"[wire] {label}: decodes with rms error {got_rms:.3e} (tolerance {4 * rms:.3e}), max "
        f"{err.max():.3e} (tolerance {32 * rms:.3e})")

    # ---- 3. BFV conv2d, outputs as terms
    Bc, Ci, Co, H, W, kh, kw = APP_CONV
    conv = Conv2dHelper(Bc, Ci, Co, H, W, kh, kw, N, MatmulObjective.EncryptLeft)
    xc = rng.integers(0, t_val, (Bc, Ci, H, W), dtype=np.int64)
    kc = rng.integers(0, t_val, (Co, Ci, kh, kw), dtype=np.int64)
    label = f"BFV conv2d {Bc} x {Ci} x {H} x {W} -> {Co}, outputs as terms"
    y = report("bfv_conv2d", label, bfv, conv, adapter, xc, conv.encode_weights(adapter, kc))
    windows = np.lib.stride_tricks.sliding_window_view(xc, (kh, kw), axis=(2, 3))
    if not np.array_equal(conv.decrypt_outputs(adapter, bfv["decryptor"], y).astype(np.int64),
                          np.einsum("bchwij,ocij->bohw", windows, kc) % t_val):
        raise AssertionError(f"[wire] {label}: decrypts wrong")
    log(f"[wire] {label}: the client decrypts the valid convolution mod t exactly")

    # ---- 4. the keys: automorphism keys and a seeded public key
    kg = bfv["keygen"]
    for mode in (S.CompressionMode.Nil, zstd):
        frame = S.save_kswitch_keys(glk, mode)
        loaded = S.load_galois_keys(frame, bfv["ctx"])
        if sorted(loaded.keys) != sorted(glk.keys) or not all(
                torch.equal(loaded.keys[g], glk.keys[g]) for g in glk.keys):
            raise AssertionError("[wire] the automorphism keys load different")
        log(f"[wire] {len(glk.keys)} automorphism keys: {len(frame)} bytes (mode byte {frame[0]}), "
            f"loaded onto {loaded.keys[3].device} equal")
    pk = kg.create_public_key(save_seed=True)
    frame = S.save_public_key(pk, bfv["ctx"], zstd)
    loaded, launches["public_key"] = run_step(
        "wire", "load of the seeded public key (c1 expanded from its seed)",
        lambda: S.load_public_key(frame, bfv["ctx"]).data(), ())
    if not torch.equal(loaded, pk.data()):
        raise AssertionError("[wire] the seeded public key loads different")
    whole = S.save_public_key(S.load_public_key(frame, bfv["ctx"]), bfv["ctx"], zstd)
    wire_bytes["public_key"] = dict(seeded=len(frame), whole=len(whole))
    log(f"[wire] seeded public key: {len(frame)} bytes (mode byte {frame[0]}) against {len(whole)} "
        f"whole; it loads equal to the key")
    threefry = {"seed expansion": threefry_report(
        "wire", gpu, f"the expansion of one seed, {(2, len(APP_BITS) - 1, N)} words, one key",
        lambda: R.bits(R.key(pk.ciphertext.seed), (2, len(APP_BITS) - 1, N), dev))}
    return dict(launches=launches, flows=flows, bytes=wire_bytes, threefry=threefry)


RING2K_LIMBS = {32: 4, 64: 6, 128: 11}  # [ring2k]: app_bench.py's chains per k
RING2K_SMALL = (24, 31)                 # [ring2k]: the int64 helper, K3 into t = 2^k
RING2K_MESSAGES = 16
RING2K_MATMUL, RING2K_CONV = APP_MATMUL, APP_CONV
RING2K_LOG_T = 25                       # the context's t, which ring2k bypasses
WIDE_BITS = [60, 40, 40, 60]            # [wide]: bench.py's wide chain
WIDE_SCALE = 2.0 ** 40
WIDE_PROFILE_STEPS = 2


def ring2k_context(dev, limbs: int) -> dict:
    """app_bench.py's ring2k context: n = N on `limbs` x 30-bit primes, t =
    PlainModulus.batching(N, 25), seed KEY_SEED, keys and encryptions from
    the context's default threefry streams."""
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, [30] * limbs))
    parms.set_plain_modulus(PlainModulus.batching(N, RING2K_LOG_T))
    ctx = HeContext.create(parms, dev, SecurityLevel.Nil, seed=KEY_SEED)
    keygen = KeyGenerator(ctx)
    return dict(ctx=ctx, encryptor=Encryptor(ctx, sk=keygen.secret_key,
                                             pk=keygen.create_public_key()),
                decryptor=Decryptor(ctx, keygen.secret_key), ev=Evaluator(ctx))


def t_gamma_tables(dev, k: int):
    """K3's tables of the ring2k {t = 2^k, gamma} conversion at app_bench.py's
    4 x 30-bit chain (the gamma the encoder picks)."""
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.rns.rns_base import RNSBase, BaseConverter
    from troy_tpu_torch.rns.rns_tool import _aux_primes

    q = CoeffModulus.create(N, [30] * 4)[:3]
    gamma = _aux_primes(N, {m.value for m in q}, 1, need_ntt=False)[0]
    return BaseConverter(RNSBase(q, dev), RNSBase([Modulus(1 << k), Modulus(gamma)],
                                                  dev)).tables


def phase_ring2k(dev, gpu: str) -> dict:
    """scripts/app_bench.py's ring2k configurations (TROY_APP_SCHEME=ring2k{32,
    64,128}), read as data: n = N, 30-bit primes, seed KEY_SEED, EncryptLeft,
    inputs uniform below min(2^k, 2^63) from numpy seed MSG_SEED; the matmul
    100 x 105 x 110 without packing at k = 32, 64 and 128, the conv2d at k =
    64; then the int64 helper (examples/13_ring2k.py's flow) on 16 messages
    at k = 24 and 31, whose decrypt runs K3 into t = 2^k."""
    from troy_tpu_torch.app.cipher2d import Cipher2d
    from troy_tpu_torch.app.conv2d import Conv2dHelper
    from troy_tpu_torch.app.encoder_adapter import Ring2kEncoderAdapter
    from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
    from troy_tpu_torch.app.ring2k import PolynomialEncoderRing2k

    need = ("ntt_forward", "ntt_inverse")
    launches, flows, ctxs = {}, {}, {}
    B, I, O = RING2K_MATMUL

    def context(limbs):
        if limbs not in ctxs:
            t0 = time.perf_counter()
            ctxs[limbs] = ring2k_context(dev, limbs)
            torch.cuda.synchronize()
            log(f"[ring2k] context n={N}, {limbs} x 30-bit primes, seed {KEY_SEED:#x}: keys "
                f"in {time.perf_counter() - t0:.3f} s")
        return ctxs[limbs]

    def stacked(y):
        return torch.stack([c.data for row in y.data for c in row])

    def oracle_mod(prod, k):
        return np.vectorize(lambda v: int(v) & ((1 << k) - 1), otypes=[object])(prod)

    for k, limbs in RING2K_LIMBS.items():
        c = context(limbs)
        ad = Ring2kEncoderAdapter(PolynomialEncoderRing2k(c["ctx"], k))
        rng = np.random.default_rng(MSG_SEED)
        hi = min(1 << k, 1 << 63)
        x = rng.integers(0, hi, (B, I), dtype=np.uint64)
        w = rng.integers(0, hi, (I, O), dtype=np.uint64)
        helper = MatmulHelper(B, I, O, N, MatmulObjective.EncryptLeft, pack_lwe=False)
        t0 = time.perf_counter()
        x_enc = helper.encrypt_inputs(c["encryptor"], ad, x)
        w_enc = helper.encode_weights(ad, w)
        torch.cuda.synchronize()
        label = f"ring2k k={k} matmul {B} x {I} x {O} on {limbs} primes"
        log(f"[ring2k] {label}: blocks (batch, input, output) = ({helper.batch_block}, "
            f"{helper.input_block}, {helper.output_block}); scale_up and encrypt of "
            f"{sum(len(r) for r in x_enc.data)} inputs, centralize of "
            f"{sum(len(r) for r in w_enc.data)} weights in {time.perf_counter() - t0:.3f} s")
        holder = {}

        def flow(helper=helper, x_enc=x_enc, w_enc=w_enc, ev=c["ev"], holder=holder):
            holder["y"] = helper.matmul(ev, x_enc, w_enc)
            return stacked(holder["y"])

        _, launches[f"matmul k={k}"] = run_step("ring2k", label, flow, need)
        got = oracle_mod(helper.decrypt_outputs(ad, c["decryptor"], holder["y"]), k)
        want = oracle_mod(x.astype(object) @ w.astype(object), k)
        if not np.array_equal(got, want):
            raise AssertionError(f"[ring2k] {label} decrypts wrong")
        log(f"[ring2k] {label}: decrypts to (x @ w) mod 2^{k} exactly, {got.shape} outputs")
        flows[f"matmul k={k}"] = flow_report("ring2k", gpu, label, flow)

    # the conv2d at k = 64, the CIFAR-like layer
    k = 64
    c = context(RING2K_LIMBS[k])
    ad = Ring2kEncoderAdapter(PolynomialEncoderRing2k(c["ctx"], k))
    Bc, Ci, Co, H, W, kh, kw = RING2K_CONV
    rng = np.random.default_rng(MSG_SEED)
    xc = rng.integers(0, 1 << 63, (Bc, Ci, H, W), dtype=np.uint64)
    kc = rng.integers(0, 1 << 63, (Co, Ci, kh, kw), dtype=np.uint64)
    conv = Conv2dHelper(Bc, Ci, Co, H, W, kh, kw, N, MatmulObjective.EncryptLeft)
    xc_enc = conv.encrypt_inputs(c["encryptor"], ad, xc)
    kc_enc = conv.encode_weights(ad, kc)
    label = f"ring2k k=64 conv2d {Bc} x {Ci} x {H} x {W} -> {Co}, {kh} x {kw}"
    holder = {}

    def conv_flow():
        holder["y"] = conv.conv2d(c["ev"], xc_enc, kc_enc)
        return stacked(holder["y"])

    _, launches["conv2d k=64"] = run_step("ring2k", label, conv_flow, need)
    got = conv.decrypt_outputs(ad, c["decryptor"], holder["y"]).astype(np.uint64)
    windows = np.lib.stride_tricks.sliding_window_view(xc, (kh, kw), axis=(2, 3))
    want = np.einsum("bchwij,ocij->bohw", windows, kc)   # uint64: exact mod 2^64
    if not np.array_equal(got, want):
        raise AssertionError(f"[ring2k] {label} decrypts wrong")
    log(f"[ring2k] {label}: decrypts to the valid convolution mod 2^64 exactly, "
        f"{got.shape} outputs")
    flows["conv2d k=64"] = flow_report("ring2k", gpu, label, conv_flow)

    # the int64 helper: scale_up, encrypt, add_plain, decrypt_scale_down
    c = context(4)
    for k in RING2K_SMALL:
        enc = PolynomialEncoderRing2k(c["ctx"], k)
        rng = np.random.default_rng(MSG_SEED)
        m1 = rng.integers(0, 1 << k, (RING2K_MESSAGES, N), dtype=np.uint64)
        m2 = rng.integers(0, 1 << k, (RING2K_MESSAGES, N), dtype=np.uint64)
        cts = [c["encryptor"].encrypt_asymmetric(enc.scale_up(m)) for m in m1]
        label = (f"ring2k k={k} int64 helper, {RING2K_MESSAGES} messages: add_plain of "
                 f"scale_up(m2), decrypt_scale_down (K3 into t = 2^{k})")

        def u32_flow(enc=enc, cts=cts, m2=m2):
            return torch.from_numpy(np.stack([
                enc.decrypt_scale_down(c["decryptor"], c["ev"].add_plain(ct, enc.scale_up(m)))
                for ct, m in zip(cts, m2)]).astype(np.int64))

        out, launches[f"helper k={k}"] = run_step("ring2k", label, u32_flow,
                                                  need + ("base_convert",))
        if not np.array_equal(out.numpy(), ((m1 + m2) & np.uint64((1 << k) - 1)).astype(np.int64)):
            raise AssertionError(f"[ring2k] {label} decrypts wrong")
        log(f"[ring2k] {label}: every message decrypts to (m1 + m2) mod 2^{k}")
        flows[f"helper k={k}"] = flow_report("ring2k", gpu, label, u32_flow, reps=1)
    return dict(launches=launches, flows=flows)


def wide_context(dev, scheme: str) -> dict:
    """bench.py's wide configuration on dev: n = N on [60, 40, 40, 60], t =
    PlainModulus.batching(N, 20) but for CKKS, seed KEY_SEED, every key from
    the context's default threefry streams."""
    c = seeded_context(dev, scheme, WIDE_BITS)
    from troy_tpu_torch.core.encryptor import Encryptor

    c["pk"] = c["keygen"].create_public_key()
    c["encryptor"] = Encryptor(c["ctx"], sk=c["keygen"].secret_key, pk=c["pk"])
    return c


def record_wide_ntt(fn) -> list:
    """fn() once with the wide NTT recording each call's direction, shape
    and tables."""
    from contextlib import ExitStack
    from troy_tpu_torch.ops import ntt64 as N64

    calls = []

    def recording(name, impl):
        def call(x, t):
            calls.append((name, tuple(x.shape), t))
            return impl(x, t)
        return call

    with ExitStack() as stack:
        for name in ("ntt_forward64", "ntt_inverse64"):
            stack.enter_context(mock.patch.object(N64, name, recording(name, getattr(N64, name))))
        fn()
    torch.cuda.synchronize()
    return calls


def wide_ntt_cost(name: str, shape, t, cache: dict) -> tuple[float, float]:
    """Launches and device ms of one wide NTT call (the profiler, 2 calls)."""
    from troy_tpu_torch.ops import ntt64 as N64

    key = (name, shape, id(t))
    if key not in cache:
        x = residues(shape, t.q, torch.Generator(device=t.q.device).manual_seed(9))
        prof = profile_step(lambda: getattr(N64, name)(x, t), 2)
        cache[key] = (prof["launches"], prof["ms"])
    return cache[key]


def wide_step(label: str, fn) -> tuple[torch.Tensor, dict]:
    """fn() once with the launch counts set to 0 just before and read just
    after: a wide step launches none of the fast path's kernels."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"[wide] {label} -> {tuple(out.shape)} in {time.perf_counter() - t0:.3f} s; "
        f"kernel launches {counts}")
    if any(counts.values()):
        raise AssertionError(f"[wide] {label} launched a fast-path kernel")
    return out, counts


def same_on_cpu(label: str, out0: torch.Tensor, cpu_fn):
    """Ciphertext 0 of a card step equals the same step run on the CPU."""
    t0 = time.perf_counter()
    ref = cpu_fn()
    if not torch.equal(out0.cpu(), ref):
        bad = int((out0.cpu() != ref).sum())
        raise AssertionError(f"[wide] {label}: card != CPU at {bad} residues of ciphertext 0")
    log(f"[wide] {label}: ciphertext 0 equals the same step on the CPU bit for bit "
        f"({time.perf_counter() - t0:.3f} s of CPU time)")


def wide_report(gpu: str, label: str, fn, chain, first, ntt_cache: dict) -> dict:
    """A wide step's chained (or repeated) event-timed ms, the profiler's
    launches, device ms and busy share, and the wide NTT's share of both
    (its calls recorded, each timed alone)."""
    for _ in range(2):
        fn()
    state = {"cur": first}

    def call():
        if chain is None:
            fn()
        else:
            state["cur"] = chain(state["cur"])

    ms = cuda_ms(call, 3)
    prof = profile_step(fn, WIDE_PROFILE_STEPS)
    calls = record_wide_ntt(fn)
    costs = [wide_ntt_cost(name, shape, t, ntt_cache) for name, shape, t in calls]
    ntt_n, ntt_ms = sum(c[0] for c in costs), sum(c[1] for c in costs)
    log(f"[wide] {gpu}: {label}: {'chained' if chain else 'repeated'} {ms:.4f} ms a step; "
        f"profiler, {WIDE_PROFILE_STEPS} steps: {prof['launches']:.0f} kernel launches and "
        f"{prof['ms']:.4f} ms of device kernel time a step, busy share "
        f"{100 * prof['ms'] / ms:.1f}%; the wide NTT: {len(calls)} calls, {ntt_n:.0f} "
        f"launches ({100 * ntt_n / max(prof['launches'], 1):.1f}% of the step's) and "
        f"{ntt_ms:.4f} ms ({100 * ntt_ms / max(prof['ms'], 1e-9):.1f}% of its device time)")
    return dict(ms=ms, launches=prof["launches"], device_ms=prof["ms"], ntt_calls=len(calls),
                ntt_launches=ntt_n, ntt_ms=ntt_ms)


def phase_wide(dev, gpu: str) -> dict:
    """bench.py's wide configuration (n = N, [60, 40, 40, 60], batch 16, seed
    KEY_SEED, keys from the context's threefry streams): the BFV multiply +
    relinearize step and rotate_rows(1), CKKS multiply + relinearize +
    rescale and rotate_vector(1) at scale 2^40, BGV multiply + relinearize;
    the client's encryptions against a CPU twin; a wide ciphertext over
    bytes.  No step may launch a fast-path kernel; ciphertext 0 of each
    equals the CPU's run of the step."""
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.core.ckks_encoder import CKKSEncoder
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.ops.galois import GaloisTool
    from troy_tpu_torch.parallel.batched import BatchedEvaluator
    from troy_tpu_torch.utils import serialize as S

    cpu = torch.device("cpu")
    launches, reports, ntt_cache = {}, {}, {}
    rng = np.random.default_rng(MSG_SEED)

    def twin(c):
        """The same context on the CPU, its level's batched evaluator."""
        ctx = seeded_context(cpu, c["ctx"].scheme.name, WIDE_BITS)["ctx"]
        return ctx, BatchedEvaluator(Evaluator(ctx), ctx.first_context_data())

    # ---- BFV: multiply + relinearize, rotate_rows(1)
    t0 = time.perf_counter()
    c = wide_context(dev, "BFV")
    cd = c["ctx"].first_context_data()
    encoder = BatchEncoder(c["ctx"])
    t_val = encoder.t.value
    rlk = c["keygen"].create_relin_keys().key(2)
    batched = BatchedEvaluator(c["ev"], cd)
    rot, rot_elts = batched.build_rotate_rows_step(1)
    glk = c["keygen"].create_galois_keys_from_elements(rot_elts)
    rot_keys = tuple(glk.key(e) for e in rot_elts)
    msgs = rng.integers(0, t_val, (2 * BATCH, N), dtype=np.int64)
    cts = [c["encryptor"].encrypt_symmetric(encoder.encode(m)).data for m in msgs]
    d1, d2 = torch.stack(cts[:BATCH]), torch.stack(cts[BATCH:])
    torch.cuda.synchronize()
    primes = [m.value for m in c["ctx"].key_context_data().parms.coeff_modulus]
    log(f"[wide] BFV context n={N}, primes {primes} ({[p.bit_length() for p in primes]} "
        f"bits), t={t_val}, |Bsk|={cd.rns_tool.base_Bsk.size}, seed {KEY_SEED:#x}: keys and "
        f"{2 * BATCH} symmetric encryptions {tuple(d1.shape)} in {time.perf_counter() - t0:.3f} s")
    mul = batched.build_mul_relin_step(rlk)
    label = f"BFV multiply + relinearize step {tuple(d1.shape)} x {tuple(d2.shape)}"
    out, launches["bfv_mul"] = wide_step(label, lambda: mul(d1, d2, rlk))
    expected = (msgs[:BATCH].astype(object) * msgs[BATCH:]) % t_val
    for b in range(BATCH):
        got = encoder.decode(c["decryptor"].decrypt(Ciphertext(out[b], cd.parms_id)))
        if not np.array_equal(got.cpu().numpy(), np.asarray(expected[b], np.int64)):
            raise AssertionError(f"[wide] {label}: ciphertext {b} decrypts wrong")
    budget = c["decryptor"].invariant_noise_budget(Ciphertext(out[0], cd.parms_id))
    log(f"[wide] {label}: all {BATCH} products decrypt to m1 * m2 mod t; noise budget of "
        f"product 0: {budget} bits")
    if budget <= 0:
        raise AssertionError(f"[wide] {label}: no noise budget left")
    cpu_ctx, cpu_b = twin(c)
    same_on_cpu(label, out[:1], lambda: cpu_b.build_mul_relin_step(rlk.cpu())(
        d1[:1].cpu(), d2[:1].cpu(), rlk.cpu()))
    reports["BFV multiply + relinearize"] = wide_report(
        gpu, label, lambda: mul(d1, d2, rlk), lambda d: mul(d, d2, rlk), d1, ntt_cache)
    label = f"BFV rotate_rows(1) step {tuple(d1.shape)}, elements {rot_elts}"
    out, launches["bfv_rotate"] = wide_step(label, lambda: rot(d1, rot_keys))
    h = N // 2
    for b in range(BATCH):
        got = encoder.decode(c["decryptor"].decrypt(Ciphertext(out[b], cd.parms_id)))
        m = msgs[b]
        if not np.array_equal(got.cpu().numpy(), np.concatenate([np.roll(m[:h], -1),
                                                                 np.roll(m[h:], -1)])):
            raise AssertionError(f"[wide] {label}: ciphertext {b} decrypts wrong")
    log(f"[wide] {label}: all {BATCH} decrypt to the rotated rows")
    same_on_cpu(label, out[:1], lambda: cpu_b.build_rotate_rows_step(1)[0](
        d1[:1].cpu(), tuple(k.cpu() for k in rot_keys)))
    reports["BFV rotate_rows(1)"] = wide_report(
        gpu, label, lambda: rot(d1, rot_keys), lambda d: rot(d, rot_keys), d1, ntt_cache)
    for name in ("ntt_forward64", "ntt_inverse64"):
        shape = (BATCH, 2, cd.coeff_modulus_size, N)
        n_l, n_ms = wide_ntt_cost(name, shape, cd.qtab(), ntt_cache)
        log(f"[wide] {gpu}: the wide NTT alone, {name} at {shape}: int64 torch passes, "
            f"{n_l:.0f} launches and {n_ms:.4f} ms of device time a transform (profiler)")

    # ---- the client: threefry streams on the card against a CPU twin; the wire
    kg_cpu = KeyGenerator(cpu_ctx)
    if not (torch.equal(kg_cpu.secret_key.data, c["keygen"].secret_key.data.cpu())):
        raise AssertionError("[wide] the CPU twin's secret key differs")
    pk_cpu = kg_cpu.create_public_key()
    if not torch.equal(pk_cpu.data(), c["pk"].data().cpu()):
        raise AssertionError("[wide] the CPU twin's public key differs")
    enc_gpu = Encryptor(c["ctx"], sk=c["keygen"].secret_key, pk=c["pk"])
    enc_cpu = Encryptor(cpu_ctx, sk=kg_cpu.secret_key, pk=pk_cpu)
    m = msgs[0]
    pt_gpu, pt_cpu = encoder.encode(m), BatchEncoder(cpu_ctx).encode(m)
    for kind in ("symmetric", "asymmetric"):
        label = f"client encrypt_{kind}"
        reset_launch_counts()
        ct = getattr(enc_gpu, f"encrypt_{kind}")(pt_gpu)
        torch.cuda.synchronize()
        launches[f"client_{kind}"] = launch_counts()
        if any(launches[f"client_{kind}"].values()):
            raise AssertionError(f"[wide] {label} launched a fast-path kernel")
        same_on_cpu(label, ct.data, lambda: getattr(enc_cpu, f"encrypt_{kind}")(pt_cpu).data)
        got = encoder.decode(c["decryptor"].decrypt(ct)).cpu().numpy()
        if not np.array_equal(got, m):
            raise AssertionError(f"[wide] {label} decrypts wrong")
        log(f"[wide] {label}: keys and ciphertext from the context's threefry streams equal "
            f"the CPU's; decrypts to the message")
    unseeded = enc_gpu.encrypt_symmetric(pt_gpu)
    seeded = enc_gpu.encrypt_symmetric(pt_gpu, save_seed=True)
    reset_launch_counts()
    for label, ct in (("unseeded", unseeded), ("seeded", seeded)):
        raw = S.save_ciphertext(ct, c["ctx"], S.CompressionMode.Zstd)
        back = S.load_ciphertext(raw, c["ctx"])
        if not torch.equal(back.data, ct.data) or back.data.device != ct.data.device:
            raise AssertionError(f"[wide] wire: the {label} ciphertext loads back different")
        log(f"[wide] wire: the {label} wide ciphertext {tuple(ct.data.shape)}, Zstd: "
            f"{len(raw)} bytes (bound {S.ciphertext_size_upperbound(ct)}), loaded back on the "
            f"card equal")
    torch.cuda.synchronize()
    launches["wire"] = launch_counts()
    if any(launches["wire"].values()):
        raise AssertionError("[wide] the wire launched a fast-path kernel")

    # ---- CKKS: multiply + relinearize + rescale, rotate_vector(1)
    c = wide_context(dev, "CKKS")
    cd = c["ctx"].first_context_data()
    cenc = CKKSEncoder(c["ctx"])
    rlk = c["keygen"].create_relin_keys().key(2)
    batched = BatchedEvaluator(c["ev"], cd)
    crot, crot_elts = batched.build_rotate_rows_step(1)
    cglk = c["keygen"].create_galois_keys_from_elements(
        sorted({GaloisTool.get_element_from_step(1, N)}))
    crot_keys = tuple(cglk.key(e) for e in crot_elts)
    m1 = rng.uniform(-1, 1, (BATCH, cenc.slot_count))
    m2 = rng.uniform(-1, 1, (BATCH, cenc.slot_count))
    mc = m1 + 1j * m2

    def encrypt(ms):
        return torch.stack([c["encryptor"].encrypt_symmetric(
            cenc.encode(v, scale=WIDE_SCALE)).data for v in ms])

    e1, e2, ec = encrypt(m1), encrypt(m2), encrypt(mc)
    mul, rescale = batched.build_mul_relin_step(rlk), batched.build_rescale_step()
    q = [m.value for m in c["ctx"].key_context_data().parms.coeff_modulus]
    L = cd.coeff_modulus_size
    noise = ckks_noise(N, L, max(q[:L]), q[-1], WIDE_SCALE)
    label = f"CKKS multiply + relinearize + rescale step {tuple(e1.shape)} x {tuple(e2.shape)}"
    out, launches["ckks_mul"] = wide_step(label, lambda: rescale(mul(e1, e2, rlk)))
    after = WIDE_SCALE ** 2 / q[L - 1]
    check_ckks(label, out, cd.next.parms_id, after, m1 * m2,
               (noise["mul"] ** 2 + (noise["rounding"] / after) ** 2) ** 0.5, cenc,
               c["decryptor"], phase="wide")
    cpu_ctx, cpu_b = twin(c)
    same_on_cpu(label, out[:1], lambda: cpu_b.build_rescale_step()(
        cpu_b.build_mul_relin_step(rlk.cpu())(e1[:1].cpu(), e2[:1].cpu(), rlk.cpu())))
    reports["CKKS multiply + relinearize + rescale"] = wide_report(
        gpu, label, lambda: rescale(mul(e1, e2, rlk)), None, None, ntt_cache)
    label = f"CKKS rotate_vector(1) step {tuple(ec.shape)}, elements {crot_elts}"
    out, launches["ckks_rotate"] = wide_step(label, lambda: crot(ec, crot_keys))
    check_ckks(label, out, cd.parms_id, WIDE_SCALE, np.roll(mc, -1, axis=-1), noise["rotate"],
               cenc, c["decryptor"], noise["digit_mean"], phase="wide")
    same_on_cpu(label, out[:1], lambda: cpu_b.build_rotate_rows_step(1)[0](
        ec[:1].cpu(), tuple(k.cpu() for k in crot_keys)))
    reports["CKKS rotate_vector(1)"] = wide_report(
        gpu, label, lambda: crot(ec, crot_keys), lambda d: crot(d, crot_keys), ec, ntt_cache)

    # ---- BGV: multiply + relinearize
    c = wide_context(dev, "BGV")
    cd = c["ctx"].first_context_data()
    encoder = BatchEncoder(c["ctx"])
    t_val = encoder.t.value
    rlk = c["keygen"].create_relin_keys().key(2)
    batched = BatchedEvaluator(c["ev"], cd)
    msgs = rng.integers(0, t_val, (2 * BATCH, N), dtype=np.int64)
    cts = [c["encryptor"].encrypt_symmetric(encoder.encode(m)) for m in msgs]
    if any(ct.correction_factor != 1 or not ct.is_ntt_form for ct in cts):
        raise AssertionError("[wide] BGV encryptions are not NTT form with factor 1")
    g1, g2 = torch.stack([ct.data for ct in cts[:BATCH]]), torch.stack([ct.data for ct in cts[BATCH:]])
    mul = batched.build_mul_relin_step(rlk)
    label = f"BGV multiply + relinearize step {tuple(g1.shape)} x {tuple(g2.shape)}"
    out, launches["bgv_mul"] = wide_step(label, lambda: mul(g1, g2, rlk))
    expected = (msgs[:BATCH].astype(object) * msgs[BATCH:]) % t_val
    for b in range(BATCH):
        got = encoder.decode(c["decryptor"].decrypt(Ciphertext(out[b], cd.parms_id, True)))
        if not np.array_equal(got.cpu().numpy(), np.asarray(expected[b], np.int64)):
            raise AssertionError(f"[wide] {label}: ciphertext {b} decrypts wrong")
    budget = c["decryptor"].invariant_noise_budget(Ciphertext(out[0], cd.parms_id, True))
    log(f"[wide] {label}: all {BATCH} products decrypt through the BGV decrypt; noise "
        f"budget of product 0: {budget} bits")
    if budget <= 0:
        raise AssertionError(f"[wide] {label}: no noise budget left")
    cpu_ctx, cpu_b = twin(c)
    same_on_cpu(label, out[:1], lambda: cpu_b.build_mul_relin_step(rlk.cpu())(
        g1[:1].cpu(), g2[:1].cpu(), rlk.cpu()))
    reports["BGV multiply + relinearize"] = wide_report(
        gpu, label, lambda: mul(g1, g2, rlk), lambda d: mul(d, g2, rlk), g1, ntt_cache)
    return dict(launches=launches, reports=reports)


def main() -> int:
    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = cuda_device()
    gpu = gpu_line()
    log(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from troy_tpu_torch.ops import (_cuda_build, ntt as NTT, ntt_cuda, bconv as BC,
                                    bconv_cuda, fused_mul as FM, fused_mul_cuda)
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.parallel.batched import BatchedEvaluator
    from troy_tpu_torch.rns.rns_base import RNSBase, BaseConverter
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.utils import numth

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = [ptxas_start(src) for src in ("ntt.cu", "fused_mul.cu", "tensor_product.cu")]
    lib = _cuda_build.build()
    _cuda_build.load()
    log(f"[build] {lib.name} from {', '.join(p.name for p in _cuda_build.sources())} "
        f"in {time.perf_counter() - t0:.3f} s")
    for proc in ptxas:
        ptxas_report(proc)
    log_n = N.bit_length() - 1
    for which, label in enumerate(("ntt_forward", "ntt_inverse", "ntt_forward radix-2 yardstick",
                                   "ntt_inverse radix-2 yardstick")):
        log(f"[build] {label} at n = {N}: {ntt_cuda.kernel_info(which, log_n)} "
            f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    for which, label in enumerate(("fused_negacyclic_multiply",
                                   "fused_negacyclic_multiply radix-2 yardstick")):
        info = fused_mul_cuda.kernel_info(which, log_n)
        log(f"[build] {label} at n = {N}: {info} (cudaFuncGetAttributes, "
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor, cudaOccupancyMaxActiveClusters)")
        if which == 0 and (info["smem"] != fused_mul_cuda.shared_bytes(log_n)
                           or info["clusters"] < 1):
            raise AssertionError(f"[build] K4's launch shape {info} is not the wrapper's "
                                 f"{fused_mul_cuda.shared_bytes(log_n)} bytes a CTA, or "
                                 f"no cluster fits")

    t0 = time.perf_counter()
    ctx = build_context(dev)
    cd = ctx.first_context_data()
    evs = {"hps": Evaluator(ctx), "behz": Evaluator(ctx, lift="behz")}
    batched = {k: BatchedEvaluator(ev, cd) for k, ev in evs.items()}
    encoder = BatchEncoder(ctx)
    tool = cd.rns_tool
    L = cd.coeff_modulus_size
    qtab, bsk = cd.qtab(), tool.bsk_ntt
    log(f"[setup] context n={N} L={L} |Bsk|={bsk.size} t={encoder.t.value} "
        f"in {time.perf_counter() - t0:.3f} s")

    # ---- 3. kernels vs plain -----------------------------------------------
    degrees = other_degrees(dev)
    otab = evs["hps"]._switch_tables(cd)["otab"]
    err = phase_ntt(dev, {
        "base q": ((BATCH,), qtab, False),
        "base Bsk": ((BATCH,), bsk, False),
        "keyswitch digits": ((BATCH * L,), otab, True),
        "plain modulus t": ((1,), encoder.tables, False),
        **{f"n={n}": ((3,), t, True) for n, t in degrees.items() if n <= 131072},
    })

    def converter(l_in, l_out):
        n = 2 * N
        return BaseConverter(
            RNSBase([Modulus(p) for p in numth.get_primes(n, 30, l_in)], dev),
            RNSBase([Modulus(p) for p in numth.get_primes(n, 29, l_out)], dev)).tables

    bconv_cases = {
        "lift q -> Bsk u {m~}": ((BATCH, 2), tool.conv_q_to_Bsk_m_tilde.tables),
        "floor q -> Bsk (folded)": ((BATCH, 3), tool.ff_tables),
        "SK B -> q": ((BATCH, 3), tool.conv_B_to_q.tables),
        "SK B -> m_sk": ((BATCH, 3), tool.conv_B_to_m_sk.tables),
        "decrypt q -> {t, gamma}": ((), tool.conv_q_to_t_gamma.tables),
        "15 -> 9": ((4,), converter(15, 9)),
        "1 -> 3": ((4,), converter(1, 3)),
        **{f"ring2k q -> {{2^{k}, gamma}}": ((RING2K_MESSAGES,), t_gamma_tables(dev, k))
           for k in (30, 31)},
    }
    err["base_convert"] = phase_bconv(dev, bconv_cases)
    err.update(phase_fused(dev, {
        "base q": ((BATCH,), qtab),
        "base Bsk": ((BATCH,), bsk),
        **{f"n={n}": ((3,), t) for n, t in degrees.items() if n <= 131072},
    }))
    phase_refusals(dev, qtab, tool.conv_B_to_q.tables, degrees[REFUSED_DEGREE])

    # ---- 4. main path --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(KEY_SEED)
    keygen = KeyGenerator(ctx, gen)
    keys = keygen.create_relin_keys().key(2)
    encryptor = Encryptor(ctx, keygen.secret_key, gen)
    decryptor = Decryptor(ctx, keygen.secret_key)
    t_val = encoder.t.value
    rng = np.random.default_rng(MSG_SEED)
    msgs = rng.integers(0, t_val, size=(2 * BATCH, N), dtype=np.int64)
    cts = [encryptor.encrypt_symmetric(encoder.encode(m)).data for m in msgs]
    d1 = torch.stack(cts[:BATCH])
    d2 = torch.stack(cts[BATCH:])
    expected = (msgs[:BATCH].astype(object) * msgs[BATCH:]) % t_val
    steps = {k: b.build_mul_relin_step(keys) for k, b in batched.items()}
    launches = {}
    for lift, step in steps.items():
        out, launches[lift] = run_step(
            "main", f"{lift.upper()} step {tuple(d1.shape)} x {tuple(d2.shape)}",
            lambda: step(d1, d2, keys), ("ntt_forward", "ntt_inverse", "base_convert"))
        check_decrypts("main", f"{lift.upper()} products m1 * m2 mod t", out, cd.parms_id,
                       expected, encoder, decryptor)
        budget = decryptor.invariant_noise_budget(Ciphertext(out[0], cd.parms_id))
        log(f"[main] {lift.upper()}: noise budget of product 0: {budget} bits")
        if budget <= 0:
            raise AssertionError(f"[main] {lift} product has no noise budget left")

    # K4 at its own entry point: the tensor-product stage of the HPS multiply.
    lift_b = {k: tool.fast_b_conv_hps(d) for k, d in (("d1", d1), ("d2", d2))}
    torch.cuda.synchronize()
    reset_launch_counts()
    fused_q = FM.fused_negacyclic_multiply(d1, d2, qtab)
    fused_b = FM.fused_negacyclic_multiply(lift_b["d1"], lift_b["d2"], bsk)
    torch.cuda.synchronize()
    launches["fused"] = launch_counts()
    log(f"[main] tensor-product stage through K4: launches {launches['fused']}")
    if launches["fused"]["fused_negacyclic_multiply"] != 2:
        raise AssertionError("[main] the tensor-product stage did not launch K4 twice")
    if not (torch.equal(fused_q, unfused_stage(d1, d2, qtab))
            and torch.equal(fused_b, unfused_stage(lift_b["d1"], lift_b["d2"], bsk))):
        raise AssertionError("[main] K4 != the evaluator's unfused tensor-product stage")
    product = tool.fast_floor_scale_fast_b_conv_sk(fused_q, fused_b)
    if not torch.equal(product, batched["hps"].multiply(d1, d2)):
        raise AssertionError("[main] the floor of K4's stage != the HPS multiply")
    log("[main] K4's stage equals the unfused stage (NTT kernel, dyadic_convolute, "
        "NTT kernel) over q and Bsk, and its floor equals the HPS multiply")

    # ---- 5. rotate, 6. modswitch, 7. quickstart --------------------------------
    rot = phase_rotate(ctx, keygen, gen, encoder, decryptor, batched["hps"])
    modswitch = phase_modswitch(ctx, evs["hps"], rot, encoder, decryptor)
    phase_quickstart(dev, gen)

    # ---- 8. ckks, 9. bgv, 10. large_n ---------------------------------------
    ckks = phase_ckks(dev, gpu)
    bgv = phase_bgv(dev, gpu, dict(ctx=ctx, encryptor=encryptor, encoder=encoder,
                                   decryptor=decryptor))
    large = phase_large_n(dev, gpu, degrees)

    # ---- 11. lwe, 12. app ---------------------------------------------------
    lwe = phase_lwe(dev, gpu)
    app = phase_app(dev, gpu)

    # ---- 13. client, 14. wire ------------------------------------------------
    client = phase_client(dev, gpu)
    wire = phase_wire(dev, gpu)

    # ---- 15. ring2k, 16. wide -------------------------------------------------
    ring2k = phase_ring2k(dev, gpu)
    wide = phase_wide(dev, gpu)

    # ---- 17. times ---------------------------------------------------------
    def batch_ms(label: str, step, first, chain: bool = True):
        """Event-timed ms per call of step, with the kernels and all plain:
        chained (each output the next input) or repeated on first."""
        for _ in range(3):
            step(first)
        state = {"cur": first}

        def call():
            out = step(state["cur"])
            if chain:
                state["cur"] = out

        ms = cuda_ms(call, REPS)
        with all_plain():
            state["cur"] = first
            call()
            plain_ms = cuda_ms(call, PLAIN_REPS)
        log(f"[times] {gpu}: {label} {ms:.4f} ms per batch of {BATCH} "
            f"({BATCH / ms * 1e3:.2f} ciphertexts/s); all plain {plain_ms:.4f} ms "
            f"({BATCH / plain_ms * 1e3:.2f} ciphertexts/s)")
        return ms, plain_ms

    step_ms = {}
    for lift, step in steps.items():
        step_ms[lift] = batch_ms(f"{lift.upper()} multiply + relinearize step, chained",
                                 lambda d, step=step: step(d, d2, keys), d1)
    for label, r in rot["steps"].items():
        step_ms[label] = batch_ms(f"{label} step, chained",
                                  lambda d, r=r: r["step"](d, r["keys"]), rot["d"])
    step_ms["mod switch"] = batch_ms(
        "mod switch L = 6 -> 5 (no kernel; repeated on one input)",
        modswitch["step"], rot["d"], chain=False)
    step_ms["mod switch + rotate"] = batch_ms(
        "mod switch L = 6 -> 5 + rotate_rows(1) at L = 5 (repeated on one input)",
        lambda d: modswitch["rot1"](modswitch["step"](d), modswitch["keys"]),
        rot["d"], chain=False)
    r1 = rot["steps"]["rotate_rows(1)"]
    step_calls = {"HPS step": record_launches(lambda: steps["hps"](d1, d2, keys)),
                  "rotate_rows(1)": record_launches(lambda: r1["step"](rot["d"], r1["keys"]))}
    profiles = {"HPS step": profile_step(lambda: steps["hps"](d1, d2, keys), PROFILE_STEPS)}
    for label in ("rotate_rows(1)", "rotate_columns"):
        r = rot["steps"][label]
        profiles[label] = profile_step(lambda: r["step"](rot["d"], r["keys"]), PROFILE_STEPS)
    for label, prof in profiles.items():
        chained = step_ms["hps" if label == "HPS step" else label][0]
        ntt_n, ntt_ms = ntt_totals(prof)
        line = (f"[times] {gpu}: profiler, {label}, {PROFILE_STEPS} steps: "
                f"{prof['launches']:.0f} kernel launches and {prof['ms']:.4f} ms of device "
                f"kernel time per step, of which the NTT kernels {ntt_n:.0f} launches "
                f"{ntt_ms:.4f} ms and K3 {prof['base_convert'][0]:.0f} launches "
                f"{prof['base_convert'][1]:.4f} ms; device busy share of the event-timed "
                f"chained step ({chained:.4f} ms) {100 * prof['ms'] / chained:.1f}%")
        if label in step_calls:
            ntt_bound_ms = sum(ntt_bound(shape)[0] for name, shape, _ in step_calls[label]
                               if name != "base_convert") / 1e3
            line += (f"; NTT bound {ntt_bound_ms:.4f} ms, {100 * ntt_bound_ms / ntt_ms:.1f}% "
                     f"of the NTT kernels' time")
        log(line)
    round_stages(gpu, evs["hps"], cd, rot)
    ab_shapes = {}
    for calls in step_calls.values():
        for name, shape, t in calls:
            if name != "base_convert":
                ab_shapes.setdefault((name, shape), t)
    ab_shapes.setdefault(("ntt_forward", (BATCH, L, N)), qtab)
    ab = phase_ntt_ab(gpu, dev, ab_shapes)
    for label, calls in step_calls.items():
        per = sum(ab[(name, shape)][0] for name, shape, _ in calls if name != "base_convert")
        old = sum(ab[(name, shape)][1] for name, shape, _ in calls if name != "base_convert")
        log(f"[times] {gpu}: {label}: {sum(name != 'base_convert' for name, _, _ in calls)} NTT "
            f"launches, {per:.3f} us by the register-radix kernel, {old:.3f} us by the "
            f"radix-2 yardstick (sums of the graph times above)")

    def pair(kernel, plain):
        """Device ms per call of the kernel and of its plain version, each
        by CUDA events around a CUDA graph of its calls."""
        return graph_us(kernel) / 1e3, graph_us(plain, PLAIN_REPS) / 1e3

    times = {}
    g = torch.Generator(device=dev).manual_seed(2)
    xq = residues((BATCH, L, N), qtab.q, g)
    for name, kernel, plain in (
            ("ntt_forward", ntt_cuda.ntt_forward, NTT.ntt_forward_plain),
            ("ntt_inverse", ntt_cuda.ntt_inverse, NTT.ntt_inverse_plain)):
        times[name] = pair(lambda: kernel(xq, qtab), lambda: plain(xq, qtab))
        log(f"[times] {gpu}: {name} at {tuple(xq.shape)}: kernel "
            f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms (device time per "
            f"call, CUDA graph)")
    for label, (lead, tabs) in bconv_cases.items():
        if label in ("15 -> 9", "1 -> 3"):
            continue
        x = residues((*lead, tabs.L_in, N), tabs.q_in, g)
        ms = pair(lambda: bconv_cuda.base_convert(x, tabs),
                  lambda: BC.base_convert_plain(x, tabs))
        if label.startswith("floor"):
            times["base_convert"] = ms
        log(f"[times] {gpu}: base_convert {label} {tuple(x.shape)} -> "
            f"{tabs.L_out} limbs: kernel {ms[0]:.5f} ms, plain {ms[1]:.5f} ms (device "
            f"time per call, CUDA graph)")
    fused_ab = phase_fused_ab(gpu, dev, {
        "base q": ((BATCH,), qtab), "base Bsk": ((BATCH,), bsk),
        **{f"n={n}": ((3,), degrees[n]) for n in K4_DEGREES}})
    for label, t in (("base q", qtab), ("base Bsk", bsk)):
        a = residues((BATCH, 2, t.size, N), t.q, g, 2)
        b = residues((BATCH, 2, t.size, N), t.q, g, 2)
        plain_ms = graph_us(lambda: FM.fused_negacyclic_multiply_plain(a, b, t),
                            PLAIN_REPS) / 1e3
        unfused_ms = graph_us(lambda: unfused_stage(a, b, t)) / 1e3
        ms = fused_ab[label][0] / 1e3
        if label == "base q":
            times["fused_negacyclic_multiply"] = (ms, plain_ms)
        log(f"[times] {gpu}: fused_negacyclic_multiply {label} {tuple(a.shape)}: "
            f"kernel {ms:.5f} ms (the A/B above), plain {plain_ms:.5f} ms, unfused kernel "
            f"path (NTT kernel, torch dyadic_convolute, NTT kernel) {unfused_ms:.5f} ms "
            f"(device time per call, CUDA graph); kernel / unfused {ms / unfused_ms:.3f}")

    # ---- 18. results -------------------------------------------------------
    paths = {  # each main path's launch counts, read just after its run
        "hps": {**launches["hps"], "fused_negacyclic_multiply":
                launches["fused"]["fused_negacyclic_multiply"]},
        "ckks": {k: sum(c[k] for c in ckks["launches"].values()) for k in KERNELS},
        "bgv": {k: sum(c[k] for c in bgv["launches"].values()) for k in KERNELS},
        "large_n": {k: large["launches"][k] + large["k4"][k] for k in KERNELS},
        "lwe": {k: sum(c[k] for c in lwe["launches"].values()) for k in KERNELS},
        "app": {k: sum(c[k] for c in app["launches"].values()) for k in KERNELS},
        "client": {k: sum(c[k] for c in client["launches"].values()) for k in KERNELS},
        "wire": {k: sum(c[k] for c in wire["launches"].values()) for k in KERNELS},
        "ring2k": {k: sum(c[k] for c in ring2k["launches"].values()) for k in KERNELS},
        "wide": {k: sum(c[k] for c in wide["launches"].values()) for k in KERNELS}}
    for path in ("client", "wire", "ring2k"):
        if not paths[path]["ntt_forward"] or not paths[path]["ntt_inverse"]:
            raise AssertionError(f"[results] the {path} path launched no NTT kernel")
    if not paths["ring2k"]["base_convert"]:
        raise AssertionError("[results] the ring2k path launched no K3 into t = 2^k")
    if any(paths["wide"].values()):
        raise AssertionError("[results] the wide path launched a fast-path kernel")
    floor_tabs = tool.ff_tables
    timed = {  # the work each kernel's "ms" times, for its bound
        "ntt_forward": ntt_bound(tuple(xq.shape)), "ntt_inverse": ntt_bound(tuple(xq.shape)),
        "base_convert": bconv_bound((BATCH, 3, floor_tabs.L_in, N), floor_tabs.L_out),
        "fused_negacyclic_multiply": fused_bound((BATCH, 2, L, N))}
    for name in KERNELS:  # the large route's kernels at (3, 2, 65536)
        if name not in timed:
            ms, plain_ms, bound_ms, by = large["times"][(name, N_LARGE)]
            times[name] = (ms, plain_ms)
            timed[name] = (bound_ms * 1e3, by)
    hps_kernels = ("ntt_forward", "ntt_inverse", "base_convert", "fused_negacyclic_multiply")
    results = []
    for name, (src, replaces) in KERNELS.items():
        path = "hps" if name in hps_kernels else "large_n"
        if path == "hps":
            prof = profiles["HPS step"]
            mine = [(shape, t) for kname, shape, t in step_calls["HPS step"] if kname == name]
        else:  # per launch of the large step: a dispatch call runs columns and blocks
            prof = large["profile"]
            mine = [(shape, t) for kname, shape, t in large["calls"] if name.startswith(kname)]
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": paths[path][name], "max_abs_err": err[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": timed[name][0] / 1e3, "bound_by": timed[name][1], "library_ms": None,
            "path": path, "paths": {p: c[name] for p, c in paths.items()},
            "bound_us": sum(launch_bound(name, shape, t)[0] for shape, t in mine),
            "device_us": prof[name][1] * 1e3, "launches_per_step": len(mine)})
        if results[-1]["launches"] == 0:
            raise AssertionError(f"[results] {name} was not launched on its path ({path})")
    print(json.dumps({"kernels": results}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

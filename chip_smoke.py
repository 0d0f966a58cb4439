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
the NTT and the fused tensor product take their cluster routes; LWE
extraction and packing on the BFV chain; the app layer's matmul and
conv2d at the reference's app-bench sizes; the client's batched steps and
the device CKKS encoder at bench.py's chain; the client and the server
over bytes (seed-compressed inputs, the helpers' wire format); the ring2k
encoder at the app bench's ring2k sizes; and the wide path at bench.py's
{60, 40, 40, 60} chain; the per-operation benchmark matrix, the eager
benchmark, the example twins and the timer, reductions and poly strings;
the mesh (the step and the app matmul split over shards of the card); and
the step and a rotation through K2's matrix-product NTT under
set_ntt_backend("pallas_mxu"), the JAX package's bench.py setting.
In phases:

  1. device   the card's name and power limit (fails without CUDA);
  2. build    nvcc builds every csrc/*.cu into one library under
              troy_tpu_torch/build/; beside it, nvcc -Xptxas -v on ntt.cu,
              fused_mul.cu, fused_mul_large.cu, tensor_product.cu,
              ntt_mxu.cu, ntt_mxu_wg.cu, ntt_mxu_cluster.cu, bconv.cu and
              bconv_first.cu prints each kernel's registers and spills, and
              the occupancy calculator its CTAs per SM (and each cluster
              kernel's clusters on the card; every form of K3 by its input
              limbs, none spilling);
  3. kernels  each kernel against its plain PyTorch version, bit for bit:
              the NTT pair (and the earlier radix-2 pair that [times] uses
              as its yardstick) at every shape the path gives it and at every
              degree 2 to 131072 (above 32768 the cluster kernel, and its
              yardstick, the column and block kernels, each launch against
              its plain partial transform); the
              base conversion (K3, csrc/bconv.cu, and the first kernel
              csrc/bconv_first.cu that [times] uses as its yardstick) at
              every conversion of both lifts, the floor (also at batch
              BCONV_DRAM_BATCH, on odd n and on a view off 16-byte
              alignment), Shenoy-Kumaresan (the
              joined B -> q u {m_sk} on the strided B rows of a (..., 9, n)
              tensor, as the step runs it, and its two halves) and decrypt,
              at 15 -> 9 and 17 -> 5 (the shared-memory form) contractions,
              at one input limb, and into ring2k's {t, gamma} with t = 2^30
              and 2^31 (output moduli past 2^30); a strided input makes no
              copy, an input the kernel cannot address one counted copy; the fused tensor
              product (K4, and its earlier radix-2 kernel, the yardstick of
              [times]) on lazy [0, 2q) input over base q and Bsk and at every
              degree 2 to 131072 (above 32768 the large cluster kernel, and
              its five-launch yardstick through the two-launch NTT and the
              tensor-product kernel, which is also held to
              dyadic_convolute).  Each wrapper refuses input its kernel
              cannot take, every degree above 131072, a cluster of other
              than 2, 4, 8 or 16 CTAs, a K4 shape the large kernel is not
              built for, and a wide (40-60-bit) modulus;
  4. main     keygen, encode, encrypt 16 distinct pairs; one HPS step and
              one BEHZ step.  Each must launch the NTT kernels and K3, equal
              the same step with every kernel dispatch (NTT.ntt_forward,
              NTT.ntt_inverse, bconv.base_convert) patched to its plain
              version, decrypt to the slot-wise products m1 * m2 mod t (the
              decryptions launch K3 too) and keep a positive noise budget.
              K4 is driven at its own entry point, the tensor-product stage
              of the same multiply: it must launch, equal the evaluator's
              unfused stage, and give the step's product through the floor.
              K3 launches STEP_K3_LAUNCHES times a step (the floor and the
              joined Shenoy-Kumaresan pair; the BEHZ lift of each operand
              two more) and its wrapper makes no copy;
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
              cluster NTT kernel (one launch per transform, 9 a step, none of
              the two-launch yardstick's) and K3, equal its all-plain run and
              decrypt right; K4 at its entry point at the step's q and Bsk
              shapes (its large cluster kernel, one launch a call, nothing
              else) equals the unfused stage and its floor the multiply;
              then each cluster kernel against its yardstick in turns (new,
              old, old, new) beside its bound and plain time: the NTT at
              (3, 2, n) for n = 65536 and 131072 and at every NTT call of
              the step, K4 at (3, 2, 2, n); and the NTT's cluster sizes in
              turns (at (3, 2, n) of both degrees, at the step's digits and
              over the step's transforms);
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
 17. harness  Timer and TimerOnce around NTT kernel launches with a CUDA probe,
              in the lines scripts/compare_bench.py parses; the reductions of
              ops/reduction.py on a card tensor against the CPU's;
              poly_to_hex_string of card tensors at both widths; a context
              made by HeContext.create(parms, True, SecurityLevel.Nil), with
              no device argument, on the card;
 18. eager    scripts/torch_troybench.py's eager object-API loop on BFV at
              n = 8192 on the card, every op timed through the port's Timer,
              the multiply + relinearize decrypting right;
 19. examples each twin under examples/torch/ run in this process with no
              arguments (the card is its default device), each ending with
              its OK line, with its seconds and kernel launches;
 20. perop    scripts/torch_troybench_perop.py's per-operation matrix (the
              reference troybench's op list) at n = 8192, batch 16: BFV, BGV
              and CKKS on the 7 x 30-bit chain and BFV on {60, 40, 40, 60},
              inputs from the port's keygen and encryption under seed 7.
              Each row (negate, add, multiply, multiply + relinearize,
              multiply_plain, mod switch, rescale, the two rotations, the
              client's encryptions, decrypt, encode and decode) runs once with
              the counts set to 0: at the fast width it equals its all-plain
              run (BFV multiply + relinearize must launch K1 and K3), at the
              wide width it launches no fast-path kernel but K1 for encode's
              and decode's NTT mod t (and then equals its all-plain run); its
              row 0 equals the object API's result on the same ciphertexts
              and decrypts right.
              Then each row's profiler launches, device ms and K1 / K3
              launches a step, its slope time by CUDA events (chained at two
              repetition counts), and the markdown table;
 21. mesh     parallel/mesh.py on the card: the HPS multiply + relinearize
              step of [main] (batch 16) over (data, limb) = (8, 1), (4, 2)
              and (2, 3) meshes of shards of this card (and (cards, 1) over
              the cards when there are several), and over make_latency_mesh(4)
              on one ciphertext's coefficients (with several cards also
              (cards, 1), (cards / 2, 2) and poly over the cards); each
              equal to the unsharded step on the card bit for bit, products
              0 and 15 (0) decrypting
              right, with its collectives and bytes, per-device bytes, the NTT
              table rows it transformed, K1 and K3 launches per shard and its
              CUDA-event ms against the unsharded step (a partition's overhead
              on one card, not a scaling number); [app]'s BFV matmul + pack
              with mesh=make_mesh(data=4, limb=1), equal to the unsharded run;
              a one-rank NCCL make_multihost_mesh(hosts=1) data-parallel step
              with no collective;
 22. mxu      K2, the matrix-product NTT, under set_ntt_backend("pallas_mxu"),
              restored after: its route (csrc/ntt_mxu_wg.cu to n = 16384,
              the cluster kernel csrc/ntt_mxu_cluster.cu above: a polynomial
              a cluster of 8 or 16 CTAs, one launch a transform) forward
              and inverse (lazy input) bit for bit against its plain version
              (ops/ntt_mxu.py), K1 and the first form (csrc/ntt_mxu.cu, the
              yardstick: its one-CTA kernel to 32768, two launches of its
              stage kernel above) at every degree 256 .. 131072 on 1 to 7
              limbs, above 16384 in every cluster size the kernel takes; at
              the keyswitch digits (96, 7, 8192) and base q (16, 6, 8192) on
              lazy and canonical input; the cluster route's refusals (a
              tensor off 16 bytes, clusters of 4 and 32, a CPU tensor); the
              route against the yardstick and K1 in turns by CUDA graphs at
              those shapes, (3, 2, n) for n = 32768, 65536, 131072 and the
              n = 65536 step's digits (16, 9, 65536), beside the transform's
              bound (ntt_bound, as K1's), each K2 form's method terms
              (wg_terms, cl_terms, mxu_terms: bytes with the table planes,
              int8 tensor-core and int32 operations) and the plane products
              alone as torch._int_mm calls (a yardstick, no route); the
              cluster sizes in turns at (3, 2, 65536) and the digits;
              [main]'s HPS multiply + relinearize and rotate_rows(1) on a
              context built under the backend: 5 forward and 4 inverse K2
              launches a step and no K1, each equal to the K1 step and to
              its all-plain run, ciphertexts 0 and 15 decrypting; and
              [large_n]'s n = 65536 HPS step on a context built under the
              backend: the cluster kernel 5 + 4 launches, K3 2, no K1 and no
              first form, equal to the K1 step and the all-plain step, both
              products decrypting; each with the profiler's launches, device
              ms, K2 ms and busy share beside its K1 step's;
 23. times    CUDA-event times of the chained steps against their all-plain
              versions (multiply + relinearize, the three rotations, the mod
              switch), the profiler's launches, device time, NTT kernel time
              and busy share of the HPS step and of one rotate_rows(1) and
              one rotate_columns step, one Galois round split into its
              stages (gather, keyswitch, add), each kernel against its plain
              version (K4 also against the unfused kernel path), and the NTT
              kernel against the earlier radix-2 kernel in turns (new, old,
              old, new) at every NTT shape of the HPS step and the Galois round,
              and K4 against its earlier radix-2 kernel the same way over q,
              over Bsk and at the degrees of K4_DEGREES, and K3 against its
              first kernel the same way at every conversion of [kernels] but
              the generic ones (the joined Shenoy-Kumaresan launch also
              against the copy and two launches it replaced), and the HPS
              step's K3 calls summed: device microseconds per launch from
              CUDA events around a CUDA graph of 50 launches, beside the
              launch's bound.

Bounds: the least time the card could take for a launch's work, the larger
of its bytes (each input read once, each output written once) over
3.35 TB/s and its int32 operations over 132 SMs x 64 lanes x 1.98 GHz
(the H100 SXM's published memory rate and boost clock); K2's bound is
the transform's, as K1's, and its method's terms (wg_terms for the kernel
to 16384, cl_terms for the cluster kernel, mxu_terms for the first form:
its table planes' bytes, int8 tensor-core operations over 1979 TOPS, the
split and recombination's int32 operations) are printed beside it.

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
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from troy_tpu_torch.utils.timer import launch_counts, reset_launch_counts

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
LARGE_DEGREES = (65536, 131072)   # the cluster routes
REFUSED_DEGREE = 262144           # above the reference's largest degree
CKKS_SCALE = 2.0 ** 25
N_LARGE = 65536
LARGE_BITS = [30] * 9             # 8 data primes + the special prime
LARGE_BATCH = 2
STEP_NTT_LAUNCHES = 9             # the n = 65536 HPS step's transforms, one launch each
STEP_K3_LAUNCHES = {"hps": 2, "behz": 4}  # K3 a BFV multiply: the floor and the joined SK
# pair (the BEHZ lift of each operand two more)
BCONV_DRAM_BATCH = 64             # the floor at (64, 3, 6, n): 189 MB, past the 50 MB L2
BCONV_FORMS = range(1, 18)        # [build]: K3's forms by L_in (17: shared-memory inputs)
CLUSTER_SWEEP = {65536: (4, 3, 2, 1), 131072: (4, 3, 2)}  # log2 C of the NTT, timed in turns
LWE_COUNT, LWE_GROUPS = 64, 4        # [lwe]: LWEs packed, and groups of them batched
APP_BITS = [30] * 4                   # [app]: the reference's app-bench chain
APP_MATMUL = (100, 105, 110)          # batch x input x output (matmul_bench.py)
APP_CONV = (4, 3, 16, 32, 32, 3, 3)   # B, Ci, Co, H, W, kh, kw (app_bench.py)
MESH_LAYOUTS = ((8, 1), (4, 2), (2, 3))  # [mesh]: (data, limb) of the step's shards
MESH_POLY = 4                         # [mesh]: coefficient shards of one ciphertext
MESH_APP_DATA = 4                     # [mesh]: the app matmul over (data=4, limb=1)
MESH_REPS = 5
_FWD = "troy_tpu/ops/ntt_pallas.py:74"
_INV = "troy_tpu/ops/ntt_pallas.py:89"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "ntt_forward": ("troy_tpu_torch/csrc/ntt.cu", _FWD),
    "ntt_inverse": ("troy_tpu_torch/csrc/ntt.cu", _INV),
    "ntt_forward_cluster": ("troy_tpu_torch/csrc/ntt.cu", _FWD),
    "ntt_inverse_cluster": ("troy_tpu_torch/csrc/ntt.cu", _INV),
    "ntt_forward_mxu": ("troy_tpu_torch/csrc/ntt_mxu_wg.cu", "troy_tpu/ops/ntt_pallas.py:206"),
    "ntt_inverse_mxu": ("troy_tpu_torch/csrc/ntt_mxu_wg.cu", "troy_tpu/ops/ntt_pallas.py:228"),
    "base_convert": ("troy_tpu_torch/csrc/bconv.cu", "troy_tpu/ops/ntt_pallas.py:413"),
    "fused_negacyclic_multiply": ("troy_tpu_torch/csrc/fused_mul.cu",
                                  "troy_tpu/ops/fused_mul.py:75"),
    "fused_mul_large": ("troy_tpu_torch/csrc/fused_mul_large.cu",
                        "troy_tpu/ops/fused_mul.py:75"),
    "ntt_forward_mxu_cluster": ("troy_tpu_torch/csrc/ntt_mxu_cluster.cu",
                                "troy_tpu/ops/ntt_pallas.py:206"),
    "ntt_inverse_mxu_cluster": ("troy_tpu_torch/csrc/ntt_mxu_cluster.cu",
                                "troy_tpu/ops/ntt_pallas.py:228"),
}
NTT_KERNELS = [k for k in KERNELS if k.startswith("ntt_")]
MXU_KERNELS = ("ntt_forward_mxu", "ntt_inverse_mxu")   # K2, under set_ntt_backend("pallas_mxu")
MXU_CLUSTER_KERNELS = ("ntt_forward_mxu_cluster", "ntt_inverse_mxu_cluster")  # K2 above 16384
# K2's first form (csrc/ntt_mxu.cu: its one-CTA kernel to n = 32768, two
# launches of its stage kernel above): the yardstick the route's two kernels
# are timed against, on no path at any degree; listed in the kernels line
# beside the route's kernels.
MXU_YARDSTICKS = {
    "ntt_forward_mxu_mma": ("troy_tpu_torch/csrc/ntt_mxu.cu", "troy_tpu/ops/ntt_pallas.py:206"),
    "ntt_inverse_mxu_mma": ("troy_tpu_torch/csrc/ntt_mxu.cu", "troy_tpu/ops/ntt_pallas.py:228"),
    "ntt_forward_mxu_stages": ("troy_tpu_torch/csrc/ntt_mxu.cu",
                               "troy_tpu/ops/ntt_pallas.py:206"),
    "ntt_inverse_mxu_stages": ("troy_tpu_torch/csrc/ntt_mxu.cu",
                               "troy_tpu/ops/ntt_pallas.py:228")}
# The cluster routes' yardsticks (the two-launch NTT pair and the tensor
# product between its calls): timed against them in [large_n], held to their
# plain versions in [kernels], launched on no path.
YARDSTICKS = ("ntt_forward_columns", "ntt_forward_blocks", "ntt_inverse_blocks",
              "ntt_inverse_columns", "tensor_product")
# K3's first kernel (csrc/bconv_first.cu): timed against K3 in turns in
# [times], held to the plain version in [kernels], launched on no path;
# listed in the kernels line beside K3.
BCONV_YARDSTICKS = {"base_convert_first": ("troy_tpu_torch/csrc/bconv_first.cu",
                                         "troy_tpu/ops/ntt_pallas.py:413")}


MEM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # SMs x int32 lanes x boost clock
INT8_OPS_PER_S = 1979e12              # H100 SXM dense INT8 tensor cores (data sheet)
# K2's first form's int32 operations a value, counted from csrc/ntt_mxu.cu (an add, a
# subtract, a shift, a mask, a compare or a select each one; a Shoup
# product x w - umulhi(x, w') q three: two multiplies and a multiply-add):
# split_digits and its packing into the plane words, once a stage (the
# conditional subtract 3, b0 and c0 2, b1 and c1 4, b2 and c2 4, three
# digits 3 each, the top digit 2; 4 shifts and 4 ors), 32; recombine, once a
# stage, by the pair fold (contraction <= 128: three folded sums 2 each, the
# first shifted Shoup product 4, three more 4 each with an add and a
# conditional subtract of 2q 3, the conditional subtract of q 3 and the
# correction 5), 42, or by the 7 single diagonals, 60; the twiddle's
# shoup_full once a transform, 6.  These are the work of K2's method, not of
# the transform: the transform's bound is ntt_bound, as K1's.
MXU_SPLIT_OPS = 32
MXU_FOLD_OPS, MXU_DIAG_OPS = 42, 60
MXU_TWIDDLE_OPS = 6
# The redesigned kernel's int32 operations a value, counted from
# csrc/ntt_mxu_wg.cu with the same rule (a wide multiply-add two, a byte
# permute, a funnel shift, a min one): split_item, once a transform (the
# conditional subtract min(x, x - q) 2, eight byte permutes for four values
# 2), 4; recombine, once a stage (the fold P4 + 2^8 P5 1, five wide
# multiply-adds 10, the funnel shift 1, umulhi 1, the multiply-subtract 1),
# 14; the twiddle, once (the Shoup product 3, a conditional subtract 2), 5;
# the handoff of stage 1's values into stage 2's planes (two byte permutes
# for two values), 1; the output's two conditional subtracts, 4.  At every
# degree: 4 + 14 + 5 + 1 + 14 + 4 = 42.
WG_SPLIT_OPS, WG_RECOMBINE_OPS, WG_TWIDDLE_OPS, WG_HANDOFF_OPS, WG_FINAL_OPS = 4, 14, 5, 1, 4
WG_OPS = WG_SPLIT_OPS + 2 * WG_RECOMBINE_OPS + WG_TWIDDLE_OPS + WG_HANDOFF_OPS + WG_FINAL_OPS
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


def mxu_terms(shape) -> dict:
    """The least times of K2's method on (..., L, n) int64, in microseconds,
    beside the transform's own bound (ntt_bound): 'bytes', the values in and
    out and the limbs' table planes and twiddles read once, over 3.35 TB/s;
    'int8', the 16 plane products of both stages, 2 x 16 x n (n1 + n2)
    operations a polynomial, over 1979 TOPS; 'int32', the split and
    recombination of both stages and the twiddle (MXU_*_OPS) over 16.7 T/s."""
    polys, n = int(np.prod(shape[:-1])), shape[-1]
    a = (n.bit_length() - 1) // 2
    n1, n2 = 1 << a, n >> a
    nbytes = 2 * polys * n * 8 + shape[-2] * (4 * (n1 * n1 + n2 * n2) + 8 * n)
    recombine = sum(MXU_FOLD_OPS if k <= 128 else MXU_DIAG_OPS for k in (n1, n2))
    int32 = 2 * MXU_SPLIT_OPS + recombine + MXU_TWIDDLE_OPS
    return {"bytes": nbytes / MEM_BYTES_PER_S * 1e6,
            "int8": polys * 2 * 16 * n * (n1 + n2) / INT8_OPS_PER_S * 1e6,
            "int32": polys * n * int32 / INT32_OPS_PER_S * 1e6}


def wg_grid(shape, ctas_per_sm: int) -> int:
    """The redesigned kernel's CTAs on (..., L, n), as ntt_mxu_wg.cu:launch
    sizes its grid: limbs x runs of a limb's rows, filling the card."""
    L, batch = shape[-2], int(np.prod(shape[:-2]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = max(1, ctas_per_sm * sms // L)
    per = -(-batch // runs)
    return -(-batch // per) * L


def wg_terms(shape, ctas: int, inverse: bool = False) -> dict:
    """The least times of the redesigned kernel's method on (..., L, n)
    int64, in microseconds, beside the transform's own bound (ntt_bound):
    'bytes', the values in and out, each CTA's table planes loaded once
    (wg_plan's t1 + t2, `ctas` CTAs) and a twiddle pair a value, over 3.35
    TB/s; 'int8', the 16 plane products of both stages with the tables'
    padding (2 x 16 x Mp x N x Kp a stage), over 1979 TOPS; 'int32', WG_OPS
    a value over 16.7 T/s."""
    from troy_tpu_torch.ops import ntt_mxu as MX

    polys, n = int(np.prod(shape[:-1])), shape[-1]
    p = MX.wg_plan(n.bit_length() - 1, inverse)
    nbytes = 2 * polys * n * 8 + ctas * (p["t1"] + p["t2"]) + polys * n * 8
    int8 = polys * 2 * 16 * (p["M1p"] * p["N1"] * p["K1p"] + p["M2p"] * p["N2"] * p["K2p"])
    return {"bytes": nbytes / MEM_BYTES_PER_S * 1e6, "int8": int8 / INT8_OPS_PER_S * 1e6,
            "int32": polys * n * WG_OPS / INT32_OPS_PER_S * 1e6}


def cl_terms(shape, inverse: bool = False, log_c: int | None = None) -> dict:
    """The least times of the cluster kernel's method (csrc/ntt_mxu_cluster.cu)
    on (..., L, n) int64, in microseconds, beside the transform's own bound
    (ntt_bound): 'bytes', the values in and out, a twiddle pair a value,
    and both tables' planes streamed by every CTA of a polynomial's cluster
    (C (4 M1 K1 + 4 M2 K2) a polynomial, from L2 where they stay), over
    3.35 TB/s; 'int8', the 16 plane products of both stages (2 x 16 x M x N
    x K a stage, no padding above 16384), over 1979 TOPS; 'int32', WG_OPS a
    value (the same arithmetic as ntt_mxu_wg.cu), over 16.7 T/s.  The
    hand-off across the cluster, 4 bytes a value over distributed shared
    memory, has no published rate and no term."""
    from troy_tpu_torch.ops import ntt_mxu as MX

    polys, n = int(np.prod(shape[:-1])), shape[-1]
    p = MX.cl_plan(n.bit_length() - 1, inverse, log_c)
    tables = 4 * (p["M1"] * p["K1"] + p["M2"] * p["K2"])
    nbytes = polys * (2 * n * 8 + n * 8 + p["C"] * tables)
    int8 = polys * 2 * 16 * (p["M1"] * p["N1"] * p["K1"] + p["M2"] * p["N2"] * p["K2"])
    return {"bytes": nbytes / MEM_BYTES_PER_S * 1e6, "int8": int8 / INT8_OPS_PER_S * 1e6,
            "int32": polys * n * WG_OPS / INT32_OPS_PER_S * 1e6}


def bconv_bound(shape, l_out: int) -> tuple[float, str]:
    """K3 on (..., L_in, n) -> (..., L_out, n): per column a Shoup scale of
    each input (3 ops), a 64-bit multiply-add per input and output (2), one
    Barrett reduction per output (6)."""
    l_in, cols = shape[-2], int(np.prod(shape[:-2])) * shape[-1]
    return bound_us((l_in + l_out) * cols * 8, cols * (3 * l_in + 2 * l_in * l_out + 6 * l_out))


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
    "ntt_cluster_kernelILi4ELb0": "ntt_forward_cluster (split 4)",
    "ntt_cluster_kernelILi4ELb1": "ntt_inverse_cluster (split 4)",
    "ntt_cluster_kernelILi3ELb0": "ntt_forward_cluster (split 3)",
    "ntt_cluster_kernelILi3ELb1": "ntt_inverse_cluster (split 3)",
    "fused_mul_large_kernelILi12ELi4E": "fused_mul_large at n = 65536 (C = 16)",
    "fused_mul_large_kernelILi13ELi4E": "fused_mul_large at n = 131072 (C = 16)",
    "tensor_product_kernel": "tensor_product",
    "ntt_forward_radix2": "ntt_forward radix-2 yardstick",
    "ntt_inverse_radix2": "ntt_inverse radix-2 yardstick",
    "fused_mul_kernelILi13E": "fused_negacyclic_multiply at n = 8192",
    "ntt_mxu_kernelILb0": "ntt_forward_mxu_mma", "ntt_mxu_kernelILb1": "ntt_inverse_mxu_mma",
    "ntt_mxu_stage_kernel": "ntt_mxu stage kernel (n > 32768)",
    "ntt_mxu_wg_kernelILb0ELb1": "ntt_forward_mxu (n <= 8192)",
    "ntt_mxu_wg_kernelILb1ELb1": "ntt_inverse_mxu (n <= 8192)",
    "ntt_mxu_wg_kernelILb0ELb0": "ntt_forward_mxu (n = 16384)",
    "ntt_mxu_wg_kernelILb1ELb0": "ntt_inverse_mxu (n = 16384)",
    "fused_mul_radix2": "fused_negacyclic_multiply radix-2 yardstick",
    "ntt_mxu_cluster_kernelILb0ELi32ELi16E": "ntt_forward_mxu_cluster (n = 32768, C = 8)",
    "ntt_mxu_cluster_kernelILb0ELi32ELi32E": "ntt_forward_mxu_cluster (R = 32)",
    "ntt_mxu_cluster_kernelILb0ELi16ELi16E": "ntt_forward_mxu_cluster (R = 16)",
    "ntt_mxu_cluster_kernelILb1ELi16ELi32E": "ntt_inverse_mxu_cluster (R1 = 16, R2 = 32)",
    "ntt_mxu_cluster_kernelILb1ELi32ELi32E": "ntt_inverse_mxu_cluster (R = 32)",
    "ntt_mxu_cluster_kernelILb1ELi16ELi16E": "ntt_inverse_mxu_cluster (R = 16)",
    "bconv_kernelILi0E": "base_convert, L_in > 16 (shared-memory inputs)",
    "bconv_kernelILi3E": "base_convert, L_in = 3", "bconv_kernelILi6E": "base_convert, L_in = 6",
    "bconv_kernelILi8E": "base_convert, L_in = 8",
    "bconv_first_kernel": "base_convert_first (the first kernel)"}


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
        elif "wgmma" in line:  # a serialized wgmma pipeline
            log(f"[build] ptxas, {source_of(line)}: {line.split(':', 1)[-1].strip()}")


def source_of(line: str) -> str:
    """The kernel a ptxas line names, by PTXAS_NAMES, or the line's function."""
    return next((v for k, v in PTXAS_NAMES.items() if k in line), "a kernel")


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
    return HeContext.create(parms, sec_level=SecurityLevel.Nil, device=dev)


def residues(shape, q: torch.Tensor, gen, factor: int = 1) -> torch.Tensor:
    """Uniform int64 residues of shape (..., L, n) below factor * q."""
    return torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                         device=q.device) % (q.view(-1, 1) * factor)


def phase_ntt(dev, tables: dict) -> dict:
    """NTT kernels vs plain, and the radix-2 yardstick of [times] too;
    returns max |err| per kernel.  The inverse also takes lazy [0, 2q).
    With a split (n > 32768) the cluster kernel, and each launch of its
    two-launch yardstick against its plain partial transform."""
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
            yard = (f"cluster of {1 << t.split}; the two-launch yardstick's launches against "
                    f"their plain partial transforms: {launch_err}")
            bad = any(launch_err.values())
            fwd, inv = "ntt_forward_cluster", "ntt_inverse_cluster"
        else:
            ok = (torch.equal(ntt_cuda.run_radix2(False, x, t), y_ref)
                  and torch.equal(ntt_cuda.run_radix2(True, y, t), z_ref))
            yard, bad = f"radix-2 yardstick equal: {ok}", not ok
            fwd, inv = "ntt_forward", "ntt_inverse"
        err[fwd] = max(err[fwd], e_f)
        err[inv] = max(err[inv], e_i)
        torch.cuda.synchronize()
        back = bool(torch.equal(z, canon))
        log(f"[kernels] ntt {label} {shape}: forward max|err| {e_f}, "
            f"inverse max|err| {e_i}, inverse(forward(x)) == x: {back}, {yard}")
        if e_f or e_i or not back or bad:
            raise AssertionError(f"[kernels] ntt {label}: kernel disagrees with plain")
    return err


def bconv_input(lead, tabs, layout: str, gen) -> torch.Tensor:
    """K3's input for a case: (*lead, L_in, n) residues laid out as
    `layout` says: "contiguous"; "strided", the first L_in rows of a
    contiguous (*lead, L_in + 1, n) tensor (the step's Shenoy-Kumaresan
    slice); "odd n", n = N - 1; "unaligned", a contiguous view 8 bytes off
    16-byte alignment (the last two: rows off 16-byte alignment)."""
    n = N - 1 if layout == "odd n" else N
    x = residues((*lead, tabs.L_in, n), tabs.q_in, gen)
    if layout == "strided":
        return torch.cat([x, torch.zeros_like(x[..., :1, :])], dim=-2)[..., :-1, :]
    if layout == "unaligned":
        buf = torch.empty(x.numel() + 1, dtype=torch.int64, device=x.device)
        buf[1:].copy_(x.flatten())
        return buf[1:].view(x.shape)
    return x


def phase_bconv(dev, cases: dict) -> dict:
    """K3 vs plain at each case (lead, tables, layout), and the first
    kernel (the yardstick) on the same input made contiguous; a strided case goes in
    with no copy, a view the kernel cannot address through one counted
    copy.  Returns max |err| of K3 and of the yardstick."""
    from troy_tpu_torch.ops import bconv as BC, bconv_cuda

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"base_convert": 0, "base_convert_first": 0}
    for label, (lead, tabs, layout) in cases.items():
        x = bconv_input(lead, tabs, layout, gen)
        reset_launch_counts()
        y = BC.base_convert(x, tabs)
        torch.cuda.synchronize()
        counts = launch_counts()
        y_ref = BC.base_convert_plain(x, tabs)
        first = bconv_cuda.run_first(x.contiguous(), tabs)
        torch.cuda.synchronize()
        e = int((y - y_ref).abs().max())
        e_first = int((first - y_ref).abs().max())
        in_range = bool((y < tabs.p_out.view(-1, 1)).all() and (y >= 0).all())
        log(f"[kernels] base_convert {label} {tuple(x.shape)} (strides {x.stride()}) -> "
            f"{tuple(y.shape)}: max|err| {e}, output in [0, p): {in_range}; launches "
            f"{counts['base_convert']}, copies {counts['base_convert_copy']}; the first "
            f"kernel max|err| {e_first}")
        if (e or e_first or not in_range or y.shape != y_ref.shape
                or counts["base_convert"] != 1 or counts["base_convert_copy"]):
            raise AssertionError(f"[kernels] base_convert {label}: kernel disagrees or copied")
        worst = {"base_convert": max(worst["base_convert"], e),
                 "base_convert_first": max(worst["base_convert_first"], e_first)}
    # a view the kernel cannot address (limbs not n apart): one counted copy
    lead, tabs, _ = next(iter(cases.values()))
    x = residues((*lead, tabs.L_in, N), tabs.q_in, gen).transpose(-1, -2).contiguous()
    x = x.transpose(-1, -2)
    reset_launch_counts()
    y = BC.base_convert(x, tabs)
    counts = launch_counts()
    if (counts["base_convert_copy"], counts["base_convert"]) != (1, 1) or \
            not torch.equal(y, BC.base_convert_plain(x, tabs)):
        raise AssertionError(f"[kernels] base_convert on strides {x.stride()}: {counts}")
    log(f"[kernels] base_convert on a view with limbs at stride 1 {tuple(x.shape)}: one "
        f"counted copy, then the kernel, equal to plain")
    return worst


def phase_fused(dev, cases: dict) -> dict:
    """Fused tensor-product kernel vs plain on lazy [0, 2q) input, and the
    radix-2 yardstick of [times] too (n <= 32768); above, the large cluster
    kernel, and its five-launch yardstick and that route's tensor-product
    kernel against dyadic_convolute.  Returns max |err| of K4's two
    kernels."""
    from troy_tpu_torch.ops import dyadic as D, fused_mul as FM, fused_mul_cuda, ntt as NTT

    gen = torch.Generator(device=dev).manual_seed(4)
    err = {"fused_negacyclic_multiply": 0, "fused_mul_large": 0}
    for label, (lead, t) in cases.items():
        shape = (*lead, 2, t.size, t.n)
        a, b = residues(shape, t.q, gen, 2), residues(shape, t.q, gen, 2)
        c = fused_mul_cuda.fused_negacyclic_multiply(a, b, t)
        c_ref = FM.fused_negacyclic_multiply_plain(a, b, t)
        if t.split:
            y = NTT.ntt_forward_plain(torch.cat([a, b], dim=-3), t)
            e_tp = int((fused_mul_cuda.tensor_product(y, t)
                        - D.dyadic_convolute(y[..., :2, :, :], y[..., 2:, :, :], t)).abs().max())
            e_five = int((fused_mul_cuda.run_five_launch(a, b, t) - c_ref).abs().max())
            yard = (f"cluster of {1 << t.split}; five-launch yardstick max|err| {e_five}, "
                    f"its tensor-product kernel max|err| {e_tp}")
            bad, name = e_tp != 0 or e_five != 0, "fused_mul_large"
        else:
            ok = torch.equal(fused_mul_cuda.run_radix2(a, b, t), c_ref)
            yard, bad, name = f"radix-2 yardstick equal: {ok}", not ok, "fused_negacyclic_multiply"
        torch.cuda.synchronize()
        e = int((c - c_ref).abs().max())
        log(f"[kernels] {name} {label} {shape} -> {tuple(c.shape)}: max|err| {e}, {yard}")
        if e or c.shape != c_ref.shape or bad:
            raise AssertionError(f"[kernels] fused {label}: kernel disagrees with plain")
        err[name] = max(err[name], e)
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
        "coefficients not at stride 1": (xb[..., ::2], ValueError),
        "limbs not n apart": (xb.transpose(-1, -2).contiguous().transpose(-1, -2), ValueError),
        "rows overlapping": (xb[:1].expand(2, -1, -1), ValueError),
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

    # the cluster routes: a cluster of 32 CTAs (split 5, the two-launch
    # yardstick's at 131072), K4 in clusters of 8 at 131072 (four blocks of
    # 16384 do not fit a CTA), a CPU tensor
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.ops.ntt import NTTTables
    from troy_tpu_torch.utils import numth

    top = max(LARGE_DEGREES)
    log_top = top.bit_length() - 1
    mods = [Modulus(p) for p in numth.get_primes(2 * top, 30, 1)]
    by_split = {k: NTTTables(log_top, mods, dev, split=k) for k in (5, 3, None)}
    x = torch.zeros((1, 1, top), dtype=torch.int64, device=dev)
    for inverse in (False, True):
        fn = ntt_cuda.ntt_inverse if inverse else ntt_cuda.ntt_forward
        expect_refusals(f"{fn.__name__} at n = {top}", lambda v: fn(*v), {
            "cluster of 32 CTAs": ((x, by_split[5]), ValueError),
            "CPU tensor": ((x.cpu(), by_split[None]), ValueError)})
    ab = torch.zeros((1, 2, 1, top), dtype=torch.int64, device=dev)
    expect_refusals(f"fused_negacyclic_multiply at n = {top}",
                    lambda v: fused_mul_cuda.fused_negacyclic_multiply(v[0], v[0], v[1]), {
                        "cluster of 32 CTAs": ((ab, by_split[5]), ValueError),
                        "cluster of 8 CTAs": ((ab, by_split[3]), ValueError),
                        "CPU tensor": ((ab.cpu(), by_split[None]), ValueError)})


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
    context = HeContext.create(parms, True, SecurityLevel.Classical128, device=dev)
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
    result = encoder.decode(decryptor.decrypt(ct_sum))
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
    context_sp = HeContext.create(parms, True, SecurityLevel.Classical128, device=dev)
    pk_sp = KeyGenerator(context_sp, gen, sk=keygen.secret_key).create_public_key()
    ct_sp = Encryptor(context_sp, pk=pk_sp, generator=gen).encrypt_asymmetric(encoder.encode(x))
    cases["special-prime encrypt_asymmetric"] = (ct_sp, x.astype(np.int64))
    for label, (ct, want) in cases.items():
        got = encoder.decode(decryptor.decrypt(ct))
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
    "ntt_forward_cluster": ("ntt_cluster_kernel<", ", false>"),
    "ntt_inverse_cluster": ("ntt_cluster_kernel<", ", true>"),
    "base_convert": ("bconv_kernel",), "fused_negacyclic_multiply": ("fused_mul_kernel",),
    "fused_mul_large": ("fused_mul_large_kernel",),
    "ntt_forward_mxu": ("ntt_mxu_wg_kernel<false",), "ntt_inverse_mxu": ("ntt_mxu_wg_kernel<true",),
    "ntt_forward_mxu_mma": ("ntt_mxu_kernel<false>",),
    "ntt_inverse_mxu_mma": ("ntt_mxu_kernel<true>",),
    "ntt_forward_mxu_cluster": ("ntt_mxu_cluster_kernel<false",),
    "ntt_inverse_mxu_cluster": ("ntt_mxu_cluster_kernel<true",),
    "ntt_mxu_stages": ("ntt_mxu_stage_kernel",)}


PROFILER_ATTEMPTS = 5   # sessions a call, until a call's every session recorded nothing
PROFILER_PAUSE_S = 1.0
PROFILER = {"failed": 0}  # calls that took counted_step
COUNTED = {**{name: (name,) for name in PROFILED},  # kernel: its wrappers' counters
           "ntt_mxu_stages": ("ntt_forward_mxu_stages", "ntt_inverse_mxu_stages")}


def profiler_kernels(fn, calls: int) -> list:
    """One profiler session over `calls` calls of fn: the key averages of
    its device kernels (the leading spin kernel left out)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler at times drops a session's first kernel: let that be
        # this spin_kernel, which is not counted either way
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
            and "spin_kernel" not in e.key]


def profile_step(fn, calls: int) -> dict:
    """Per call of fn, from the profiler's device events: kernel launches,
    device milliseconds, and each port kernel's launches and milliseconds.
    The profiler at times records no device kernel in a session, and then in
    every later one of the process: after PROFILER_ATTEMPTS such sessions
    (one, once a call has failed) the port kernels' launches come from their
    wrappers' counts and every device time and the step's launch count are
    not measured (nan)."""
    attempts = 1 if PROFILER["failed"] else PROFILER_ATTEMPTS
    for attempt in range(1, attempts + 1):
        kernels = profiler_kernels(fn, calls)
        if kernels:
            break
        log(f"[times] the profiler recorded no device kernels (attempt {attempt} of "
            f"{attempts})")
        time.sleep(PROFILER_PAUSE_S)
    else:
        PROFILER["failed"] += 1
        return counted_step(fn, calls, attempts)
    out = {"launches": sum(e.count for e in kernels) / calls,
           "ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
           "profiled": True}
    for name, parts in PROFILED.items():
        mine = [e for e in kernels if all(p in e.key for p in parts)]
        out[name] = (sum(e.count for e in mine) / calls,
                     sum(e.self_device_time_total for e in mine) / 1e3 / calls)
    return out


def counted_step(fn, calls: int, sessions: int) -> dict:
    """profile_step's result where the profiler records nothing: each port
    kernel's launches a call of fn by its wrappers' counts; the step's
    launches and every device time nan (not measured)."""
    before = launch_counts()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    after = launch_counts()
    nan = float("nan")
    log(f"[times] the profiler recorded no device kernels in {sessions} session(s): "
        "the port kernels' launches from their counts, device times not measured")
    out = {"launches": nan, "ms": nan, "profiled": False}
    for name, keys in COUNTED.items():
        out[name] = (sum(after[k] - before[k] for k in keys) / calls, nan)
    return out


def measured(x: float):
    """x, or None where it was not measured (nan): JSON has no nan."""
    return None if x != x else x


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
    """The bound of one launch of kernel `name` on a dispatch call's input
    (every NTT kernel of a path does a whole transform a launch)."""
    if name == "base_convert":
        return bconv_bound(shape, t.L_out)
    return ntt_bound(shape)   # K1 and K2 alike: the same transform


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


def phase_bconv_ab(gpu: str, dev, cases: dict, sk_parts: tuple) -> dict:
    """K3 against the first kernel in turns (new, old, old, new) by CUDA
    graphs at each case (lead, tables, layout), beside its bound and the
    plain version; the first kernel reads a contiguous copy made beforehand.
    At the strided (joined Shenoy-Kumaresan) case, also the route it
    replaced: the copy of the B rows, then one launch into q and one into
    m_sk (sk_parts), of the first kernel and of K3, in turns.  Returns
    {label: dict(us, first_us, plain_us, bound, by)}."""
    from troy_tpu_torch.ops import bconv as BC, bconv_cuda

    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for label, (lead, tabs, layout) in cases.items():
        x = bconv_input(lead, tabs, layout, g)
        xc = x.contiguous()
        new = lambda: BC.base_convert(x, tabs)
        old = lambda: bconv_cuda.run_first(xc, tabs)
        n1, o1, o2, n2 = graph_us(new), graph_us(old), graph_us(old), graph_us(new)
        plain_us = graph_us(lambda: BC.base_convert_plain(x, tabs), PLAIN_REPS)
        bound, by = bconv_bound(tuple(x.shape), tabs.L_out)
        us, first_us = min(n1, n2), min(o1, o2)
        out[label] = dict(us=us, first_us=first_us, plain_us=plain_us, bound=bound, by=by)
        log(f"[times] {gpu}: base_convert {label} {tuple(x.shape)} -> {tabs.L_out} limbs: "
            f"K3 {n1:.3f} / {n2:.3f} us, the first kernel {o1:.3f} / {o2:.3f} us a launch "
            f"(graph of {GRAPH_LAUNCHES}); bound {bound:.3f} us ({by}); share of the bound "
            f"{100 * bound / us:.1f}% against {100 * bound / first_us:.1f}%; "
            f"{first_us / us:.2f}x; plain {plain_us:.3f} us")
        if layout != "strided":
            continue
        to_q, to_msk = sk_parts
        routes = {
            "joined": new,
            "copy + 2 first-kernel launches": lambda: [
                bconv_cuda.run_first(y, t) for y in (x.contiguous(),) for t in (to_q, to_msk)],
            "copy + 2 K3 launches": lambda: [
                BC.base_convert(y, t) for y in (x.contiguous(),) for t in (to_q, to_msk)],
            "the copy alone": lambda: x.contiguous()}
        order = list(routes) + list(routes)[::-1]
        got = {}
        for name in order:
            got.setdefault(name, []).append(graph_us(routes[name]))
        log(f"[times] {gpu}: Shenoy-Kumaresan conversion {tuple(x.shape)} -> "
            f"{to_q.L_out} + {to_msk.L_out} limbs, in turns: " + ", ".join(
                f"{k} {v[0]:.3f} / {v[1]:.3f} us" for k, v in got.items())
            + f"; the joined launch's bound {bound:.3f} us; the two launches' bounds "
            f"{bconv_bound(tuple(x.shape), to_q.L_out)[0]:.3f} + "
            f"{bconv_bound(tuple(x.shape), to_msk.L_out)[0]:.3f} us")
        out[label]["routes"] = {k: min(v) for k, v in got.items()}
    return out


def step_k3(gpu: str, dev, fn) -> dict:
    """K3's launches in one call of fn, each input recorded with its shape
    and strides: the sum of their graph times on fresh inputs laid out the
    same, beside the sum of their bounds, in turns with the first kernel's route of
    the same conversions (a strided input copied first and a joined
    table's last row converted by a launch of its own)."""
    from troy_tpu_torch.ops import bconv as BC, bconv_cuda

    calls = []
    real = BC.base_convert

    def rec(x, t):
        calls.append((tuple(x.shape), x.stride(), t))
        return real(x, t)
    with mock.patch.object(BC, "base_convert", rec):
        fn()
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(12)
    items = []
    for shape, stride, t in calls:
        span = 1 + sum((size - 1) * st for size, st in zip(shape, stride))
        buf = torch.randint(0, int(t.q_in.min()), (span,), generator=g, dtype=torch.int64,
                            device=dev)
        x = buf.as_strided(shape, stride)
        parts = None if x.is_contiguous() else (
            BC.take_outputs(t, range(t.L_out - 1)), BC.take_outputs(t, [t.L_out - 1]))
        items.append((x, t, parts))

    def new():
        for x, t, _ in items:
            BC.base_convert(x, t)

    def old():
        for x, t, parts in items:
            if parts is None:
                bconv_cuda.run_first(x, t)
            else:
                y = x.contiguous()
                for part in parts:
                    bconv_cuda.run_first(y, part)
    n1, o1, o2, n2 = graph_us(new, 20), graph_us(old, 20), graph_us(old, 20), graph_us(new, 20)
    bound = sum(bconv_bound(tuple(x.shape), t.L_out)[0] for x, t, _ in items)
    us = min(n1, n2)
    log(f"[times] {gpu}: the HPS step's K3: {len(items)} launches at "
        f"{[(tuple(x.shape), x.is_contiguous()) for x, _, _ in items]} (shape, contiguous): "
        f"{n1:.3f} / {n2:.3f} us a step by CUDA graphs, bound {bound:.3f} us "
        f"({100 * bound / us:.1f}%); the first kernel's route "
        f"({sum(2 if p else 1 for _, _, p in items)} launches and "
        f"{sum(p is not None for _, _, p in items)} copies) "
        f"{o1:.3f} / {o2:.3f} us")
    return dict(us=us, first_us=min(o1, o2), bound=bound, launches=len(items))


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
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, seed=KEY_SEED, device=dev)
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
    ctx = HeContext.create(bgv_parms(False), True, SecurityLevel.Nil, seed=KEY_SEED, device=dev)
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
    sp_ctx = HeContext.create(bgv_parms(True), True, SecurityLevel.Nil, seed=KEY_SEED, device=dev)
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
        got = encoder.decode(sp_dec.decrypt(c))
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
    """BFV multiply + relinearize at n = 65536 through the cluster NTT, K4's
    large cluster kernel at its entry point, then each cluster kernel timed
    against its yardstick, and the cluster sizes in turns."""
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
    from troy_tpu_torch.ops import fused_mul as FM, fused_mul_cuda, ntt as NTT, ntt_cuda

    t0 = time.perf_counter()
    n = N_LARGE
    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, LARGE_BITS))
    parms.set_plain_modulus(PlainModulus.batching(n, LOG_T))
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, device=dev)
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
        f"NTT clusters of {1 << qtab.split} (blocks of {1 << qtab.block_log_n}), keys and "
        f"{2 * LARGE_BATCH} encryptions in {time.perf_counter() - t0:.3f} s")
    step = batched.build_mul_relin_step(rlk)
    out, launches = run_step("large_n", f"HPS step {tuple(d1.shape)} x {tuple(d2.shape)}",
                             lambda: step(d1, d2, rlk),
                             ("ntt_forward_cluster", "ntt_inverse_cluster", "base_convert"))
    calls = record_launches(lambda: step(d1, d2, rlk))
    ntt_calls = [c for c in calls if c[0] != "base_convert"]
    cluster_n = launches["ntt_forward_cluster"] + launches["ntt_inverse_cluster"]
    others = {k: launches[k] for k in ("ntt_forward", "ntt_inverse", *YARDSTICKS) if launches[k]}
    log(f"[large_n] the step's NTT: {cluster_n} cluster kernel launches for its "
        f"{len(ntt_calls)} transforms ({STEP_NTT_LAUNCHES} expected); other NTT kernels "
        f"launched: {others or 'none'}")
    if cluster_n != len(ntt_calls) or cluster_n != STEP_NTT_LAUNCHES or others:
        raise AssertionError("[large_n] the step's transforms are not one cluster launch each")
    if (launches["base_convert"], launches["base_convert_copy"]) != (STEP_K3_LAUNCHES["hps"], 0):
        raise AssertionError(f"[large_n] the step launched K3 {launches['base_convert']} times "
                             f"and copied {launches['base_convert_copy']} inputs")
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
    log(f"[large_n] tensor-product stage through K4's large cluster kernel: launches {k4}")
    if k4["fused_mul_large"] != 2 or any(v for k, v in k4.items() if k != "fused_mul_large"):
        raise AssertionError("[large_n] K4's large route did not make one launch a call")
    if not (torch.equal(fused_q, unfused_stage(d1, d2, qtab))
            and torch.equal(fused_b, unfused_stage(lift["d1"], lift["d2"], bsk))):
        raise AssertionError("[large_n] K4 != the unfused tensor-product stage")
    if not torch.equal(tool.fast_floor_scale_fast_b_conv_sk(fused_q, fused_b),
                       batched.multiply(d1, d2)):
        raise AssertionError("[large_n] the floor of K4's stage != the HPS multiply")
    log("[large_n] K4's large kernel equals the unfused stage over q and Bsk, and its "
        "floor equals the HPS multiply")
    for _ in range(2):
        step(d1, d2, rlk)
    state = {"cur": d1}

    def chained():
        state["cur"] = step(state["cur"], d2, rlk)

    ms = cuda_ms(chained, 5)
    profile = step_report("large_n", gpu, f"HPS multiply + relinearize step, batch {LARGE_BATCH}",
                          lambda: step(d1, d2, rlk), ms, 2)

    # each cluster kernel against its yardstick, in turns (new, old, old,
    # new), by CUDA graphs, beside its bound and its plain version
    g = torch.Generator(device=dev).manual_seed(8)
    yard_tabs = {}

    def yardstick(t):
        """The two-launch route's tables: t's moduli in its blocks of 4096."""
        key = (t.log_n, tuple(m.value for m in t.moduli))
        if key not in yard_tabs:
            yard_tabs[key] = NTT.NTTTables(t.log_n, t.moduli, dev,
                                           split=t.log_n - NTT.LARGE_BLOCK_LOG_N)
        return yard_tabs[key]

    def in_turns(new, old):
        n1, o1, o2, n2 = graph_us(new), graph_us(old), graph_us(old), graph_us(new)
        return (n1, n2), (o1, o2)

    times = {}
    for deg in LARGE_DEGREES:
        t = degrees[deg]
        old_t = yardstick(t)
        shape = (3, t.size, deg)
        x = residues(shape, t.q, g)
        ab = residues((3, 4, t.size, deg), t.q, g, 2)
        a2, b2 = ab[:, :2].contiguous(), ab[:, 2:].contiguous()
        cases = {
            "ntt_forward_cluster": (shape, lambda: ntt_cuda.ntt_forward(x, t),
                                    lambda: ntt_cuda.two_launch(False, x, old_t),
                                    lambda: NTT.ntt_forward_plain(x, t), ntt_bound(shape)),
            "ntt_inverse_cluster": (shape, lambda: ntt_cuda.ntt_inverse(x, t),
                                    lambda: ntt_cuda.two_launch(True, x, old_t),
                                    lambda: NTT.ntt_inverse_plain(x, t), ntt_bound(shape)),
            "fused_mul_large": (tuple(a2.shape),
                                lambda: fused_mul_cuda.fused_negacyclic_multiply(a2, b2, t),
                                lambda: fused_mul_cuda.run_five_launch(a2, b2, old_t),
                                lambda: FM.fused_negacyclic_multiply_plain(a2, b2, t),
                                fused_bound(tuple(a2.shape))),
        }
        for name, (arg, new, old, plain, (bound, by)) in cases.items():
            (n1, n2), (o1, o2) = in_turns(new, old)
            plain_us = graph_us(plain, PLAIN_REPS)
            us, old_us = min(n1, n2), min(o1, o2)
            times[(name, deg)] = (us / 1e3, plain_us / 1e3, bound / 1e3, by, old_us / 1e3)
            yard = "five launches" if name == "fused_mul_large" else "two launches"
            log(f"[large_n] {gpu}: {name} at {arg}, clusters of {1 << t.split}: kernel "
                f"{n1:.3f} / {n2:.3f} us, yardstick ({yard}, blocks of "
                f"{1 << old_t.block_log_n}) {o1:.3f} / {o2:.3f} us a call (graph of "
                f"{GRAPH_LAUNCHES}, in turns); plain {plain_us:.3f} us; bound {bound:.3f} us "
                f"({by}); share of the bound {100 * bound / us:.1f}% against "
                f"{100 * bound / old_us:.1f}%; new <= old: {us <= old_us}")
    # every transform of the step, the same way
    step_us, seen = [0.0, 0.0, 0.0], {}
    for name, shape, t in ntt_calls:
        key = (name, shape, tuple(m.value for m in t.moduli))
        if key not in seen:
            inverse, old_t = name == "ntt_inverse", yardstick(t)
            x = residues(shape, t.q, g)
            fn = ntt_cuda.ntt_inverse if inverse else ntt_cuda.ntt_forward
            (n1, n2), (o1, o2) = in_turns(lambda: fn(x, t),
                                          lambda: ntt_cuda.two_launch(inverse, x, old_t))
            seen[key] = (min(n1, n2), min(o1, o2))
            bound = ntt_bound(shape)[0]
            log(f"[large_n] {gpu}: step's {name} at {shape}: cluster kernel {n1:.3f} / "
                f"{n2:.3f} us, two-launch yardstick {o1:.3f} / {o2:.3f} us; bound {bound:.3f} "
                f"us, share {100 * bound / seen[key][0]:.1f}% against "
                f"{100 * bound / seen[key][1]:.1f}%")
        step_us = [step_us[0] + seen[key][0], step_us[1] + seen[key][1],
                   step_us[2] + ntt_bound(shape)[0]]
    log(f"[large_n] {gpu}: the step's {len(ntt_calls)} transforms: cluster kernel "
        f"{step_us[0]:.3f} us in {len(ntt_calls)} launches, two-launch yardstick "
        f"{step_us[1]:.3f} us in {2 * len(ntt_calls)}; bound {step_us[2]:.3f} us; share of "
        f"the bound {100 * step_us[2] / step_us[0]:.1f}% against "
        f"{100 * step_us[2] / step_us[1]:.1f}% (sums of the graph times above)")

    # the cluster sizes in turns (each in order, then in reverse): the NTT's
    # forward + inverse at (3, 2, n) and at the step's keyswitch digits
    sweeps = {f"n = {deg}": ((3,), degrees[deg].moduli, deg) for deg in LARGE_DEGREES}
    sweeps["the step's digits"] = ((LARGE_BATCH, cd.coeff_modulus_size),
                                   ctx.key_context_data().parms.coeff_modulus, N_LARGE)
    for label, (lead, mods, deg) in sweeps.items():
        log_n = deg.bit_length() - 1
        fns = {}
        for k in CLUSTER_SWEEP[deg]:
            t = NTT.NTTTables(log_n, mods, dev, split=k)
            x = residues((*lead, t.size, deg), t.q, g)
            fns[k] = lambda t=t, x=x: ntt_cuda.ntt_inverse(ntt_cuda.ntt_forward(x, t), t)
        got = {}
        for k in list(fns) + list(fns)[::-1]:
            got.setdefault(k, []).append(graph_us(fns[k], 20))
        del fns
        shape = (*lead, len(mods), deg)
        bound = 2 * ntt_bound(shape)[0]
        log(f"[large_n] {gpu}: forward + inverse NTT at {shape} ({label}) by cluster size, in "
            "turns: " + "; ".join(
                f"clusters of {1 << k} (blocks of {deg >> k}): "
                f"{' / '.join(f'{v:.3f}' for v in got[k])} us, share of the bound "
                f"{100 * bound / min(got[k]):.1f}%" for k in got))
    # the step's transforms, all of them, by cluster size in turns
    fns, by_split = {}, {}
    for k in CLUSTER_SWEEP[N_LARGE]:
        work = []
        for name, shape, t in ntt_calls:
            key = (k, tuple(m.value for m in t.moduli))
            if key not in by_split:
                by_split[key] = NTT.NTTTables(t.log_n, t.moduli, dev, split=k)
            fn = ntt_cuda.ntt_inverse if name == "ntt_inverse" else ntt_cuda.ntt_forward
            work.append((fn, residues(shape, t.q, g), by_split[key]))
        fns[k] = lambda work=work: [fn(x, t) for fn, x, t in work]
    got = {}
    for k in list(fns) + list(fns)[::-1]:
        got.setdefault(k, []).append(graph_us(fns[k], 10))
    del fns, by_split
    log(f"[large_n] {gpu}: the step's {len(ntt_calls)} transforms by cluster size, in turns: "
        + "; ".join(f"clusters of {1 << k}: {' / '.join(f'{v:.3f}' for v in got[k])} us, share "
                    f"of the bound {100 * step_us[2] / min(got[k]):.1f}%" for k in got))
    return dict(launches=launches, k4=k4, times=times, profile=profile, calls=calls,
                step=step, d1=d1, d2=d2, rlk=rlk, out=out, expected=expected, encoder=encoder,
                decryptor=decryptor, cd=cd, parms=parms)


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
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, seed=KEY_SEED, device=dev)
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
    matmul = dict(helper=helper, x_enc=x_enc, w_enc=w_enc, glk=bfv_glk, ev=ev, out=out,
                  adapter=adapter, decryptor=bfv["decryptor"], want=(x @ w) % t_val)
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
    return dict(launches=launches, flows=flows, matmul=matmul)


def ntt_rows(fn) -> tuple:
    """fn() with the NTT dispatch recorded: (its result, the sorted set of
    table rows (limbs) of its transforms)."""
    from troy_tpu_torch.ops import ntt as NTT

    rows = set()
    real = {k: getattr(NTT, k) for k in ("ntt_forward", "ntt_inverse")}

    def rec(name):
        def call(x, t):
            rows.add(t.size)
            return real[name](x, t)
        return call
    with mock.patch.object(NTT, "ntt_forward", rec("ntt_forward")), \
            mock.patch.object(NTT, "ntt_inverse", rec("ntt_inverse")):
        out = fn()
    return out, sorted(rows)


def shard_launches(record) -> str:
    """Each shard's K1 and K3 launches from a CollectiveRecord."""
    parts = []
    for i in sorted(record.launches):
        c = record.launches[i]
        k1 = sum(v for k, v in c.items() if k.startswith("ntt_"))
        parts.append(f"{i}: K1 {k1}, K3 {c.get('base_convert', 0)}")
    return "; ".join(parts)


def phase_mesh(dev, gpu: str, main: dict, app: dict) -> dict:
    """The mesh (parallel/mesh.py, parallel/partition.py) on the card: the
    HPS multiply + relinearize step of [main] over (data, limb) meshes of
    shards on this card (and over the cards when there are several), over
    one ciphertext's coefficients ('poly'), the [app] BFV matmul + pack
    over (data=4, limb=1), and a one-rank NCCL multihost mesh."""
    import socket

    import torch.distributed as dist
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.parallel import mesh as M

    step, d1, d2, keys = main["step"], main["d1"], main["d2"], main["keys"]
    cd, encoder, decryptor = main["cd"], main["encoder"], main["decryptor"]
    count = torch.cuda.device_count()
    need = ("ntt_forward", "ntt_inverse", "base_convert")
    ref, whole_rows = ntt_rows(lambda: step(d1, d2, keys))
    whole_ms = cuda_ms(lambda: step(d1, d2, keys), MESH_REPS)
    op_bytes = d1.numel() * d1.element_size()
    log(f"[mesh] {count} card(s); shards of {dev}; the unsharded HPS step "
        f"{tuple(d1.shape)}: {whole_ms:.4f} ms ({gpu}, CUDA events, {MESH_REPS} calls), "
        f"NTT table rows {whole_rows}")

    def decrypts(label, got, rows):
        for b in rows:
            dec = encoder.decode(decryptor.decrypt(Ciphertext(got[b], cd.parms_id)))
            if not np.array_equal(dec, np.asarray(main["expected"][b], np.int64)):
                raise AssertionError(f"[mesh] {label}: product {b} decrypts wrong")

    def run(label, fn, want, rows, whole_ms, devices):
        torch.cuda.synchronize()
        reset_launch_counts()
        out, nrows = ntt_rows(fn)
        torch.cuda.synchronize()
        counts = launch_counts()
        for name in need:
            if counts[name] == 0:
                raise AssertionError(f"[mesh] {label} did not launch {name}")
        got = out.gather(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"[mesh] {label} != the unsharded step at "
                                 f"{int((got != want).sum())} residues")
        decrypts(label, got, rows)
        k3 = {i: (c.get("base_convert", 0), c.get("base_convert_copy", 0))
              for i, c in out.record.launches.items()}
        if any(v != (STEP_K3_LAUNCHES["hps"], 0) for v in k3.values()):
            raise AssertionError(f"[mesh] {label}: K3 launches and copies per shard {k3}, "
                                 f"not ({STEP_K3_LAUNCHES['hps']}, 0) each")
        stats = M.collective_stats(out)
        ms = cuda_ms(fn, MESH_REPS)
        log(f"[mesh] {label}: equals the unsharded step bit for bit, products "
            f"{list(rows)} decrypt right; collectives {stats['counts']}, "
            f"{stats['approx_bytes']} bytes ({stats['approx_bytes'] / op_bytes:.3f} x the "
            f"operand's {op_bytes}); per-device bytes of the result "
            f"{M.per_device_bytes(out)}; NTT table rows {nrows}; launches {counts}; "
            f"per shard {shard_launches(out.record)}")
        where = (f"{len(set(devices))} cards driven by one process" if len(set(devices)) > 1
                 else "shards of one card: the partition's overhead, not a scaling number")
        log(f"[mesh] {gpu}: {label}: {ms:.4f} ms against the unsharded {whole_ms:.4f} ms "
            f"(CUDA events, {MESH_REPS} calls; {where})")
        return dict(launches=counts, stats=stats, ms=ms, unsharded_ms=whole_ms,
                    per_device=M.per_device_bytes(out))

    runs = {}
    meshes = [(f"data={d}, limb={k}", M.make_mesh(d, k, [dev] * (d * k)))
              for d, k in MESH_LAYOUTS]
    cards = [torch.device("cuda", i) for i in range(count)] if dev.type == "cuda" else []
    if count >= 2:
        meshes.append((f"data={count} over the cards", M.make_mesh(count, 1, cards)))
        if count % 2 == 0:
            meshes.append((f"data={count // 2}, limb=2 over the cards",
                           M.make_mesh(count // 2, 2, cards)))
    last = d1.shape[0] - 1
    for label, mesh in meshes:
        limbs = mesh.shape["limb"] > 1
        x1, x2 = M.shard_batch(d1, mesh, limbs), M.shard_batch(d2, mesh, limbs)
        kr = M.replicate(keys, mesh)
        runs[label] = run(label, lambda: step(x1, x2, kr), ref, (0, last), whole_ms,
                          list(mesh.devices.flat))
        if not limbs and runs[label]["stats"]["total"]:
            raise AssertionError(f"[mesh] {label}: a data-only plan issued collectives")
        if limbs and not runs[label]["stats"]["total"]:
            raise AssertionError(f"[mesh] {label}: a limb split issued no collective")

    # one ciphertext over its coefficients
    one_ms = cuda_ms(lambda: step(d1[:1], d2[:1], keys), MESH_REPS)
    polys = [(f"poly={MESH_POLY}, one ciphertext", [dev] * MESH_POLY)]
    if count >= 2:
        polys.append((f"poly={count} over the cards, one ciphertext", cards))
    for label, devs in polys:
        pm = M.make_latency_mesh(len(devs), devs)
        p1, p2, pk = M.shard_poly(d1[:1], pm), M.shard_poly(d2[:1], pm), M.shard_poly(keys, pm)
        runs[label] = run(label, lambda: step(p1, p2, pk), ref[:1], (0,), one_ms, devs)
        if not runs[label]["stats"]["counts"].get("all-to-all"):
            raise AssertionError(f"[mesh] {label}: no all-to-all")

    # the [app] BFV matmul + pack_outputs over (data=4, limb=1)
    mm = app["matmul"]
    am = M.make_mesh(MESH_APP_DATA, 1, [dev] * MESH_APP_DATA)
    helper, ev = mm["helper"], mm["ev"]

    def app_run():
        y = helper.matmul(ev, mm["x_enc"], mm["w_enc"], mesh=am)
        return torch.stack([c.data for c in helper.pack_outputs(ev, mm["glk"], y, mesh=am)[0]])
    torch.cuda.synchronize()
    reset_launch_counts()
    with M.recording() as rec:
        out = app_run()
    torch.cuda.synchronize()
    counts = launch_counts()
    if not torch.equal(out, mm["out"]):
        raise AssertionError("[mesh] the sharded app matmul != the unsharded run")
    if not (counts["ntt_forward"] and counts["ntt_inverse"]):
        raise AssertionError("[mesh] the sharded app matmul launched no NTT kernel")
    app_ms = cuda_ms(app_run, 1)
    stats = M.collective_stats(rec)
    log(f"[mesh] BFV matmul {APP_MATMUL} + pack_outputs, mesh=make_mesh(data={MESH_APP_DATA}, "
        f"limb=1): equals the unsharded [app] run bit for bit; shards that ran a stage "
        f"{rec.active_shards}; collectives {stats['counts']}; launches {counts}; per shard "
        f"{shard_launches(rec)}; {gpu}: {app_ms:.4f} ms a call (CUDA events)")
    runs["app matmul"] = dict(launches=counts, stats=stats, ms=app_ms)

    # one rank of a multihost mesh: NCCL on the card
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        hm = M.make_multihost_mesh(hosts=1, limb=1, devices=[dev] * min(4, d1.shape[0]))
        h1, h2 = M.shard_batch(d1, hm, False), M.shard_batch(d2, hm, False)
        hk = M.replicate(keys, hm)
        label = f"{backend} multihost mesh {hm.shape}"
        runs[label] = run(label, lambda: step(h1, h2, hk), ref, (0, last), whole_ms,
                          list(hm.devices.flat))
        if runs[label]["stats"]["total"]:
            raise AssertionError(f"[mesh] {label}: batch parallelism issued collectives")
    finally:
        dist.destroy_process_group()
    return dict(runs=runs, launches={k: r["launches"] for k, r in runs.items()})


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
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, seed=KEY_SEED, device=dev)
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
                               lambda d: steps["asymmetric"][0](d, pk.data()), start)},
        calls=1)  # an encrypt step makes 1800-2600 launches: one call profiles enough
    # a short step's one-call profiler session at times records no kernel
    timed.update(time_steps("client", gpu, {
        "decrypt": (lambda: decrypt(outs[-1]), None, None),
        "batch encode": (lambda: encode(vals), None, None),
        "batch decode": (lambda: decode(coeffs), None, None)}))
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
    ctx = HeContext.create(parms, True, SecurityLevel.Nil, seed=KEY_SEED, device=dev)
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
        if not np.array_equal(got, np.asarray(expected[b], np.int64)):
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
        if not np.array_equal(got, np.concatenate([np.roll(m[:h], -1),
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
        got = encoder.decode(c["decryptor"].decrypt(ct))
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
        if not np.array_equal(got, np.asarray(expected[b], np.int64)):
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


# ---- the per-op matrix, the eager bench, the example twins, the harness ----
ROOT = Path(__file__).resolve().parent
PEROP_CONFIGS = (("bfv", Q_BITS), ("bgv", Q_BITS), ("ckks", Q_BITS), ("bfv", WIDE_BITS))
PEROP_REPS = {"fast": 10, "wide": 2}   # slope runs: reps_hi = reps (x 8 for a short row)
PEROP_REQUIRED = {  # kernels a row must launch at the fast width (all schemes, BFV)
    "all": {"multiply_relinearize": ("ntt_forward", "ntt_inverse"),
            "rotate_rows(1)": ("ntt_forward", "ntt_inverse"),
            "rotate_vector(1)": ("ntt_forward", "ntt_inverse"),
            "rotate_columns": ("ntt_forward", "ntt_inverse"),
            "complex_conjugate": ("ntt_forward", "ntt_inverse")},
    "bfv": {"multiply": ("ntt_forward", "ntt_inverse", "base_convert"),
            "multiply_relinearize": ("ntt_forward", "ntt_inverse", "base_convert"),
            "decrypt (device)": ("ntt_forward", "ntt_inverse", "base_convert")}}
PEROP_K3 = {"multiply": STEP_K3_LAUNCHES["hps"],  # K3 a BFV row at the fast width
            "multiply_relinearize": STEP_K3_LAUNCHES["hps"], "decrypt (device)": 1}
PEROP_MOD_T = {"encode_simd (device)": ("ntt_inverse",),  # BFV / BGV: the NTT mod t
               "decode_simd (device)": ("ntt_forward",)}
EAGER_REPS = 5
EXAMPLES_DIR = "examples/torch"


def script_module(name: str):
    """A script of the repo's scripts/ folder, imported as a module."""
    path = str(ROOT / "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)
    import importlib

    return importlib.import_module(name)


def phase_perop(dev, gpu: str) -> dict:
    """scripts/torch_troybench_perop.py's matrix at n = N, batch BATCH, for
    each of PEROP_CONFIGS: every row once with the counts set to 0, equal to
    its all-plain run (fast width, and the NTT mod t at the wide width) or
    launching no fast-path kernel (the other wide rows),
    row 0 equal to the object API's result and decrypting right; then the
    profiler's launches, device ms and K1 / K3 launches a step, and the
    slope time by CUDA events."""
    perop = script_module("torch_troybench_perop")
    out = {"launches": {}, "rows": {}}
    for scheme, bits in PEROP_CONFIGS:
        t0 = time.perf_counter()
        width = "wide" if bits == WIDE_BITS else "fast"
        args = perop.parse_args(["--scheme", scheme, "-n", str(N), "--batch", str(BATCH),
                                 "--reps", str(PEROP_REPS[width]), "--q-bits",
                                 ",".join(map(str, bits))])
        s = perop.setup(args, dev)
        steps = perop.build_steps(s)
        torch.cuda.synchronize()
        tag = f"{scheme.upper()} {width} {{{','.join(map(str, bits))}}}"
        log(f"[perop] {tag}: context, keys and inputs in {time.perf_counter() - t0:.3f} s; "
            f"rows {list(steps)}")
        required = {**PEROP_REQUIRED["all"], **PEROP_REQUIRED.get(scheme, {})}
        lines = perop.header(s) + perop.host_lines(perop.host_times(s))
        for name, row in steps.items():
            label = f"{tag} {name}"
            run = lambda row=row: row.step(row.cur, row.aux)
            # at the wide width only the NTT mod t (BFV / BGV) takes a kernel, K1
            need = required.get(name, ()) if width == "fast" else PEROP_MOD_T.get(name)
            if need is not None:
                res, launches = run_step("perop", label, run, need)
                if scheme == "bfv" and width == "fast" and name in PEROP_K3 and (
                        launches["base_convert"], launches["base_convert_copy"]) != (
                        PEROP_K3[name], 0):
                    raise AssertionError(f"[perop] {label} launched K3 "
                                         f"{launches['base_convert']} times ({PEROP_K3[name]}) "
                                         f"and copied {launches['base_convert_copy']} inputs")
            else:
                reset_launch_counts()
                res = run()
                torch.cuda.synchronize()
                launches = launch_counts()
                if any(launches.values()):
                    raise AssertionError(f"[perop] {label} launched a fast-path kernel "
                                         f"{launches}")
            out["launches"][label] = launches
            checked = perop.check_row(s, row, res)
            # a wide step makes thousands of launches: one call profiles enough
            wide_step = width == "wide" and name not in perop.CHEAP
            prof = profile_step(run, 1 if wide_step else PROFILE_STEPS)
            ms = perop.slope_ms(row, *perop.rep_counts(name, args.reps), s.dev)
            k1 = prof["ntt_forward"][0] + prof["ntt_inverse"][0]
            out["rows"][label] = dict(ms=ms, launches=prof["launches"], device_ms=prof["ms"],
                                      k1=k1, k3=prof["base_convert"][0])
            lines.append(perop.device_line(name, ms, BATCH))
            log(f"[perop] {gpu}: {label}: {checked}; slope {ms:.4f} ms a batched step "
                f"({ms / BATCH * 1e3:.1f} us a ciphertext); profiler: {prof['launches']:.0f} "
                f"launches, {prof['ms']:.4f} ms of device time a step, busy "
                f"{100 * prof['ms'] / ms:.1f}%; K1 {k1:.0f} launches, K3 "
                f"{prof['base_convert'][0]:.0f} a step; dispatch launches {launches}")
        for line in lines:
            log(f"[perop] {line}")
        log(f"[perop] {tag} done in {time.perf_counter() - t0:.3f} s")
    return out


def phase_eager(dev, gpu: str) -> dict:
    """scripts/torch_troybench.py's eager loop on BFV at n = N on the card,
    its correctness check on, with the counts set to 0 just before."""
    import contextlib
    import io

    bench = script_module("torch_troybench")
    args = bench.parse_args(["--scheme", "bfv", "-n", str(N), "--reps", str(EAGER_REPS),
                             "--device", dev.type])
    buf = io.StringIO()
    t0 = time.perf_counter()
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        res = bench.run(args)
    torch.cuda.synchronize()
    launches = launch_counts()
    text = buf.getvalue().splitlines()
    for line in text:
        log(f"[eager] {gpu}: {line.strip()}")
    if not res["correct"] or text[-1] != "correctness: OK":
        raise AssertionError("[eager] the eager bench's correctness check did not pass")
    timed = [line for line in text if line.startswith("\t")]
    if [line.split(":")[0].strip() for line in timed] != bench.op_names("bfv"):
        raise AssertionError(f"[eager] the bench timed {len(timed)} ops, not its op list")
    for name in ("ntt_forward", "ntt_inverse", "base_convert"):
        if not launches[name]:
            raise AssertionError(f"[eager] the eager bench did not launch {name}")
    log(f"[eager] {len(timed)} ops timed, multiply + relinearize correct; kernel launches "
        f"{launches}; {time.perf_counter() - t0:.3f} s")
    return {"launches": launches}


def phase_examples(args=()) -> dict:
    """Each twin under examples/torch/ run in this process as a script, with
    sys.argv = [path, *args] (none: the twins' default device, the card),
    the counts set to 0 just before; each must end without an exception and
    print its OK line where its JAX original has one."""
    import contextlib
    import io
    import runpy

    folder = ROOT / EXAMPLES_DIR
    twins = sorted((p for p in folder.glob("*.py") if p.name != "common.py"),
                   key=lambda p: int(p.name.split("_")[0]))
    out = {"launches": {}, "seconds": {}}
    argv, path0 = sys.argv, list(sys.path)
    try:
        for p in twins:
            sys.modules.pop("common", None)
            sys.argv = [str(p), *args]
            sys.path[:] = [str(folder)] + path0
            buf = io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(p), run_name="__main__")
            torch.cuda.synchronize()
            out["seconds"][p.name] = time.perf_counter() - t0
            out["launches"][p.name] = launch_counts()
            text = buf.getvalue().strip().splitlines()
            original = (ROOT / "examples" / p.name).read_text()
            if not text or ("OK" in original and not any("OK" in line for line in text)):
                raise AssertionError(f"[examples] {p.name} printed no OK line: {text[-3:]}")
            log(f"[examples] {p.name}: {out['seconds'][p.name]:.3f} s; last line "
                f"{text[-1]!r}; kernel launches {out['launches'][p.name]}")
    finally:
        sys.argv, sys.path[:] = argv, path0
        sys.modules.pop("common", None)
    log(f"[examples] all {len(twins)} twins ran in {sum(out['seconds'].values()):.3f} s")
    return out


TIMER_LINE = r"^\t(?P<name>[\w()+-]+): (?P<val>[\d.]+) (?P<unit>ns|us|ms|s)"


def phase_harness(dev, gpu: str, qtab) -> dict:
    """Timer and TimerOnce around an NTT kernel launch with a CUDA probe; the
    reductions on a card tensor against the CPU's; poly_to_hex_string of a
    card tensor at both widths; a context made without device= on the card."""
    import contextlib
    import io
    import re
    from troy_tpu_torch.ops import ntt as NTT, reduction as RD
    from troy_tpu_torch.utils import poly_string as PS
    from troy_tpu_torch.utils.timer import Timer, TimerOnce

    x = residues((BATCH, qtab.size, N), qtab.q, torch.Generator(device=dev).manual_seed(9))
    timer, buf = Timer(), io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        for _ in range(3):
            timer.tick("ntt_forward")
            y = NTT.ntt_forward(x, qtab)
            timer.tock("ntt_forward", y)
        with TimerOnce("ntt_inverse once") as once:
            NTT.ntt_inverse(y, qtab)
            torch.cuda.synchronize()
        timer.print()
    launches = launch_counts()
    lines = buf.getvalue().splitlines()
    if launches["ntt_forward"] != 3 or launches["ntt_inverse"] != 1:
        raise AssertionError(f"[harness] the timed NTT calls launched {launches}")
    if not (re.match(TIMER_LINE, lines[-1]) and lines[0].startswith("ntt_inverse once: ")
            and once.elapsed_ns > 0):
        raise AssertionError(f"[harness] Timer lines {lines} are not the parsed format")
    log(f"[harness] {gpu}: Timer over 3 NTT launches at {tuple(x.shape)} with a CUDA "
        f"probe: {lines[-1].strip()!r}; TimerOnce: {lines[0]!r}")
    q = int(qtab.q[0])
    cases = {"max_value": RD.max_value, "min_value": RD.min_value,
             "nonzero_count": RD.nonzero_count, "sum_values": RD.sum_values,
             "sum_values_wide": RD.sum_values_wide,
             "max_centered_magnitude": lambda v: RD.max_centered_magnitude(v, q)}
    x0 = x[:, 0]
    for name, fn in cases.items():
        card, host = fn(x0), fn(x0.cpu())
        if card.device != x0.device or int(card) != int(host):
            raise AssertionError(f"[harness] {name} on the card {card} != the CPU's {host}")
    log(f"[harness] {len(cases)} reductions of {tuple(x0.shape)} on the card equal the "
        f"CPU's: {({k: int(fn(x0)) for k, fn in cases.items()})}")
    wide = torch.tensor([0, 1, (1 << 60) + 3, 255], dtype=torch.int64, device=dev)
    for poly in (x[0, 0, :8], wide):
        got = PS.poly_to_hex_string(poly)
        want = " + ".join(f"{int(c):X}x^{i}" if i else f"{int(c):X}"
                          for i, c in reversed(list(enumerate(poly.tolist()))) if c)
        if got != want:
            raise AssertionError(f"[harness] poly_to_hex_string {got!r} != {want!r}")
    log(f"[harness] poly_to_hex_string of card tensors: {PS.poly_to_hex_string(wide)!r}")
    from troy_tpu_torch import (EncryptionParameters, SchemeType, CoeffModulus, PlainModulus,
                                HeContext, SecurityLevel)
    parms = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, QUICKSTART_BITS))
    parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
    ctx = HeContext.create(parms, True, SecurityLevel.Nil)  # no device=: the card
    devices = {cd.device.type for cd in ctx._data.values()}
    if devices != {dev.type}:
        raise AssertionError(f"[harness] HeContext.create without device= built on {devices}")
    log(f"[harness] HeContext.create(parms, True, SecurityLevel.Nil) built its "
        f"{len(ctx._data)} levels on {dev.type} with no device argument")
    return {"launches": launches}


MXU_DEGREES = range(8, 18)   # [mxu]: K2 at every degree 256 .. 131072, L = 1 .. 7
MXU_LIMBS = 7
MXU_LARGE = (15, 16, 17)     # [mxu]: K2 against the first form and K1 at (3, 2, 2^lg)
MXU_SWEEP_REPS = 20          # [mxu]: graph launches a turn of the cluster-size sweep


def plane_products(x: torch.Tensor, t) -> list:
    """The 16 plane products of both stages of a forward transform of x as
    torch._int_mm calls (int8 x int8 -> int32), a stage a limb: a yardstick
    of the tensor-core part alone, which no route of the port calls.
    Returns the calls, each a function of no argument."""
    from troy_tpu_torch.ops import ntt_mxu as MX

    L = t.size
    X = x.reshape(-1, L, t.n1, t.n2)
    tabs = MX.plain_tables(t)
    planes = MX.split_balanced(X, tabs["q"].view(1, -1, 1, 1))  # (4, P, L, n1, n2)
    calls = []
    for l in range(L):
        p = planes[:, :, l]                                         # (4, P, n1, n2)
        # left: (4 n1 x n1) W1 planes times the data (n1 x 4 P n2)
        a = tabs["W1"][:, l].reshape(4 * t.n1, t.n1).contiguous()
        b = p.permute(2, 0, 1, 3).reshape(t.n1, -1).contiguous()
        # right: the data (4 P n1 x n2) times the W2 planes (n2 x 4 n2)
        c = p.reshape(-1, t.n2).contiguous()
        d = tabs["W2"][:, l].permute(1, 0, 2).reshape(t.n2, 4 * t.n2).contiguous()
        calls += [lambda a=a, b=b: torch._int_mm(a, b), lambda c=c, d=d: torch._int_mm(c, d)]
    return calls


def phase_mxu(dev, gpu: str, main: dict, rot: dict, large: dict) -> dict:
    """K2 under set_ntt_backend("pallas_mxu"): its route (csrc/ntt_mxu_wg.cu
    to n = 16384, the cluster kernel csrc/ntt_mxu_cluster.cu above) bit for
    bit against its plain version, K1 and the first form (csrc/ntt_mxu.cu,
    the yardstick) at every degree and limb count, and above 16384 in every
    cluster size it takes; at the keyswitch digits and base q on lazy and
    canonical input; the cluster route's refusals; timed against the
    yardstick and K1 in turns beside the transform's bound, each form's
    method terms and the plane products as torch._int_mm calls, at the
    flagship's shapes, (3, 2, n) for n = 32768, 65536, 131072 and the n =
    65536 step's digits, and the cluster sizes in turns; then [main]'s HPS
    multiply + relinearize and rotate_rows(1), and [large_n]'s n = 65536
    HPS step, each on a context built under the backend, each equal to its
    K1 step and its all-plain step, decrypting, with its launches."""
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.core.coeff_modulus import SecurityLevel
    from troy_tpu_torch.core.context import HeContext
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.ops import ntt as NTT, ntt_cuda, ntt_mxu as MX, ntt_mxu_cuda
    from troy_tpu_torch.parallel.batched import BatchedEvaluator
    from troy_tpu_torch.utils import numth

    saved = NTT.get_ntt_backend()
    NTT.set_ntt_backend("pallas_mxu")
    try:
        gen = torch.Generator(device=dev).manual_seed(14)
        t0 = time.perf_counter()
        worst = 0
        for lg in MXU_DEGREES:
            n = 1 << lg
            full = NTT.NTTTables(lg, [Modulus(p) for p in numth.get_primes(2 * n, 30, MXU_LIMBS)],
                                 dev)
            for L in range(1, MXU_LIMBS + 1):
                t = full.take(list(range(L))) if L < MXU_LIMBS else full
                x = residues((1, L, n), t.q, gen, 2)
                canon = x % t.q.view(-1, 1)
                f = ntt_mxu_cuda.ntt_forward(x, t.mxu)
                i_lazy = ntt_mxu_cuda.ntt_inverse(x, t.mxu)
                i = ntt_mxu_cuda.ntt_inverse(f, t.mxu)
                refs = [(f, MX.ntt_forward_mxu(x, t.mxu)), (f, ntt_cuda.ntt_forward(x, t)),
                        (i_lazy, MX.ntt_inverse_mxu(x, t.mxu)),
                        (i_lazy, ntt_cuda.ntt_inverse(canon, t)),
                        (f, ntt_mxu_cuda.mma_forward(x, t.mxu)),
                        (i_lazy, ntt_mxu_cuda.mma_inverse(x, t.mxu))]
                for k in MX.CL_SWEEP.get(lg, ()):  # every cluster size the kernel takes
                    refs += [(f, ntt_mxu_cuda.cluster_forward(x, t.mxu, k)),
                             (i_lazy, ntt_mxu_cuda.cluster_inverse(x, t.mxu, k))]
                err = max(int((a - b).abs().max()) for a, b in refs)
                worst = max(worst, err)
                if err or not torch.equal(i, canon):
                    raise AssertionError(f"[mxu] n = {n}, L = {L}: K2 != its plain version, K1 "
                                         f"or the yardstick (max |err| {err}), or "
                                         f"inverse(forward(x)) != x")
            route = ("the kernel to 16384" if lg <= MX.WG_MAX_LOG_N else
                     "the cluster kernel in clusters of "
                     + " and ".join(str(1 << k) for k in MX.CL_SWEEP[lg]))
            log(f"[mxu] n = {n} ({route}), L = 1 .. {MXU_LIMBS}: K2 forward and inverse (lazy "
                f"input) equal the plain version, K1 and the first form ("
                + ("its one-CTA kernel" if lg <= MX.ONE_LAUNCH_MAX_LOG_N else
                   "two launches of its stage kernel")
                + ") bit for bit, inverse(forward(x)) == x")
        torch.cuda.synchronize()
        log(f"[mxu] every degree 256 .. 131072 at L = 1 .. {MXU_LIMBS} in "
            f"{time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        ctx = build_context(dev)
        cd = ctx.first_context_data()
        ev = Evaluator(ctx)
        be = BatchedEvaluator(ev, cd)
        qtab, otab = cd.qtab(), ev._switch_tables(cd)["otab"]
        if qtab.mxu is None or otab.mxu is None or cd.rns_tool.bsk_ntt.mxu is None:
            raise AssertionError("[mxu] the context's tables lack the matrix-product route")
        log(f"[mxu] context under pallas_mxu in {time.perf_counter() - t0:.3f} s")
        cases = {"keyswitch digits": ((BATCH * L_DATA, L_DATA + 1, N), otab),
                 "base q": ((BATCH, L_DATA, N), qtab)}
        for label, (shape, t) in cases.items():
            for lazy in (True, False):
                x = residues(shape, t.q, gen, 2 if lazy else 1)
                canon = x % t.q.view(-1, 1)
                f, i = ntt_mxu_cuda.ntt_forward(x, t.mxu), ntt_mxu_cuda.ntt_inverse(x, t.mxu)
                err = max(int((f - MX.ntt_forward_mxu(x, t.mxu)).abs().max()),
                          int((f - ntt_cuda.ntt_forward(x, t)).abs().max()),
                          int((f - ntt_mxu_cuda.mma_forward(x, t.mxu)).abs().max()),
                          int((i - MX.ntt_inverse_mxu(x, t.mxu)).abs().max()),
                          int((i - ntt_cuda.ntt_inverse(canon, t)).abs().max()),
                          int((i - ntt_mxu_cuda.mma_inverse(x, t.mxu)).abs().max()))
                worst = max(worst, err)
                log(f"[mxu] {label} {shape}, {'lazy' if lazy else 'canonical'} input: K2 "
                    f"against its plain version, K1 and the yardstick, max |err| {err}")
                if err:
                    raise AssertionError(f"[mxu] {label} {shape}: K2 disagrees")

        # the cluster route's refusals: a tensor off 16 bytes, cluster sizes
        # it does not take, a CPU tensor
        lg = MXU_LARGE[1]
        t16 = NTT.NTTTables(lg, [Modulus(p) for p in numth.get_primes(2 << lg, 30, 2)], dev)
        x = torch.zeros((1, 2, 1 << lg), dtype=torch.int64, device=dev)
        shifted = torch.zeros(x.numel() + 1, dtype=torch.int64, device=dev)[1:].view(x.shape)
        for inverse in (False, True):
            fn = ntt_mxu_cuda.cluster_inverse if inverse else ntt_mxu_cuda.cluster_forward
            expect_refusals(f"{fn.__name__} at n = {1 << lg}", lambda v: fn(*v), {
                "not 16-byte aligned": ((shifted, t16.mxu, MX.CL_SWEEP[lg][0]), ValueError),
                "cluster of 32 CTAs": ((x, t16.mxu, 5), ValueError),
                "cluster of 4 CTAs": ((x, t16.mxu, 2), ValueError),
                "CPU tensor": ((x.cpu(), t16.mxu, MX.CL_SWEEP[lg][0]), ValueError)})

        # the n = 65536 step's context under the backend (its digits' tables
        # are timed below)
        t0 = time.perf_counter()
        ctx_l = HeContext.create(large["parms"], True, SecurityLevel.Nil, device=dev)
        cd_l = ctx_l.first_context_data()
        ev_l = Evaluator(ctx_l)
        otab_l = ev_l._switch_tables(cd_l)["otab"]
        if otab_l.mxu is None or cd_l.qtab().mxu is None:
            raise AssertionError("[mxu] the n = 65536 context lacks the matrix-product route")
        log(f"[mxu] n = {N_LARGE} context under pallas_mxu in {time.perf_counter() - t0:.3f} s")

        # times: the route against the yardstick and K1 in turns (K2, first
        # form, K1, K1, first form, K2), graphs of 50 (of 20 above 16384)
        timing = {"keyswitch digits": cases["keyswitch digits"], "base q": cases["base q"]}
        for lg in MXU_LARGE:
            timing[f"n = {1 << lg}"] = ((3, 2, 1 << lg), t16 if lg == MXU_LARGE[1] else
                                        NTT.NTTTables(lg, [Modulus(p) for p in
                                                           numth.get_primes(2 << lg, 30, 2)], dev))
        timing[f"n = {N_LARGE} step's digits"] = ((LARGE_BATCH * (len(LARGE_BITS) - 1),
                                                   len(LARGE_BITS), N_LARGE), otab_l)
        times = {}
        for label, (shape, t) in timing.items():
            x = residues(shape, t.q, gen)
            lg = shape[-1].bit_length() - 1
            reps = GRAPH_LAUNCHES if ntt_mxu_cuda._wg_route(t.mxu) else 20
            row = {}
            for inverse in (False, True):
                direction = "inverse" if inverse else "forward"
                k2 = lambda: getattr(ntt_mxu_cuda, f"ntt_{direction}")(x, t.mxu)
                yd = lambda: getattr(ntt_mxu_cuda, f"mma_{direction}")(x, t.mxu)
                k1 = lambda: getattr(ntt_cuda, f"ntt_{direction}")(x, t)
                a1, c1, b1, b2, c2, a2 = (graph_us(f, reps) for f in (k2, yd, k1, k1, yd, k2))
                plain = (MX.ntt_inverse_mxu if inverse else MX.ntt_forward_mxu)
                plain_us = graph_us(lambda: plain(x, t.mxu), PLAIN_REPS)
                bound, by = ntt_bound(shape)
                if ntt_mxu_cuda._wg_route(t.mxu):
                    info = ntt_mxu_cuda.wg_info(inverse, lg)
                    ctas = wg_grid(shape, info["ctas_per_sm"])
                    terms = wg_terms(shape, ctas, inverse)
                    name = f"ntt_{direction}_mxu"
                    how = f"{ctas} CTAs, the table planes loaded once each"
                else:
                    log_c = ntt_mxu_cuda.route_log_c(x, t.mxu, inverse)
                    ctas = (1 << log_c) * min(int(np.prod(shape[:-1])), ntt_mxu_cuda.cluster_info(
                        inverse, lg, log_c)["clusters"])
                    terms = cl_terms(shape, inverse, log_c)
                    name = f"ntt_{direction}_mxu_cluster"
                    how = f"clusters of {1 << log_c}, {ctas} CTAs, the tables streamed a row"
                yard_terms = mxu_terms(shape)
                method = max(terms.values())
                k2_us, k1_us, yd_us = min(a1, a2), min(b1, b2), min(c1, c2)
                row[name] = dict(us=k2_us, k1_us=k1_us, yard_us=yd_us, plain_us=plain_us,
                                 bound=bound, by=by, terms=terms, yard_terms=yard_terms,
                                 ctas=ctas)
                log(f"[mxu] {gpu}: {name} {shape}: K2 {a1:.3f} / {a2:.3f} us, the first form "
                    f"(yardstick) {c1:.3f} / {c2:.3f} us, K1 {b1:.3f} / {b2:.3f} us a launch "
                    f"(graph of {reps}); plain {plain_us:.3f} us; the transform's "
                    f"bound {bound:.3f} us ({by}, as K1's), its share K2 "
                    f"{100 * bound / k2_us:.1f}%, the first form {100 * bound / yd_us:.1f}%, "
                    f"K1 {100 * bound / k1_us:.1f}%; K2 / first form {k2_us / yd_us:.3f}, "
                    f"K2 / K1 {k2_us / k1_us:.3f}; K2's method ({how}): "
                    + ", ".join(f"{k} {v:.3f} us" for k, v in terms.items())
                    + f", K2 at {100 * method / k2_us:.1f}% of their largest; the first form's: "
                    + ", ".join(f"{k} {v:.3f} us" for k, v in yard_terms.items()))
            calls = plane_products(x, t.mxu)
            try:
                mm_us = graph_us(lambda: [c() for c in calls], reps)
            except RuntimeError as e:  # the yardstick only; no route calls it
                mm_us = None
                log(f"[mxu] torch._int_mm yardstick at {shape} not measured: {e}")
            if mm_us is not None:
                log(f"[mxu] {gpu}: yardstick, not a route: the 16 plane products of both "
                    f"stages of one forward transform at {shape} as {len(calls)} torch._int_mm "
                    f"calls: {mm_us:.3f} us (graph of {reps})")
            for v in row.values():
                v["int_mm_us"] = mm_us
            times[label] = row

        # the cluster sizes in turns (each in order, then in reverse): forward
        # + inverse at (3, 2, 65536) and at the step's digits
        sweeps = {}
        for label in (f"n = {N_LARGE}", f"n = {N_LARGE} step's digits"):
            shape, t = timing[label]
            x = residues(shape, t.q, gen)
            fns = {k: (lambda k=k: ntt_mxu_cuda.cluster_inverse(
                ntt_mxu_cuda.cluster_forward(x, t.mxu, k), t.mxu, k))
                for k in MX.CL_SWEEP[t.log_n]}
            got = {}
            for k in list(fns) + list(fns)[::-1]:
                got.setdefault(k, []).append(graph_us(fns[k], MXU_SWEEP_REPS))
            sweeps[label] = got
            bound = 2 * ntt_bound(shape)[0]
            log(f"[mxu] {gpu}: the cluster kernel's forward + inverse at {shape} by cluster "
                "size, in turns: " + "; ".join(
                    f"clusters of {1 << k}: {' / '.join(f'{v:.3f}' for v in got[k])} us, share "
                    f"of the bound {100 * bound / min(got[k]):.1f}%" for k in got)
                + f"; the route takes clusters of "
                f"{1 << ntt_mxu_cuda.route_log_c(x, t.mxu, False)} here")

        # the flagship step and one rotation under the backend
        keys, d1, d2 = main["keys"], main["d1"], main["d2"]
        step = be.build_mul_relin_step(keys)
        out, launches = run_step("mxu", f"HPS step {tuple(d1.shape)} under pallas_mxu",
                                 lambda: step(d1, d2, keys),
                                 ("ntt_forward_mxu", "ntt_inverse_mxu", "base_convert"))
        per_step = (launches["ntt_forward_mxu"], launches["ntt_inverse_mxu"])
        others = sum(launches[k] for k in ("ntt_forward", "ntt_inverse", "ntt_forward_mxu_mma",
                                           "ntt_inverse_mxu_mma"))
        if per_step != (5, 4) or others:
            raise AssertionError(f"[mxu] the HPS step launched K2 {per_step} (5 forward, 4 "
                                 f"inverse expected) and K1 or the first form {others} times")
        if not torch.equal(out, main["out"]):
            raise AssertionError("[mxu] the HPS step under pallas_mxu != the K1 step")
        pick = [0, BATCH - 1]
        check_decrypts("mxu", "products 0 and 15", out[pick], cd.parms_id,
                       main["expected"][pick], main["encoder"], main["decryptor"])
        log("[mxu] the HPS step under pallas_mxu equals the K1 step and the all-plain step "
            "bit for bit; K2 (the redesigned kernel) 5 forward and 4 inverse launches a step, "
            "K1 and the first form none")
        (rstep, elts), r1 = be.build_rotate_rows_step(1), rot["steps"]["rotate_rows(1)"]
        rkeys = tuple(rot["glk"].key(e) for e in elts)
        rout, rlaunches = run_step("mxu", "rotate_rows(1) under pallas_mxu",
                                   lambda: rstep(rot["d"], rkeys),
                                   ("ntt_forward_mxu", "ntt_inverse_mxu"))
        if not torch.equal(rout, r1["result"]):
            raise AssertionError("[mxu] rotate_rows(1) under pallas_mxu != the K1 step")
        check_decrypts("mxu", "rotate_rows(1), ciphertexts 0 and 15", rout[pick], cd.parms_id,
                       rotated(rot["msgs"][pick], 1), main["encoder"], main["decryptor"])
        profiles = {}
        for label, fn, k1_fn in (
                ("HPS step", lambda: step(d1, d2, keys), lambda: main["step"](d1, d2, keys)),
                ("rotate_rows(1)", lambda: rstep(rot["d"], rkeys),
                 lambda: r1["step"](rot["d"], r1["keys"]))):
            chained = cuda_ms(fn, REPS)
            k1_chained = cuda_ms(k1_fn, REPS)
            prof, k1_prof = profile_step(fn, PROFILE_STEPS), profile_step(k1_fn, PROFILE_STEPS)
            mxu_n = sum(prof[k][0] for k in MXU_KERNELS)
            mxu_ms = sum(prof[k][1] for k in MXU_KERNELS)
            k1_n, k1_ms = ntt_totals(k1_prof)
            profiles[label] = dict(prof=prof, calls=record_launches(fn))
            log(f"[mxu] {gpu}: profiler, {label} under pallas_mxu, {PROFILE_STEPS} steps: "
                f"{prof['launches']:.0f} kernel launches and {prof['ms']:.4f} ms of device "
                f"kernel time a step, of which K2 {mxu_n:.0f} launches {mxu_ms:.4f} ms; "
                f"{chained:.4f} ms a step by events (repeated), busy share "
                f"{100 * prof['ms'] / chained:.1f}%; the K1 step: {k1_prof['launches']:.0f} "
                f"launches, {k1_prof['ms']:.4f} ms of device time, K1 {k1_n:.0f} launches "
                f"{k1_ms:.4f} ms, {k1_chained:.4f} ms a step, busy "
                f"{100 * k1_prof['ms'] / k1_chained:.1f}%")

        # [large_n]'s n = 65536 HPS step on the context built under the
        # backend: the cluster kernel 5 + 4 launches, K1 and the first form none
        be_l = BatchedEvaluator(ev_l, cd_l)
        rlk, ld1, ld2 = large["rlk"], large["d1"], large["d2"]
        step_l = be_l.build_mul_relin_step(rlk)
        lout, llaunches = run_step(
            "mxu", f"n = {N_LARGE} HPS step {tuple(ld1.shape)} under pallas_mxu",
            lambda: step_l(ld1, ld2, rlk), (*MXU_CLUSTER_KERNELS, "base_convert"))
        per_step = tuple(llaunches[k] for k in MXU_CLUSTER_KERNELS)
        others = {k: v for k, v in llaunches.items() if v and k not in (
            *MXU_CLUSTER_KERNELS, "base_convert")}
        if per_step != (5, 4) or others or llaunches["base_convert"] != STEP_K3_LAUNCHES["hps"]:
            raise AssertionError(f"[mxu] the n = {N_LARGE} step launched the cluster kernel "
                                 f"{per_step} (5 forward, 4 inverse expected), K3 "
                                 f"{llaunches['base_convert']} ({STEP_K3_LAUNCHES['hps']}) "
                                 f"and others {others}")
        if not torch.equal(lout, large["out"]):
            raise AssertionError(f"[mxu] the n = {N_LARGE} step under pallas_mxu != the K1 step")
        check_decrypts("mxu", f"n = {N_LARGE} HPS products", lout, large["cd"].parms_id,
                       large["expected"], large["encoder"], large["decryptor"], n=N_LARGE)
        log(f"[mxu] the n = {N_LARGE} HPS step under pallas_mxu equals the K1 step and the "
            "all-plain step bit for bit; the cluster kernel 5 forward and 4 inverse launches a "
            "step, K1, the kernel to 16384 and the first form none, K3 2")
        lcalls = record_launches(lambda: step_l(ld1, ld2, rlk))
        for _ in range(2):
            step_l(ld1, ld2, rlk)
        chained = cuda_ms(lambda: step_l(ld1, ld2, rlk), 5)
        k1_chained = cuda_ms(lambda: large["step"](ld1, ld2, rlk), 5)
        prof = profile_step(lambda: step_l(ld1, ld2, rlk), 2)
        k1_prof = profile_step(lambda: large["step"](ld1, ld2, rlk), 2)
        cl_n = sum(prof[k][0] for k in MXU_CLUSTER_KERNELS)
        cl_ms = sum(prof[k][1] for k in MXU_CLUSTER_KERNELS)
        k1_n, k1_ms = ntt_totals(k1_prof)
        bound_ms = sum(ntt_bound(shape)[0] for name, shape, _ in lcalls
                       if name != "base_convert") / 1e3
        log(f"[mxu] {gpu}: profiler, the n = {N_LARGE} HPS step under pallas_mxu, 2 steps: "
            f"{prof['launches']:.0f} kernel launches and {prof['ms']:.4f} ms of device kernel "
            f"time a step, of which K2 (the cluster kernel) {cl_n:.0f} launches {cl_ms:.4f} ms "
            f"(the transforms' bound {bound_ms:.4f} ms, {100 * bound_ms / cl_ms:.1f}%) and K3 "
            f"{prof['base_convert'][0]:.0f} launches {prof['base_convert'][1]:.4f} ms; "
            f"{chained:.4f} ms a step by events (repeated), busy share "
            f"{100 * prof['ms'] / chained:.1f}%; the K1 step: {k1_prof['launches']:.0f} "
            f"launches, {k1_prof['ms']:.4f} ms of device time, K1 {k1_n:.0f} launches "
            f"{k1_ms:.4f} ms, {k1_chained:.4f} ms a step, busy "
            f"{100 * k1_prof['ms'] / k1_chained:.1f}%")
        # every transform of the step by CUDA graphs, summed: the profiler at
        # times drops a launch of a session
        step_us, step_bound = 0.0, 0.0
        for name, shape, t in lcalls:
            if name == "base_convert":
                continue
            inverse = name == "ntt_inverse"
            x = residues(shape, t.q, gen)
            fn = ntt_mxu_cuda.ntt_inverse if inverse else ntt_mxu_cuda.ntt_forward
            us = graph_us(lambda: fn(x, t.mxu), 20)
            step_us, step_bound = step_us + us, step_bound + ntt_bound(shape)[0]
            log(f"[mxu] {gpu}: the n = {N_LARGE} step's {name} at {shape}: the cluster kernel "
                f"in clusters of {1 << ntt_mxu_cuda.route_log_c(x, t.mxu, inverse)}, "
                f"{us:.3f} us a launch (graph of 20), bound {ntt_bound(shape)[0]:.3f} us")
        log(f"[mxu] {gpu}: the n = {N_LARGE} step's {len(lcalls) - llaunches['base_convert']} "
            f"K2 transforms by CUDA graphs: {step_us:.3f} us in all, bound {step_bound:.3f} us, "
            f"share {100 * step_bound / step_us:.1f}%")
        return dict(err=worst, times=times, launches={"HPS step": launches,
                                                      "rotate_rows(1)": rlaunches},
                    profiles=profiles, sweeps=sweeps,
                    large=dict(launches=llaunches, prof=prof, calls=lcalls, ms=chained,
                               k1_ms=k1_chained, k1_prof=k1_prof, k2_graph_us=step_us))
    finally:
        NTT.set_ntt_backend(saved)


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
                                    bconv_cuda, fused_mul as FM, fused_mul_cuda,
                                    ntt_mxu as MX, ntt_mxu_cuda)
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
    ptxas = [ptxas_start(src) for src in ("ntt.cu", "fused_mul.cu", "fused_mul_large.cu",
                                          "tensor_product.cu", "ntt_mxu.cu", "ntt_mxu_wg.cu",
                                          "ntt_mxu_cluster.cu", "bconv.cu", "bconv_first.cu")]
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
    for deg in LARGE_DEGREES:
        lg = deg.bit_length() - 1
        for inverse in (False, True):
            for threads in (256, 128):
                info = ntt_cuda.cluster_info(inverse, lg, NTT.default_split(lg), threads)
                log(f"[build] ntt_{'inverse' if inverse else 'forward'}_cluster at n = {deg}: "
                    f"{info} (cudaFuncGetAttributes, "
                    f"cudaOccupancyMaxActiveBlocksPerMultiprocessor, "
                    f"cudaOccupancyMaxActiveClusters)")
                if info["clusters"] < 1:
                    raise AssertionError(f"[build] no cluster of the NTT fits at n = {deg}")
    for lg in (N.bit_length() - 1, MX.WG_MAX_LOG_N):
        for inverse in (False, True):
            info = ntt_mxu_cuda.wg_info(inverse, lg)
            plan = MX.wg_plan(lg, inverse)
            log(f"[build] ntt_{'inverse' if inverse else 'forward'}_mxu at n = {1 << lg}: "
                f"{info}; the table planes {info['t1'] + info['t2']} bytes, loaded "
                f"{'once a CTA' if info['resident'] else 'before each stage'} "
                f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            if (info["ctas_per_sm"] < 1 or info["local_bytes"] or info["smem"] != plan["smem"]
                    or bool(info["resident"]) != plan["resident"]):
                raise AssertionError(f"[build] K2's launch shape {info} fits no SM, spills, "
                                     f"or is not the plan's {plan}")
    for lg in sorted(MX.CL_SWEEP):
        for inverse in (False, True):
            for k in MX.CL_SWEEP[lg]:
                info = ntt_mxu_cuda.cluster_info(inverse, lg, k)
                plan = MX.cl_plan(lg, inverse, k)
                log(f"[build] ntt_{'inverse' if inverse else 'forward'}_mxu_cluster at n = "
                    f"{1 << lg}, clusters of {1 << k}: {info}; a warpgroup's ring {plan['slots']} "
                    f"chunk(s) of {plan['chunk']} bytes, the tables streamed once a polynomial "
                    f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveClusters)")
                if info["clusters"] < 1 or info["smem"] != plan["smem"] or \
                        info["cluster"] != plan["C"]:
                    raise AssertionError(f"[build] K2's cluster kernel {info} fits no cluster or "
                                         f"is not the plan's {plan}")
    for lg in (N.bit_length() - 1, 15, 16):
        plan = MX.kernel_plan(lg)
        smem = max(plan["left"]["smem"], plan["right"]["smem"])
        kernels = (((0, "ntt_forward_mxu_mma"), (1, "ntt_inverse_mxu_mma"))
                   if plan["launches"] == 1 else ((2, "ntt_mxu stage kernel"),))
        for which, label in kernels:
            info = ntt_mxu_cuda.kernel_info(which, smem)
            log(f"[build] {label} at n = {1 << lg} ({plan['launches']} launch(es) a transform; "
                f"K chunks {plan['left']['kc']} / {plan['right']['kc']}): {info} "
                f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            if info["ctas_per_sm"] < 1 or info["local_bytes"]:
                raise AssertionError(f"[build] K2's launch shape {info} fits no SM or spills")
    forms = {l_in: bconv_cuda.kernel_info(l_in) for l_in in BCONV_FORMS}
    log(f"[build] base_convert's forms by L_in, (registers, CTAs an SM), "
        f"{forms[1]['threads']} threads a CTA, a column a thread, one CTA a tile of a row: "
        f"{ {k: (v['regs'], v['ctas_per_sm']) for k, v in forms.items()} }; the "
        f"shared-memory form (L_in > 16) {forms[17]['smem']} bytes of shared memory at most "
        f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    if any(v["ctas_per_sm"] < 1 or v["local_bytes"] for v in forms.values()):
        raise AssertionError(f"[build] a form of K3 fits no SM or spills: {forms}")
    for lg, k in fused_mul_cuda.LARGE_SHAPES:
        info = fused_mul_cuda.large_info(lg, k)
        log(f"[build] fused_mul_large at n = {1 << lg}, clusters of {1 << k}: {info}")
        if info["smem"] != fused_mul_cuda.large_shared_bytes(lg - k) or info["clusters"] < 1:
            raise AssertionError(f"[build] fused_mul_large's launch shape {info} is not the "
                                 f"wrapper's {fused_mul_cuda.large_shared_bytes(lg - k)} bytes "
                                 f"a CTA, or no cluster fits")

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
        **{f"n={n}, clusters of {1 << k}": ((3,), NTT.NTTTables(
            n.bit_length() - 1, degrees[n].moduli, dev, split=k), True)
           for n, splits in CLUSTER_SWEEP.items() for k in splits
           if k != degrees[n].split},
    })

    def converter(l_in, l_out):
        n = 2 * N
        return BaseConverter(
            RNSBase([Modulus(p) for p in numth.get_primes(n, 30, l_in)], dev),
            RNSBase([Modulus(p) for p in numth.get_primes(n, 29, l_out)], dev)).tables

    sk_tabs = tool._rows("q", None)["sk"]
    bconv_cases = {  # label: (lead, tables, layout)
        "lift q -> Bsk u {m~}": ((BATCH, 2), tool.conv_q_to_Bsk_m_tilde.tables, "contiguous"),
        "floor q -> Bsk (folded)": ((BATCH, 3), tool.ff_tables, "contiguous"),
        f"floor at batch {BCONV_DRAM_BATCH}": ((BCONV_DRAM_BATCH, 3), tool.ff_tables,
                                                "contiguous"),
        "floor, odd n": ((4, 3), tool.ff_tables, "odd n"),
        "floor, unaligned view": ((4, 3), tool.ff_tables, "unaligned"),
        "SK B -> q u {m_sk}, joined, strided": ((BATCH, 3), sk_tabs, "strided"),
        "SK B -> q": ((BATCH, 3), tool.conv_B_to_q.tables, "contiguous"),
        "SK B -> m_sk": ((BATCH, 3), tool.conv_B_to_m_sk.tables, "contiguous"),
        "decrypt q -> {t, gamma}": ((), tool.conv_q_to_t_gamma.tables, "contiguous"),
        "decrypt step q -> {t, gamma}": ((BATCH,), tool.conv_q_to_t_gamma.tables, "contiguous"),
        "15 -> 9": ((4,), converter(15, 9), "contiguous"),
        "17 -> 5": ((4,), converter(17, 5), "contiguous"),
        "1 -> 3": ((4,), converter(1, 3), "contiguous"),
        **{f"ring2k q -> {{2^{k}, gamma}}": ((RING2K_MESSAGES,), t_gamma_tables(dev, k),
                                              "contiguous") for k in (30, 31)},
    }
    err.update(phase_bconv(dev, bconv_cases))
    err.update(phase_fused(dev, {
        "base q": ((BATCH,), qtab),
        "base Bsk": ((BATCH,), bsk),
        **{f"n={n}": ((3,), t) for n, t in degrees.items() if n <= 131072},
        **{f"n={1 << lg}, clusters of {1 << k}": ((3,), NTT.NTTTables(
            lg, degrees[1 << lg].moduli, dev, split=k))
           for lg, k in fused_mul_cuda.LARGE_SHAPES if k != degrees[1 << lg].split},
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
    launches, outs = {}, {}
    for lift, step in steps.items():
        out, launches[lift] = run_step(
            "main", f"{lift.upper()} step {tuple(d1.shape)} x {tuple(d2.shape)}",
            lambda: step(d1, d2, keys), ("ntt_forward", "ntt_inverse", "base_convert"))
        outs[lift] = out
        k3 = (launches[lift]["base_convert"], launches[lift]["base_convert_copy"])
        if k3 != (STEP_K3_LAUNCHES[lift], 0):
            raise AssertionError(f"[main] the {lift} step launched K3 {k3[0]} times "
                                 f"({STEP_K3_LAUNCHES[lift]}) and copied {k3[1]} inputs (0)")
        log(f"[main] {lift.upper()} step: K3 {k3[0]} launches (the floor, the joined "
            f"Shenoy-Kumaresan pair{', the lift of each operand' if lift == 'behz' else ''}), "
            "no input copied")
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

    # ---- 17. harness, 18. eager, 19. examples, 20. perop ---------------------
    harness = phase_harness(dev, gpu, qtab)
    eager = phase_eager(dev, gpu)
    examples = phase_examples()
    perop = phase_perop(dev, gpu)

    # ---- 21. mesh ---------------------------------------------------------
    mesh = phase_mesh(dev, gpu, dict(step=steps["hps"], d1=d1, d2=d2, keys=keys, cd=cd,
                                     encoder=encoder, decryptor=decryptor,
                                     expected=expected), app)

    # ---- 22. mxu ----------------------------------------------------------
    mxu = phase_mxu(dev, gpu, dict(step=steps["hps"], d1=d1, d2=d2, keys=keys, cd=cd,
                                   out=outs["hps"], encoder=encoder, decryptor=decryptor,
                                   expected=expected), rot, large)

    # ---- 23. times ---------------------------------------------------------
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
    bconv_ab = phase_bconv_ab(gpu, dev, {
        k: v for k, v in bconv_cases.items() if k not in ("15 -> 9", "17 -> 5", "1 -> 3")},
        (tool.conv_B_to_q.tables, tool.conv_B_to_m_sk.tables))
    floor_ab = bconv_ab["floor q -> Bsk (folded)"]
    times["base_convert"] = (floor_ab["us"] / 1e3, floor_ab["plain_us"] / 1e3)
    hps_k3 = step_k3(gpu, dev, lambda: steps["hps"](d1, d2, keys))
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

    # ---- 24. results -------------------------------------------------------
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
        "wide": {k: sum(c[k] for c in wide["launches"].values()) for k in KERNELS},
        "perop": {k: sum(c[k] for c in perop["launches"].values()) for k in KERNELS},
        "eager": {k: eager["launches"][k] for k in KERNELS},
        "examples": {k: sum(c[k] for c in examples["launches"].values()) for k in KERNELS},
        "harness": {k: harness["launches"][k] for k in KERNELS},
        "mesh": {k: sum(c[k] for c in mesh["launches"].values()) for k in KERNELS},
        "mxu": {k: sum(c[k] for c in mxu["launches"].values()) for k in KERNELS},
        "mxu_large": {k: mxu["large"]["launches"][k] for k in KERNELS}}
    for path in ("client", "wire", "ring2k", "perop", "eager", "examples", "mesh"):
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
    for name in MXU_KERNELS:  # K2 at [times]' shape (16, 6, 8192), base q
        row = mxu["times"]["base q"][name]
        err[name] = mxu["err"]
        times[name] = (row["us"] / 1e3, row["plain_us"] / 1e3)
        timed[name] = (row["bound"], row["by"])
    for name in MXU_CLUSTER_KERNELS:  # K2's cluster kernel at (3, 2, 65536)
        row = mxu["times"][f"n = {N_LARGE}"][name]
        err[name] = mxu["err"]
        times[name] = (row["us"] / 1e3, row["plain_us"] / 1e3)
        timed[name] = (row["bound"], row["by"])
    for name in KERNELS:  # the cluster kernels at (3, 2, 65536) (K4: (3, 2, 2, 65536))
        if name not in timed:
            ms, plain_ms, bound_ms, by, _ = large["times"][(name, N_LARGE)]
            times[name] = (ms, plain_ms)
            timed[name] = (bound_ms * 1e3, by)
    hps_kernels = ("ntt_forward", "ntt_inverse", "base_convert", "fused_negacyclic_multiply")
    results = []
    for name, (src, replaces) in KERNELS.items():
        path = ("hps" if name in hps_kernels else "mxu" if name in MXU_KERNELS else
                "mxu_large" if name in MXU_CLUSTER_KERNELS else "large_n")
        if path == "mxu_large":  # per dispatch call of the n = 65536 step under pallas_mxu
            prof = mxu["large"]["prof"]
            mine = [(shape, t) for kname, shape, t in mxu["large"]["calls"]
                    if name.startswith(kname)]
        elif path == "hps":
            prof = profiles["HPS step"]
            mine = [(shape, t) for kname, shape, t in step_calls["HPS step"] if kname == name]
        elif path == "mxu":  # per dispatch call of the step under pallas_mxu
            prof = mxu["profiles"]["HPS step"]["prof"]
            mine = [(shape, t) for kname, shape, t in mxu["profiles"]["HPS step"]["calls"]
                    if name.startswith(kname)]
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
            "device_us": measured(prof[name][1] * 1e3), "launches_per_step": len(mine)})
        if name in (*MXU_KERNELS, *MXU_CLUSTER_KERNELS):  # K2's method terms, and the plane
            # products alone as torch._int_mm: a yardstick (null: not measured)
            row = mxu["times"]["base q" if name in MXU_KERNELS else f"n = {N_LARGE}"][name]
            results[-1]["method_terms_ms"] = {k: v / 1e3 for k, v in row["terms"].items()}
            results[-1]["int_mm_ms"] = None if row["int_mm_us"] is None else row["int_mm_us"] / 1e3
        if results[-1]["launches"] == 0:
            raise AssertionError(f"[results] {name} was not launched on its path ({path})")
        if name == "base_convert":  # the HPS step's K3 launches by CUDA graphs (step_k3)
            results[-1]["step_graph_us"] = hps_k3["us"]
            results[-1]["step_first_route_us"] = hps_k3["first_us"]
    for name, (src, replaces) in MXU_YARDSTICKS.items():  # on no path: timed, not launched
        # the one-CTA kernel at base q (16, 6, 8192), the stage kernel's two
        # launches at (3, 2, 65536)
        of = (name.removesuffix("_mma") if name.endswith("_mma") else
              name.removesuffix("_stages") + "_cluster")
        row = mxu["times"]["base q" if name.endswith("_mma") else f"n = {N_LARGE}"][of]
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(c[name] for c in (*mxu["launches"].values(),
                                              mxu["large"]["launches"])),
            "max_abs_err": mxu["err"],
            "ms": row["yard_us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
            "bound_ms": row["bound"] / 1e3, "bound_by": row["by"], "library_ms": None,
            "path": None, "yardstick_of": of,
            "method_terms_ms": {k: v / 1e3 for k, v in row["yard_terms"].items()}})
    for name, (src, replaces) in BCONV_YARDSTICKS.items():  # on no path: timed, not launched
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(launches[k][name] for k in ("hps", "behz")),
            "max_abs_err": err[name], "ms": floor_ab["first_us"] / 1e3,
            "plain_ms": floor_ab["plain_us"] / 1e3, "bound_ms": floor_ab["bound"] / 1e3,
            "bound_by": floor_ab["by"], "library_ms": None, "path": None,
            "yardstick_of": "base_convert"})
        if results[-1]["launches"]:
            raise AssertionError(f"[results] the yardstick {name} was launched on a path")
    if PROFILER["failed"]:
        log(f"[results] the profiler recorded no device kernel for {PROFILER['failed']} "
            "profiled calls: their device times are not measured (device_us null)")
    print(json.dumps({"kernels": results}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

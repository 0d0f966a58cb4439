#!/usr/bin/env python3
"""Smoke run of the PyTorch port (troy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's server paths at n = 8192 on a 7 x 30-bit chain (the last
prime special, so data level L = 6), plain modulus
PlainModulus.batching(8192, 20), batch 16: the batched BFV multiply +
relinearize step under both lifts of base q to the auxiliary base Bsk (the
default HPS lift and the reference-exact BEHZ lift, Evaluator(ctx,
lift="behz")), the batched Galois rotations and the mod switch; and the
client flow of examples/99_quickstart.py.  In phases:

  1. device   the card's name and power limit (fails without CUDA);
  2. build    nvcc builds every csrc/*.cu into one library under
              troy_tpu_torch/build/; beside it, nvcc -Xptxas -v on ntt.cu
              prints each NTT kernel's registers and spills, and the
              occupancy calculator its CTAs per SM;
  3. kernels  each kernel against its plain PyTorch version, bit for bit:
              the NTT pair (and the earlier radix-2 pair that [times] uses
              as its yardstick) at every shape the path gives it and at every
              degree 2 to 32768; the base conversion (K3) at every conversion of
              both lifts, the floor, Shenoy-Kumaresan and decrypt, at a
              15 -> 9 contraction and at one input limb; the fused tensor
              product (K4) over base q and Bsk and at degrees 16 to 32768.
              Each wrapper refuses input its kernel cannot take;
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
  7. client   examples/99_quickstart.py's flow (public key,
              encrypt_asymmetric, add, decrypt, decode), multiply_plain in
              coefficient and NTT form, add_plain, and one special-prime
              encryption, each decrypting right;
  8. times    CUDA-event times of the chained steps against their all-plain
              versions (multiply + relinearize, the three rotations, the mod
              switch), the profiler's launches, device time, NTT kernel time
              and busy share of the HPS step and of one rotate_rows(1) and
              one rotate_columns step, one Galois round split into its
              stages (gather, keyswitch, add), each kernel against its plain
              version (K4 also against the unfused kernel path), and the NTT
              kernel against the earlier radix-2 kernel in turns (new, old,
              old, new) at every NTT shape of the HPS step and the Galois round:
              device microseconds per launch from CUDA events around a CUDA
              graph of 50 launches, beside the launch's bound.

Bounds: the least time the card could take for a launch's work, the larger
of its bytes (each input read once, each output written once) over
3.35 TB/s and its int32 operations over 132 SMs x 64 lanes x 1.98 GHz
(the H100 SXM's published memory rate and boost clock).

Prints one JSON line of kernel results, then the nvidia-smi line, then
{"ok": true, "device": {...}} as the last line.  Any failure raises, so the
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
KERNELS = {  # name: (source, the TPU kernels it replaces: K1 and K2 for the NTT)
    "ntt_forward": ("troy_tpu_torch/csrc/ntt.cu",
                    "troy_tpu/ops/ntt_pallas.py:74, troy_tpu/ops/ntt_pallas.py:206"),
    "ntt_inverse": ("troy_tpu_torch/csrc/ntt.cu",
                    "troy_tpu/ops/ntt_pallas.py:89, troy_tpu/ops/ntt_pallas.py:228"),
    "base_convert": ("troy_tpu_torch/csrc/bconv.cu", "troy_tpu/ops/ntt_pallas.py:413"),
    "fused_negacyclic_multiply": ("troy_tpu_torch/csrc/fused_mul.cu",
                                  "troy_tpu/ops/fused_mul.py:75"),
}


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


def ptxas_report(proc: subprocess.Popen):
    """Registers, stack and spills of each kernel of ntt.cu, as
    nvcc -Xptxas -v prints them."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"[build] nvcc -Xptxas -v failed:\n{out}\n{err}")
    names = {"ntt_kernelILb0": "ntt_forward", "ntt_kernelILb1": "ntt_inverse",
             "ntt_forward_radix2": "ntt_forward radix-2 yardstick",
             "ntt_inverse_radix2": "ntt_inverse radix-2 yardstick"}
    current = None
    for line in err.splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in names.items() if k in line), None)
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
    """NTT kernel pair vs plain, and the radix-2 yardstick of [times] too;
    returns max |err| per kernel.  The inverse also takes lazy [0, 2q)."""
    from troy_tpu_torch.ops import ntt as NTT, ntt_cuda

    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"ntt_forward": 0, "ntt_inverse": 0}
    for label, (lead, t, lazy) in tables.items():
        shape = (*lead, t.size, t.n)
        x = residues(shape, t.q, gen, 2 if lazy else 1)
        y = ntt_cuda.ntt_forward(x, t)
        y_ref = NTT.ntt_forward_plain(x, t)
        z = ntt_cuda.ntt_inverse(y, t)
        z_ref = NTT.ntt_inverse_plain(y, t)
        z_lazy = ntt_cuda.ntt_inverse(x, t)
        z_lazy_ref = NTT.ntt_inverse_plain(x % t.q.view(-1, 1), t)
        yard = (torch.equal(ntt_cuda.run_radix2(False, x, t), y_ref)
                and torch.equal(ntt_cuda.run_radix2(True, y, t), z_ref))
        torch.cuda.synchronize()
        e_f = int((y - y_ref).abs().max())
        e_i = max(int((z - z_ref).abs().max()), int((z_lazy - z_lazy_ref).abs().max()))
        back = bool(torch.equal(z, x % t.q.view(-1, 1)))
        log(f"[kernels] ntt {label} {shape}: forward max|err| {e_f}, "
            f"inverse max|err| {e_i}, inverse(forward(x)) == x: {back}, "
            f"radix-2 yardstick equal: {yard}")
        if e_f or e_i or not back or not yard:
            raise AssertionError(f"[kernels] ntt {label}: kernel disagrees with plain")
        err["ntt_forward"] = max(err["ntt_forward"], e_f)
        err["ntt_inverse"] = max(err["ntt_inverse"], e_i)
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


def phase_fused(dev, cases: dict) -> int:
    """Fused tensor-product kernel vs plain; returns max |err|."""
    from troy_tpu_torch.ops import fused_mul as FM, fused_mul_cuda

    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0
    for label, (lead, t) in cases.items():
        shape = (*lead, 2, t.size, t.n)
        a, b = residues(shape, t.q, gen), residues(shape, t.q, gen)
        c = fused_mul_cuda.fused_negacyclic_multiply(a, b, t)
        c_ref = FM.fused_negacyclic_multiply_plain(a, b, t)
        torch.cuda.synchronize()
        e = int((c - c_ref).abs().max())
        log(f"[kernels] fused_negacyclic_multiply {label} {shape} -> "
            f"{tuple(c.shape)}: max|err| {e}")
        if e or c.shape != c_ref.shape:
            raise AssertionError(f"[kernels] fused {label}: kernel disagrees with plain")
        worst = max(worst, e)
    return worst


def other_degrees(dev) -> dict:
    """NTT tables off the main path, every n = 2 to the kernels' limit 32768
    (above 48 KiB of dynamic shared memory), and n = 65536, which the
    wrappers refuse."""
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.ops.ntt import NTTTables
    from troy_tpu_torch.utils import numth

    out = {}
    for log_n in range(1, 17):
        n = 1 << log_n
        mods = [Modulus(p) for p in numth.get_primes(2 * n, 30, 2)]
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
    """Each wrapper raises, without launching, on input its kernel cannot take."""
    from troy_tpu_torch.ops import ntt_cuda, bconv_cuda, fused_mul_cuda

    x = torch.zeros((2, t.size, t.n), dtype=torch.int64, device=dev)
    expect_refusals("ntt_forward", lambda v: ntt_cuda.ntt_forward(v, t), {
        "int32": (x.to(torch.int32), TypeError),
        "not contiguous": (x.transpose(0, 1), ValueError),
        "wrong limb count": (x[:, :1].contiguous(), ValueError),
        "CPU tensor": (x.cpu(), ValueError)})
    expect_refusals("ntt_forward at n = 65536",
                    lambda v: ntt_cuda.ntt_forward(v, big), {
                        "n above 32768": (torch.zeros((1, big.size, big.n), dtype=torch.int64,
                                                      device=dev), ValueError)})
    xb = torch.zeros((2, bconv_tabs.L_in, N), dtype=torch.int64, device=dev)
    expect_refusals("base_convert", lambda v: bconv_cuda.base_convert(v, bconv_tabs), {
        "int32": (xb.to(torch.int32), TypeError),
        "not contiguous": (xb.transpose(0, 1), ValueError),
        "wrong limb count": (xb[:, :1].contiguous(), ValueError),
        "CPU tensor": (xb.cpu(), ValueError)})
    a = torch.zeros((2, 2, t.size, t.n), dtype=torch.int64, device=dev)
    expect_refusals("fused_negacyclic_multiply",
                    lambda v: fused_mul_cuda.fused_negacyclic_multiply(v, a, t), {
                        "int32": (a.to(torch.int32), TypeError),
                        "not contiguous": (a.transpose(0, 1), ValueError),
                        "three polynomials": (torch.zeros((2, 3, t.size, t.n), dtype=torch.int64,
                                                          device=dev), ValueError),
                        "CPU tensor": (a.cpu(), ValueError)})
    ab = torch.zeros((1, 2, big.size, big.n), dtype=torch.int64, device=dev)
    expect_refusals("fused_negacyclic_multiply at n = 65536",
                    lambda v: fused_mul_cuda.fused_negacyclic_multiply(v, v, big), {
                        "n above 32768": (ab, ValueError)})


def run_step(phase: str, label: str, fn, required) -> tuple[torch.Tensor, dict]:
    """fn() once with the launch counts set to 0 just before and read just
    after; it must launch every kernel named in required and equal the same
    call with every kernel dispatch patched to its plain version."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[{phase}] {label} -> {tuple(out.shape)}; kernel launches {launches}")
    for name in required:
        if launches[name] == 0:
            raise AssertionError(f"[{phase}] {label} did not launch {name}")
    with all_plain():
        ref = fn()
    torch.cuda.synchronize()
    if launch_counts() != launches:
        raise AssertionError(f"[{phase}] the plain run of {label} launched a kernel")
    if not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise AssertionError(f"[{phase}] {label}: kernel run != plain run at {bad} residues")
    log(f"[{phase}] {label} equals the all-plain run bit for bit")
    return out, launches


def check_decrypts(phase: str, label: str, out: torch.Tensor, parms_id, expected,
                   encoder, decryptor, k3_shape=None) -> int:
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
            if got.shape != (N,) or not np.array_equal(got, np.asarray(expected[b], np.int64)):
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


def phase_client(dev, gen) -> dict:
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
        raise AssertionError("[client] the quickstart sum decrypts wrong")
    log(f"[client] quickstart flow (n={N}, {QUICKSTART_BITS} bits, Classical128): public "
        f"key, encrypt_asymmetric x2, add, decrypt, decode = (x + y) mod t; slots 0..3 "
        f"{result[:4].tolist()}; kernel launches {launches}")
    for name in ("ntt_forward", "ntt_inverse", "base_convert"):
        if launches[name] == 0:
            raise AssertionError(f"[client] the quickstart flow did not launch {name}")

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
            raise AssertionError(f"[client] {label} decrypts wrong")
        log(f"[client] {label}: decrypts right (noise budget "
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


PROFILED = {  # kernel: a part of its name in the profiler
    "ntt_forward": "ntt_kernel<false>", "ntt_inverse": "ntt_kernel<true>",
    "base_convert": "bconv_kernel", "fused_negacyclic_multiply": "fused_mul_kernel"}


def profile_step(fn, calls: int) -> dict:
    """Per call of fn, from the profiler's device events: kernel launches,
    device milliseconds, and each port kernel's launches and milliseconds."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        raise AssertionError("[times] the profiler recorded no device kernels")
    out = {"launches": sum(e.count for e in kernels) / calls,
           "ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls}
    for name, part in PROFILED.items():
        mine = [e for e in kernels if part in e.key]
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
    return bconv_bound(shape, t.L_out) if name == "base_convert" else ntt_bound(shape)


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
                                    bconv_cuda, dyadic as D, fused_mul as FM,
                                    fused_mul_cuda)
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
    ptxas = subprocess.Popen(
        [_cuda_build._nvcc(), *_cuda_build.COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(_cuda_build.BUILD_DIR / "ntt_ptxas.o"), str(_cuda_build.CSRC / "ntt.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lib = _cuda_build.build()
    _cuda_build.load()
    log(f"[build] {lib.name} from {', '.join(p.name for p in _cuda_build.sources())} "
        f"in {time.perf_counter() - t0:.3f} s")
    ptxas_report(ptxas)
    for which, label in enumerate(("ntt_forward", "ntt_inverse", "ntt_forward radix-2 yardstick",
                                   "ntt_inverse radix-2 yardstick")):
        log(f"[build] {label} at n = {N}: {ntt_cuda.kernel_info(which, N.bit_length() - 1)} "
            f"(cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)")

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
        **{f"n={n}": ((3,), t, True) for n, t in degrees.items() if n <= 32768},
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
    }
    err["base_convert"] = phase_bconv(dev, bconv_cases)
    err["fused_negacyclic_multiply"] = phase_fused(dev, {
        "base q": ((BATCH,), qtab),
        "base Bsk": ((BATCH,), bsk),
        **{f"n={n}": ((3,), degrees[n]) for n in K4_DEGREES},
    })
    phase_refusals(dev, qtab, tool.conv_B_to_q.tables, degrees[65536])

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

    def unfused_stage(a, b, t):
        return NTT.ntt_inverse(D.dyadic_convolute(NTT.ntt_forward(a, t),
                                                  NTT.ntt_forward(b, t), t), t)

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

    # ---- 5. rotate, 6. modswitch, 7. client ------------------------------------
    rot = phase_rotate(ctx, keygen, gen, encoder, decryptor, batched["hps"])
    modswitch = phase_modswitch(ctx, evs["hps"], rot, encoder, decryptor)
    phase_client(dev, gen)

    # ---- 8. times ----------------------------------------------------------
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
        ntt_n = prof["ntt_forward"][0] + prof["ntt_inverse"][0]
        ntt_ms = prof["ntt_forward"][1] + prof["ntt_inverse"][1]
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
    for label, t in (("base q", qtab), ("base Bsk", bsk)):
        a = residues((BATCH, 2, t.size, N), t.q, g)
        b = residues((BATCH, 2, t.size, N), t.q, g)
        ms = pair(lambda: fused_mul_cuda.fused_negacyclic_multiply(a, b, t),
                  lambda: FM.fused_negacyclic_multiply_plain(a, b, t))
        unfused_ms = graph_us(lambda: unfused_stage(a, b, t)) / 1e3
        if label == "base q":
            times["fused_negacyclic_multiply"] = ms
        log(f"[times] {gpu}: fused_negacyclic_multiply {label} {tuple(a.shape)}: "
            f"kernel {ms[0]:.5f} ms, plain {ms[1]:.5f} ms, unfused kernel path "
            f"(NTT kernel, torch dyadic_convolute, NTT kernel) {unfused_ms:.5f} ms (device "
            f"time per call, CUDA graph)")

    # ---- 9. results ----------------------------------------------------------
    main_launches = {**launches["hps"],
                     "fused_negacyclic_multiply":
                         launches["fused"]["fused_negacyclic_multiply"]}
    floor_tabs = tool.ff_tables
    timed = {  # the work each kernel's "ms" times, for its bound
        "ntt_forward": ntt_bound(tuple(xq.shape)), "ntt_inverse": ntt_bound(tuple(xq.shape)),
        "base_convert": bconv_bound((BATCH, 3, floor_tabs.L_in, N), floor_tabs.L_out),
        "fused_negacyclic_multiply": fused_bound((BATCH, 2, L, N))}
    hps = profiles["HPS step"]
    results = []
    for name, (src, replaces) in KERNELS.items():
        mine = [(shape, t) for kname, shape, t in step_calls["HPS step"] if kname == name]
        results.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": err[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": timed[name][0] / 1e3, "bound_by": timed[name][1], "library_ms": None,
            "bound_us": sum(launch_bound(name, shape, t)[0] for shape, t in mine),
            "device_us": hps[name][1] * 1e3, "launches_per_step": len(mine)})
    print(json.dumps({"kernels": results}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

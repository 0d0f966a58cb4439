#!/usr/bin/env python3
"""Smoke run of the PyTorch port (troy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the batched BFV multiply + relinearize step,
at n = 8192 on a 7 x 30-bit chain (the last prime special), plain modulus
PlainModulus.batching(8192, 20), batch 16, under both lifts of base q to the
auxiliary base Bsk: the default HPS lift and the reference-exact BEHZ lift
(Evaluator(ctx, lift="behz")).  In phases:

  1. device   the card's name and power limit (fails without CUDA);
  2. build    nvcc builds every csrc/*.cu into one library under
              troy_tpu_torch/build/;
  3. kernels  each kernel against its plain PyTorch version, bit for bit:
              the NTT pair at every shape the path gives it and at degrees
              16 to 32768; the base conversion (K3) at every conversion of
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
  5. times    CUDA-event times of the chained steps against their all-plain
              versions, and of each kernel against its plain version (K4
              also against the unfused kernel path).

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
LOG_T = 20
BATCH = 16
KEY_SEED = 0xBEEF
MSG_SEED = 7
REPS = 20
KERNEL_REPS = 50
PLAIN_REPS = 5
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "ntt_forward": ("troy_tpu_torch/csrc/ntt.cu", "troy_tpu/ops/ntt_pallas.py:206"),
    "ntt_inverse": ("troy_tpu_torch/csrc/ntt.cu", "troy_tpu/ops/ntt_pallas.py:228"),
    "base_convert": ("troy_tpu_torch/csrc/bconv.cu", "troy_tpu/ops/ntt_pallas.py:413"),
    "fused_negacyclic_multiply": ("troy_tpu_torch/csrc/fused_mul.cu",
                                  "troy_tpu/ops/fused_mul.py:75"),
}


def log(msg: str):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    """NTT kernel pair vs plain; returns max |err| per kernel."""
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
        torch.cuda.synchronize()
        e_f = int((y - y_ref).abs().max())
        e_i = int((z - z_ref).abs().max())
        back = bool(torch.equal(z, x % t.q.view(-1, 1)))
        log(f"[kernels] ntt {label} {shape}: forward max|err| {e_f}, "
            f"inverse max|err| {e_i}, inverse(forward(x)) == x: {back}")
        if e_f or e_i or not back:
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
    """NTT tables off the main path, n = 16 to the kernels' limit 32768
    (above 48 KiB of dynamic shared memory), and n = 65536, which the
    wrappers refuse."""
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.ops.ntt import NTTTables
    from troy_tpu_torch.utils import numth

    out = {}
    for log_n in (4, 10, 14, 15, 16):
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


def run_step(label: str, step, d1, d2, keys) -> tuple[torch.Tensor, dict]:
    """One step with counted launches; it must launch the NTT kernels and K3
    and equal the all-plain step bit for bit."""
    reset_launch_counts()
    out = step(d1, d2, keys)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"[main] {label} step {tuple(d1.shape)} x {tuple(d2.shape)} -> "
        f"{tuple(out.shape)}; kernel launches {launches}")
    for name in ("ntt_forward", "ntt_inverse", "base_convert"):
        if launches[name] == 0:
            raise AssertionError(f"[main] the {label} step did not launch {name}")
    with all_plain():
        ref = step(d1, d2, keys)
    torch.cuda.synchronize()
    if launch_counts() != launches:
        raise AssertionError(f"[main] the plain {label} run launched a kernel")
    if not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise AssertionError(f"[main] {label} kernel step != plain step at {bad} residues")
    log(f"[main] {label} step equals the all-plain step bit for bit")
    return out, launches


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
    lib = _cuda_build.build()
    _cuda_build.load()
    log(f"[build] {lib.name} from {', '.join(p.name for p in _cuda_build.sources())} "
        f"in {time.perf_counter() - t0:.3f} s")

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
        **{f"n={n}": ((3,), t) for n, t in degrees.items() if n <= 32768},
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
        out, launches[lift] = run_step(lift.upper(), step, d1, d2, keys)
        reset_launch_counts()
        for b in range(BATCH):
            got = encoder.decode(decryptor.decrypt(Ciphertext(out[b], cd.parms_id)))
            got = got.cpu().numpy()
            if got.shape != (N,) or not np.array_equal(got, expected[b].astype(np.int64)):
                raise AssertionError(f"[main] {lift} ciphertext {b} decrypts wrong")
        dec_launches = launch_counts()["base_convert"]
        if dec_launches < BATCH:
            raise AssertionError(f"[main] decrypt launched base_convert {dec_launches} times")
        budget = decryptor.invariant_noise_budget(Ciphertext(out[0], cd.parms_id))
        log(f"[main] {lift.upper()}: all {BATCH} products decrypt to m1 * m2 mod t "
            f"(base_convert launched {dec_launches} times by decrypt); noise budget "
            f"of product 0: {budget} bits")
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

    # ---- 5. times ----------------------------------------------------------
    step_ms = {}
    for lift, step in steps.items():
        for _ in range(3):
            step(d1, d2, keys)
        state = {"cur": d1}

        def chained():
            state["cur"] = step(state["cur"], d2, keys)

        ms = cuda_ms(chained, REPS)
        with all_plain():
            state["cur"] = d1
            chained()
            plain_ms = cuda_ms(chained, PLAIN_REPS)
        step_ms[lift] = (ms, plain_ms)
        log(f"[times] {gpu}: {lift.upper()} step {ms:.4f} ms per batch of {BATCH} "
            f"({BATCH / ms * 1e3:.2f} ciphertexts/s); all plain {plain_ms:.4f} ms")

    def pair(kernel, plain):
        kernel()
        plain()
        return cuda_ms(kernel, KERNEL_REPS), cuda_ms(plain, PLAIN_REPS)

    times = {}
    g = torch.Generator(device=dev).manual_seed(2)
    xq = residues((BATCH, L, N), qtab.q, g)
    for name, kernel, plain in (
            ("ntt_forward", ntt_cuda.ntt_forward, NTT.ntt_forward_plain),
            ("ntt_inverse", ntt_cuda.ntt_inverse, NTT.ntt_inverse_plain)):
        times[name] = pair(lambda: kernel(xq, qtab), lambda: plain(xq, qtab))
        log(f"[times] {gpu}: {name} at {tuple(xq.shape)}: kernel "
            f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms (wall time "
            f"per call, wrapper included)")
    for label, (lead, tabs) in bconv_cases.items():
        if label in ("15 -> 9", "1 -> 3"):
            continue
        x = residues((*lead, tabs.L_in, N), tabs.q_in, g)
        ms = pair(lambda: bconv_cuda.base_convert(x, tabs),
                  lambda: BC.base_convert_plain(x, tabs))
        if label.startswith("floor"):
            times["base_convert"] = ms
        log(f"[times] {gpu}: base_convert {label} {tuple(x.shape)} -> "
            f"{tabs.L_out} limbs: kernel {ms[0]:.5f} ms, plain {ms[1]:.5f} ms")
    for label, t in (("base q", qtab), ("base Bsk", bsk)):
        a = residues((BATCH, 2, t.size, N), t.q, g)
        b = residues((BATCH, 2, t.size, N), t.q, g)
        ms = pair(lambda: fused_mul_cuda.fused_negacyclic_multiply(a, b, t),
                  lambda: FM.fused_negacyclic_multiply_plain(a, b, t))
        unfused_ms = cuda_ms(lambda: unfused_stage(a, b, t), KERNEL_REPS)
        if label == "base q":
            times["fused_negacyclic_multiply"] = ms
        log(f"[times] {gpu}: fused_negacyclic_multiply {label} {tuple(a.shape)}: "
            f"kernel {ms[0]:.5f} ms, plain {ms[1]:.5f} ms, unfused kernel path "
            f"(NTT kernel, torch dyadic_convolute, NTT kernel) {unfused_ms:.5f} ms")

    # ---- 6. results ----------------------------------------------------------
    main_launches = {**launches["hps"],
                     "fused_negacyclic_multiply":
                         launches["fused"]["fused_negacyclic_multiply"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": main_launches[name], "max_abs_err": err[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

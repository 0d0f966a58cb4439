#!/usr/bin/env python3
"""Smoke run of the PyTorch port (troy_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the batched BFV multiply + relinearize step,
at n = 8192 on a 7 x 30-bit chain (the last prime special), plain modulus
PlainModulus.batching(8192, 20), batch 16, in phases:

  1. device   the card's name and power limit (fails without CUDA);
  2. build    nvcc builds csrc/ntt.cu into troy_tpu_torch/build/;
  3. kernels  the NTT kernel pair against its plain PyTorch version, bit for
              bit, at every shape the main path gives it and at degrees
              16 to 32768; the wrapper refuses input the kernel cannot take;
  4. main     keygen, encode, encrypt 16 distinct pairs, one step; the step
              must launch the kernels, equal the same step run with the plain
              NTT, and decrypt to the slot-wise products m1 * m2 mod t;
  5. times    CUDA-event times of the chained step and of each kernel
              against its plain version.

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
SOURCE = "troy_tpu_torch/csrc/ntt.cu"
REPLACES = {"ntt_forward": "troy_tpu/ops/ntt_pallas.py:206",
            "ntt_inverse": "troy_tpu/ops/ntt_pallas.py:228"}


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


def build_context(dev):
    from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
    from troy_tpu_torch.core.coeff_modulus import CoeffModulus, PlainModulus, SecurityLevel
    from troy_tpu_torch.core.context import HeContext

    parms = EncryptionParameters(SchemeType.BFV)
    parms.set_poly_modulus_degree(N)
    parms.set_coeff_modulus(CoeffModulus.create(N, Q_BITS))
    parms.set_plain_modulus(PlainModulus.batching(N, LOG_T))
    return HeContext.create(parms, dev, sec_level=SecurityLevel.Nil)


def phase_kernels(dev, tables: dict):
    """Kernel vs plain at the main path's shapes; returns max |err| per kernel."""
    from troy_tpu_torch.ops import ntt as NTT, ntt_cuda

    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"ntt_forward": 0, "ntt_inverse": 0}
    for label, (lead, t, lazy) in tables.items():
        q = t.q.view(-1, 1)
        shape = (*lead, t.size, t.n)
        x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                          device=dev) % (q * (2 if lazy else 1))
        y = ntt_cuda.ntt_forward(x, t)
        y_ref = NTT.ntt_forward_plain(x, t)
        z = ntt_cuda.ntt_inverse(y, t)
        z_ref = NTT.ntt_inverse_plain(y, t)
        torch.cuda.synchronize()
        e_f = int((y - y_ref).abs().max())
        e_i = int((z - z_ref).abs().max())
        back = bool(torch.equal(z, x % q))
        log(f"[kernels] {label} {shape}: forward max|err| {e_f}, "
            f"inverse max|err| {e_i}, inverse(forward(x)) == x: {back}")
        if e_f or e_i or not back:
            raise AssertionError(f"[kernels] {label}: kernel disagrees with plain")
        err["ntt_forward"] = max(err["ntt_forward"], e_f)
        err["ntt_inverse"] = max(err["ntt_inverse"], e_i)
    return err


def other_degrees(dev) -> dict:
    """Tables at degrees off the main path, down to n = 16 and up to the
    kernel's limit n = 32768 (above 48 KiB of dynamic shared memory)."""
    from troy_tpu_torch.core.modulus import Modulus
    from troy_tpu_torch.ops.ntt import NTTTables
    from troy_tpu_torch.utils import numth

    out = {}
    for log_n in (4, 10, 14, 15):
        n = 1 << log_n
        mods = [Modulus(p) for p in numth.get_primes(2 * n, 30, 2)]
        out[f"n={n}"] = ((3,), NTTTables(log_n, mods, dev), True)
    return out


def phase_refusals(dev, t):
    """The wrapper raises, without launching, on input the kernel does not take."""
    from troy_tpu_torch.ops import ntt_cuda

    x = torch.zeros((2, t.size, t.n), dtype=torch.int64, device=dev)
    cases = {"int32": (x.to(torch.int32), TypeError),
             "not contiguous": (x.transpose(0, 1), ValueError),
             "wrong limb count": (x[:, :1].contiguous(), ValueError),
             "CPU tensor": (x.cpu(), ValueError)}
    before = dict(ntt_cuda.LAUNCHES)
    for label, (bad, exc) in cases.items():
        try:
            ntt_cuda.ntt_forward(bad, t)
        except exc:
            continue
        raise AssertionError(f"[kernels] the wrapper took a {label} input")
    if dict(ntt_cuda.LAUNCHES) != before:
        raise AssertionError("[kernels] a refused input was launched")
    log(f"[kernels] the wrapper refuses: {', '.join(cases)}")


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

    from troy_tpu_torch.ops import ntt as NTT, ntt_cuda
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.core.ciphertext import Ciphertext
    from troy_tpu_torch.parallel.batched import BatchedEvaluator

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = ntt_cuda.build()
    ntt_cuda._load()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    ctx = build_context(dev)
    cd = ctx.first_context_data()
    ev = Evaluator(ctx)
    batched = BatchedEvaluator(ev, cd)
    encoder = BatchEncoder(ctx)
    L = cd.coeff_modulus_size
    bsk = cd.rns_tool.bsk_ntt
    log(f"[setup] context n={N} L={L} |Bsk|={bsk.size} t={encoder.t.value} "
        f"in {time.perf_counter() - t0:.3f} s")

    # ---- 3. kernel vs plain ------------------------------------------------
    otab = ev._switch_tables(cd)["otab"]
    err = phase_kernels(dev, {
        "base q": ((BATCH,), cd.qtab(), False),
        "base Bsk": ((BATCH,), bsk, False),
        "keyswitch digits": ((BATCH * L,), otab, True),
        "plain modulus t": ((1,), encoder.tables, False),
        **other_degrees(dev),
    })
    phase_refusals(dev, cd.qtab())

    # ---- 4. main path ------------------------------------------------------
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
    step = batched.build_mul_relin_step(keys)

    ntt_cuda.reset_launches()
    out = step(d1, d2, keys)
    torch.cuda.synchronize()
    launches = dict(ntt_cuda.LAUNCHES)
    log(f"[main] step {tuple(d1.shape)} x {tuple(d2.shape)} -> {tuple(out.shape)}; "
        f"kernel launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError("[main] the step did not launch every NTT kernel")

    with mock.patch.object(NTT, "ntt_forward", NTT.ntt_forward_plain), \
            mock.patch.object(NTT, "ntt_inverse", NTT.ntt_inverse_plain):
        ref = step(d1, d2, keys)
    torch.cuda.synchronize()
    if dict(ntt_cuda.LAUNCHES) != launches:
        raise AssertionError("[main] the plain run launched a kernel")
    if not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise AssertionError(f"[main] kernel step != plain step at {bad} residues")
    log("[main] step output equals the plain-NTT step bit for bit")

    expected = (msgs[:BATCH].astype(object) * msgs[BATCH:]) % t_val
    for b in range(BATCH):
        got = encoder.decode(decryptor.decrypt(Ciphertext(out[b], cd.parms_id)))
        got = got.cpu().numpy()
        if got.shape != (N,) or not np.array_equal(got, expected[b].astype(np.int64)):
            raise AssertionError(f"[main] ciphertext {b} decrypts wrong")
    log(f"[main] all {BATCH} products decrypt to m1 * m2 mod t")

    # ---- 5. times ----------------------------------------------------------
    for _ in range(3):
        step(d1, d2, keys)
    state = {"cur": d1}

    def chained():
        state["cur"] = step(state["cur"], d2, keys)

    step_ms = cuda_ms(chained, REPS)
    with mock.patch.object(NTT, "ntt_forward", NTT.ntt_forward_plain), \
            mock.patch.object(NTT, "ntt_inverse", NTT.ntt_inverse_plain):
        state["cur"] = d1
        chained()
        plain_step_ms = cuda_ms(chained, max(2, REPS // 4))
    log(f"[times] {gpu}: step {step_ms:.4f} ms per batch of {BATCH} "
        f"({BATCH / step_ms * 1e3:.2f} ciphertexts/s); with the plain NTT "
        f"{plain_step_ms:.4f} ms")

    q_tab = cd.qtab()
    xq = torch.randint(0, 1 << 62, (BATCH, L, N), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2)) \
        % q_tab.q.view(-1, 1)
    times = {}
    for name, kernel, plain in (
            ("ntt_forward", ntt_cuda.ntt_forward, NTT.ntt_forward_plain),
            ("ntt_inverse", ntt_cuda.ntt_inverse, NTT.ntt_inverse_plain)):
        kernel(xq, q_tab)
        plain(xq, q_tab)
        times[name] = (cuda_ms(lambda: kernel(xq, q_tab), KERNEL_REPS),
                       cuda_ms(lambda: plain(xq, q_tab), KERNEL_REPS))
        log(f"[times] {gpu}: {name} at {tuple(xq.shape)}: kernel "
            f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms (wall time "
            f"per call, wrapper included)")

    # ---- 6. results ----------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in ("ntt_forward", "ntt_inverse")]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

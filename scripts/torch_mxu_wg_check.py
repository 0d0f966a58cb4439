#!/usr/bin/env python3
"""A short first check of the redesigned K2 kernel (csrc/ntt_mxu_wg.cu) on
one GPU: its ptxas report, the wgmma layout probe, its route against the
plain version at every degree it serves, and its time against the first
form and K1 at the flagship step's shapes.

    python3 scripts/torch_mxu_wg_check.py

  * nvcc -Xptxas -v on csrc/ntt_mxu_wg.cu (registers, spills, and whether
    ptxas serialized the wgmma pipeline), beside the library's build;
  * scripts/torch_mxu_wg_probe.cu: one m64n32k32 u8 product at K = 32 and
    64, with the kernel's descriptors (mode 0) and with LBO and SBO swapped
    (mode 1), against numpy;
  * wg_info at every degree 256 .. 16384 (registers, shared bytes, CTAs an
    SM, the plan);
  * ntt_mxu_cuda.ntt_forward / ntt_inverse (lazy input) against
    ops/ntt_mxu.py's plain version at 256 .. 16384 on 1, 3 and 7 limbs;
  * at the keyswitch digits (96, 7, 8192) and base q (16, 6, 8192), the
    kernel, the first form (mma_*) and K1 in turns (kernel, first form,
    K1, K1, first form, kernel) by chip_smoke.graph_us, beside ntt_bound.

Exits 1 if a check fails.  Builds into troy_tpu_torch/build/; imports
nothing of jax.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from troy_tpu_torch.core.modulus import Modulus  # noqa: E402
from troy_tpu_torch.ops import (_cuda_build, ntt as NTT, ntt_cuda, ntt_mxu as MX,  # noqa: E402
                                ntt_mxu_cuda)
from troy_tpu_torch.utils import numth  # noqa: E402


def layout(m: np.ndarray) -> np.ndarray:
    """(R, Kp) u8 -> the core-matrix layout (R / 8, Kp / 16, 8, 16)."""
    r, kp = m.shape
    return np.ascontiguousarray(m.reshape(r // 8, 8, kp // 16, 16).transpose(0, 2, 1, 3)).ravel()


def probe(lib, dev) -> bool:
    fn = lib.run_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    rng = np.random.default_rng(1)
    ok = True
    for kp in (32, 64):
        a = rng.integers(0, 256, (64, kp), dtype=np.uint8)
        b = rng.integers(0, 256, (32, kp), dtype=np.uint8)
        want = a.astype(np.int64) @ b.astype(np.int64).T
        for mode in (0, 1):
            ta = torch.from_numpy(layout(a)).to(dev)
            tb = torch.from_numpy(layout(b)).to(dev)
            d = torch.zeros(64 * 32, dtype=torch.int32, device=dev)
            err = fn(ta.data_ptr(), tb.data_ptr(), d.data_ptr(), mode, kp)
            bad = int((d.cpu().numpy().reshape(64, 32) != want).sum())
            print(f"[probe] Kp {kp}, mode {mode}: CUDA error {err}, {bad} of 2048 wrong",
                  flush=True)
            ok &= err == 0 and (bad == 0) == (mode == 0)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mxu_wg_check: no CUDA device", file=sys.stderr)
        return 1
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    print(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda_build._nvcc()
    so = _cuda_build.BUILD_DIR / "mxu_wg_probe.so"
    procs = {
        "ptxas": subprocess.Popen(
            [nvcc, *_cuda_build.COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(_cuda_build.BUILD_DIR / "ntt_mxu_wg.ptxas.o"), str(_cuda_build.CSRC / "ntt_mxu_wg.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "probe": subprocess.Popen(
            [nvcc, *_cuda_build.COMPILE_FLAGS, "-shared", "-o", str(so),
             str(ROOT / "scripts" / "torch_mxu_wg_probe.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    lib = _cuda_build.build()
    _cuda_build.load()
    ok = True
    for name, proc in procs.items():
        out, err = proc.communicate()
        print(f"[{name}] rc {proc.returncode}\n{out}{err}", flush=True)
        ok &= proc.returncode == 0
    print(f"[build] {lib.name}", flush=True)
    ok &= probe(ctypes.CDLL(str(so)), dev)
    for lg in range(MX.MIN_LOG_N, MX.WG_MAX_LOG_N + 1):
        for inverse in (False, True):
            print(f"[info] n = {1 << lg}, {'inverse' if inverse else 'forward'}: "
                  f"{ntt_mxu_cuda.wg_info(inverse, lg)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    for lg in range(MX.MIN_LOG_N, MX.WG_MAX_LOG_N + 1):
        n = 1 << lg
        for limbs, rows in ((1, 1), (3, 2), (7, 5)):
            t = MX.MxuNTTTables(lg, [Modulus(p) for p in numth.get_primes(2 * n, 30, limbs)], dev)
            q = MX.plain_tables(t)["q"].view(-1, 1)
            x = torch.randint(0, 1 << 62, (rows, limbs, n), generator=gen, device=dev) % (2 * q)
            f, i = ntt_mxu_cuda.ntt_forward(x, t), ntt_mxu_cuda.ntt_inverse(x, t)
            torch.cuda.synchronize()
            ef = int((f != MX.ntt_forward_mxu(x, t)).sum())
            ei = int((i != MX.ntt_inverse_mxu(x, t)).sum())
            print(f"[wg] n = {n}, L = {limbs}, {rows} rows: forward {ef}, inverse {ei} values "
                  f"differ from the plain version", flush=True)
            ok &= ef == 0 and ei == 0
    for shape in ((96, 7, 8192), (16, 6, 8192)):
        full = NTT.NTTTables(13, [Modulus(p) for p in numth.get_primes(2 << 13, 30, shape[1])],
                             dev)
        t = MX.MxuNTTTables(13, full.moduli, dev)
        x = torch.randint(0, 1 << 62, shape, generator=gen, device=dev) % full.q.view(-1, 1)
        for inverse in (False, True):
            d = "inverse" if inverse else "forward"
            wg = lambda: getattr(ntt_mxu_cuda, f"ntt_{d}")(x, t)
            first = lambda: getattr(ntt_mxu_cuda, f"mma_{d}")(x, t)
            k1 = lambda: getattr(ntt_cuda, f"ntt_{d}")(x, full)
            a1, b1, c1, c2, b2, a2 = (chip_smoke.graph_us(f) for f in (wg, first, k1, k1, first, wg))
            print(f"[time] {gpu}: {shape} {d}: kernel {a1:.2f} / {a2:.2f} us, the first form "
                  f"{b1:.2f} / {b2:.2f}, K1 {c1:.2f} / {c2:.2f} (graphs of "
                  f"{chip_smoke.GRAPH_LAUNCHES}); bound {chip_smoke.ntt_bound(shape)[0]:.2f} us",
                  flush=True)
    print(f"[done] {'every check passed' if ok else 'a check failed'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

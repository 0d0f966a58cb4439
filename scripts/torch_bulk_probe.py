#!/usr/bin/env python3
"""The rate at which one SM's shared memory fills from L2 by cp.async.bulk,
as the cluster kernel of K2 streams its table chunks
(scripts/torch_bulk_probe.cu): GB/s a CTA and over the launch, for chunk
sizes, copies a chunk, chunks in flight, CTA counts and cluster sizes, the
waits by try_wait or a test_wait spin, and cp.async 16-byte copies by every
thread (no TMA) beside them.

    python3 scripts/torch_bulk_probe.py

Builds the probe with nvcc into troy_tpu_torch/build/probe/; needs one CUDA
device; imports nothing of jax.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from troy_tpu_torch.ops import _cuda_build  # noqa: E402

SRC_BYTES = 1 << 20
ROUNDS = 256
CASES = (  # chunk bytes, copies a chunk, chunks in flight, CTAs, cluster (0: none), mode
    (16384, 1, 3, 8, 8, 0), (16384, 1, 3, 8, 8, 1), (16384, 1, 6, 8, 8, 1),
    (16384, 32, 6, 8, 8, 1), (65536, 1, 3, 8, 8, 1), (16384, 1, 6, 128, 8, 1),
    (16384, 1, 3, 8, 8, 2), (16384, 1, 6, 8, 8, 2), (16384, 1, 6, 128, 8, 2),
    (16384, 1, 6, 112, 16, 2), (32768, 1, 6, 128, 8, 2), (16384, 32, 6, 8, 8, 0))
MODES = ("bulk, try_wait", "bulk, test_wait spin", "cp.async by 128 threads")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bulk_probe: no CUDA device", file=sys.stderr)
        return 1
    gpu = chip_smoke.gpu_line()
    out = _cuda_build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "bulk_probe.so"
    subprocess.run([_cuda_build._nvcc(), *_cuda_build.COMPILE_FLAGS, "-shared", "-o",
                    str(lib_path), str(ROOT / "scripts" / "torch_bulk_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.troy_bulk_probe
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9
    fn.restype = ctypes.c_float
    src = torch.randint(0, 255, (SRC_BYTES,), dtype=torch.uint8, device="cuda")
    for chunk, copies, depth, ctas, cluster, mode in CASES:
        us = fn(src.data_ptr(), SRC_BYTES, chunk, depth, copies, ROUNDS, ctas, cluster, 4096,
                mode)
        if us < 0:
            print(f"[probe] chunk {chunk}, {copies} copies, depth {depth}, {ctas} CTAs, cluster "
                  f"{cluster}: CUDA error {-us:.0f}", flush=True)
            continue
        per = chunk * ROUNDS / us / 1e3
        print(f"[probe] {gpu}: {MODES[mode]}: chunk {chunk} B as {copies} copies, {depth} in "
              f"flight, {ctas} "
              f"CTAs, cluster {cluster or 'none'}: {us:.2f} us for {ROUNDS} chunks a CTA, "
              f"{per:.2f} GB/s a CTA, {per * ctas:.1f} GB/s in all", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build of the port's CUDA kernels: every csrc/*.cu into one library.

At first use, nvcc compiles each source under troy_tpu_torch/csrc/ for
sm_90a, all sources at once in parallel processes, and links the objects
into one shared library with a plain C interface under
troy_tpu_torch/build/, loaded with ctypes.  The library name carries a hash
of every source and header in csrc/ and of the flags, so an edited kernel or
shared header is never served by a stale build.  A failed build raises:
nothing falls back to the plain versions.

The kernel wrappers (ops/ntt_cuda.py, ops/bconv_cuda.py,
ops/fused_mul_cuda.py) take their C functions from function().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None
_functions: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("[cuda_build] nvcc not found: the CUDA toolkit is "
                           "needed to build troy_tpu_torch/csrc")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest(csrc: Path = CSRC) -> str:
    """Hash of every .cu and .cuh file in csrc (name and bytes) and of the
    compile flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def library_path() -> Path:
    return BUILD_DIR / f"troy_kernels_{digest()}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]):
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("[cuda_build] nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile and link csrc/*.cu (if not yet built); return the library."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objects.append(str(obj))
        _run(procs)
        out = Path(tmp) / lib.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *objects]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(out, lib)
    return lib


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def function(name: str, argtypes: list):
    """The C function `name` of the library, with its argument types set and
    an int (cudaError_t) result."""
    if name not in _functions:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return _functions[name]

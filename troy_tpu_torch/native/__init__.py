"""The port's host library: AES-128-CTR for the samplers' "aes" mode.

Counterpart of troy_tpu/native/__init__.py (its AES part; the u64 host NTT
oracle is not ported).  At first use the host C compiler (cc, else gcc)
builds native/aesctr.c into troy_tpu_torch/build/, named by a hash of the
source and the flags, and ctypes loads it.  A failed build raises: there is
no other AES.

    aes128_ctr_bytes(key16, counter, nbytes): nbytes of the AES-128-CTR
        keystream under key16 from the 128-bit block counter `counter`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "aesctr.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CFLAGS = ["-O2", "-std=c11", "-shared", "-fPIC"]

_lib = None


def _compiler() -> str:
    for name in ("cc", "gcc"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("[native] no C compiler (cc or gcc) to build aesctr.c")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"troy_native_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile aesctr.c (if not yet built); return the library.  Concurrent
    builds each write a temporary file and rename it into place."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        cmd = [_compiler(), *CFLAGS, "-o", str(out), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"[native] {' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(out, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.aes128_ctr_fill.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                                        ctypes.c_void_p, ctypes.c_uint64]
        lib.aes128_ctr_fill.restype = None
        _lib = lib
    return _lib


def aes128_ctr_bytes(key: bytes, counter: int, nbytes: int) -> bytes:
    """Deterministic AES-128-CTR keystream: block i is AES_key(counter + i)
    with the 128-bit counter little-endian (low word first)."""
    if len(key) != 16:
        raise ValueError("[native.aes128_ctr_bytes] key must be 16 bytes")
    out = ctypes.create_string_buffer(nbytes)
    _load().aes128_ctr_fill(key, counter & ((1 << 64) - 1), (counter >> 64) & ((1 << 64) - 1),
                            out, nbytes)
    return out.raw

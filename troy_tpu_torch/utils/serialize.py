"""Serialization: save and load of every HE object, with optional compression
(counterpart of troy_tpu/utils/serialize.py, byte for byte: bytes written by
either package load in the other).

Little-endian framing over bytes objects (ref: serialize.h,
compression*.{h,cpp}, and the objects' save/load, plaintext.h:210,
ciphertext.h:154-288, kswitch_keys.cu):

  * a frame: mode u8, then for Nil the payload length u64 and the payload,
    else the payload length u64, the compressed length u64 and the
    compressed bytes.  CompressionMode {Nil, Zstd, Zlib}: zstd from the
    system libzstd by ctypes (level 3), zlib from the standard library
    (level 6).  A compressed form that is not smaller is written raw, and so
    is a Zstd payload when libzstd is missing; reading a Zstd frame without
    libzstd raises (serialize.h:59-91 semantics);
  * an array: ndim u8, each dim u64, then the u32 data.  The port's int64
    residue tensors are written as u32 and come back on the device of the
    context (or the device) the loader is given; at a wide level (40-60-bit
    primes) each residue is its (hi, lo) u32 pair with the word axis at -3,
    the JAX package's wide layout, folded back into one int64 on load;
  * a ciphertext: parms_id (32 bytes), size u8, flags u8 (bit 0 NTT form,
    bit 1 seed, bit 3 terms), scale f64, correction factor u64, the seed
    u64 when it has one, then the data.  A seed-compressed ciphertext stores
    c0 and the seed; c1 = uniform_from_seed(seed) is regenerated on load
    (ciphertext.h:255 expand_seed; the seed keeps 64 bits on the wire, and
    the expansion reads its low 32, as the JAX package's does).  With terms=
    (save_terms, ciphertext.h:272) c0 travels as its coefficients at the
    given indices (the inverse NTT first for an NTT-form ciphertext, the
    forward NTT after loading), the other polys whole: the matmul and conv2d
    output wires.  A loaded ciphertext has no seed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import enum
import io
import struct
import zlib

import numpy as np
import torch

from ..core.plaintext import Plaintext
from ..core.ciphertext import Ciphertext
from ..core.keys import SecretKey, PublicKey, KSwitchKeys, RelinKeys, GaloisKeys
from ..core.lwe import LWECiphertext
from ..core.params import WIDE_PARMS_IDS
from ..ops import u64 as W


class CompressionMode(enum.IntEnum):
    Nil = 0
    Zstd = 1
    Zlib = 2


# -- zstd via ctypes --------------------------------------------------------
_zstd = None


def _load_zstd():
    """The system libzstd, or False where it is missing (loaded once)."""
    global _zstd
    if _zstd is not None:
        return _zstd
    try:
        lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    except OSError:
        _zstd = False
        return _zstd
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_int]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                    ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    _zstd = lib
    return _zstd


def _zstd_compress(data: bytes) -> bytes | None:
    lib = _load_zstd()
    if not lib:
        return None
    bound = lib.ZSTD_compressBound(len(data))
    buf = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(buf, bound, data, len(data), 3)
    if lib.ZSTD_isError(n):
        return None
    return buf.raw[:n]


def _zstd_decompress(data: bytes, raw_size: int) -> bytes:
    lib = _load_zstd()
    if not lib:
        raise RuntimeError("[serialize] libzstd unavailable for decompression")
    buf = ctypes.create_string_buffer(raw_size)
    n = lib.ZSTD_decompress(buf, raw_size, data, len(data))
    if lib.ZSTD_isError(n) or n != raw_size:
        raise ValueError("[serialize] zstd decompression failed")
    return buf.raw


def compress(payload: bytes, mode: CompressionMode = CompressionMode.Nil) -> bytes:
    """Frame a payload with optional compression; raw when the compressed
    form is not smaller, or there is none."""
    mode = CompressionMode(mode)
    comp = None
    if mode == CompressionMode.Zstd:
        comp = _zstd_compress(payload)
    elif mode == CompressionMode.Zlib:
        comp = zlib.compress(payload, 6)
    if comp is None or len(comp) >= len(payload):
        return struct.pack("<BQ", int(CompressionMode.Nil), len(payload)) + payload
    return struct.pack("<BQQ", int(mode), len(payload), len(comp)) + comp


def decompress(data: bytes, offset: int = 0) -> tuple[bytes, int]:
    """(payload, offset of the next frame)."""
    mode = data[offset]
    if mode == CompressionMode.Nil:
        (raw_len,) = struct.unpack_from("<Q", data, offset + 1)
        start = offset + 9
        return data[start:start + raw_len], start + raw_len
    raw_len, comp_len = struct.unpack_from("<QQ", data, offset + 1)
    start = offset + 17
    blob = data[start:start + comp_len]
    if mode == CompressionMode.Zstd:
        return _zstd_decompress(blob, raw_len), start + comp_len
    return zlib.decompress(blob), start + comp_len


def _u32(x) -> np.ndarray:
    """A residue tensor (or array) as a u32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
        raise ValueError("[serialize] values outside u32")
    return arr.astype(np.uint32)


def _wide(parms_id) -> bool:
    return parms_id in WIDE_PARMS_IDS


def _wire(x, wide: bool):
    """A residue tensor as it goes on the wire: u32 as it is, or at the wide
    width its (hi, lo) u32 pairs with the word axis at -3, hi first (the
    JAX package's layout, byte for byte)."""
    if not wide:
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.stack(W.pack64(x), axis=-3)


def _unwire(arr: np.ndarray, device, wide: bool) -> torch.Tensor:
    """The inverse of _wire, onto device as int64 residues."""
    if wide:
        arr = W.unpack64(arr[..., 0, :, :], arr[..., 1, :, :])
    return _tensor(arr, device)


def _device(where) -> torch.device:
    """A loader's target: a HeContext's device, or a device."""
    if hasattr(where, "key_context_data"):
        return where.key_context_data().device
    return torch.device(where)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.int64)).to(device)


# -- low-level writers ------------------------------------------------------

class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def u8(self, v):  self.buf.write(struct.pack("<B", v))
    def u32(self, v): self.buf.write(struct.pack("<I", v))
    def u64(self, v): self.buf.write(struct.pack("<Q", v))
    def f64(self, v): self.buf.write(struct.pack("<d", v))
    def raw(self, b): self.buf.write(b)

    def hexid(self, s: str):
        self.buf.write(bytes.fromhex(s))

    def array_u32(self, a):
        arr = _u32(a)
        self.u8(arr.ndim)
        for d in arr.shape:
            self.u64(d)
        self.raw(arr.astype("<u4").tobytes())

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += size
        return v

    def u8(self):  return self._unpack("<B", 1)
    def u32(self): return self._unpack("<I", 4)
    def u64(self): return self._unpack("<Q", 8)
    def f64(self): return self._unpack("<d", 8)

    def hexid(self) -> str:
        v = self.data[self.off:self.off + 32].hex()
        self.off += 32
        return v

    def array_u32(self) -> np.ndarray:
        ndim = self.u8()
        shape = tuple(self.u64() for _ in range(ndim))
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(self.data, dtype="<u4", count=count,
                            offset=self.off).reshape(shape)
        self.off += count * 4
        return arr.copy()


# -- Plaintext --------------------------------------------------------------

def save_plaintext(pt: Plaintext, mode: CompressionMode = CompressionMode.Nil) -> bytes:
    w = Writer()
    w.hexid(pt.parms_id)
    w.u8(int(pt.is_ntt_form))
    w.f64(pt.scale)
    w.u64(pt.coeff_count)
    w.array_u32(_wire(pt.data, _wide(pt.parms_id)))
    return compress(w.getvalue(), mode)


def load_plaintext(data: bytes, device) -> Plaintext:
    """device: a HeContext or a device."""
    r = Reader(decompress(data)[0])
    parms_id = r.hexid()
    ntt = bool(r.u8())
    scale = r.f64()
    cc = r.u64()
    return Plaintext(_unwire(r.array_u32(), _device(device), _wide(parms_id)), parms_id,
                     ntt, scale, cc)


# -- Ciphertext -------------------------------------------------------------

def save_ciphertext(ct: Ciphertext, context=None,
                    mode: CompressionMode = CompressionMode.Nil,
                    terms: list[int] | None = None) -> bytes:
    w = Writer()
    w.hexid(ct.parms_id)
    w.u8(ct.size)
    flags = (int(ct.is_ntt_form) | (int(ct.seed is not None) << 1)
             | (int(terms is not None) << 3))
    w.u8(flags)
    w.f64(ct.scale)
    w.u64(ct.correction_factor)
    if ct.seed is not None:
        if ct.size != 2:
            raise ValueError("[save_ciphertext] seeded ciphertext must be size 2")
        w.u64(ct.seed)
    wide = _wide(ct.parms_id)
    if terms is None:
        w.array_u32(_wire(ct.data[0] if ct.seed is not None else ct.data, wide))
    else:
        if context is None:
            raise ValueError("[save_ciphertext] save_terms requires context")
        from ..ops import rp as R

        c0 = ct.data[0]
        if ct.is_ntt_form:
            c0 = R.ntt_inverse(c0.contiguous(), context.get_context_data(ct.parms_id).qtab())
        w.u64(len(terms))
        for t in terms:
            w.u64(t)
        idx = torch.tensor(terms, dtype=torch.int64, device=c0.device)
        w.array_u32(_wire(c0.index_select(-1, idx), wide))
        w.array_u32(_wire(ct.data[2 if ct.seed is not None else 1:], wide))
    return compress(w.getvalue(), mode)


def load_ciphertext(data: bytes, context) -> Ciphertext:
    """The ciphertext on the context's device; a seeded one gets its c1 back
    from the seed (on the device), and the result has no seed."""
    from ..ops import rp as R
    from .random import uniform_from_seed

    r = Reader(decompress(data)[0])
    parms_id = r.hexid()
    r.u8()  # size: the data's own shape says it
    flags = r.u8()
    ntt, has_seed, has_terms = bool(flags & 1), bool(flags & 2), bool(flags & 8)
    scale = r.f64()
    cf = r.u64()
    cd = context.get_context_data(parms_id)
    n, L, dev = cd.parms.poly_modulus_degree, cd.coeff_modulus_size, cd.device
    seed = r.u64() if has_seed else None

    def expand_c1():
        a_ntt = uniform_from_seed(seed, (L, n), cd.qtab())
        return a_ntt if ntt else R.ntt_inverse(a_ntt, cd.qtab())

    wide = _wide(parms_id)
    if not has_terms:
        arr = _unwire(r.array_u32(), dev, wide)
        dat = torch.stack([arr, expand_c1()]) if has_seed else arr
    else:
        terms = [r.u64() for _ in range(r.u64())]
        c0 = np.zeros((L, n), dtype=np.int64)
        c0[:, terms] = _unwire(r.array_u32(), "cpu", wide).numpy()
        c0 = torch.from_numpy(c0).to(dev)
        if ntt:
            c0 = R.ntt_forward(c0, cd.qtab())
        polys = [c0] + ([expand_c1()] if has_seed else [])
        polys += list(_unwire(r.array_u32(), dev, wide).unbind(0))
        dat = torch.stack(polys)
    return Ciphertext(dat, parms_id, ntt, scale, cf)


# -- keys -------------------------------------------------------------------

def save_secret_key(sk: SecretKey, mode=CompressionMode.Nil) -> bytes:
    w = Writer()
    w.hexid(sk.parms_id)
    w.array_u32(_wire(sk.data, _wide(sk.parms_id)))
    return compress(w.getvalue(), mode)


def load_secret_key(data: bytes, device) -> SecretKey:
    r = Reader(decompress(data)[0])
    pid = r.hexid()
    return SecretKey(_unwire(r.array_u32(), _device(device), _wide(pid)), pid)


def save_public_key(pk: PublicKey, context=None, mode=CompressionMode.Nil) -> bytes:
    return save_ciphertext(pk.ciphertext, context, mode)


def load_public_key(data: bytes, context) -> PublicKey:
    return PublicKey(load_ciphertext(data, context))


def save_kswitch_keys(keys: KSwitchKeys, mode=CompressionMode.Nil) -> bytes:
    w = Writer()
    w.hexid(keys.parms_id)
    w.u64(len(keys.keys))
    for idx, arr in sorted(keys.keys.items()):
        w.u64(idx)
        w.array_u32(_wire(arr, _wide(keys.parms_id)))
    return compress(w.getvalue(), mode)


def _load_ksk_dict(data: bytes, device):
    r = Reader(decompress(data)[0])
    pid = r.hexid()
    dev = _device(device)
    keys = {}
    for _ in range(r.u64()):
        idx = r.u64()
        keys[idx] = _unwire(r.array_u32(), dev, _wide(pid))
    return keys, pid


def load_kswitch_keys(data: bytes, device) -> KSwitchKeys:
    return KSwitchKeys(*_load_ksk_dict(data, device))


def load_relin_keys(data: bytes, device) -> RelinKeys:
    return RelinKeys(*_load_ksk_dict(data, device))


def load_galois_keys(data: bytes, device) -> GaloisKeys:
    return GaloisKeys(*_load_ksk_dict(data, device))


# -- size upper bounds (ref: serialized_size_upperbound on every object) ----

_FRAME_OVERHEAD = 17  # compression frame header worst case


def _nbytes(x, wide: bool = False) -> int:
    """Bytes of x as u32 on the wire (two words a residue at the wide width)."""
    return 4 * (1 + wide) * x.numel()


def _header(x, wide: bool = False) -> int:
    """An array's ndim byte and u64 dims on the wire."""
    return 1 + 8 * (x.dim() + wide)


def plaintext_size_upperbound(pt: Plaintext) -> int:
    w = _wide(pt.parms_id)
    return 32 + 1 + 8 + 8 + _header(pt.data, w) + _nbytes(pt.data, w) + _FRAME_OVERHEAD


def ciphertext_size_upperbound(ct: Ciphertext) -> int:
    w = _wide(ct.parms_id)
    polys = 1 if ct.seed is not None else ct.size
    data = polys * (_nbytes(ct.data, w) // ct.size)
    seed = 8 if ct.seed is not None else 0
    return 32 + 2 + 8 + 8 + seed + _header(ct.data, w) + data + _FRAME_OVERHEAD


def kswitch_keys_size_upperbound(keys: KSwitchKeys) -> int:
    w = _wide(keys.parms_id)
    return 32 + 8 + _FRAME_OVERHEAD + sum(8 + (1 + 8 * (4 + w)) + _nbytes(arr, w)
                                          for arr in keys.keys.values())


# -- LWE --------------------------------------------------------------------

def save_lwe(lwe: LWECiphertext, mode=CompressionMode.Nil) -> bytes:
    w = Writer()
    w.hexid(lwe.parms_id)
    w.f64(lwe.scale)
    w.u64(lwe.correction_factor)
    w.array_u32(lwe.c0)
    w.array_u32(lwe.c1)
    return compress(w.getvalue(), mode)


def load_lwe(data: bytes, device) -> LWECiphertext:
    r = Reader(decompress(data)[0])
    pid = r.hexid()
    scale = r.f64()
    cf = r.u64()
    dev = _device(device)
    c0 = _tensor(r.array_u32(), dev)
    c1 = _tensor(r.array_u32(), dev)
    return LWECiphertext(c0, c1, pid, scale, cf)


# -- EncryptionParameters (ref: serialize.cu EncryptionParameters cases) ----

def save_parms(parms, mode=CompressionMode.Nil) -> bytes:
    """scheme, n, the coefficient moduli (u64), the plain modulus and the
    special-prime flag (ref: encryption_parameters.h save)."""
    w = Writer()
    w.u8(int(parms.scheme.value))
    w.u64(parms.poly_modulus_degree)
    w.u64(len(parms.coeff_modulus))
    for m in parms.coeff_modulus:
        w.u64(m.value)
    w.u64(parms.plain_modulus.value)
    w.u8(int(parms.use_special_prime_for_encryption))
    return compress(w.getvalue(), mode)


def load_parms(data: bytes):
    from ..core.params import EncryptionParameters, SchemeType

    r = Reader(decompress(data)[0])
    parms = EncryptionParameters(SchemeType(r.u8()))
    parms.set_poly_modulus_degree(r.u64())
    parms.set_coeff_modulus([r.u64() for _ in range(r.u64())])
    t = r.u64()
    if t:
        parms.set_plain_modulus(t)
    parms.use_special_prime_for_encryption = bool(r.u8())
    return parms


def parms_size_upperbound(parms) -> int:
    return 1 + 8 + 8 + 8 * len(parms.coeff_modulus) + 8 + 1 + _FRAME_OVERHEAD


def secret_key_size_upperbound(sk: SecretKey) -> int:
    w = _wide(sk.parms_id)
    return 32 + _header(sk.data, w) + _nbytes(sk.data, w) + _FRAME_OVERHEAD


def public_key_size_upperbound(pk: PublicKey) -> int:
    return ciphertext_size_upperbound(pk.ciphertext)


def lwe_size_upperbound(lwe: LWECiphertext) -> int:
    return (32 + 8 + 8 + (1 + 8 * lwe.c0.dim()) + _nbytes(lwe.c0)
            + (1 + 8 * lwe.c1.dim()) + _nbytes(lwe.c1) + _FRAME_OVERHEAD)

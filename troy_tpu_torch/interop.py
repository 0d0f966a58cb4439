"""Carry state between the JAX package and the port.

The JAX package holds residues as u32 arrays; the port as int64 tensors.
These helpers take numpy arrays (np.asarray of a jax array) and return the
port's objects on a device, and back.  Layouts are the same on both sides:
ciphertexts (..., size, L, n), plaintexts (1, n) mod t or (L, n) in RNS,
switching keys (decomp, 2, L_key, n), the secret key (L_key, n) and the
public key (2, L_key, n) in NTT form, an LWE sample's c0 (L,) and c1 (L, n).
A CKKS plaintext, ciphertext or LWE sample carries its scale across, a BGV
one its correction factor; to_numpy takes each tensor back.  No jax import is needed here.

At the wide width (a level of 40-60-bit primes, params.WIDE_PARMS_IDS) the
JAX package holds each residue as a (hi, lo) u32 pair with the word axis at
-3 (hi first): ciphertexts (size, 2, L, n), RNS plaintexts and the secret
key (2, L, n), switching keys (decomp, 2, 2, L_key, n).  The port holds one
int64 word in the fast path's layout, so the word axis folds away on the
way in and comes back on the way out; an array whose shape does not match
its level's width is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.ciphertext import Ciphertext
from .core.plaintext import Plaintext
from .core.lwe import LWECiphertext
from .core.keys import SecretKey, PublicKey, RelinKeys, GaloisKeys
from .core.params import ParmsID, WIDE_PARMS_IDS
from .ops import u64 as W


def wide(parms_id: ParmsID) -> bool:
    """True for a wide-path level."""
    return parms_id in WIDE_PARMS_IDS


def to_tensor(arr, device, wide: bool = False) -> torch.Tensor:
    """u32 residues (numpy, any shape) -> int64 tensor on device; wide: the
    (..., 2, L, n) (hi, lo) pairs -> (..., L, n) words."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32:
        raise TypeError(f"[interop] expected uint32 residues, got {arr.dtype}")
    if wide:
        if arr.ndim < 3 or arr.shape[-3] != 2:
            raise ValueError(f"[interop] a wide array has its (hi, lo) word axis at -3; "
                             f"got shape {arr.shape}")
        arr = W.unpack64(arr[..., 0, :, :], arr[..., 1, :, :])
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def to_numpy(x: torch.Tensor, wide: bool = False) -> np.ndarray:
    """int64 residue tensor -> u32 numpy array (values must be in [0, 2^32));
    wide: (..., L, n) words below 2^61 -> (..., 2, L, n) (hi, lo) pairs."""
    a = x.detach().cpu().numpy()
    if wide:
        if a.size and (a.min() < 0 or a.max() >= (1 << 61)):
            raise ValueError("[interop] tensor holds values outside the wide range")
        return np.stack(W.pack64(a), axis=-3)
    if a.size and (a.min() < 0 or a.max() >= (1 << 32)):
        raise ValueError("[interop] tensor holds values outside u32")
    return a.astype(np.uint32)


def _level_tensor(data, parms_id: ParmsID, device, ndim: int) -> torch.Tensor:
    """An object's array at its level's width: ndim axes at the fast width,
    ndim + 1 (the word axis) at the wide width."""
    w = wide(parms_id)
    data = np.asarray(data)
    if data.ndim != ndim + w:
        raise ValueError(f"[interop] shape {data.shape} does not match a "
                         f"{'wide' if w else 'fast-path'} level")
    return to_tensor(data, device, w)


def ciphertext(data, parms_id: ParmsID, device, is_ntt_form: bool = False,
               scale: float = 1.0, correction_factor: int = 1) -> Ciphertext:
    """data: one (size, L, n) ciphertext, (size, 2, L, n) at a wide level."""
    return Ciphertext(_level_tensor(data, parms_id, device, 3), parms_id, is_ntt_form,
                      scale, correction_factor)


def plaintext(data, parms_id: ParmsID, device, is_ntt_form: bool = False,
              scale: float = 1.0) -> Plaintext:
    """data: (1, n) mod t, or (L, n) in RNS ((2, L, n) at a wide level)."""
    return Plaintext(_level_tensor(data, parms_id, device, 2), parms_id, is_ntt_form,
                     scale)


def secret_key(data, parms_id: ParmsID, device) -> SecretKey:
    return SecretKey(_level_tensor(data, parms_id, device, 2), parms_id)


def relin_keys(keys: dict, parms_id: ParmsID, device) -> RelinKeys:
    """keys: {index: (decomp, 2, L_key, n) u32 array}, as in the JAX
    package's RelinKeys.keys."""
    return RelinKeys({k: _level_tensor(v, parms_id, device, 4) for k, v in keys.items()},
                     parms_id)


def public_key(data, parms_id: ParmsID, device) -> PublicKey:
    """data: the (2, L_key, n) u32 NTT-form array of the JAX package's
    PublicKey.data()."""
    return PublicKey(Ciphertext(_level_tensor(data, parms_id, device, 3), parms_id,
                                is_ntt_form=True))


def galois_keys(keys: dict, parms_id: ParmsID, device) -> GaloisKeys:
    """keys: {galois element: (decomp, 2, L_key, n) u32 array}, as in the
    JAX package's GaloisKeys.keys."""
    return GaloisKeys({g: _level_tensor(v, parms_id, device, 4) for g, v in keys.items()},
                      parms_id)


def lwe_ciphertext(c0, c1, parms_id: ParmsID, device, scale: float = 1.0,
                   correction_factor: int = 1) -> LWECiphertext:
    """c0: (L,) and c1: (L, n) u32 arrays, as in the JAX package's
    LWECiphertext."""
    return LWECiphertext(to_tensor(c0, device), to_tensor(c1, device), parms_id, scale,
                         correction_factor)

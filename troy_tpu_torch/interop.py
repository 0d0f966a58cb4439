"""Carry state between the JAX package and the port.

The JAX package holds residues as u32 arrays; the port as int64 tensors.
These helpers take numpy arrays (np.asarray of a jax array) and return the
port's objects on a device, and back.  Layouts are the same on both sides:
ciphertexts (..., size, L, n), plaintexts (1, n) mod t or (L, n) in RNS,
switching keys (decomp, 2, L_key, n), the secret key (L_key, n) and the
public key (2, L_key, n) in NTT form, an LWE sample's c0 (L,) and c1 (L, n).
A CKKS plaintext, ciphertext or LWE sample carries its scale across, a BGV
one its correction factor; to_numpy takes each tensor back.  No jax import is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.ciphertext import Ciphertext
from .core.plaintext import Plaintext
from .core.lwe import LWECiphertext
from .core.keys import SecretKey, PublicKey, RelinKeys, GaloisKeys
from .core.params import ParmsID


def to_tensor(arr, device) -> torch.Tensor:
    """u32 residues (numpy, any shape) -> int64 tensor on device."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32:
        raise TypeError(f"[interop] expected uint32 residues, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 residue tensor -> u32 numpy array (values must be in [0, 2^32))."""
    a = x.detach().cpu().numpy()
    if a.size and (a.min() < 0 or a.max() >= (1 << 32)):
        raise ValueError("[interop] tensor holds values outside u32")
    return a.astype(np.uint32)


def ciphertext(data, parms_id: ParmsID, device, is_ntt_form: bool = False,
               scale: float = 1.0, correction_factor: int = 1) -> Ciphertext:
    return Ciphertext(to_tensor(data, device), parms_id, is_ntt_form, scale,
                      correction_factor)


def plaintext(data, parms_id: ParmsID, device, is_ntt_form: bool = False,
              scale: float = 1.0) -> Plaintext:
    return Plaintext(to_tensor(data, device), parms_id, is_ntt_form, scale)


def secret_key(data, parms_id: ParmsID, device) -> SecretKey:
    return SecretKey(to_tensor(data, device), parms_id)


def relin_keys(keys: dict, parms_id: ParmsID, device) -> RelinKeys:
    """keys: {index: (decomp, 2, L_key, n) u32 array}, as in the JAX
    package's RelinKeys.keys."""
    return RelinKeys({k: to_tensor(v, device) for k, v in keys.items()}, parms_id)


def public_key(data, parms_id: ParmsID, device) -> PublicKey:
    """data: the (2, L_key, n) u32 NTT-form array of the JAX package's
    PublicKey.data()."""
    return PublicKey(Ciphertext(to_tensor(data, device), parms_id, is_ntt_form=True))


def galois_keys(keys: dict, parms_id: ParmsID, device) -> GaloisKeys:
    """keys: {galois element: (decomp, 2, L_key, n) u32 array}, as in the
    JAX package's GaloisKeys.keys."""
    return GaloisKeys({g: to_tensor(v, device) for g, v in keys.items()}, parms_id)


def lwe_ciphertext(c0, c1, parms_id: ParmsID, device, scale: float = 1.0,
                   correction_factor: int = 1) -> LWECiphertext:
    """c0: (L,) and c1: (L, n) u32 arrays, as in the JAX package's
    LWECiphertext."""
    return LWECiphertext(to_tensor(c0, device), to_tensor(c1, device), parms_id, scale,
                         correction_factor)

"""Encryption parameters and parameter identifiers.

Copy of troy_tpu/core/params.py, so that the PyTorch port imports nothing of
the JAX package.  TPU-native rebuild of reference src/encryption_parameters.{h,cu} +
src/utils/hash.h (blake2b ParmsID).  A ParmsID is the hex digest of a
blake2b-256 hash over (scheme, n, coeff moduli, plain modulus), so identical
parameters at any chain level share an id exactly like the reference — and we
reuse it as the compiled-kernel cache key (XLA analog of the reference's
per-level precomputed tables).
"""

from __future__ import annotations

import enum
import hashlib
import struct

from .modulus import Modulus


class SchemeType(enum.IntEnum):
    """ref: encryption_parameters.h:7"""

    Nil = 0
    BFV = 1
    CKKS = 2
    BGV = 3


ParmsID = str  # 64-char hex digest

PARMS_ID_ZERO: ParmsID = "0" * 64

# parms_ids of wide-path levels (core/context.py adds each wide level it
# builds).  A parms_id hashes the moduli, so it fixes the width: the port's
# objects hold one layout for both widths and read their width here.
WIDE_PARMS_IDS: set = set()


class EncryptionParameters:
    """ref: encryption_parameters.h:315"""

    def __init__(self, scheme: SchemeType | str):
        if isinstance(scheme, str):
            scheme = SchemeType[scheme.upper()] if scheme.lower() != "nil" else SchemeType.Nil
        self.scheme = SchemeType(scheme)
        self._poly_modulus_degree = 0
        self._coeff_modulus: list[Modulus] = []
        self._plain_modulus = Modulus(0)
        self.use_special_prime_for_encryption = False

    # -- setters mirroring the reference API --------------------------------
    def set_poly_modulus_degree(self, degree: int):
        if degree & (degree - 1) or degree < 2:
            raise ValueError("[EncryptionParameters] degree must be a power of 2")
        self._poly_modulus_degree = degree
        return self

    def set_coeff_modulus(self, moduli: list[Modulus]):
        self._coeff_modulus = [
            m if isinstance(m, Modulus) else Modulus(m) for m in moduli
        ]
        return self

    def set_plain_modulus(self, t: Modulus | int):
        if self.scheme == SchemeType.CKKS and (t if isinstance(t, int) else t.value):
            raise ValueError("[EncryptionParameters] CKKS has no plain modulus")
        self._plain_modulus = t if isinstance(t, Modulus) else Modulus(t)
        return self

    def set_use_special_prime_for_encryption(self, flag: bool):
        self.use_special_prime_for_encryption = flag
        return self

    # -- getters -------------------------------------------------------------
    @property
    def poly_modulus_degree(self) -> int:
        return self._poly_modulus_degree

    @property
    def coeff_modulus(self) -> list[Modulus]:
        return self._coeff_modulus

    @property
    def plain_modulus(self) -> Modulus:
        return self._plain_modulus

    @property
    def parms_id(self) -> ParmsID:
        """blake2b over the canonical parameter words
        (ref: encryption_parameters.cu:8, hash.h:13-33)."""
        h = hashlib.blake2b(digest_size=32)
        h.update(struct.pack("<QQ", int(self.scheme), self._poly_modulus_degree))
        for m in self._coeff_modulus:
            h.update(struct.pack("<Q", m.value))
        h.update(struct.pack("<Q", self._plain_modulus.value))
        return h.hexdigest()

    def clone(self) -> "EncryptionParameters":
        p = EncryptionParameters(self.scheme)
        p._poly_modulus_degree = self._poly_modulus_degree
        p._coeff_modulus = list(self._coeff_modulus)
        p._plain_modulus = self._plain_modulus
        p.use_special_prime_for_encryption = self.use_special_prime_for_encryption
        return p

    def __repr__(self):
        return (
            f"EncryptionParameters(scheme={self.scheme.name}, "
            f"n={self._poly_modulus_degree}, "
            f"log_q={[m.bit_count for m in self._coeff_modulus]}, "
            f"t={self._plain_modulus.value})"
        )

"""Encoder adapters (counterpart of troy_tpu/app/encoder_adapter.py): one
polynomial-encoding interface over the BatchEncoder (uint64 mod t), the
CKKSEncoder (float64) and the ring2k encoder (Z_2^k), used by the matmul and
conv2d helpers.

The evaluator lifts mod-t plaintexts itself, so both BFV encodings are the
raw coefficient encoding.  The CKKS adapter uses the host encoder's
encode_float64_polynomial / decode_float64_polynomial.  The ring2k adapter
encodes a ciphertext operand by scale_up and a plaintext operand by
centralize (both RNS-form plaintexts at a level), and decrypts by the
{t, gamma} scale_down of the raw phase.
"""

from __future__ import annotations

import numpy as np

from ..core.batch_encoder import BatchEncoder
from ..core.ckks_encoder import CKKSEncoder
from ..core.decryptor import Decryptor
from ..core.plaintext import Plaintext


class BatchEncoderAdapter:
    """uint64 values mod t (ref: encoder_adapter.h BatchEncoderAdapter)."""

    def __init__(self, encoder: BatchEncoder):
        self.encoder = encoder
        self.slot_count = encoder.slot_count

    def encode_for_cipher(self, vec) -> Plaintext:
        return self.encoder.encode_polynomial(vec)

    def encode_for_plain(self, vec) -> Plaintext:
        return self.encoder.encode_polynomial(vec)

    def decrypt_outputs(self, decryptor: Decryptor, ct) -> np.ndarray:
        return self.encoder.decode_polynomial(decryptor.decrypt(ct))


class CKKSEncoderAdapter:
    """float64 values, one per coefficient (ref: encoder_adapter.h
    CKKSEncoderAdapter)."""

    def __init__(self, encoder: CKKSEncoder, scale: float, parms_id=None):
        self.encoder = encoder
        self.scale = scale
        self.parms_id = parms_id
        self.slot_count = encoder.n

    def encode_for_cipher(self, vec) -> Plaintext:
        return self.encoder.encode_float64_polynomial(vec, self.parms_id, self.scale)

    def encode_for_plain(self, vec) -> Plaintext:
        return self.encoder.encode_float64_polynomial(vec, self.parms_id, self.scale)

    def decrypt_outputs(self, decryptor: Decryptor, ct) -> np.ndarray:
        return self.encoder.decode_float64_polynomial(decryptor.decrypt(ct))


class Ring2kEncoderAdapter:
    """Values mod 2^k (ref: encoder_adapter.h PolynomialEncoderRing2kAdapter);
    see app/ring2k.py."""

    def __init__(self, encoder, parms_id=None):
        self.encoder = encoder
        self.parms_id = parms_id
        self.slot_count = encoder.n

    def encode_for_cipher(self, vec) -> Plaintext:
        return self.encoder.scale_up(vec, self.parms_id)

    def encode_for_plain(self, vec) -> Plaintext:
        return self.encoder.centralize(vec, self.parms_id)

    def decrypt_outputs(self, decryptor: Decryptor, ct) -> np.ndarray:
        return self.encoder.decrypt_scale_down(decryptor, ct)

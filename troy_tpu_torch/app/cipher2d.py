"""Plain2d and Cipher2d: matrices of plaintext and ciphertext blocks
(counterpart of troy_tpu/app/cipher2d.py), the containers of the matmul and
conv2d helpers, with their elementwise homomorphic operations.
encrypt_symmetric(save_seed=True) gives seed-compressed ciphertexts, which
serialize as (c0, seed) (utils/serialize.py).
"""

from __future__ import annotations

from ..core.plaintext import Plaintext
from ..core.ciphertext import Ciphertext
from ..core.encryptor import Encryptor
from ..core.evaluator import Evaluator


class Plain2d:
    def __init__(self, data: list[list[Plaintext]] | None = None):
        self.data: list[list[Plaintext]] = data or []

    def size(self) -> int:
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def encrypt_asymmetric(self, encryptor: Encryptor) -> "Cipher2d":
        return Cipher2d([[encryptor.encrypt_asymmetric(p) for p in row] for row in self.data])

    def encrypt_symmetric(self, encryptor: Encryptor, save_seed: bool = False) -> "Cipher2d":
        return Cipher2d([[encryptor.encrypt_symmetric(p, save_seed=save_seed) for p in row]
                         for row in self.data])


class Cipher2d:
    def __init__(self, data: list[list[Ciphertext]] | None = None):
        self.data: list[list[Ciphertext]] = data or []

    def size(self) -> int:
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]

    def add(self, other: "Cipher2d", evaluator: Evaluator) -> "Cipher2d":
        return Cipher2d([[evaluator.add(a, b) for a, b in zip(r1, r2)]
                         for r1, r2 in zip(self.data, other.data)])

    def add_plain(self, other: Plain2d, evaluator: Evaluator) -> "Cipher2d":
        return Cipher2d([[evaluator.add_plain(a, b) for a, b in zip(r1, r2)]
                         for r1, r2 in zip(self.data, other.data)])

    def mod_switch_to_next(self, evaluator: Evaluator) -> "Cipher2d":
        return Cipher2d([[evaluator.mod_switch_to_next(c) for c in row] for row in self.data])

"""troy_tpu_torch — the PyTorch/CUDA port of troy_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths and names:
troy_tpu_torch/core/evaluator.py is the counterpart of
troy_tpu/core/evaluator.py, and so on, and the package's top-level names are
the JAX package's (`from troy_tpu_torch import HeContext, ...`).  Residues
are int64 tensors at every public function, on the context's device
(HeContext.create(..., device=): the CUDA card by default); randomness comes
from a utils.random.RandomGenerator stream (threefry by default, as the JAX
package's; AES-CTR on request) or an explicit torch.Generator.

It holds BFV, CKKS and BGV (keys, encryption, the whole evaluator with its
batched steps, LWE packing), their encoders, the app layer (the BumbleBee
matmul, the Cheetah conv2d and the ring2k encoder over Z_2^k, k <= 128),
serialization and the device-batched client, at both residue widths: the
fast path's 29/30-bit primes and the wide path's 40-60-bit primes, one int64
word a residue either way (ops/rp.py dispatches on the tables' width).  The
fast path's NTT, base conversion and fused tensor product run as
hand-written CUDA kernels (csrc/) on CUDA tensors and as plain PyTorch
versions on CPU tensors; the wide path is int64 PyTorch on both.  It imports
torch and never jax.
"""

__version__ = "0.1.0"

# Lazy public API (PEP 562), the JAX package's names: each resolves to the
# port's own object on first attribute access.
_API = {
    "Modulus": "core.modulus",
    "CoeffModulus": "core.coeff_modulus",
    "PlainModulus": "core.coeff_modulus",
    "SecurityLevel": "core.coeff_modulus",
    "EncryptionParameters": "core.params",
    "SchemeType": "core.params",
    "HeContext": "core.context",
    "ContextData": "core.context",
    "EncryptionParameterQualifiers": "core.context",
    "Plaintext": "core.plaintext",
    "Ciphertext": "core.ciphertext",
    "SecretKey": "core.keys",
    "PublicKey": "core.keys",
    "KSwitchKeys": "core.keys",
    "RelinKeys": "core.keys",
    "GaloisKeys": "core.keys",
    "BatchEncoder": "core.batch_encoder",
    "CKKSEncoder": "core.ckks_encoder",
    "KeyGenerator": "core.keygen",
    "Encryptor": "core.encryptor",
    "Decryptor": "core.decryptor",
    "Evaluator": "core.evaluator",
    "LWECiphertext": "core.lwe",
    "PolynomialEncoderRing2k": "app.ring2k",
    "MatmulHelper": "app.matmul",
    "MatmulObjective": "app.matmul",
    "Conv2dHelper": "app.conv2d",
    "Plain2d": "app.cipher2d",
    "Cipher2d": "app.cipher2d",
    "BatchedEvaluator": "parallel.batched",
    "BatchEncoderAdapter": "app.encoder_adapter",
    "CKKSEncoderAdapter": "app.encoder_adapter",
    "Ring2kEncoderAdapter": "app.encoder_adapter",
}


def __getattr__(name):
    if name in _API:
        import importlib

        mod = importlib.import_module("." + _API[name], __name__)
        value = getattr(mod, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'troy_tpu_torch' has no attribute {name!r}")


__all__ = [
    "Modulus", "CoeffModulus", "PlainModulus", "SecurityLevel",
    "EncryptionParameters", "SchemeType", "HeContext", "ContextData",
    "EncryptionParameterQualifiers",
    "Plaintext", "Ciphertext", "SecretKey", "PublicKey", "KSwitchKeys",
    "RelinKeys", "GaloisKeys", "BatchEncoder", "CKKSEncoder", "KeyGenerator",
    "Encryptor", "Decryptor", "Evaluator", "LWECiphertext",
    "PolynomialEncoderRing2k", "MatmulHelper", "MatmulObjective",
    "Conv2dHelper", "Plain2d", "Cipher2d", "BatchedEvaluator",
    "BatchEncoderAdapter", "CKKSEncoderAdapter", "Ring2kEncoderAdapter",
]

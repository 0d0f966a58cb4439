"""troy_tpu_torch — the PyTorch/CUDA port of troy_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths and names:
troy_tpu_torch/core/evaluator.py is the counterpart of
troy_tpu/core/evaluator.py, and so on.  Residues are int64 tensors at every
public function, on an explicit device; randomness comes from a
utils.random.RandomGenerator stream (threefry by default, as the JAX
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

"""troy_tpu_torch — the PyTorch/CUDA port of troy_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths and names:
troy_tpu_torch/core/evaluator.py is the counterpart of
troy_tpu/core/evaluator.py, and so on.  Residues are int64 tensors at every
public function, on an explicit device; randomness comes from explicit
torch.Generators.  The NTT runs as a hand-written CUDA kernel pair
(csrc/ntt.cu) on CUDA tensors and as a plain PyTorch version on CPU tensors.

The port covers the BFV multiply + relinearize path and the client side
around it (keygen, encode, encrypt, decrypt, decode) at the u32 fast width.
It imports torch and never jax.
"""

__version__ = "0.1.0"

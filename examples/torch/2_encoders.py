"""Encoders tour: batch (SIMD), polynomial, CKKS (mirrors examples/2_encoders.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, BatchEncoder, CKKSEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel

n = 4096

# --- BatchEncoder: SIMD slots over a prime t ≡ 1 mod 2n -------------------
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
ctx = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
be = BatchEncoder(ctx)
v = np.arange(be.slot_count, dtype=np.uint64)
assert (be.decode(be.encode(v)) == v).all()
print("BatchEncoder SIMD roundtrip OK; slots =", be.slot_count)

# raw polynomial coefficients (no SIMD)
coeffs = np.array([1, 2, 3, 4], dtype=np.uint64)
pt = be.encode_polynomial(coeffs)
assert (be.decode_polynomial(pt)[:4] == coeffs).all()
print("polynomial encoding OK")

# --- CKKSEncoder: complex slots with a scale ------------------------------
cparms = EncryptionParameters(SchemeType.CKKS)
cparms.set_poly_modulus_degree(n)
cparms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30]))
cctx = HeContext.create(cparms, True, SecurityLevel.Nil, device=DEVICE)
ce = CKKSEncoder(cctx)
z = np.exp(1j * np.linspace(0, np.pi, ce.slot_count))
back = ce.decode(ce.encode(z, scale=2.0 ** 30))
print("CKKS roundtrip max err:", float(np.abs(back - z).max()))
assert np.abs(back - z).max() < 1e-5

# --- device encode: double-float FFT fully on the accelerator -------------
# (ops/ddfft.py; valid while scale * max|value| < 2^46 — host f64 otherwise)
pt_dev = ce.encode_device(z, scale=2.0 ** 30)
back_dev = ce.decode(pt_dev)
print("CKKS device-encode roundtrip max err:", float(np.abs(back_dev - z).max()))
assert np.abs(back_dev - z).max() < 1e-5

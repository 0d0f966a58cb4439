"""LWE extraction & packing (mirrors examples/12_lwes.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel

n = 1024
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)
auto_keys = keygen.create_automorphism_keys()

rng = np.random.default_rng(1)
coeffs = rng.integers(0, parms.plain_modulus.value, n, dtype=np.uint64)
ct = encryptor.encrypt_asymmetric(encoder.encode_polynomial(coeffs))

# extract 8 coefficients as LWE samples, pack them back into one RLWE ct
lwes = [evaluator.extract_lwe(ct, 10 * i) for i in range(8)]
packed = evaluator.pack_lwe_ciphertexts(lwes, auto_keys)
dec = encoder.decode_polynomial(decryptor.decrypt(packed))
stride = n // 8
for i in range(8):
    assert dec[i * stride] == coeffs[10 * i]
print("LWE extract+pack OK")

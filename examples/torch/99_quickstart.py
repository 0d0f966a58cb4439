"""Quickstart: BFV encrypt/add/decrypt (mirrors reference examples/99_quickstart.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel

# n=8192 with three 30-bit data primes + special prime (reference uses
# {40,40,40}; 30-bit limbs are the TPU-native word size)
n = 8192
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Classical128, device=DEVICE)

keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)

x = np.arange(encoder.slot_count, dtype=np.uint64)
y = np.arange(encoder.slot_count, dtype=np.uint64)[::-1].copy()
ct_x = encryptor.encrypt_asymmetric(encoder.encode(x))
ct_y = encryptor.encrypt_asymmetric(encoder.encode(y))
ct_sum = evaluator.add(ct_x, ct_y)
result = encoder.decode(decryptor.decrypt(ct_sum))
assert (result == (x + y) % parms.plain_modulus.value).all()
print("quickstart OK: slot 0..3 =", result[:4])

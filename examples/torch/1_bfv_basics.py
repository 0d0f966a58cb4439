"""BFV basics: noise budgets, multiply, relinearize
(mirrors reference examples/1_bfv_basics.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel

n = 4096
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)  # demo-size params
keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)
rlk = keygen.create_relin_keys()

t = parms.plain_modulus.value
m = np.arange(encoder.slot_count, dtype=np.uint64) % t
ct = encryptor.encrypt_asymmetric(encoder.encode(m))
print("fresh noise budget:", decryptor.invariant_noise_budget(ct), "bits")

sq = evaluator.square(ct)
print("after square (size 3):", decryptor.invariant_noise_budget(sq), "bits")
rel = evaluator.relinearize(sq, rlk)
print("after relinearize:", decryptor.invariant_noise_budget(rel), "bits")
out = encoder.decode(decryptor.decrypt(rel))
assert (out == m * m % t).all()
print("x^2 OK")

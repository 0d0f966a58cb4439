"""Rotations: BFV rows/columns + CKKS vector (mirrors examples/6_rotation.cu)."""

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
glk = keygen.create_galois_keys_from_steps([3, -1])
glk_cols = keygen.create_galois_keys_from_elements([2 * n - 1])

m = np.arange(encoder.slot_count, dtype=np.uint64)
ct = encryptor.encrypt_asymmetric(encoder.encode(m))
rows = m.reshape(2, -1)

r3 = encoder.decode(decryptor.decrypt(evaluator.rotate_rows(ct, 3, glk))).reshape(2, -1)
assert (r3 == np.roll(rows, -3, axis=1)).all()
rm1 = encoder.decode(decryptor.decrypt(evaluator.rotate_rows(ct, -1, glk))).reshape(2, -1)
assert (rm1 == np.roll(rows, 1, axis=1)).all()
rc = encoder.decode(decryptor.decrypt(evaluator.rotate_columns(ct, glk_cols))).reshape(2, -1)
assert (rc == rows[::-1]).all()
print("rotations OK")

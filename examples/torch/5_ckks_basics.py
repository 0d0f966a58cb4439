"""CKKS basics: encode with scale, multiply, rescale
(mirrors reference examples/5_ckks_basics.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      KeyGenerator, Encryptor, Decryptor, Evaluator, CKKSEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel

n = 4096
scale = 2.0 ** 27
parms = EncryptionParameters(SchemeType.CKKS)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)  # demo-size params
keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = CKKSEncoder(context)
rlk = keygen.create_relin_keys()

v = np.linspace(0, 1, encoder.slot_count)
ct = encryptor.encrypt_asymmetric(encoder.encode(v, scale=scale))
prod = evaluator.relinearize(evaluator.multiply(ct, ct), rlk)
prod = evaluator.rescale_to_next(prod)
out = encoder.decode(decryptor.decrypt(prod)).real
err = np.abs(out - v * v).max()
print(f"x^2 max error after rescale: {err:.2e}")
assert err < 5e-3

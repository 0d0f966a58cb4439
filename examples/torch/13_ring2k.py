"""Ring2k encoding: BFV over Z_{2^k} (mirrors examples/13_ring2k.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor, Evaluator)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.app.ring2k import PolynomialEncoderRing2k

n, k = 2048, 24
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))  # bypassed by ring2k
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
enc = PolynomialEncoderRing2k(context, k)
mask = (1 << k) - 1

rng = np.random.default_rng(0)
m1 = rng.integers(0, 1 << k, n, dtype=np.uint64)
m2 = rng.integers(0, 1 << k, n, dtype=np.uint64)
ct = encryptor.encrypt_asymmetric(enc.scale_up(m1))
ct = evaluator.add_plain(ct, enc.scale_up(m2))
out = enc.decrypt_scale_down(decryptor, ct)
assert (out == (m1 + m2) & mask).all()
print(f"ring2k (k={k}) homomorphic add over Z_2^k OK")

"""BGV basics: NTT-form ciphertexts, correction factors
(mirrors examples/4_bgv_basics.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel

n = 4096
parms = EncryptionParameters(SchemeType.BGV)
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

m = np.arange(encoder.slot_count, dtype=np.uint64)
ct = encryptor.encrypt_asymmetric(encoder.encode(m))
assert ct.is_ntt_form  # BGV ciphertexts live in the NTT domain

sq = evaluator.relinearize(evaluator.square(ct), rlk)
down = evaluator.mod_switch_to_next(sq)
print("correction factor after modswitch:", down.correction_factor)
out = encoder.decode(decryptor.decrypt(down))
assert (out == m * m % t).all()
print("BGV x^2 + modswitch OK")

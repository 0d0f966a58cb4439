"""Modulus switching chain walk (mirrors examples/3_levels.cu)."""

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

# walk the chain: key level -> first -> ... -> last
cd = context.key_context_data()
while cd is not None:
    tag = ("key" if cd.parms_id == context.key_parms_id else
           "first" if cd.parms_id == context.first_parms_id else
           "last" if cd.is_last() else "mid")
    print(f"chain {cd.chain_index} [{tag:5}] L={cd.coeff_modulus_size} "
          f"parms_id={cd.parms_id[:12]}")
    cd = cd.next

keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)

m = np.arange(encoder.slot_count, dtype=np.uint64)
ct = encryptor.encrypt_asymmetric(encoder.encode(m))
while True:
    print("budget at L =", ct.coeff_modulus_size, ":",
          decryptor.invariant_noise_budget(ct), "bits")
    if context.get_context_data(ct.parms_id).is_last():
        break
    ct = evaluator.mod_switch_to_next(ct)
assert (encoder.decode(decryptor.decrypt(ct)) == m).all()
print("mod switch chain OK")

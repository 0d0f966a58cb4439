"""Batched ciphertext operations (mirrors examples/15_batched_operation.cu).

Where the reference offers *_batched APIs dispatching one CUDA kernel over a
vector of ciphertexts, this build stacks ciphertexts into one
(B, size, L, n) array and runs the same jitted kernel with a leading batch
axis — the natural TPU layout (and the data-parallel mesh axis).
"""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.parallel.batched import BatchedEvaluator

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
rlk = keygen.create_relin_keys()
t = parms.plain_modulus.value

B = 4
rng = np.random.default_rng(3)
ms1 = [rng.integers(0, t, encoder.slot_count, dtype=np.uint64) for _ in range(B)]
ms2 = [rng.integers(0, t, encoder.slot_count, dtype=np.uint64) for _ in range(B)]
cts1 = [encryptor.encrypt_asymmetric(encoder.encode(m)) for m in ms1]
cts2 = [encryptor.encrypt_asymmetric(encoder.encode(m)) for m in ms2]

cd = context.first_context_data()
batched = BatchedEvaluator(evaluator, cd)
d1, d2 = batched.stack(cts1), batched.stack(cts2)
step = batched.build_mul_relin_step(rlk.key(2))
out = step(d1, d2, rlk.key(2))

for i, ct in enumerate(batched.unstack(out, cts1[0])):
    dec = encoder.decode(decryptor.decrypt(ct))
    assert (dec == ms1[i] * ms2[i] % t).all()
print(f"batched multiply+relinearize of {B} ciphertexts OK")

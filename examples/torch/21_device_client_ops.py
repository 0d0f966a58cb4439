"""Device-batched CLIENT operations (round 5).

The reference benches encode/encrypt/decrypt as DEVICE kernels
(test/bench/he_operations.cu:15-50; rlwe.cu, batch_encoder.cu).  This
build's counterpart is `parallel.batched.BatchedClient`: pure jittable
step builders that encrypt/decrypt/encode a whole (B, ...) stack in ONE
kernel — PRF key derivation, sampling and the RLWE combine all fused
in-trace.  PERF.md gives their times on the H100 (the [client] phase of
chip_smoke.py).
"""

from common import DEVICE
import numpy as np
import torch

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.parallel.batched import BatchedClient

n, B = 1024, 4
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30] * 4))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)

keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key(),
                      sk=keygen.secret_key)
decryptor = Decryptor(context, keygen.secret_key)
encoder = BatchEncoder(context)
cd = context.first_context_data()
client = BatchedClient(context, cd)
t = parms.plain_modulus.value

# 1) device-batched SIMD encode: (B, n) slot values -> (B, n) coefficients
vals = np.arange(B * n, dtype=np.uint64).reshape(B, n) % t
encode = client.build_batch_encode_step(encoder)
coeffs = encode(torch.as_tensor(vals.astype(np.int64), device=DEVICE))

# 2) device-batched asymmetric encryption of ONE plaintext payload under
#    fresh per-element randomness (the payload here: element 0's encoding)
pt0 = encoder.encode(vals[0])
enc_step = client.build_encrypt_asymmetric_step(
    encryptor.prng.base_keys, pt0.data)
proto = encryptor.encrypt_asymmetric(pt0)  # shape template / metadata proto
cts = enc_step(torch.stack([proto.data] * B), encryptor.pk.data())
assert (cts[0] != cts[1]).any()  # fresh randomness

# 3) device-batched decryption: (B, 2, L, n) -> (B, n) mod-t coefficients
dec_step = client.build_decrypt_step([decryptor._power(1)])
pt_out = dec_step(cts)

# every batch element decrypts to the same payload (vals[0])
decoded = [np.asarray(encoder.decode(
    type(pt0)(pt_out[i][None, :], coeff_count=n))).astype(np.uint64)
    for i in range(B)]
for d in decoded:
    np.testing.assert_array_equal(d, vals[0])
print("device-batched encode/encrypt/decrypt OK:",
      f"B={B}, slot 0..3 = {decoded[0][:4]}")

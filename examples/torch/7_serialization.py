"""Serialization: compression modes, seed-compressed ciphertexts
(mirrors examples/7_serialization.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.utils import serialize as S

n = 4096
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
keygen = KeyGenerator(context)
encryptor = Encryptor(context, sk=keygen.secret_key, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
encoder = BatchEncoder(context)

m = np.arange(encoder.slot_count, dtype=np.uint64)
pt = encoder.encode(m)

ct_pk = encryptor.encrypt_asymmetric(pt)
blob_raw = S.save_ciphertext(ct_pk, context)
blob_zstd = S.save_ciphertext(ct_pk, context, S.CompressionMode.Zstd)
ct_sk = encryptor.encrypt_symmetric(pt, save_seed=True)
blob_seed = S.save_ciphertext(ct_sk, context, S.CompressionMode.Zstd)
print(f"asymmetric raw:  {len(blob_raw):8d} bytes")
print(f"asymmetric zstd: {len(blob_zstd):8d} bytes")
print(f"symmetric+seed:  {len(blob_seed):8d} bytes  (c1 regenerated from 8-byte seed)")

for blob in (blob_raw, blob_zstd, blob_seed):
    back = S.load_ciphertext(blob, context)
    assert (encoder.decode(decryptor.decrypt(back)) == m).all()
print("all serialization roundtrips OK")

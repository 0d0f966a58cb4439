"""BumbleBee CKKS matmul (mirrors examples/11_ckks_matmul.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      KeyGenerator, Encryptor, Decryptor, Evaluator, CKKSEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
from troy_tpu_torch.app.encoder_adapter import CKKSEncoderAdapter

n = 2048
scale = 2.0 ** 25
parms = EncryptionParameters(SchemeType.CKKS)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
keygen = KeyGenerator(context)
encryptor = Encryptor(context, sk=keygen.secret_key, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = CKKSEncoder(context)
adapter = CKKSEncoderAdapter(encoder, scale)

batch, in_d, out_d = 4, 16, 8
helper = MatmulHelper(batch, in_d, out_d, n, MatmulObjective.EncryptLeft,
                      pack_lwe=False)
rng = np.random.default_rng(0)
x = rng.uniform(-1, 1, (batch, in_d))
w = rng.uniform(-1, 1, (in_d, out_d))

x_enc = helper.encrypt_inputs(encryptor, adapter, x)
w_enc = helper.encode_weights(adapter, w)
y = helper.matmul(evaluator, x_enc, w_enc)
dec_adapter = CKKSEncoderAdapter(encoder, scale * scale)  # product scale
dec = helper.decrypt_outputs(dec_adapter, decryptor, y)
err = np.abs(dec - x @ w).max()
print(f"CKKS matmul max err: {err:.2e}")
assert err < 1e-2

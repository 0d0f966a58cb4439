"""Cheetah conv2d (mirrors examples/14_bfv_conv2d.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.app.conv2d import Conv2dHelper
from troy_tpu_torch.app.matmul import MatmulObjective
from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter

n = 2048
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
keygen = KeyGenerator(context)
encryptor = Encryptor(context, sk=keygen.secret_key, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)
adapter = BatchEncoderAdapter(encoder)
t = parms.plain_modulus.value

B, Ci, Co, H, W, kh, kw = 1, 2, 3, 8, 8, 3, 3
helper = Conv2dHelper(B, Ci, Co, H, W, kh, kw, n, MatmulObjective.EncryptLeft)
rng = np.random.default_rng(0)
x = rng.integers(0, 256, (B, Ci, H, W), dtype=np.uint64)
kern = rng.integers(0, 256, (Co, Ci, kh, kw), dtype=np.uint64)

x_enc = helper.encrypt_inputs(encryptor, adapter, x)
k_enc = helper.encode_weights(adapter, kern)
y = helper.conv2d(evaluator, x_enc, k_enc)
dec = helper.decrypt_outputs(adapter, decryptor, y)

# verify against plain valid convolution
for b in range(B):
    for oc in range(Co):
        for i in range(H - kh + 1):
            for j in range(W - kw + 1):
                acc = sum(int((x[b, ic, i:i+kh, j:j+kw] * kern[oc, ic]).sum())
                          for ic in range(Ci)) % t
                assert int(dec[b, oc, i, j]) % t == acc
print("conv2d OK, output shape:", dec.shape)

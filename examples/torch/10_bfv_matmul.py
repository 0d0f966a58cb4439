"""BumbleBee BFV matmul, client/server protocol with serialization
(mirrors reference examples/10_bfv_matmul.cu)."""

from common import DEVICE
import numpy as np

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter
from troy_tpu_torch.utils import serialize as S

n = 4096
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)  # demo-size params
keygen = KeyGenerator(context)
encryptor = Encryptor(context, sk=keygen.secret_key, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)
adapter = BatchEncoderAdapter(encoder)
t = parms.plain_modulus.value

batch, in_d, out_d = 8, 32, 16
helper = MatmulHelper(batch, in_d, out_d, n, MatmulObjective.EncryptLeft,
                      pack_lwe=False)
rng = np.random.default_rng(0)
x = rng.integers(0, t, (batch, in_d), dtype=np.uint64)
w = rng.integers(0, t, (in_d, out_d), dtype=np.uint64)

# client: encrypt inputs (seed-compressed) and serialize
x_enc = helper.encode_inputs(adapter, x).encrypt_symmetric(encryptor, save_seed=True)
wire = [[S.save_ciphertext(c, context, S.CompressionMode.Zstd) for c in row]
        for row in x_enc.data]
print("client->server bytes:", sum(len(b) for row in wire for b in row))

# server: deserialize, multiply by plain weights
from troy_tpu_torch.app.cipher2d import Cipher2d
x_srv = Cipher2d([[S.load_ciphertext(b, context) for b in row] for row in wire])
w_enc = helper.encode_weights(adapter, w)
y = helper.matmul(evaluator, x_srv, w_enc)

# client: decrypt
dec = helper.decrypt_outputs(adapter, decryptor, y)
want = (x.astype(object) @ w.astype(object)) % t
assert (dec.astype(object) % t == want).all()
print("matmul OK:", dec.shape)

"""Wide parameters: SEAL-default 40-60-bit primes through the one public API.

The framework supports two residue widths through the same
HeContext/Encryptor/Evaluator/Decryptor surface (ref: the reference library
operates natively on <=61-bit primes, src/utils/basics.h:579):

  * fast path  — all primes 29/30 bits, residues in single u32 lanes
    (fastest on TPU; express a budget as more, smaller primes);
  * wide path  — all primes 31..60 bits, residues as (hi, lo) u32 pairs
    (use when a protocol fixes the parameter set, e.g. a SEAL peer expects
    {60, 40, 40, 60}).

This demo runs CKKS at the reference's default bench parameters.
"""

from common import DEVICE
import numpy as np

from troy_tpu_torch.core.params import EncryptionParameters, SchemeType
from troy_tpu_torch.core.context import HeContext
from troy_tpu_torch.core.coeff_modulus import CoeffModulus, SecurityLevel
from troy_tpu_torch.core.keygen import KeyGenerator
from troy_tpu_torch.core.encryptor import Encryptor
from troy_tpu_torch.core.decryptor import Decryptor
from troy_tpu_torch.core.evaluator import Evaluator
from troy_tpu_torch.core.ckks_encoder import CKKSEncoder

n = 128  # demo size; TPU-verified at n=8192
scale = 2.0 ** 40

parms = EncryptionParameters(SchemeType.CKKS)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 60]))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
print("primes:", [q.value for q in parms.coeff_modulus])

keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key(), sk=keygen.secret_key)
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = CKKSEncoder(context)

v = np.linspace(0, 1, encoder.slot_count)
ct = encryptor.encrypt_asymmetric(encoder.encode(v, scale=scale))

# multiply + relinearize + rescale at full 2^40 scale
rlk = keygen.create_relin_keys()
prod = evaluator.rescale_to_next(evaluator.relinearize(evaluator.multiply(ct, ct), rlk))
out = encoder.decode(decryptor.decrypt(prod)).real
err = np.abs(out - v * v).max()
print(f"x^2 max error after rescale (scale 2^40): {err:.2e}")
assert err < 1e-6  # 2^40 scale gives ~7 more digits than the 2^27 demo

# rotation at wide width
steps = 5
glk = keygen.create_galois_keys()
rot = evaluator.rotate_vector(ct, steps, glk)
err_r = np.abs(encoder.decode(decryptor.decrypt(rot)).real - np.roll(v, -steps)).max()
print(f"rotate({steps}) max error: {err_r:.2e}")
assert err_r < 1e-6

# BFV at the same wide widths, t = 2^20 batching prime
from troy_tpu_torch.core.coeff_modulus import PlainModulus
from troy_tpu_torch.core.batch_encoder import BatchEncoder

parms_b = EncryptionParameters(SchemeType.BFV)
parms_b.set_poly_modulus_degree(n)
parms_b.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 60]))
parms_b.set_plain_modulus(PlainModulus.batching(n, 20))
ctx_b = HeContext.create(parms_b, True, SecurityLevel.Nil, device=DEVICE)
kg = KeyGenerator(ctx_b)
enc_b = Encryptor(ctx_b, pk=kg.create_public_key())
dec_b = Decryptor(ctx_b, kg.secret_key)
ev_b = Evaluator(ctx_b)
be = BatchEncoder(ctx_b)
m = np.arange(be.slot_count, dtype=np.uint64)
c = enc_b.encrypt_asymmetric(be.encode(m))
sq = ev_b.relinearize(ev_b.multiply(c, c), kg.create_relin_keys())
got = be.decode(dec_b.decrypt(sq))
assert np.array_equal(got, (m.astype(object) ** 2 % be.t.value).astype(np.uint64))
print("wide BFV square: OK")

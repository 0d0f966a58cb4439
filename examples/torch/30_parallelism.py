"""Parallelism: what replaced host multithreading and independent multi-GPU.

The reference documents a multithread hazard (examples/30_issue_multithread.cu)
because CUDA streams + shared memory pools race; its multi-GPU story is
independent per-device replicas with no collectives (readme.md:179-200).

Here both collapse into declarative sharding: a batch of ciphertexts is one
(B, size, L, n) array; shard B over the 'data' mesh axis (the multi-GPU
analog) and the RNS limb axis over 'limb' (intra-ciphertext parallelism the
reference cannot express).  There are no races by construction — everything
is a pure function over immutable arrays.

Run with 8 shards on the card (or --device cpu):
  python3 examples/torch/30_parallelism.py
"""

from common import DEVICE
import numpy as np
import torch

from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                      PlainModulus, KeyGenerator, Encryptor, Decryptor,
                      Evaluator, BatchEncoder)
from troy_tpu_torch.core.coeff_modulus import SecurityLevel
from troy_tpu_torch.parallel import mesh as M
from troy_tpu_torch.parallel.batched import BatchedEvaluator

DEVICES = [torch.device(DEVICE)] * 8  # eight shards on one device; a mesh of cards lists each

n = 512
parms = EncryptionParameters(SchemeType.BFV)
parms.set_poly_modulus_degree(n)
parms.set_coeff_modulus(CoeffModulus.create(n, [30, 30, 30]))
parms.set_plain_modulus(PlainModulus.batching(n, 20))
context = HeContext.create(parms, True, SecurityLevel.Nil, device=DEVICE)
keygen = KeyGenerator(context)
encryptor = Encryptor(context, pk=keygen.create_public_key())
decryptor = Decryptor(context, keygen.secret_key)
evaluator = Evaluator(context)
encoder = BatchEncoder(context)
rlk = keygen.create_relin_keys()
t = parms.plain_modulus.value

data_axis = min(4, len(DEVICES))
mesh = M.make_mesh(data=data_axis, limb=1, devices=DEVICES)
print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))

B = 2 * data_axis
rng = np.random.default_rng(0)
ms = [rng.integers(0, t, encoder.slot_count, dtype=np.uint64) for _ in range(B)]
cts = [encryptor.encrypt_asymmetric(encoder.encode(m)) for m in ms]

cd = context.first_context_data()
batched = BatchedEvaluator(evaluator, cd)
d = batched.stack(cts)
d = M.shard_batch(d, mesh, shard_limbs=False)
print("batch sharding:", d.sharding.spec)
keys = M.replicate(rlk.key(2), mesh)
out = batched.build_mul_relin_step(keys)(d, d, keys)
for i, ct in enumerate(batched.unstack(out, cts[0])):
    dec = encoder.decode(decryptor.decrypt(ct))
    assert (dec == ms[i] * ms[i] % t).all()
print(f"sharded squaring of {B} ciphertexts over {data_axis} devices OK")

# -- multi-host deployments -------------------------------------------------
# Across hosts: torch.distributed.init_process_group() first, and 'host' is the rank
# (scripts/torch_multiproc_cpu_demo.py); here the hierarchical
# (host, data, limb) mesh is simulated over the local devices.  Batch
# parallelism spans hosts with ZERO cross-host traffic (see
# tests/test_torch_mesh.py for the collective record).
if len(DEVICES) >= 4:
    hmesh = M.make_multihost_mesh(hosts=2, limb=1, devices=DEVICES)
    print("multihost mesh:", dict(zip(hmesh.axis_names, hmesh.devices.shape)))
    dh = M.shard_batch(batched.stack(cts), hmesh, shard_limbs=False)
    out = batched.build_mul_relin_step(keys)(dh, dh, M.replicate(keys, hmesh))
    dec = encoder.decode(decryptor.decrypt(batched.unstack(out, cts[0])[0]))
    assert (dec == ms[0] * ms[0] % t).all()
    print("multihost batch-parallel squaring OK")

# -- app layer under the mesh -------------------------------------------------
# The reference benches matmul with --multiple-devices
# (scripts/test_matmul.sh); here the SAME MatmulHelper call takes a mesh and
# the port splits the block contraction and the pack_outputs keyswitch tree.
if len(DEVICES) >= 4:
    from troy_tpu_torch.app.matmul import MatmulHelper, MatmulObjective
    from troy_tpu_torch.app.encoder_adapter import BatchEncoderAdapter

    adapter = BatchEncoderAdapter(encoder)
    helper = MatmulHelper(8, 5, 6, n, MatmulObjective.EncryptLeft,
                          pack_lwe=True)
    # pin a 4-row block grid so the 'data' axis has something to shard
    helper.batch_block, helper.input_block, helper.output_block = 2, 2, 4
    x = rng.integers(0, t, (8, 5), dtype=np.uint64)
    w = rng.integers(0, t, (5, 6), dtype=np.uint64)
    amesh = M.make_mesh(data=4, limb=1, devices=DEVICES)
    enc_sym = Encryptor(context, sk=keygen.secret_key)  # seed-compressible cts
    y = helper.matmul(evaluator, helper.encrypt_inputs(enc_sym, adapter, x),
                      helper.encode_weights(adapter, w), mesh=amesh)
    y = helper.pack_outputs(evaluator, keygen.create_automorphism_keys(), y,
                            mesh=amesh)
    got = helper.decrypt_outputs(adapter, decryptor, y)
    assert (got.astype(object) % t
            == x.astype(object) @ w.astype(object) % t).all()
    print("multi-device BumbleBee matmul (contraction + pack) OK")

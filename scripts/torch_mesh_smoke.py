#!/usr/bin/env python3
"""chip_smoke.py's [mesh] phase alone, on the card (or every card).

    python3 scripts/torch_mesh_smoke.py

Builds the kernels, makes [main]'s inputs (the n = 8192, 7 x 30-bit BFV
chain, batch 16, keys and encryptions from a torch.Generator seeded with
KEY_SEED) and [app]'s BFV matmul, then runs chip_smoke.phase_mesh: the HPS
step over (data, limb) meshes of shards of card 0, over one ciphertext's
coefficients, and with several cards also over the cards; the app matmul +
pack over (data=4, limb=1); a one-rank NCCL multihost mesh.  Each run must
equal the unsharded one bit for bit.  About 45 s of command time on one
H100, most of it the build and [app].  Imports nothing of jax.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_smoke: no CUDA device", file=sys.stderr)
        return 1
    from troy_tpu_torch.ops import _cuda_build
    from troy_tpu_torch.core.keygen import KeyGenerator
    from troy_tpu_torch.core.encryptor import Encryptor
    from troy_tpu_torch.core.decryptor import Decryptor
    from troy_tpu_torch.core.evaluator import Evaluator
    from troy_tpu_torch.core.batch_encoder import BatchEncoder
    from troy_tpu_torch.parallel.batched import BatchedEvaluator

    t0 = time.perf_counter()
    dev, gpu = cs.cuda_device(), cs.gpu_line()
    cs.log(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} device(s)")
    _cuda_build.build()
    _cuda_build.load()
    ctx = cs.build_context(dev)
    cd = ctx.first_context_data()
    encoder = BatchEncoder(ctx)
    gen = torch.Generator(device=dev).manual_seed(cs.KEY_SEED)
    keygen = KeyGenerator(ctx, gen)
    keys = keygen.create_relin_keys().key(2)
    encryptor = Encryptor(ctx, keygen.secret_key, gen)
    t_val = encoder.t.value
    msgs = np.random.default_rng(cs.MSG_SEED).integers(0, t_val, size=(2 * cs.BATCH, cs.N),
                                                       dtype=np.int64)
    cts = [encryptor.encrypt_symmetric(encoder.encode(m)).data for m in msgs]
    d1, d2 = torch.stack(cts[:cs.BATCH]), torch.stack(cts[cs.BATCH:])
    cs.log(f"[setup] build, context, keys and {2 * cs.BATCH} encryptions in "
           f"{time.perf_counter() - t0:.3f} s")
    app = cs.phase_app(dev, gpu)
    t1 = time.perf_counter()
    cs.phase_mesh(dev, gpu, dict(
        step=BatchedEvaluator(Evaluator(ctx), cd).build_mul_relin_step(keys), d1=d1, d2=d2,
        keys=keys, cd=cd, encoder=encoder, decryptor=Decryptor(ctx, keygen.secret_key),
        expected=(msgs[:cs.BATCH].astype(object) * msgs[cs.BATCH:]) % t_val), app)
    cs.log(f"[mesh] the phase in {time.perf_counter() - t1:.3f} s; all runs bit-exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())

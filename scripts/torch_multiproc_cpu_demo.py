"""Two-process torch.distributed run of a sharded BFV multiply +
relinearize on the CPU (the port's twin of scripts/multiproc_cpu_demo.py).

Two OS processes join one gloo process group through a FileStore, each
holding 4 CPU devices; both build the same (host=2, data=2, limb=2) mesh
(parallel/mesh.make_multihost_mesh: 'host' is the rank), shard the same
batch, and run the batched mul + relin step on the shards they own: the
batch splits over (host, data) with no cross-process traffic, the limbs
over 'limb' inside each process.  Each process checks its own shards bit for
bit against the unsharded step it runs itself.  The processes build their
contexts, keys and ciphertexts from one seed, so they hold the same inputs
(a deployment would send serialized keys instead).

Run:  python scripts/torch_multiproc_cpu_demo.py [--store PATH] [--timeout S]
      (the parent; it starts the two workers, each with TROY_MP_ROLE=worker,
      in a session of its own, and kills them when the one deadline of
      --timeout seconds passes; the workers' process group times out with it)
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import subprocess
import sys
import tempfile
import time

NPROC = 2
LOCAL_DEVICES = 4
N = 64
BATCH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(rank: int, store_path: str, timeout: float) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from troy_tpu_torch import (EncryptionParameters, SchemeType, HeContext, CoeffModulus,
                                PlainModulus, KeyGenerator, Encryptor, Evaluator,
                                BatchEncoder, BatchedEvaluator)
    from troy_tpu_torch.core.coeff_modulus import SecurityLevel
    from troy_tpu_torch.parallel import mesh as M

    dist.init_process_group("gloo", store=dist.FileStore(store_path, NPROC), rank=rank,
                            world_size=NPROC, timeout=datetime.timedelta(seconds=timeout))
    try:
        parms = EncryptionParameters(SchemeType.BFV).set_poly_modulus_degree(N)
        parms.set_coeff_modulus(CoeffModulus.create(N, [30, 30, 30]))
        parms.set_plain_modulus(PlainModulus.batching(N, 20))
        ctx = HeContext.create(parms, True, SecurityLevel.Nil, 0xD15, device="cpu")
        kg = KeyGenerator(ctx)
        enc, coder = Encryptor(ctx, pk=kg.create_public_key()), BatchEncoder(ctx)
        t = parms.plain_modulus.value
        rng = np.random.default_rng(33)
        msgs = rng.integers(0, t, size=(2, BATCH, coder.slot_count), dtype=np.uint64)
        be = BatchedEvaluator(Evaluator(ctx), ctx.first_context_data())
        d1, d2 = (be.stack([enc.encrypt_asymmetric(coder.encode(m)) for m in ms])
                  for ms in msgs)
        keys = kg.create_relin_keys().key(2)
        step = be.build_mul_relin_step(keys)
        expected = step(d1, d2, keys)                      # the local oracle

        mesh = M.make_multihost_mesh(hosts=NPROC, limb=2,
                                     devices=[torch.device("cpu")] * LOCAL_DEVICES)
        out = step(M.shard_batch(d1, mesh), M.shard_batch(d2, mesh), M.replicate(keys, mesh))
        checked = 0
        for shard in out.addressable_shards:
            assert torch.equal(shard.data, expected[shard.index]), \
                f"rank {rank} shard {shard.index} mismatch"
            checked += 1
        assert checked == LOCAL_DEVICES, checked
        assert all(s is None for i, s in enumerate(out.shards) if not mesh.is_local(i))
        stats = M.collective_stats(out)
        print(f"[worker {rank}] {checked} local shards verified bit-exact ({NPROC} processes "
              f"x {LOCAL_DEVICES} devices; {stats['total']} limb collectives inside "
              f"the process, none across)", flush=True)
    finally:
        dist.destroy_process_group()


def parent(store: str | None, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        store = store or os.path.join(tmp, "store")
        procs = []
        for rank in range(NPROC):
            env = dict(os.environ, TROY_MP_ROLE="worker", TROY_MP_RANK=str(rank),
                       TROY_MP_STORE=store, TROY_MP_TIMEOUT=str(timeout))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)],
                                          env=env, cwd=REPO, start_new_session=True))
        rcs = []
        try:
            for p in procs:
                rcs.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
    if len(rcs) < NPROC or any(rcs):
        raise SystemExit(f"worker exit codes: {rcs}")
    print("multiproc demo OK: 2-process distributed mul+relin verified")


if __name__ == "__main__":
    if os.environ.get("TROY_MP_ROLE") == "worker":
        worker(int(os.environ["TROY_MP_RANK"]), os.environ["TROY_MP_STORE"],
               float(os.environ["TROY_MP_TIMEOUT"]))
    else:
        ap = argparse.ArgumentParser()
        ap.add_argument("--store", help="the FileStore path (default: a temporary file)")
        ap.add_argument("--timeout", type=float, default=120.0,
                        help="seconds the two workers may take together")
        args = ap.parse_args()
        parent(args.store, args.timeout)

#!/usr/bin/env python3
"""A short check of K2's cluster kernel (csrc/ntt_mxu_cluster.cu, the route
at n = 32768, 65536, 131072) on one GPU: its ptxas report, its launch
shapes, its result against the plain version and K1, and its time against
the first form and K1.

    python3 scripts/torch_mxu_cluster_check.py [--quick]

  * nvcc -Xptxas -v on csrc/ntt_mxu_cluster.cu (registers, spills, and
    whether ptxas serialized the wgmma pipeline), beside the library's
    build;
  * cluster_info at every degree and cluster size the kernel takes
    (registers, shared bytes, the clusters the card holds, the plan);
  * the kernel's forward (lazy input) and inverse (lazy and canonical
    input) against ops/ntt_mxu.py's plain version and K1 at each degree and
    cluster size, on 1 to 3 limbs and 3 rows;
  * without --quick, at (3, 2, n) for each degree and at the n = 65536
    step's keyswitch digits (16, 9, 65536): the route, the first form
    (mma_*) and K1 in turns (route, first form, K1, K1, first form, route)
    by chip_smoke.graph_us, beside ntt_bound and the method's terms
    (chip_smoke.cl_terms); then each cluster size in turns.

Exits 1 if a check fails.  Builds into troy_tpu_torch/build/; imports
nothing of jax.
"""

from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from troy_tpu_torch.core.modulus import Modulus  # noqa: E402
from troy_tpu_torch.ops import _cuda_build, ntt as NTT, ntt_cuda, ntt_mxu as MX  # noqa: E402
from troy_tpu_torch.ops import ntt_mxu_cuda  # noqa: E402
from troy_tpu_torch.utils import numth  # noqa: E402

DEGREES = (15, 16, 17)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_mxu_cluster_check: no CUDA device", file=sys.stderr)
        return 1
    quick = "--quick" in argv
    dev = chip_smoke.cuda_device()
    gpu = chip_smoke.gpu_line()
    log = chip_smoke.log
    log(f"[device] {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = chip_smoke.ptxas_start("ntt_mxu_cluster.cu")
    _cuda_build.load()
    chip_smoke.ptxas_report(ptxas)
    for lg in DEGREES:
        for inverse in (False, True):
            for k in MX.CL_SWEEP[lg]:
                info = ntt_mxu_cuda.cluster_info(inverse, lg, k)
                log(f"[check] ntt_{'inverse' if inverse else 'forward'}_mxu_cluster at n = "
                    f"{1 << lg}, clusters of {1 << k}: {info}")
    gen = torch.Generator(device=dev).manual_seed(16)
    failed = 0
    NTT.set_ntt_backend("pallas_mxu")
    try:
        for lg in DEGREES:
            n = 1 << lg
            mods = [Modulus(p) for p in numth.get_primes(2 * n, 30, 3)]
            for L in (1, 3):
                t = NTT.NTTTables(lg, mods[:L], dev)
                x = chip_smoke.residues((3, L, n), t.q, gen, 2)
                canon = x % t.q.view(-1, 1)
                want_f, want_i = MX.ntt_forward_mxu(x, t.mxu), MX.ntt_inverse_mxu(x, t.mxu)
                k1_f, k1_i = ntt_cuda.ntt_forward(x, t), ntt_cuda.ntt_inverse(canon, t)
                for k in MX.CL_SWEEP[lg]:
                    f = ntt_mxu_cuda.cluster_forward(x, t.mxu, k)
                    i = ntt_mxu_cuda.cluster_inverse(x, t.mxu, k)
                    ic = ntt_mxu_cuda.cluster_inverse(canon, t.mxu, k)
                    torch.cuda.synchronize()
                    ok = (torch.equal(f, want_f) and torch.equal(f, k1_f)
                          and torch.equal(i, want_i) and torch.equal(i, k1_i)
                          and torch.equal(ic, k1_i))
                    bad = int((f != want_f).sum()) + int((i != want_i).sum())
                    log(f"[check] n = {n}, L = {L}, clusters of {1 << k}: forward and inverse "
                        f"{'equal' if ok else 'DIFFER from'} the plain version and K1 "
                        f"({bad} residues differ)")
                    failed += not ok
    finally:
        NTT.set_ntt_backend("sixstep")
    if failed or quick:
        return 1 if failed else 0

    shapes = {f"(3, 2, {1 << lg})": (lg, 2, (3,)) for lg in DEGREES}
    shapes["digits (16, 9, 65536)"] = (16, 9, (16,))
    NTT.set_ntt_backend("pallas_mxu")
    try:
        for label, (lg, L, lead) in shapes.items():
            n = 1 << lg
            t = NTT.NTTTables(lg, [Modulus(p) for p in numth.get_primes(2 * n, 30, L)], dev)
            shape = (*lead, L, n)
            x = chip_smoke.residues(shape, t.q, gen)
            for inverse in (False, True):
                d = "inverse" if inverse else "forward"
                k2 = lambda: getattr(ntt_mxu_cuda, f"ntt_{d}")(x, t.mxu)
                yd = lambda: getattr(ntt_mxu_cuda, f"mma_{d}")(x, t.mxu)
                k1 = lambda: getattr(ntt_cuda, f"ntt_{d}")(x, t)
                a1, c1, b1, b2, c2, a2 = (chip_smoke.graph_us(f, 20) for f in
                                          (k2, yd, k1, k1, yd, k2))
                bound = chip_smoke.ntt_bound(shape)[0]
                terms = chip_smoke.cl_terms(shape, inverse)
                log(f"[check] {gpu}: {d} {label}: cluster kernel {a1:.3f} / {a2:.3f} us, "
                    f"first form {c1:.3f} / {c2:.3f} us, K1 {b1:.3f} / {b2:.3f} us; bound "
                    f"{bound:.3f} us, share {100 * bound / min(a1, a2):.1f}%; method "
                    + ", ".join(f"{k} {v:.3f} us" for k, v in terms.items()))
            if len(MX.CL_SWEEP[lg]) > 1:
                fns = {k: (lambda k=k: ntt_mxu_cuda.cluster_inverse(
                    ntt_mxu_cuda.cluster_forward(x, t.mxu, k), t.mxu, k))
                    for k in MX.CL_SWEEP[lg]}
                got = {}
                for k in list(fns) + list(fns)[::-1]:
                    got.setdefault(k, []).append(chip_smoke.graph_us(fns[k], 20))
                log(f"[check] {gpu}: forward + inverse at {label} by cluster size, in turns: "
                    + "; ".join(f"clusters of {1 << k}: "
                                f"{' / '.join(f'{v:.3f}' for v in got[k])} us" for k in got))
    finally:
        NTT.set_ntt_backend("sixstep")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

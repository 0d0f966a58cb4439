"""Run one cell of the benchmark once:

    python3 hebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the compared numbers beside their
limits as the last lines of standard error, then one JSON line as the last
line of standard output.  Exits with another code than 0, printing no
result, where there is no CUDA card (or fewer than the cell asks for), where
the program cannot be imported, or where jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    bench_json = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench_json["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    from harness import bench

    result, _ = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START)
    bad = bench.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The correctness check's control and the readings its limits come from.

    python3 hebench/control.py --workload <name> --seeds 11 12 13 \
        [--side control|reference|program] [--fault unchanged|half|altered] \
        [--seconds S]

For each seed it makes the keys and inputs of a run and the sample a run
judges, computes the outputs of that sample on one side, and judges them
with the check a run makes (bench.check):

  * control (the default): the plain reference (harness/reference.Evaluator)
    in the program's place, every modular product in float64 (53-bit
    mantissas where the program's residue products are exact integers);
    the check must refuse it;
  * reference: the same, exact; the check must accept it;
  * program: a run of the cell (bench.run) with a window of --seconds,
    optionally with a fault planted under its timed step (faults.py), which
    the check must refuse.  The seeds share one process, so the port's
    imports and builds are paid once.

Prints one JSON line a seed with the numbers compared.  Runs on the card
where there is one, else on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import faults  # noqa: E402
from harness import bench, reference as REF  # noqa: E402


def readings(workload: str, seed: int, side: str, device, fault: str | None = None,
             config_overrides=None, traffic_overrides=None, seconds: float = 1.0):
    if side == "program":
        return bench.run(workload, seed, seconds, False, device,
                         fault=faults.FAULTS[fault] if fault else None,
                         config_overrides=config_overrides,
                         traffic_overrides=traffic_overrides)[1]
    spec = bench.Spec(workload, config_overrides=config_overrides,
                      traffic_overrides=traffic_overrides)
    traffic = spec.traffic
    keys, switch, msgs, inputs = bench.prepare(spec, seed, torch.device(device))
    keep, idx = bench.sample(seed, traffic)
    sel = torch.tensor(idx, device=device)
    ev = REF.Evaluator(keys, exact=side == "reference")
    D = traffic["distinct_batches"]
    outs = {o: spec.op.reference(ev, traffic, tuple(x.index_select(0, sel)
                                                    for x in inputs[o % D]), switch)
            for o in sorted(keep) + [traffic["min_batches"]]}   # the last batch's stand-in
    return bench.check(spec, keys, msgs, outs, idx)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--side", choices=("control", "reference", "program"), default="control")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the window of a program-side run")
    args = ap.parse_args()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        v = readings(args.workload, seed, args.side, device, args.fault,
                     seconds=args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": args.side,
                          "fault": args.fault, "seconds": args.seconds,
                          "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                          "correct": v.correct, "numbers": v.numbers, "limits": v.limits,
                          "judged": v.judged, "failed": v.failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

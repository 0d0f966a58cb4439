"""A run loads neither jax nor the JAX package, compared by whole
top-level names, and the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import sys, json
sys.path[:0] = [{hebench!r}, {root!r}]
from harness import bench
bench.run("bfv8k_q210.rotate_rows.b64", 7, 0.2, False, device="cpu",
          config_overrides={{"poly_modulus_degree": 256, "security_level": "Nil"}},
          traffic_overrides={{"batch": 2, "distinct_batches": 1, "min_batches": 2,
                              "judged_batches": 1, "judged_per_batch": 2}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import sys, json
sys.path[:0] = [{hebench!r}]
from harness import arith, bench, judge, reference, roofline, scheme, stats
for folder in ("ops", "schemes", "metrics"):
    for f in sorted((bench.HERE / folder).glob("*.py")):
        bench.found(folder, f.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(hebench=str(ROOT / "hebench"),
                                                           root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = top_levels(RUN)
    assert "troy_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "troy_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    """The reference, the check, and every operation, scheme and metric
    file, loaded without a run."""
    mods = top_levels(REF)
    assert not mods & {"jax", "jaxlib", "flax", "troy_tpu", "troy_tpu_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    from harness import bench
    monkeypatch.setitem(sys.modules, "troy_tpu_torch.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("x"))
    assert not any(m.startswith(("troy_tpu_torch", "jaxtyping")) for m in bench.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "troy_tpu.fake", types.ModuleType("x"))
    assert "troy_tpu.fake" in bench.loaded_forbidden()
